"""Masked bilinear gather for the 3D-consistency loss: CUDA kernels + plain twin.

Port of :mod:`rgbd_gan_tpu.ops.bilinear_pallas`. On a CUDA tensor the
gather runs the hand-written kernels in ``csrc/bilinear.cu`` (K1 forward,
K2 backward, each on the kernel that :func:`fwd_route` or :func:`bwd_route`
picks by the channel count); on a CPU tensor it runs
:func:`bilinear_gather_reference` and :func:`bilinear_gather_reference_vjp`,
the plain PyTorch versions of the same function. A CUDA tensor never falls back to the plain version.

Semantics (those of ``bilinear_gather_pallas``): ``img`` (B, H, W, C),
row coordinates ``u`` and column coordinates ``v`` (B, N) -> (B, N, C).
A point is in bounds iff ``0 <= u < H-1`` and ``0 <= v < W-1``; corners are
``u0 = trunc(u)``, ``v0 = trunc(v)``, ``v1 = v0 + 1`` and ``u1 = u0 + 1``,
or ``u1 = u0`` with ``exact=True`` while the weights keep ``u0 + 1`` (the
reference's quirk, ``loss_functions.py:219``). Out-of-bounds points give 0
and receive no gradient; gradients flow through the weights (u, v) and the
gathered values (img). The in-bounds mask and the corner indices carry no
gradient.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from ._build import load_library, raise_on

# Launches of each kernel since the last reset; the plain CPU path does not
# count. ``fwd`` counts the thread-per-point forward (C == 4, or the old
# route forced by name), ``fwd_lanes`` the forward with a group of lanes a
# point; ``bwd`` the thread-per-point backward (forced by name only),
# ``bwd_vec4`` the vectorised one (C == 4), ``bwd_lanes`` the one with a
# group of lanes a point.
launches = {"fwd": 0, "fwd_lanes": 0, "bwd": 0, "bwd_vec4": 0, "bwd_lanes": 0}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path, and the kernels' reference on the card)
# ---------------------------------------------------------------------------


def _corner_data(u: torch.Tensor, v: torch.Tensor, h: int, w: int, exact: bool):
    """Masked corner indices and weights (``bilinear_pallas._weights``)."""
    u_s, v_s = u.detach(), v.detach()
    mask = (u_s >= 0) & (u_s < h - 1) & (v_s >= 0) & (v_s < w - 1)
    # masked coordinates may be NaN or inf: replace them by 0 so that no
    # index or weight is computed from them (their output is zeroed anyway)
    zero = torch.zeros_like(u_s)
    u = torch.where(mask, u, zero)
    v = torch.where(mask, v, zero)
    u0i = u.detach().to(torch.int64)  # truncation toward zero
    v0i = v.detach().to(torch.int64)
    u1i = u0i if exact else u0i + 1
    v1i = v0i + 1
    u0f = u0i.to(u.dtype)
    v0f = v0i.to(v.dtype)
    # weights keep the unoverwritten u0 + 1 even in exact mode
    wu0 = u0f + 1.0 - u
    wu1 = u - u0f
    wv0 = v0f + 1.0 - v
    wv1 = v - v0f
    return (u0i, u1i, v0i, v1i), (wu0, wu1, wv0, wv1), mask


def _gather_rows(img: torch.Tensor, ui: torch.Tensor, vi: torch.Tensor) -> torch.Tensor:
    b, h, w, c = img.shape
    flat = img.reshape(b, h * w, c)
    idx = (ui * w + vi).unsqueeze(-1).expand(-1, -1, c)
    return torch.gather(flat, 1, idx)


def bilinear_gather_reference(
    img: torch.Tensor, u: torch.Tensor, v: torch.Tensor, exact: bool = True
) -> torch.Tensor:
    """Plain PyTorch masked bilinear gather, differentiable by autograd.

    Same signature and semantics as ``bilinear_gather_pallas``; an
    out-of-bounds point gives an exact 0 even where ``u`` or ``v`` is NaN.
    """
    b, h, w, c = img.shape
    (u0, u1, v0, v1), (wu0, wu1, wv0, wv1), mask = _corner_data(u, v, h, w, exact)
    rows0 = wv0[..., None] * _gather_rows(img, u0, v0) + wv1[..., None] * _gather_rows(img, u0, v1)
    if exact:
        out = (wu0 + wu1)[..., None] * rows0
    else:
        rows1 = wv0[..., None] * _gather_rows(img, u1, v0) + wv1[..., None] * _gather_rows(img, u1, v1)
        out = wu0[..., None] * rows0 + wu1[..., None] * rows1
    return torch.where(mask[..., None], out, torch.zeros_like(out))


def bilinear_gather_reference_vjp(
    img: torch.Tensor, u: torch.Tensor, v: torch.Tensor, g: torch.Tensor, exact: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward of the gather: (d img, d u, d v) for cotangent ``g``.

    Closed form per point, as ``ops/bilinear_gradgather.py:_bwd``; d img is
    a scatter-add of the weighted cotangent onto the four corners.
    """
    b, h, w, c = img.shape
    (u0, u1, v0, v1), (wu0, wu1, wv0, wv1), mask = _corner_data(u, v, h, w, exact)
    m = mask.to(img.dtype)
    wu0, wu1, wv0, wv1 = wu0 * m, wu1 * m, wv0 * m, wv1 * m
    g = torch.where(mask[..., None], g, torch.zeros_like(g))
    p00, p01 = _gather_rows(img, u0, v0), _gather_rows(img, u0, v1)
    p10, p11 = (p00, p01) if exact else (_gather_rows(img, u1, v0), _gather_rows(img, u1, v1))

    def gdot(a):
        return (g * a).sum(-1)

    if exact:
        du = torch.zeros_like(u)
    else:
        du = gdot(wv0[..., None] * (p10 - p00) + wv1[..., None] * (p11 - p01))
    dv = gdot(
        (wu0[..., None] * p01 + wu1[..., None] * p11) - (wu0[..., None] * p00 + wu1[..., None] * p10)
    )

    dimg = torch.zeros(b, h * w, c, dtype=img.dtype, device=img.device)
    for ui, vi, wt in ((u0, v0, wu0 * wv0), (u1, v0, wu1 * wv0), (u0, v1, wu0 * wv1), (u1, v1, wu1 * wv1)):
        idx = (ui * w + vi).unsqueeze(-1).expand(-1, -1, c)
        dimg.scatter_add_(1, idx, wt[..., None] * g)
    return dimg.reshape(b, h, w, c), du, dv


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def fwd_route(c: int) -> str:
    """The forward kernel that takes a call on the card: ``"vec4"``
    (``bilinear_fwd_kernel<EXACT, true>``: a thread per point, one float4
    load per corner) when C == 4, else ``"lanes"``
    (``bilinear_fwd_lanes_kernel``: a group of lanes per point over the
    channels, each corner row read and the output row written coalesced).
    ``"generic"``, the thread-per-point kernel of any C, is taken only when
    forced by name, for measurements."""
    return "vec4" if c == 4 else "lanes"


def bwd_route(c: int) -> str:
    """The backward kernel that takes a call on the card: ``"vec4"``
    (``bilinear_bwd_vec4_kernel``: a thread per point, float4 cotangent and
    corner reads, a corner column shared with the next point handed to its
    lane in registers, one 4-float reduction per corner) when C == 4, else
    ``"lanes"`` (``bilinear_bwd_lanes_kernel``: a group of lanes per point
    over the channels, coalesced reads and scalar reductions, du and dv
    summed across the group by shuffles). ``"generic"``
    (``bilinear_bwd_kernel``: a thread per point, scalar atomics) is taken
    only when forced by name. For C == 4 the wrapper takes only a
    16-byte-aligned image and cotangent (the autograd backward copies a
    cotangent that is not); d img is a fresh allocation, aligned by
    construction."""
    return "vec4" if c == 4 else "lanes"


def _pick(kind: str, chosen: str, route, c: int) -> str:
    """``route`` where it can take a call of C channels, else ``chosen``
    (``route`` None): ``"generic"`` and ``"lanes"`` take any C, ``"vec4"``
    only C == 4. Raises, before any device is touched, on any other."""
    if route not in (None, "generic", "vec4", "lanes") or (route == "vec4" and chosen != "vec4"):
        raise ValueError(f"{kind} route {route!r} does not take C={c}")
    return route or chosen


def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/bilinear.cu``."""
    global _lib
    if _lib is None:
        lib = load_library("bilinear")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bilinear_gather_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.bilinear_gather_fwd.restype = i
        lib.bilinear_gather_bwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.bilinear_gather_bwd.restype = i
        lib.bilinear_gather_bwd_vec4.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.bilinear_gather_bwd_vec4.restype = i
        lib.bilinear_gather_fwd_lanes.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.bilinear_gather_fwd_lanes.restype = i
        lib.bilinear_gather_bwd_lanes.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.bilinear_gather_bwd_lanes.restype = i
        _lib = lib
    return _lib


def _check(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor, g=None) -> None:
    if img.dim() != 4 or u.dim() != 2 or u.shape != v.shape or u.shape[0] != img.shape[0]:
        raise ValueError(
            f"expected img (B,H,W,C) and u, v (B,N); got {tuple(img.shape)}, "
            f"{tuple(u.shape)}, {tuple(v.shape)}"
        )
    tensors = [img, u, v] + ([g] if g is not None else [])
    if g is not None and tuple(g.shape) != (u.shape[0], u.shape[1], img.shape[3]):
        raise ValueError(f"cotangent shape {tuple(g.shape)} does not match the output")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the bilinear gather takes float32 only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("img, u, v must be on one device")
    if any(t.numel() >= 2**31 for t in tensors):
        raise ValueError("tensor too large for the kernels' 32-bit sizes")


def _check_cuda(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor, g=None) -> None:
    vectors = (img,) + ((g,) if g is not None else ())
    if any(not t.is_contiguous() for t in vectors + (u, v)):
        raise ValueError("the bilinear kernels take contiguous tensors")
    if img.shape[3] == 4 and any(t.data_ptr() % 16 for t in vectors):
        raise ValueError("for C=4 the image and the cotangent must be 16-byte aligned (float4 loads)")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte-aligned address: itself where it is,
    else a copy (a fresh allocation is aligned)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fwd(img, u, v, exact: bool, route=None) -> torch.Tensor:
    """K1 on CUDA tensors, the plain version on CPU tensors. ``route``
    overrides :func:`fwd_route`'s choice, for measurements only (see
    :func:`_pick`)."""
    _check(img, u, v)
    route = _pick("forward", fwd_route(img.shape[3]), route, img.shape[3])
    if img.device.type == "cpu":
        return bilinear_gather_reference(img, u, v, exact)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    _check_cuda(img, u, v)
    b, h, w, c = img.shape
    n = u.shape[1]
    out = torch.empty(b, n, c, dtype=torch.float32, device=img.device)
    lib = _library()
    # the thread-per-point kernel (C == 4: its float4 instance) or the lanes kernel
    entry = lib.bilinear_gather_fwd_lanes if route == "lanes" else lib.bilinear_gather_fwd
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = entry(
            img.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, w, c, n, int(exact), stream,
        )
    raise_on(err, f"bilinear_gather_fwd ({route})")
    launches["fwd_lanes" if route == "lanes" else "fwd"] += 1
    return out


def _bwd(img, u, v, g, exact: bool, route=None):
    """K2 on CUDA tensors, the plain version on CPU tensors. ``route``
    overrides :func:`bwd_route`'s choice, for measurements only (see
    :func:`_pick`)."""
    _check(img, u, v, g)
    route = _pick("backward", bwd_route(img.shape[3]), route, img.shape[3])
    if img.device.type == "cpu":
        return bilinear_gather_reference_vjp(img, u, v, g, exact)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    _check_cuda(img, u, v, g)
    b, h, w, c = img.shape
    n = u.shape[1]
    dimg = torch.zeros_like(img)
    du = torch.empty_like(u)
    dv = torch.empty_like(v)
    lib = _library()
    entry = {"generic": lib.bilinear_gather_bwd, "vec4": lib.bilinear_gather_bwd_vec4,
             "lanes": lib.bilinear_gather_bwd_lanes}[route]
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = entry(
            img.data_ptr(), u.data_ptr(), v.data_ptr(), g.data_ptr(),
            dimg.data_ptr(), du.data_ptr(), dv.data_ptr(),
            b, h, w, c, n, int(exact), stream,
        )
    raise_on(err, f"bilinear_gather_bwd ({route})")
    launches[{"generic": "bwd", "vec4": "bwd_vec4", "lanes": "bwd_lanes"}[route]] += 1
    return dimg, du, dv


class _BilinearGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, u, v, exact):
        ctx.save_for_backward(img, u, v)
        ctx.exact = exact
        return _fwd(img, u, v, exact)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        img, u, v = ctx.saved_tensors
        dimg, du, dv = _bwd(img, u, v, _aligned(g), ctx.exact)
        return dimg, du, dv, None


def bilinear_gather(
    img: torch.Tensor, u: torch.Tensor, v: torch.Tensor, exact: bool = True
) -> torch.Tensor:
    """Masked bilinear gather ``(B,H,W,C), (B,N), (B,N) -> (B,N,C)`` with its
    gradient; K1/K2 on CUDA tensors, the plain version on CPU tensors.

    First-order only (``once_differentiable``): the R1 penalty never
    differentiates through the gather twice.
    """
    return _BilinearGather.apply(img, u, v, exact)
