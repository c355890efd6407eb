"""Trilinear frustum lift of the DeepVoxels generator: CUDA kernels + plain twin.

Port of :mod:`rgbd_gan_tpu.ops.trilinear_pallas`. On a CUDA tensor the lift
runs the hand-written kernels in ``csrc/trilinear.cu`` (K3 forward, K4
backward, and their windowed pair K5; each in its vectorised form, four
channels a thread, where :func:`fwd_route` and :func:`bwd_route` say so); on
a CPU tensor it runs
:func:`trilinear_lift_reference` and :func:`trilinear_lift_reference_vjp`,
the plain PyTorch versions of the same function. A CUDA tensor never falls
back to the plain version.

Semantics (those of ``trilinear_lift``): ``voxel`` (B, G, G, G, C),
``vox_coords`` (B, 3, N) with row 2 indexing grid dim0, row 1 dim1 and row 0
dim2, ``in_bounds`` (B, N) -> (B, N, C) float32. Per axis
``i0 = clamp(int(idx), 0, G-1)``, ``i1 = min(i0+1, G-1)``,
``frac = idx - i0``; a cell that is not in bounds gives zeros and reads
nothing, whatever its coordinates hold. The gradient goes to ``voxel`` only.

``dtype=torch.bfloat16`` rounds the operands where the Pallas kernels round
them (grid values, fused (dim0, dim1) weight, dim2 weight, the
(dim0, dim1)-collapsed partial sum and its product with the dim2 weight; in
the backward the cotangent and its product with the dim2 weight) and
accumulates in float32. ``window=w`` restricts each tile of
:data:`TILE_N` consecutive cells to the ``w`` dim1-planes ``[s, s+w)`` with
``s = clamp(min valid i0 of dim1, 0, G-w)``: corners outside are dropped.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ._build import load_library, raise_on

TILE_N = 1024  # cells per window tile (``trilinear_pallas.TILE_N``)

# Launches of each kernel since the last reset; the plain CPU path does not
# count. The windowed pair counts apart from the full kernels, and the
# vectorised kernels (``*_vec4``) apart from the thread-per-(cell, channel)
# ones.
launches = {k: 0 for k in ("fwd", "fwd_vec4", "bwd", "bwd_vec4", "fwd_win", "fwd_win_vec4", "bwd_win",
                           "bwd_win_vec4")}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path, and the kernels' reference on the card)
# ---------------------------------------------------------------------------


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round to the operand type and come back to float32."""
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


def _axis_terms(idx: torch.Tensor, g: int):
    """Corner indices and weights of one axis (``_axis_terms``); where the
    two corners coincide (last plane) one corner carries both weights, as
    the one-hot rows of the Pallas kernels add them."""
    i0 = idx.to(torch.int64).clamp(0, g - 1)  # the cast truncates toward zero
    i1 = (i0 + 1).clamp(max=g - 1)
    frac = idx - i0.to(idx.dtype)
    w0, w1 = 1.0 - frac, frac
    same = i1 == i0
    w0 = torch.where(same, w0 + w1, w0)
    w1 = torch.where(same, torch.zeros_like(w1), w1)
    return (i0, i1), (w0, w1)


def _cell_terms(vox_coords, mask, g: int, dtype: torch.dtype, window: Optional[int]):
    """Corner indices, rounded fused (dim0, dim1) weights and rounded dim2
    weights of every cell, with the window rule applied. Masked cells are
    computed from coordinate 0 and get zero weights."""
    # a masked cell's coordinates may be NaN, inf or far away: never index with them
    coords = torch.where(mask[:, None, :], vox_coords, torch.zeros_like(vox_coords))
    (x0, x1), (wx0, wx1) = _axis_terms(coords[:, 2], g)
    (y0, y1), (wy0, wy1) = _axis_terms(coords[:, 1], g)
    (z0, z1), (wz0, wz1) = _axis_terms(coords[:, 0], g)
    if window is not None:
        b, n = mask.shape
        y0_valid = torch.where(mask, y0, torch.full_like(y0, g))  # sentinel g
        s = y0_valid.reshape(b, n // TILE_N, TILE_N).min(dim=2, keepdim=True).values
        stop = (s.clamp(0, g - window) + window).expand(b, n // TILE_N, TILE_N).reshape(b, n)
        wy0 = torch.where(y0 < stop, wy0, torch.zeros_like(wy0))
        wy1 = torch.where(y1 < stop, wy1, torch.zeros_like(wy1))
    m = mask.to(wx0.dtype)
    a = [[_round(wx * wy * m, dtype) for wy in (wy0, wy1)] for wx in (wx0, wx1)]
    wz = [_round(wz0, dtype), _round(wz1, dtype)]
    return ((x0, x1), (y0, y1), (z0, z1)), a, wz


def _check(voxel_shape, vox_coords, in_bounds, window, *floats: torch.Tensor) -> torch.Tensor:
    """Validate the arguments (``floats``: the voxel grid or the cotangent);
    returns ``in_bounds`` as a bool tensor."""
    if len(voxel_shape) != 5 or not (voxel_shape[1] == voxel_shape[2] == voxel_shape[3]):
        raise ValueError(f"expected voxel (B,G,G,G,C); got {tuple(voxel_shape)}")
    b, g, c = voxel_shape[0], voxel_shape[1], voxel_shape[4]
    if vox_coords.dim() != 3 or tuple(vox_coords.shape[:2]) != (b, 3):
        raise ValueError(f"expected vox_coords (B,3,N); got {tuple(vox_coords.shape)}")
    n = vox_coords.shape[2]
    if tuple(in_bounds.shape) != (b, n):
        raise ValueError(f"expected in_bounds (B,N); got {tuple(in_bounds.shape)}")
    tensors = [vox_coords, *floats]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the trilinear lift takes float32 tensors (dtype selects the operand rounding)")
    if len({t.device for t in tensors + [in_bounds]}) != 1:
        raise ValueError("voxel, vox_coords, in_bounds must be on one device")
    if window is not None:
        if not 0 < window <= g:
            raise ValueError(f"window {window} must lie in (0, {g}]")
        if n % TILE_N:
            raise ValueError(f"the windowed lift needs N % {TILE_N} == 0; got N={n}")
    if b * n * c >= 2**31 or b * g * g * g * c >= 2**31:
        raise ValueError("tensor too large for the kernels' 32-bit sizes")
    return in_bounds if in_bounds.dtype == torch.bool else in_bounds != 0


def _operand_dtype(dtype: Optional[torch.dtype]) -> torch.dtype:
    dtype = dtype or torch.float32
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"operand dtype must be float32 or bfloat16; got {dtype}")
    return dtype


def _lin(ix, iy, iz, g: int, c: int) -> torch.Tensor:
    return (((ix * g + iy) * g + iz)).unsqueeze(-1).expand(-1, -1, c)


def trilinear_lift_reference(
    voxel: torch.Tensor,
    vox_coords: torch.Tensor,
    in_bounds: torch.Tensor,
    dtype: Optional[torch.dtype] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch lift: index arithmetic and ``torch.gather``, with the
    clamp, mask-first rule, rounding points and window rule of the kernels."""
    dtype = _operand_dtype(dtype)
    mask = _check(voxel.shape, vox_coords, in_bounds, window, voxel)
    b, g, c = voxel.shape[0], voxel.shape[1], voxel.shape[4]
    (xs, ys, zs), a, wz = _cell_terms(vox_coords, mask, g, dtype, window)
    flat = _round(voxel, dtype).reshape(b, g * g * g, c)
    out = None
    for k in range(2):  # the two dim2 planes
        t = None
        for i in range(2):
            for j in range(2):
                term = a[i][j][..., None] * torch.gather(flat, 1, _lin(xs[i], ys[j], zs[k], g, c))
                t = term if t is None else t + term
        p = _round(_round(t, dtype) * wz[k][..., None], dtype)
        out = p if out is None else out + p
    return torch.where(mask[..., None], out, torch.zeros_like(out))


def trilinear_lift_reference_vjp(
    voxel_shape,
    vox_coords: torch.Tensor,
    in_bounds: torch.Tensor,
    gbar: torch.Tensor,
    dtype: Optional[torch.dtype] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch backward of the lift: dV (B, G, G, G, C) for cotangent
    ``gbar`` (B, N, C), a ``scatter_add_`` of weight x cotangent onto the
    eight corners of each valid cell."""
    dtype = _operand_dtype(dtype)
    b, g, _, _, c = voxel_shape
    mask = _check(voxel_shape, vox_coords, in_bounds, window, gbar)
    if tuple(gbar.shape) != (b, vox_coords.shape[2], c):
        raise ValueError(f"cotangent shape {tuple(gbar.shape)} does not match the output")
    (xs, ys, zs), a, wz = _cell_terms(vox_coords, mask, g, dtype, window)
    gb = _round(torch.where(mask[..., None], gbar, torch.zeros_like(gbar)), dtype)
    dv = torch.zeros(b, g * g * g, c, dtype=torch.float32, device=gbar.device)
    for k in range(2):
        e = _round(wz[k][..., None] * gb, dtype)
        for i in range(2):
            for j in range(2):
                dv.scatter_add_(1, _lin(xs[i], ys[j], zs[k], g, c), a[i][j][..., None] * e)
    return dv.reshape(b, g, g, g, c)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def fwd_route(c: int, voxel_ptr: int) -> str:
    """The forward kernel that takes a call on the card: ``"vec4"``
    (``lift_fwd_vec4_kernel``: each thread 4 channels of a cell, float4 loads
    and stores) when C % 4 == 0 and the grid lies at a 16-byte-aligned
    address, else ``"generic"`` (``lift_fwd_kernel``: a thread per (cell,
    channel)). The output is a fresh allocation, aligned by construction."""
    return "vec4" if c % 4 == 0 and voxel_ptr % 16 == 0 else "generic"


def bwd_route(c: int, gbar_ptr: int) -> str:
    """The backward kernel that takes a call on the card: ``"vec4"``
    (``lift_bwd_vec4_kernel``: each thread 4 channels of a run of cells,
    float4 cotangent reads, the corner sums of cells with one corner base
    merged in registers and reduced into dV 4 floats at a time) when C % 4
    == 0 and the cotangent lies at a 16-byte-aligned address, else
    ``"generic"`` (``lift_bwd_kernel``: a thread per (cell, channel), scalar
    atomics). dV is a fresh allocation, aligned by construction."""
    return "vec4" if c % 4 == 0 and gbar_ptr % 16 == 0 else "generic"


def _library() -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/trilinear.cu``."""
    global _lib
    if _lib is None:
        lib = load_library("trilinear")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.trilinear_lift_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.trilinear_lift_fwd.restype = i
        lib.trilinear_lift_fwd_vec4.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.trilinear_lift_fwd_vec4.restype = i
        lib.trilinear_lift_bwd.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.trilinear_lift_bwd.restype = i
        lib.trilinear_lift_bwd_vec4.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.trilinear_lift_bwd_vec4.restype = i
        _lib = lib
    return _lib


def _fwd(voxel, vox_coords, in_bounds, dtype=None, window=None, route=None) -> torch.Tensor:
    """K3 (or windowed K5) on CUDA tensors, the plain version on CPU tensors.
    ``route`` overrides :func:`fwd_route`'s choice, for measurements only:
    ``"generic"`` also takes the calls that ``"vec4"`` takes."""
    dtype = _operand_dtype(dtype)
    if voxel.device.type == "cpu":
        return trilinear_lift_reference(voxel, vox_coords, in_bounds, dtype, window)
    if voxel.device.type != "cuda":
        raise ValueError(f"unsupported device {voxel.device}")
    mask = _check(voxel.shape, vox_coords, in_bounds, window, voxel)
    # a frustum reshape or an autograd cotangent may be strided
    voxel, vox_coords, mask = voxel.contiguous(), vox_coords.contiguous(), mask.contiguous()
    b, g, c = voxel.shape[0], voxel.shape[1], voxel.shape[4]
    n = vox_coords.shape[2]
    chosen = fwd_route(c, voxel.data_ptr())
    route = route or chosen
    if route not in ("generic", "vec4") or (route == "vec4" and chosen != "vec4"):
        raise ValueError(f"forward route {route!r} does not take C={c} with the grid at {voxel.data_ptr():#x}")
    out = torch.empty(b, n, c, dtype=torch.float32, device=voxel.device)
    lib = _library()
    args = (voxel.data_ptr(), vox_coords.data_ptr(), mask.data_ptr(), out.data_ptr(),
            b, g, c, n, int(dtype == torch.bfloat16), int(window or 0))
    with torch.cuda.device(voxel.device):
        stream = torch.cuda.current_stream(voxel.device).cuda_stream
        entry = lib.trilinear_lift_fwd if route == "generic" else lib.trilinear_lift_fwd_vec4
        err = entry(*args, stream)
    raise_on(err, f"trilinear_lift_fwd ({route})")
    launches[("fwd" if window is None else "fwd_win") + ("_vec4" if route == "vec4" else "")] += 1
    return out


def _bwd(voxel_shape, vox_coords, in_bounds, gbar, dtype=None, window=None, route=None) -> torch.Tensor:
    """K4 (or windowed K5) on CUDA tensors, the plain version on CPU tensors.
    ``route`` overrides :func:`bwd_route`'s choice, for measurements only:
    ``"generic"`` also takes the calls that ``"vec4"`` takes."""
    dtype = _operand_dtype(dtype)
    if gbar.device.type == "cpu":
        return trilinear_lift_reference_vjp(voxel_shape, vox_coords, in_bounds, gbar, dtype, window)
    if gbar.device.type != "cuda":
        raise ValueError(f"unsupported device {gbar.device}")
    mask = _check(voxel_shape, vox_coords, in_bounds, window, gbar)
    b, g, _, _, c = voxel_shape
    n = vox_coords.shape[2]
    if tuple(gbar.shape) != (b, n, c):
        raise ValueError(f"cotangent shape {tuple(gbar.shape)} does not match the output")
    vox_coords, mask, gbar = vox_coords.contiguous(), mask.contiguous(), gbar.contiguous()
    chosen = bwd_route(c, gbar.data_ptr())
    route = route or chosen
    if route not in ("generic", "vec4") or (route == "vec4" and chosen != "vec4"):
        raise ValueError(f"backward route {route!r} does not take C={c} with the cotangent at {gbar.data_ptr():#x}")
    dv = torch.zeros(b, g, g, g, c, dtype=torch.float32, device=gbar.device)
    lib = _library()
    with torch.cuda.device(gbar.device):
        stream = torch.cuda.current_stream(gbar.device).cuda_stream
        entry = lib.trilinear_lift_bwd if route == "generic" else lib.trilinear_lift_bwd_vec4
        err = entry(
            vox_coords.data_ptr(), mask.data_ptr(), gbar.data_ptr(), dv.data_ptr(),
            b, g, c, n, int(dtype == torch.bfloat16), int(window or 0), stream,
        )
    raise_on(err, f"trilinear_lift_bwd ({route})")
    launches[("bwd" if window is None else "bwd_win") + ("_vec4" if route == "vec4" else "")] += 1
    return dv


class _TrilinearLift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, voxel, vox_coords, in_bounds, dtype, window):
        ctx.save_for_backward(vox_coords, in_bounds)
        ctx.voxel_shape, ctx.dtype, ctx.window = tuple(voxel.shape), dtype, window
        return _fwd(voxel, vox_coords, in_bounds, dtype, window)

    @staticmethod
    @once_differentiable
    def backward(ctx, gbar):
        vox_coords, in_bounds = ctx.saved_tensors
        dv = _bwd(ctx.voxel_shape, vox_coords, in_bounds, gbar, ctx.dtype, ctx.window)
        return dv, None, None, None, None


def trilinear_lift(
    voxel: torch.Tensor,
    vox_coords: torch.Tensor,
    in_bounds: torch.Tensor,
    dtype: Optional[torch.dtype] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Trilinear lift ``(B,G,G,G,C), (B,3,N), (B,N) -> (B,N,C)`` with its
    gradient to ``voxel``; K3/K4 (K5 with ``window``) on CUDA tensors, the
    plain version on CPU tensors. First-order only."""
    return _TrilinearLift.apply(voxel, vox_coords, in_bounds, dtype, window)
