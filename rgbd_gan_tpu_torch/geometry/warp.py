"""Differentiable depth warping and the 3D-consistency loss (PyTorch, NHWC).

Port of :mod:`rgbd_gan_tpu.geometry.warp` (reference
``common/loss_functions.py:31-228``). Images are NHWC with depth last. The
pixel grid stacks ``[x(col), y(row), 1]`` row-major and the sampler swaps
u/v, so ``u`` indexes rows. Gradients flow through the projected
coordinates into the bilinear weights and through the gathered values; the
corner indices, the out-of-bounds mask and the occlusion mask carry none.

Quirk preserved (``loss_functions.py:219``): ``exact=True`` overwrites
``u1 = u0``, so interpolation is nearest (truncated) along u and linear
along v.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.bilinear import bilinear_gather

CLIP_Z_MIN = 1e-4
CLIP_Z_MAX = 10000.0

GATHER_MODES = ("xla", "onehot", "hybrid", "pallas")


def intrinsics(
    size: int, device: torch.device | str = "cpu", dtype: torch.dtype = torch.float32, base_k=None
) -> torch.Tensor:
    """Camera intrinsics K: focal ``2*size``, principal point ``size/2``
    (``loss_functions.py:48-50``; not centred at (size-1)/2, quirk kept).
    With ``base_k`` given, its first two rows are rescaled so that the
    principal point maps to ``size/2`` (``loss_functions.py:43-44``)."""
    if base_k is not None:
        k = torch.as_tensor(base_k, dtype=torch.float32)[:3, :3].to(device=device, dtype=dtype).clone()
        k[:2] *= size / k[0, 2] / 2
        return k
    return torch.tensor(
        [[size * 2.0, 0.0, size / 2.0], [0.0, size * 2.0, size / 2.0], [0.0, 0.0, 1.0]],
        dtype=dtype,
        device=device,
    )


def pixel_grid(
    size: int, device: torch.device | str = "cpu", dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Homogeneous pixel grid (3, size*size), rows [x, y, 1], x fastest."""
    xs = torch.arange(size, dtype=dtype, device=device)
    y, x = torch.meshgrid(xs, xs, indexing="ij")  # x[r, c] = c, y[r, c] = r
    return torch.stack([x, y, torch.ones_like(x)]).reshape(3, -1)


def relative_pose(mat1: torch.Tensor, mat2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``R = R2^T R1`` and ``t = R1^T (t2 - t1)`` (``loss_functions.py:85-91``)."""
    r1, r2 = mat1[:, :3, :3], mat2[:, :3, :3]
    t1, t2 = mat1[:, :3, -1:], mat2[:, :3, -1:]
    r = torch.matmul(r2.transpose(1, 2), r1)
    t = torch.matmul(r1.transpose(1, 2), t2 - t1)
    return r, t


def warp(k, inv_k, r, t, z, p) -> torch.Tensor:
    """Forward warp ``K R K^-1 (z*p) - K R t`` -> (B, HW, 3)
    (``loss_functions.py:171-175``). ``z`` (B, 1, HW), ``p`` (3, HW)."""
    kr = torch.matmul(k, r)
    krk = torch.matmul(kr, inv_k)
    krt = torch.matmul(kr, t)
    return (torch.matmul(krk, z * p) - krt).transpose(1, 2)


def inv_warp(k, inv_k, inv_r, t, z, p) -> torch.Tensor:
    """Inverse warp ``K R^T K^-1 (z*p) + K t`` (``loss_functions.py:178-182``)."""
    krk = torch.matmul(torch.matmul(k, inv_r), inv_k)
    kt = torch.matmul(k, t)
    return (torch.matmul(krk, z * p) + kt).transpose(1, 2)


def _bilinear_sample_xla(img: torch.Tensor, zp: torch.Tensor, exact: bool):
    """The plain four-corner gather route (``warp.py:139-193``), by autograd."""
    b, hw, _ = zp.shape
    _, h, w, c = img.shape
    zp = zp.reshape(-1, 3)
    zc = torch.clamp(zp[:, 2], CLIP_Z_MIN, CLIP_Z_MAX)
    v = zp[:, 0] / zc
    u = zp[:, 1] / zc  # axis swap: u indexes rows (H), v indexes cols (W)

    u_s, v_s, z_s = u.detach(), v.detach(), zp[:, 2].detach()
    u0i = u_s.to(torch.int32).to(torch.int64)  # truncation toward zero
    u1i = u0i + 1
    v0i = v_s.to(torch.int32).to(torch.int64)
    v1i = v0i + 1
    u0f, u1f = u0i.to(u.dtype), u1i.to(u.dtype)
    v0f, v1f = v0i.to(v.dtype), v1i.to(v.dtype)
    w1 = (u1f - u) * (v1f - v)
    w2 = (u - u0f) * (v1f - v)
    w3 = (u1f - u) * (v - v0f)
    w4 = (u - u0f) * (v - v0f)

    mask_b = (u_s >= 0) & (u_s < h - 1) & (v_s >= 0) & (v_s < w - 1) & (z_s > CLIP_Z_MIN)
    mask = mask_b.to(img.dtype)
    mask_i = mask_b.to(torch.int64)
    u0 = u0i * mask_i
    u1 = u0 if exact else u1i * mask_i  # reference quirk: u1 = u0 * not_getting_out
    v0 = v0i * mask_i
    v1 = v1i * mask_i
    w1, w2, w3, w4 = w1 * mask, w2 * mask, w3 * mask, w4 * mask

    img_flat = img.reshape(b * h * w, c)
    base = torch.div(torch.arange(b * hw, device=img.device), hw, rounding_mode="floor") * (h * w)

    def gather(uu, vv):
        return img_flat[base + uu * w + vv]

    warped = (
        w1[:, None] * gather(u0, v0)
        + w2[:, None] * gather(u1, v0)
        + w3[:, None] * gather(u0, v1)
        + w4[:, None] * gather(u1, v1)
    )
    return warped, mask


def bilinear_sample(
    img: torch.Tensor, zp: torch.Tensor, exact: bool = True, gather_mode: str = "xla"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Perspective divide + masked bilinear gather (``loss_functions.py:185-228``).

    :param img: (B, H, W, C) NHWC image
    :param zp: (B, HW, 3) projected homogeneous coords ``depth * (x, y, 1)``
    :param gather_mode: one of :data:`GATHER_MODES`. On a CUDA tensor every
        mode runs the CUDA kernels of :mod:`..ops.bilinear`; on a CPU tensor
        ``xla`` is the plain four-corner gather and the other modes run the
        kernels' plain version. All give the same numbers.
    :returns: ``warped`` (B*HW, C), zero where out of bounds, and ``mask``
        (B*HW,) float in-bounds indicator (no gradient).
    """
    if gather_mode not in GATHER_MODES:
        raise NotImplementedError(f"gather_mode {gather_mode!r} is not ported")
    if gather_mode == "xla" and img.device.type == "cpu":
        return _bilinear_sample_xla(img, zp, exact)
    b, hw, _ = zp.shape
    _, h, w, c = img.shape
    zc = torch.clamp(zp[..., 2], CLIP_Z_MIN, CLIP_Z_MAX)
    u_rows = zp[..., 1] / zc  # post-swap: u indexes rows
    v_cols = zp[..., 0] / zc
    z_s = zp[..., 2].detach()
    zmask = (z_s > CLIP_Z_MIN).to(img.dtype)
    warped = bilinear_gather(img, u_rows, v_cols, exact) * zmask[..., None]
    u_s, v_s = u_rows.detach(), v_cols.detach()
    mask = ((u_s >= 0) & (u_s < h - 1) & (v_s >= 0) & (v_s < w - 1) & (z_s > CLIP_Z_MIN)).to(img.dtype)
    return warped.reshape(b * hw, c), mask.reshape(b * hw)


def rotate_consistency_loss(
    img: torch.Tensor,
    mat: torch.Tensor,
    img_rot: torch.Tensor,
    mat_rot: torch.Tensor,
    *,
    occlusion_aware: bool = False,
    lambda_geometric: float = 3.0,
    max_depth: Optional[float] = None,
    min_depth: Optional[float] = None,
    base_k=None,
    exact_bilinear: bool = True,
    gather_mode: str = "xla",
):
    """3D-consistency loss between two renders of the same latent
    (``LossFuncRotate.__call__``, ``loss_functions.py:63-146``), L1 norm.

    ``img``/``img_rot`` (B, H, W, C) with depth last; ``mat``/``mat_rot``
    (B, 4, 4) cam2world. Returns ``(loss, concat([new_zp, new_zp_rot]))``.
    ``base_k`` replaces the default intrinsics (see :func:`intrinsics`);
    ``max_depth`` / ``min_depth`` keep only the pixels whose own depth lies
    below / above the limit (masks without gradient). The JAX package's
    ``norm`` other than L1 is not ported yet.
    """
    b, h, w, c = img.shape
    dev = img.device
    k = intrinsics(w, device=dev, dtype=img.dtype, base_k=base_k)
    inv_k = torch.linalg.inv(k)
    p = pixel_grid(w, device=dev, dtype=img.dtype)

    z = img[..., -1].reshape(b, 1, -1)
    z_rot = img_rot[..., -1].reshape(b, 1, -1)
    r, t = relative_pose(mat, mat_rot)
    inv_r = r.transpose(1, 2)

    new_zp = warp(k, inv_k, r, t, z, p)
    new_zp_rot = inv_warp(k, inv_k, inv_r, t, z_rot, p)

    # both directions in one batched gather
    warped_cat, not_out_cat = bilinear_sample(
        torch.cat([img_rot, img], dim=0),
        torch.cat([new_zp, new_zp_rot], dim=0),
        exact=exact_bilinear,
        gather_mode=gather_mode,
    )
    half_flat = b * h * w
    warped, warped_rot = warped_cat[:half_flat], warped_cat[half_flat:]
    not_out, not_out_rot = not_out_cat[:half_flat], not_out_cat[half_flat:]

    warped_target = torch.cat(
        [img[..., :-1].reshape(-1, c - 1), new_zp[:, :, 2].reshape(-1, 1)], dim=1
    ) * not_out[:, None]
    warped_rot_target = torch.cat(
        [img_rot[..., :-1].reshape(-1, c - 1), new_zp_rot[:, :, 2].reshape(-1, 1)], dim=1
    ) * not_out_rot[:, None]

    if occlusion_aware:
        # visible iff the depth sampled at the target lies behind the
        # projected depth (loss_functions.py:112-119); no gradient
        not_occluded = (
            warped[:, -1:].detach() > new_zp[:, :, 2].detach().reshape(-1, 1)
        ).to(img.dtype)
        not_occluded_rot = (
            warped_rot[:, -1:].detach() > new_zp_rot[:, :, 2].detach().reshape(-1, 1)
        ).to(img.dtype)
        warped = warped * not_occluded
        warped_rot = warped_rot * not_occluded_rot
        warped_target = warped_target * not_occluded
        warped_rot_target = warped_rot_target * not_occluded_rot

    for limit, keep in ((max_depth, torch.lt), (min_depth, torch.gt)):
        if limit is None:
            continue
        near = keep(z.detach().reshape(-1, 1), limit).to(img.dtype)
        near_rot = keep(z_rot.detach().reshape(-1, 1), limit).to(img.dtype)
        warped, warped_target = warped * near, warped_target * near
        warped_rot, warped_rot_target = warped_rot * near_rot, warped_rot_target * near_rot

    def criteria(a, b_):
        return torch.mean(torch.abs(a - b_))

    loss = criteria(warped[:, :-1], warped_target[:, :-1]) + criteria(
        warped_rot[:, :-1], warped_rot_target[:, :-1]
    )
    loss = loss + (
        criteria(warped[:, -1], warped_target[:, -1]) * lambda_geometric
        + criteria(warped_rot[:, -1], warped_rot_target[:, -1]) * lambda_geometric
    )
    return loss, torch.cat([new_zp, new_zp_rot], dim=0)
