"""Plain PyTorch camera matrices and 3D-consistency loss, for the
benchmark's reference.

A frozen copy of RGBD-GAN's ``updater.py:26-60`` (6-DoF pose to a 4x4
cam2world matrix) and ``common/loss_functions.py:31-228``
(``LossFuncRotate``): each render's depth is warped into the other camera,
both images are sampled there with a masked bilinear gather written as four
plain row gathers, and the L1 errors of colour and (weighted) depth are
summed over both directions. The occlusion-aware mask keeps a pixel where
the sampled depth lies behind the projected one. Quirk kept
(``loss_functions.py:219``): the gather is nearest along rows (``u1 = u0``)
and linear along columns, while the weights keep ``u0 + 1``.
"""

from __future__ import annotations

from typing import Optional

import torch

CLIP_Z_MIN = 1e-4
CLIP_Z_MAX = 10000.0


def _rotation(theta: torch.Tensor, a1: int, a2: int) -> torch.Tensor:
    rot = torch.eye(4, dtype=theta.dtype, device=theta.device).repeat(theta.shape[0], 1, 1)
    c, s = torch.cos(theta), torch.sin(theta)
    rot[:, a1, a1], rot[:, a1, a2], rot[:, a2, a1], rot[:, a2, a2] = c, -s, s, c
    return rot


def camera_matrices(thetas: torch.Tensor) -> torch.Tensor:
    """(B, 6) ``[rx, ry, rz, tx, ty, tz]`` -> (B, 4, 4) cam2world."""
    thetas = thetas.float()
    mat = torch.diag(torch.tensor([1.0, 1.0, -1.0, 1.0], device=thetas.device)).repeat(thetas.shape[0], 1, 1)
    mat[:, 2, 3] = 1.0
    for i in (0, 1, 2):
        mat = torch.matmul(_rotation(thetas[:, i], (i + 1) % 3, (i + 2) % 3), mat)
    mat[:, :3, 3] = mat[:, :3, 3] + thetas[:, 3:]
    return mat


def theta_to_9dof(thetas: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.cos(thetas[:, :3]), torch.sin(thetas[:, :3]), thetas[:, 3:]], dim=1)


def _intrinsics(size: int, device, base_k=None) -> torch.Tensor:
    if base_k is not None:
        k = torch.as_tensor(base_k, dtype=torch.float32)[:3, :3].to(device).clone()
        k[:2] *= size / k[0, 2] / 2
        return k
    return torch.tensor([[size * 2.0, 0.0, size / 2.0], [0.0, size * 2.0, size / 2.0], [0.0, 0.0, 1.0]],
                        device=device)


def _pixel_grid(size: int, device) -> torch.Tensor:
    xs = torch.arange(size, dtype=torch.float32, device=device)
    y, x = torch.meshgrid(xs, xs, indexing="ij")
    return torch.stack([x, y, torch.ones_like(x)]).reshape(3, -1)


def bilinear_sample(img: torch.Tensor, zp: torch.Tensor):
    """Perspective divide and masked gather: (B*HW, C) values, zero out of
    bounds, and the (B*HW,) in-bounds mask."""
    b, hw, _ = zp.shape
    _, h, w, c = img.shape
    zp = zp.reshape(-1, 3)
    zc = torch.clamp(zp[:, 2], CLIP_Z_MIN, CLIP_Z_MAX)
    v, u = zp[:, 0] / zc, zp[:, 1] / zc
    us, vs = u.detach(), v.detach()
    inside = (us >= 0) & (us < h - 1) & (vs >= 0) & (vs < w - 1) & (zp[:, 2].detach() > CLIP_Z_MIN)
    mask = inside.to(img.dtype)
    u = torch.where(inside, u, torch.zeros_like(u))
    v = torch.where(inside, v, torch.zeros_like(v))
    u0 = u.detach().to(torch.int64)
    v0 = v.detach().to(torch.int64)
    v1 = v0 + 1
    wu = (u0 + 1).to(u.dtype) - u + (u - u0.to(u.dtype))  # the two row weights, both on row u0
    wv0, wv1 = v1.to(v.dtype) - v, v - v0.to(v.dtype)
    flat = img.reshape(b * h * w, c)
    base = torch.div(torch.arange(b * hw, device=img.device), hw, rounding_mode="floor") * (h * w)
    out = wu[:, None] * (wv0[:, None] * flat[base + u0 * w + v0] + wv1[:, None] * flat[base + u0 * w + v1])
    return out * mask[:, None], mask


def rotate_consistency_loss(img, mat, img_rot, mat_rot, *, occlusion_aware: bool, lambda_geometric: float,
                            base_k=None) -> torch.Tensor:
    """L1 3D-consistency loss between two renders (B, H, W, C), depth last."""
    b, h, w, c = img.shape
    dev = img.device
    k = _intrinsics(w, dev, base_k)
    inv_k = torch.linalg.inv(k)
    p = _pixel_grid(w, dev)
    z = img[..., -1].reshape(b, 1, -1)
    z_rot = img_rot[..., -1].reshape(b, 1, -1)
    r1, r2 = mat[:, :3, :3], mat_rot[:, :3, :3]
    r = torch.matmul(r2.transpose(1, 2), r1)
    t = torch.matmul(r1.transpose(1, 2), mat_rot[:, :3, -1:] - mat[:, :3, -1:])
    kr = torch.matmul(k, r)
    new_zp = (torch.matmul(torch.matmul(kr, inv_k), z * p) - torch.matmul(kr, t)).transpose(1, 2)
    new_zp_rot = (torch.matmul(torch.matmul(torch.matmul(k, r.transpose(1, 2)), inv_k), z_rot * p)
                  + torch.matmul(k, t)).transpose(1, 2)

    warped, not_out = bilinear_sample(img_rot, new_zp)
    warped_rot, not_out_rot = bilinear_sample(img, new_zp_rot)
    target = torch.cat([img[..., :-1].reshape(-1, c - 1), new_zp[:, :, 2].reshape(-1, 1)], 1) * not_out[:, None]
    target_rot = torch.cat([img_rot[..., :-1].reshape(-1, c - 1), new_zp_rot[:, :, 2].reshape(-1, 1)], 1)
    target_rot = target_rot * not_out_rot[:, None]
    if occlusion_aware:
        seen = (warped[:, -1:].detach() > new_zp[:, :, 2].detach().reshape(-1, 1)).to(img.dtype)
        seen_rot = (warped_rot[:, -1:].detach() > new_zp_rot[:, :, 2].detach().reshape(-1, 1)).to(img.dtype)
        warped, target = warped * seen, target * seen
        warped_rot, target_rot = warped_rot * seen_rot, target_rot * seen_rot

    def l1(a, b_):
        return torch.mean(torch.abs(a - b_))

    loss = l1(warped[:, :-1], target[:, :-1]) + l1(warped_rot[:, :-1], target_rot[:, :-1])
    return loss + (l1(warped[:, -1], target[:, -1]) + l1(warped_rot[:, -1], target_rot[:, -1])) * lambda_geometric


def depth_floor(img: torch.Tensor, depth_min: float) -> torch.Tensor:
    """``mean(relu(depth_min - depth)^2)`` (``updater.py:357-359``)."""
    return torch.mean(torch.relu(depth_min - img[..., -1]) ** 2)


def sample_poses(generator: Optional[torch.Generator], cfg: dict, batch: int, device) -> torch.Tensor:
    """Paired 6-DoF poses (``train_rgbd.py:192-217``): ``theta1 ~ U(-1, 1)^6``
    and ``theta2 = theta1 - eps * sign(theta1)``, ``eps ~ U(0, 0.5)``, both
    scaled by the configuration's per-axis range (``x_rotate`` ... ``z_translate``)."""
    ranges = [cfg[f"{axis}_{kind}"] for kind in ("rotate", "translate") for axis in "xyz"]
    rotation_ranges, uniform = ranges[:3], bool(cfg.get("uniform_distribution"))
    half = batch // 2
    kw = dict(generator=generator, device=device)
    thetas = torch.rand(half, 6, **kw) * 2.0 - 1.0
    eps = torch.rand(half, 6, **kw) * 0.5
    sign = (torch.randint(0, 2, (half, 3), **kw) * 2 - 1).to(torch.float32)
    rot = torch.tensor(rotation_ranges, dtype=torch.float32, device=device)
    limit = torch.clamp(1.0 / (rot + 1e-8), 0.0, 1.0)
    if uniform:
        eps_rot = eps[:, :3] * sign * limit
    else:
        full = (rot == 3.1415).to(torch.float32)
        eps_rot = eps[:, :3] * (sign * full + sign.abs() * (1.0 - full)) * limit
    eps = torch.cat([eps_rot, eps[:, 3:]], dim=1)
    thetas2 = -eps * torch.sign(thetas) + thetas
    if uniform:
        thetas2 = (thetas2 * ((-1 <= thetas2) & (thetas2 <= 1)) + (-2 - thetas2) * (thetas2 < -1)
                   + (2 - thetas2) * (thetas2 > 1))
    scale = torch.tensor(ranges, dtype=torch.float32, device=device)
    return torch.cat([thetas, thetas2], dim=0) * scale[None]
