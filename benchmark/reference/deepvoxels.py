"""Plain PyTorch DeepVoxels generator with the accumulative occlusion net
(NDHWC/NHWC), for the benchmark's reference.

A frozen copy of the published pipeline (RGBD-GAN
``deepvoxels_generator.py:112-323``, ``deepvoxel/``): the mapping network,
a 3D StyleGAN voxel generator (4^3 const to a 32^3 grid of 32 features),
the perspective lift of the grid into each camera's 56 x 64 x 64 frustum
(trilinear, clamped corner indices, cells outside the grid zeroed), the
accumulative occlusion net (density, clipped cumulative sum, its
differences as visibility weights and an expected depth) and the 2D style
refiner. The lift is the textbook one: eight gathers a cell in float32,
over the whole grid; the measured program's windowed kernels must give the
same function on these cameras.

Quirks kept, as published: the frustum's y uses float division
(``projection.py:67``), the 3D conv's fan-in counts ``k**2``, the refiner's
last conv has gain 0.5, the occlusion threshold is 4, the latents are plain
N(0, 1). Below them, the architecture's part of the reference step (the
items ``reference/step.py`` names).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .geometry import camera_matrices, depth_floor, rotate_consistency_loss, sample_poses
from .layers import AdaINBlock, EqualizedConv2D, EqualizedConv3D, EqualizedLinear, leaky_relu, upscale2x, upscale2x_3d
from .step import LOSS_KEYS, ClippedAdam, _dis_loss, _pool_to, _unit, update
from .stylegan import MappingNetwork

GRID_DIM = 32
PROJ_DIM = 64
VOXEL_SIZE = (1.0 / GRID_DIM) * 1.1 * 0.5
NEAR_PLANE = math.sqrt(3) / 4
FRUSTUM_DEPTH = int(np.ceil(np.sqrt(3) * GRID_DIM))  # 56
NUM_GRID_FEATS = 32
FOCAL = PROJ_DIM * 2.0
CENTER = float(GRID_DIM)
PROJECTION_INTRINSIC = np.array(
    [[FOCAL, 0.0, CENTER, 0.0], [0.0, FOCAL, CENTER, 0.0], [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]],
    dtype="float32",
)
STAGE, ALPHA = 8, 0.5  # the pinned stage and fade-in of the discriminator
LAZY_R1 = False
TINY = {"keys": {"ch": 8}, "rank_batch": 2}


def frustum_camera_coords() -> np.ndarray:
    """(4, D*H*W) homogeneous camera-space coordinates, depth-major."""
    lin = np.arange(PROJ_DIM * PROJ_DIM * FRUSTUM_DEPTH)
    zi = lin // (PROJ_DIM * PROJ_DIM)
    tmp = lin - zi * PROJ_DIM * PROJ_DIM
    y = tmp / PROJ_DIM  # float division, as published
    x = tmp % PROJ_DIM
    zc = zi * VOXEL_SIZE + NEAR_PLANE
    return np.stack([(x - CENTER) / FOCAL * zc, (y - CENTER) / FOCAL * zc, zc, np.ones_like(zc)]).astype("float32")


def lift(voxel: torch.Tensor, cam2world: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinear resampling of ``voxel`` (B, G, G, G, C) at every frustum
    cell: (B, D, H, W, C). Voxel coordinate row 2 indexes grid dim0, row 1
    dim1, row 0 dim2; per axis ``i0 = clamp(trunc(x), 0, G-1)``,
    ``i1 = min(i0 + 1, G-1)``; cells outside ``[0, G)^3`` give 0."""
    b, g, c = voxel.shape[0], voxel.shape[1], voxel.shape[-1]
    vox = torch.matmul(cam2world, coords)[:, :3] / VOXEL_SIZE + g / 2  # (B, 3, N)
    inside = torch.all(vox >= 0, dim=1) & torch.all(vox < g, dim=1)
    vox = torch.where(inside[:, None], vox, torch.zeros_like(vox))
    corners = []
    for axis in (2, 1, 0):
        i0 = vox[:, axis].to(torch.int64).clamp(0, g - 1)
        i1 = (i0 + 1).clamp(max=g - 1)
        frac = vox[:, axis] - i0.to(vox.dtype)
        corners.append(((i0, 1.0 - frac), (i1, frac)))
    flat = voxel.reshape(b, g * g * g, c)
    out = 0.0
    for ix, wx in corners[0]:
        for iy, wy in corners[1]:
            for iz, wz in corners[2]:
                idx = ((ix * g + iy) * g + iz).unsqueeze(-1).expand(-1, -1, c)
                out = out + (wx * wy * wz)[..., None] * torch.gather(flat, 1, idx)
    out = out * inside[..., None].to(out.dtype)
    return out.reshape(b, FRUSTUM_DEPTH, PROJ_DIM, PROJ_DIM, c)


class Conv3dSame(nn.Module):
    """Equalized 1x1x1 conv (the accumulative net's; no padding needed)."""

    def __init__(self, in_ch: int, out_ch: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = EqualizedConv3D(in_ch, out_ch, 1, 1, 0, use_bias=True, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class AccumulativeOcclusionNet(nn.Module):
    def __init__(self, threshold: float = 4.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.accumulative_threshold = threshold
        self.c0 = Conv3dSame(NUM_GRID_FEATS + 1, 4, generator=generator)
        self.c1 = Conv3dSame(4, 1, generator=generator)

    def forward(self, frustum: torch.Tensor):
        d = np.arange(-FRUSTUM_DEPTH // 2, FRUSTUM_DEPTH // 2) / FRUSTUM_DEPTH
        dc = torch.from_numpy(d.reshape(1, FRUSTUM_DEPTH, 1, 1, 1).astype("float32")).to(frustum)
        dc = dc.expand(frustum.shape[:-1] + (1,))
        h = self.c1(leaky_relu(self.c0(torch.cat([dc, frustum], dim=-1))))
        density = torch.sigmoid(h - self.accumulative_threshold)
        cumsum = torch.clamp(torch.cumsum(density, dim=1), 0.0, 1.0)
        cumsum = torch.cat([torch.zeros_like(cumsum[:, :1]), cumsum], dim=1)
        weights = cumsum[:, 1:] - cumsum[:, :-1]
        return weights, torch.sum(dc * weights, dim=1)


class SynthesisBlock3D(nn.Module):
    def __init__(self, ch: int, ch_in: int, w_dim: int, upsample: bool, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ch_in, self.upsample = ch_in, upsample
        if upsample:
            self.c0 = EqualizedConv3D(ch_in, ch, 3, 1, 1, use_bias=False, generator=generator)
        else:
            self.const = nn.Parameter(torch.ones(4, 4, 4, ch_in))
        self.b0 = nn.Parameter(torch.zeros(ch))
        self.s0 = AdaINBlock(w_dim, ch, generator=generator)
        self.c1 = EqualizedConv3D(ch, ch, 3, 1, 1, use_bias=False, generator=generator)
        self.b1 = nn.Parameter(torch.zeros(ch))
        self.s1 = AdaINBlock(w_dim, ch, generator=generator)

    def forward(self, w: torch.Tensor, x: Optional[torch.Tensor]) -> torch.Tensor:
        if self.upsample:
            h = self.c0(upscale2x_3d(x))
        else:
            h = self.const[None].expand(w.shape[0], 4, 4, 4, self.ch_in).to(w.dtype)
        h = self.s0(w, leaky_relu(h + self.b0.to(h.dtype)))
        return self.s1(w, leaky_relu(self.c1(h) + self.b1.to(h.dtype)))


class VoxelGenerator(nn.Module):
    def __init__(self, ch: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        chans = [(ch // 4, ch // 4, False), (ch // 4, ch // 4, True), (ch // 8, ch // 4, True), (ch // 8, ch // 8, True)]
        for i, (c_out, c_in, up) in enumerate(chans):
            self.add_module(f"block{i}", SynthesisBlock3D(c_out, c_in, ch, up, generator=generator))
        self.out = EqualizedConv3D(ch // 8, NUM_GRID_FEATS, 1, 1, 0, generator=generator)

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        h = None
        for i in range(4):
            h = getattr(self, f"block{i}")(w, h)
        return self.out(h)


class RefinerStyleGenerator(nn.Module):
    """64 -> 16 -> 64 px with skip concatenations, RGB out."""

    def __init__(self, w_dim: int, hidden_ch: int = 256, generator: Optional[torch.Generator] = None):
        super().__init__()
        hc, c_in = hidden_ch, NUM_GRID_FEATS
        convs = {"c0": (c_in, hc * 2, 4, 2), "c1": (hc * 2, hc * 4, 4, 2), "c4": (hc * 4, hc * 4, 3, 1),
                 "c5": (hc * 4, hc * 2, 3, 1), "c6": (hc * 4, hc, 3, 1)}
        for name, (i, o, k, s) in convs.items():
            self.add_module(name, EqualizedConv2D(i, o, k, s, 1, generator=generator))
            self.add_module("s" + name[1:], AdaINBlock(w_dim, o, generator=generator))
        self.c7 = EqualizedConv2D(hc + c_in, 3, 3, 1, 1, gain=0.5, generator=generator)

    def forward(self, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        h1 = self.s0(w, leaky_relu(self.c0(h)))
        h2 = self.s1(w, leaky_relu(self.c1(h1)))
        h3 = upscale2x(self.s4(w, leaky_relu(self.c4(h2))))
        h3 = leaky_relu(self.c5(h3))
        h3 = upscale2x(torch.cat([self.s5(w, h3), h1], dim=-1))
        h3 = leaky_relu(self.c6(h3))
        return self.c7(torch.cat([self.s6(w, h3), h], dim=-1))


class CameraParamGenerator(nn.Module):
    """Owned by the published generator; no step runs it."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.l0 = EqualizedLinear(8, 64, generator=generator)
        self.l1 = EqualizedLinear(64, 64, generator=generator)
        self.l2 = EqualizedLinear(64, 9, generator=generator)


class DeepVoxelsGenerator(nn.Module):
    def __init__(self, ch: int, threshold: float = 4.0, compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.mapping = MappingNetwork(ch, generator=generator)
        self.voxel_gen = VoxelGenerator(ch, generator=generator)
        self.occlusion_net = AccumulativeOcclusionNet(threshold, generator=generator)
        self.style_generator = RefinerStyleGenerator(ch, generator=generator)
        self.camera_param_generator = CameraParamGenerator(generator=generator)
        self.register_buffer("frustum_coords", torch.from_numpy(frustum_camera_coords()), persistent=False)

    def forward(self, z: torch.Tensor, cam2world: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
        """(B, ch) latents and (B, 4, 4) cam2world -> (B, 64, 64, 4) RGBD."""
        w, w2 = self.mapping(z), self.mapping(z2)
        if self.compute_dtype is not None:
            w, w2 = w.to(self.compute_dtype), w2.to(self.compute_dtype)
        frustum = lift(self.voxel_gen(w).float(), cam2world, self.frustum_coords)
        weights, depth_norm = self.occlusion_net(frustum)
        feats = torch.sum(weights * frustum, dim=1)
        depth = (depth_norm + 0.5) * FRUSTUM_DEPTH * VOXEL_SIZE + NEAR_PLANE
        rgb = self.style_generator(feats.to(w2.dtype), w2).float()
        return torch.cat([rgb, depth.float()], dim=-1)


def generator(cfg: dict, dtype: Optional[torch.dtype], generator: Optional[torch.Generator]) -> nn.Module:
    return DeepVoxelsGenerator(cfg["ch"], cfg.get("accumulative_threshold") or 4.0, dtype, generator)


def domains(cfg: dict, gen: DeepVoxelsGenerator) -> Dict[str, ClippedAdam]:
    a_g, b1, b2 = cfg["adam_alpha_g"], cfg["adam_beta1"], cfg["adam_beta2"]
    return {"map": ClippedAdam([(list(gen.mapping.named_parameters()), a_g / 100, 1.0)], b1, b2, "gen.mapping."),
            "gen": ClippedAdam([(list(gen.named_parameters()), a_g, 1.0)], b1, b2, "gen.")}


def draws(cfg: dict, generator: Optional[torch.Generator], batch: int, device) -> Dict[str, torch.Tensor]:
    """Plain N(0, 1) latents (batch, ch): ``z`` and ``z2`` paired (a latent
    for both views) for the G phase, the paired poses ``thetas6``, then
    ``z_d`` and ``z2_d`` unpaired for the D phase."""
    ch, half = int(cfg["ch"]), batch // 2
    out = {k: torch.randn(half, ch, generator=generator, device=device).repeat(2, 1) for k in ("z", "z2")}
    out["thetas6"] = sample_poses(generator, cfg, batch, device)
    out.update({k: torch.randn(batch, ch, generator=generator, device=device) for k in ("z_d", "z2_d")})
    return out


def kernel_calls(local_batch: int, image_px: int) -> Dict[str, tuple]:
    """K1/K2 once each on the 64 px renders (the 3D loss, C = 4); the lift of
    every render at every frustum cell, twice forward (G and D phase), once backward."""
    gather, lift_shape = (local_batch, PROJ_DIM**2, 4), (local_batch, FRUSTUM_DEPTH * PROJ_DIM**2, NUM_GRID_FEATS)
    return {"bilinear_fwd": (gather, 1), "bilinear_bwd": (gather, 1),
            "lift_fwd": (lift_shape, 2), "lift_bwd": (lift_shape, 1)}


def step(cfg: dict, models, opts, shards, iteration: int) -> Dict[str, torch.Tensor]:
    """RGBD-GAN's ``DeepVoxelsUpdater`` (``updater_deepvoxels.py:76-252``)
    over ``shards`` (each ``x`` uint8 and the draws): the StyleGAN step's G
    phase with the focal adversarial loss, the projection intrinsic in the
    3D loss, 0.3 x (3D loss + 10 x depth floor), no occlusion mask; the
    mapping is stepped twice from the same gradients (its own Adam and the
    whole generator's); the D phase renders the unpaired latents through
    the updated generator without gradient, and pays R1 every step."""
    gen, dis = models["gen"], models["dis"]
    stage, alpha = STAGE, ALPHA
    gamma = cfg.get("focal_loss_gamma") or 0.0
    metrics = {k: [] for k in LOSS_KEYS}

    def gen_loss(s):
        def fn():
            half = s["z"].shape[0] // 2
            mats = camera_matrices(s["thetas6"])
            x_fake = gen(s["z"], mats, s["z2"])
            y = dis(x_fake[..., :3], stage, alpha)
            loss = torch.mean(F.softplus(-y) * torch.sigmoid(-y) ** gamma)
            metrics["gen/loss_adv"].append(loss.detach())
            rot = rotate_consistency_loss(x_fake[:half], mats[:half], x_fake[half:], mats[half:],
                                          occlusion_aware=False, lambda_geometric=3.0,
                                          base_k=PROJECTION_INTRINSIC)
            rot = rot + cfg["lambda_depth"] * depth_floor(x_fake, cfg["depth_min"])
            metrics["gen/loss_rotate"].append(rot.detach())
            return loss + rot * 0.3
        return fn

    update(gen, [opts["map"], opts["gen"]], [gen_loss(s) for s in shards])

    def dis_loss(s):
        def fn():
            with torch.no_grad():
                fake = gen(s["z_d"], camera_matrices(s["thetas6"]), s["z2_d"])[..., :3]
            real = _pool_to(_unit(s["x"]), PROJ_DIM)
            return _dis_loss(dis, fake, real, stage, alpha, cfg["lambda_gp"], metrics)
        return fn

    update(dis, [opts["dis"]], [dis_loss(s) for s in shards])
    return {k: torch.stack(v).mean() for k, v in metrics.items()}
