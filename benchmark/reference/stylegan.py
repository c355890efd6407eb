"""Plain PyTorch StyleGAN RGBD generator and progressive PGGAN discriminator
(NHWC), for the benchmark's reference.

A frozen copy of the published architecture (RGBD-GAN ``net.py:22-504``)
as the configurations run it: the mapping network (PixelNorm, 8 equalized
linears), the progressive synthesis stack (const 4x4, upsample, conv, bias,
leaky ReLU, AdaIN), camera conditioning of blocks 0-1 (``[w, theta*16]``
through two linears), ``w2`` from block 3 on, the inverse-depth head
``1/(softplus(h) + 1e-4)``, and the residual discriminator. Noise is never
added (``net.py:243``). ``compute_dtype`` runs the trunks in bf16 with
float32 parameters; the mapping, the heads and the blend stay float32.

Parameter names and construction order are those of the published
checkpoints (``gen.block0.c1.weight``, ``block5.c_sc.weight``), so one state
dict loads into either implementation. Below them, the architecture's
part of the reference step (the items ``reference/step.py`` names).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .geometry import camera_matrices, depth_floor, rotate_consistency_loss, sample_poses, theta_to_9dof
from .layers import (
    AdaINBlock,
    EqualizedConv2D,
    EqualizedLinear,
    NoiseBlock,
    downscale2x,
    init_depth_head_,
    leaky_relu,
    pixel_norm,
    upscale2x,
)
from .step import LOSS_KEYS, ClippedAdam, _dis_loss, _pool_to, _unit, update

MAX_STAGE = 17
LAZY_R1 = True
TINY = {"keys": {"ch": 16, "max_stage": 7, "stage_interval": "0,0,0,0,0,0,0,0"}, "rank_batch": 4, "px": 32}


class MappingNetwork(nn.Module):
    def __init__(self, ch: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        for i in range(8):
            self.add_module(f"l{i}", EqualizedLinear(ch, ch, generator=generator))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = pixel_norm(z.reshape(z.shape[0], -1))
        for i in range(8):
            h = leaky_relu(getattr(self, f"l{i}")(h))
        return h


class SynthesisBlock(nn.Module):
    def __init__(self, ch: int, ch_in: int, w_dim: int, upsample: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ch_in, self.upsample = ch_in, upsample
        if upsample:
            self.c0 = EqualizedConv2D(ch_in, ch, 3, 1, 1, use_bias=False, generator=generator)
        else:
            self.const = nn.Parameter(torch.ones(4, 4, ch_in))
        self.n0 = NoiseBlock(ch)
        self.b0 = nn.Parameter(torch.zeros(ch))
        self.s0 = AdaINBlock(w_dim, ch, generator=generator)
        self.c1 = EqualizedConv2D(ch, ch, 3, 1, 1, use_bias=False, generator=generator)
        self.n1 = NoiseBlock(ch)
        self.b1 = nn.Parameter(torch.zeros(ch))
        self.s1 = AdaINBlock(w_dim, ch, generator=generator)

    def forward(self, w: torch.Tensor, x: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.upsample:
            h = self.c0(upscale2x(x))
        else:
            h = self.const[None].expand(w.shape[0], 4, 4, self.ch_in).to(w.dtype)
        h = self.s0(w, leaky_relu(h + self.b0.to(h.dtype)))
        h = self.c1(h)
        return self.s1(w, leaky_relu(h + self.b1.to(h.dtype)))


class StyleGenerator(nn.Module):
    """Synthesis blocks at 4, 8, 16, 32, 64, 128 px, each with its toRGBD head."""

    def __init__(self, ch: int, initial_depth: float = 1.0, compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        chans = ((ch, ch), (ch, ch), (ch, ch), (ch, ch), (ch // 2, ch), (ch // 4, ch // 2))
        for i, (c_out, c_in) in enumerate(chans):
            self.add_module(f"block{i}", SynthesisBlock(c_out, c_in, ch, upsample=(i != 0), generator=generator))
            out = EqualizedConv2D(c_out, 4, 1, 1, 0, gain=1.0, generator=generator)
            init_depth_head_(out, initial_depth)
            self.add_module(f"out{i}", out)
        self.l1 = EqualizedLinear(ch + 9, ch, generator=generator)
        self.l2 = EqualizedLinear(ch, ch, generator=generator)

    def _w(self, i: int, w: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
        if i >= 2:
            return w
        return leaky_relu(self.l2(leaky_relu(self.l1(torch.cat([w, theta * 16], dim=1)))))

    def forward(self, w: torch.Tensor, w2: torch.Tensor, stage_floor: int, alpha, theta: torch.Tensor):
        stage = min(int(stage_floor), MAX_STAGE - 1)
        if self.compute_dtype is not None:
            w, w2, theta = w.to(self.compute_dtype), w2.to(self.compute_dtype), theta.to(self.compute_dtype)
        block = lambda i: getattr(self, f"block{i}")  # noqa: E731
        out = lambda i: getattr(self, f"out{i}")  # noqa: E731
        h = None
        if stage % 2 == 0:
            k = (stage - 2) // 2
            for i in range(0, k + 2):
                if i == 3:
                    w = w2
                h = block(i)(self._w(i, w, theta), x=h)
            h = out(k + 1)(h.float())
        else:
            k = (stage - 1) // 2
            for i in range(0, k + 1):
                if i == 3:
                    w = w2
                h = block(i)(self._w(i, w, theta), x=h)
            h_0 = upscale2x(out(k)(h.float()))
            h_1 = out(k + 1)(block(k + 1)(w, x=h).float())  # the fade-in block takes the unconditioned w
            h = (1.0 - alpha) * h_0 + alpha * h_1
        depth = 1.0 / (F.softplus(h[..., -1:]) + 1e-4)
        return torch.cat([h[..., :3], depth], dim=-1)


class StyleGANGenerator(nn.Module):
    def __init__(self, ch: int, initial_depth: float = 1.0, compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mapping = MappingNetwork(ch, generator=generator)
        self.gen = StyleGenerator(ch, initial_depth, compute_dtype, generator=generator)

    def forward(self, z: torch.Tensor, stage_floor: int, alpha, theta: torch.Tensor) -> torch.Tensor:
        z1, z2 = torch.chunk(z.reshape(z.shape[0], -1), 2, dim=1)
        return self.gen(self.mapping(z1), self.mapping(z2), stage_floor, alpha, theta)


class DiscriminatorBlockBase(nn.Module):
    def __init__(self, ch: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.c0 = EqualizedConv2D(ch, ch, 3, 1, 1, generator=generator)
        self.c1 = EqualizedConv2D(ch, ch, 4, 1, 0, generator=generator)
        self.l2 = EqualizedLinear(ch, 1, gain=1.0, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.l2(leaky_relu(self.c1(leaky_relu(self.c0(x)))))


class DiscriminatorBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, res: bool, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.res = res
        self.c0 = EqualizedConv2D(in_ch, out_ch, 3, 1, 1, generator=generator)
        self.c1 = EqualizedConv2D(out_ch, out_ch, 3, 1, 1, generator=generator)
        if res:
            self.c_sc = EqualizedConv2D(in_ch, out_ch, 3, 1, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.c1(leaky_relu(self.c0(x)))
        if self.res:
            h = h + self.c_sc(x)
        return downscale2x(leaky_relu(h))


class Discriminator(nn.Module):
    def __init__(self, ch: int, res: bool = True, compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.block0 = DiscriminatorBlockBase(ch, generator=generator)
        for i, (c_in, c_out) in enumerate([(ch, ch), (ch, ch), (ch, ch), (ch // 2, ch), (ch // 4, ch // 2)]):
            self.add_module(f"block{i + 1}", DiscriminatorBlock(c_in, c_out, res, generator=generator))
        for i, c in enumerate([ch, ch, ch, ch, ch // 2, ch // 4]):
            self.add_module(f"in{i}", EqualizedConv2D(3, c, 1, 1, 0, generator=generator))

    def forward(self, x: torch.Tensor, stage_floor: int, alpha=0.0) -> torch.Tensor:
        stage = min(int(stage_floor), MAX_STAGE - 1)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        block = lambda i: getattr(self, f"block{i}")  # noqa: E731
        stem = lambda i, t: leaky_relu(getattr(self, f"in{i}")(t))  # noqa: E731
        if stage % 2 == 0:
            k = (stage - 2) // 2
            h = stem(k + 1, x)
            for i in reversed(range(0, k + 2)):
                h = block(i)(h)
        else:
            k = (stage - 1) // 2
            h_0 = stem(k, downscale2x(x))
            h_1 = block(k + 1)(stem(k + 1, x))
            # a float32 alpha promotes the trunk after the fade-in
            h = (1.0 - alpha) * h_0.float() + alpha * h_1.float()
            for i in reversed(range(0, k + 1)):
                h = block(i)(h)
        return h.float()


def generator(cfg: dict, dtype: Optional[torch.dtype], generator: Optional[torch.Generator]) -> nn.Module:
    return StyleGANGenerator(cfg["ch"], cfg.get("initial_depth") or 1.0, dtype, generator)


def domains(cfg: dict, gen: StyleGANGenerator) -> Dict[str, ClippedAdam]:
    a_g, b1, b2 = cfg["adam_alpha_g"], cfg["adam_beta1"], cfg["adam_beta2"]
    named = list(gen.gen.named_parameters())
    slow = [(n, p) for n, p in named if n.split(".")[0] in ("l1", "l2")]
    fast = [(n, p) for n, p in named if n.split(".")[0] not in ("l1", "l2")]
    return {"map": ClippedAdam([(list(gen.mapping.named_parameters()), a_g / 100, 1.0)], b1, b2, "gen.mapping."),
            "gen": ClippedAdam([(fast, a_g, 1.0), (slow, a_g, 0.01)], b1, b2, "gen.gen.")}


def draws(cfg: dict, generator: Optional[torch.Generator], batch: int, device) -> Dict[str, torch.Tensor]:
    """``z`` (batch, 2ch): a latent a pair, normalised by ``sqrt(sum/ch)``,
    both views of the pair; ``thetas6``: the paired poses."""
    ch = int(cfg["ch"])
    z = torch.randn(batch // 2, ch * 2, generator=generator, device=device)
    z = z / torch.sqrt(torch.sum(z * z, dim=1, keepdim=True) / ch + 1e-8)
    return {"z": z.repeat(2, 1), "thetas6": sample_poses(generator, cfg, batch, device)}


def kernel_calls(local_batch: int, image_px: int) -> Dict[str, tuple]:
    """The 3D-consistency loss gathers both directions of each render pair
    in one call: K1/K2 once each, the local batch, H*W points, C = 4 (RGBD)."""
    gather = ((local_batch, image_px * image_px, 4), 1)
    return {"bilinear_fwd": gather, "bilinear_bwd": gather}


def step(cfg: dict, models, opts, shards, iteration: int) -> Dict[str, torch.Tensor]:
    """RGBD-GAN's ``RGBDUpdater`` (``updater.py:274-448``) over ``shards``
    (each ``x`` uint8 (b, S, S, 3), ``z``, ``thetas6``) at the stage the
    program's schedule gives at ``max_stage``: G renders both views of each
    pair, its loss the non-saturating one plus 2 x (the L1 3D-consistency
    loss + 10 x the depth floor); Adam steps the mapping at alpha/100 and
    the synthesis network (its camera layers ``l1``/``l2`` at alpha/100).
    D then sees the pre-update fakes, detached, and the reals, and pays R1
    every ``r1_interval`` steps, weighted by the interval. Returns the
    metrics averaged over the shards (0-dim tensors)."""
    gen, dis = models["gen"], models["dis"]
    pinned = cfg["max_stage"] - 1e-8
    stage, alpha = int(math.floor(pinned)), pinned - math.floor(pinned)
    metrics = {k: [] for k in LOSS_KEYS}
    size = 4 * 2 ** (stage // 2)
    fakes = []

    def gen_loss(s):
        def fn():
            half = s["z"].shape[0] // 2
            mats = camera_matrices(s["thetas6"])
            x_fake = gen(s["z"], stage, alpha, theta_to_9dof(s["thetas6"]))
            fakes.append(x_fake[..., :3].detach())
            loss = torch.mean(F.softplus(-dis(x_fake[..., :3], stage, alpha)))
            metrics["gen/loss_adv"].append(loss.detach())
            rot = rotate_consistency_loss(x_fake[:half], mats[:half], x_fake[half:], mats[half:],
                                          occlusion_aware=True, lambda_geometric=3.0)
            rot = rot + cfg["lambda_depth"] * depth_floor(x_fake, cfg["depth_min"])
            metrics["gen/loss_rotate"].append(rot.detach())
            return loss + rot * (2.0 if size <= 128 else 4.0)
        return fn

    update(gen, [opts["map"], opts["gen"]], [gen_loss(s) for s in shards])
    interval = int(cfg.get("r1_interval") or 1)
    gp_weight = cfg["lambda_gp"] * interval if iteration % interval == 0 else 0.0
    update(dis, [opts["dis"]], [
        (lambda s=s, f=f: _dis_loss(dis, f, _pool_to(_unit(s["x"]), size), stage, alpha, gp_weight, metrics))
        for s, f in zip(shards, fakes)])
    return {k: torch.stack(v).mean() for k, v in metrics.items()}
