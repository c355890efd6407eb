"""Plain PyTorch DCGAN RGBD generator (NHWC), for the benchmark's reference.

A frozen copy of the published architecture (RGBD-GAN ``net.py:603-773``)
as ``train_rgbd.py:220-246`` builds it: the training script passes the yml's ``ch``
as the latent width ``in_ch`` while the hidden width stays at its default
512. The stem, an equalized linear on ``concat([z, theta*10])``, gives
``hidden*4*4`` values viewed as an NCHW (B, hidden, 4, 4) map; then five
blocks (8, 16, 32, 64, 128 px at hidden, hidden, hidden, hidden/2,
hidden/4 channels), each a nearest 2x upsample and, twice, a 3x3 conv,
its bias, leaky ReLU and Chainer's ``F.normalize`` over the channels
(``x / (||x||_2 + 1e-5)``); a 1x1 toRGBD head a block, whose depth
channel starts at zero weights and the bias ``log(e - 1)``; the inverse
depth ``1/(softplus(h) + 1e-4)``. Latents are (B, in_ch) Gaussians
normalised by ``sqrt(sum(z^2)/in_ch + 1e-8)`` (``net.py:697-707``).

Departures from the published code:

- NHWC, as the other reference modules; the stem's output is still read
  in the published NCHW order
- noise is never added and its gains ``n0``/``n1`` get no gradient
  (``net.py:720``), blur is off (``enable_blur: False``)
- float32 only: no cell runs the bf16 trunk on this reference
- the weights are drawn in this module's construction order; the
  program is handed them by parameter name

Below them, the architecture's part of the reference step (the items
``reference/step.py`` names): one Adam over the whole generator;
``kernel_calls`` is the StyleGAN module's, the same 3D loss.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .geometry import camera_matrices, depth_floor, rotate_consistency_loss, sample_poses, theta_to_9dof
from .layers import EqualizedConv2D, EqualizedLinear, NoiseBlock, init_depth_head_, leaky_relu, upscale2x
from .step import LOSS_KEYS, ClippedAdam, _dis_loss, _pool_to, _unit, update
from .stylegan import kernel_calls  # noqa: F401  the same 3D loss at the same shapes: K1/K2 once each

HIDDEN = 512  # net.py:652's default; train_rgbd.py passes the yml's ch as in_ch
LAZY_R1 = True
# 8, 16 and 32 px: the three blocks at the hidden width
TINY = {"keys": {"ch": 16, "max_stage": 7, "stage_interval": "0,0,0,0,0,0,0,0"}, "rank_batch": 4, "px": 32}


def channel_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Chainer's ``F.normalize`` over the channels (the last axis)."""
    return x / (torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)) + eps)


class DCGANBlock(nn.Module):
    def __init__(self, ch: int, ch_in: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.c0 = EqualizedConv2D(ch_in, ch, 3, 1, 1, use_bias=False, generator=generator)
        self.n0 = NoiseBlock(ch)
        self.b0 = nn.Parameter(torch.zeros(ch))
        self.c1 = EqualizedConv2D(ch, ch, 3, 1, 1, use_bias=False, generator=generator)
        self.n1 = NoiseBlock(ch)
        self.b1 = nn.Parameter(torch.zeros(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = channel_norm(leaky_relu(self.c0(upscale2x(x)) + self.b0))
        return channel_norm(leaky_relu(self.c1(h) + self.b1))


class DCGANGenerator(nn.Module):
    def __init__(self, in_ch: int, ch: int = HIDDEN, initial_depth: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ch = ch
        self.linear = EqualizedLinear(in_ch + 9, ch * 4 * 4, generator=generator)
        chans = ((ch, ch), (ch, ch), (ch, ch), (ch // 2, ch), (ch // 4, ch // 2))
        for i, (c_out, c_in) in enumerate(chans):
            self.add_module(f"block{i}", DCGANBlock(c_out, c_in, generator=generator))
        for i, (c_out, _) in enumerate(chans):
            out = EqualizedConv2D(c_out, 4, 1, 1, 0, gain=1.0, generator=generator)
            init_depth_head_(out, initial_depth)
            self.add_module(f"out{i}", out)

    def forward(self, z: torch.Tensor, stage_floor: int, alpha, theta: torch.Tensor) -> torch.Tensor:
        """At an even stage s the blocks 0..(s-2)/2 and that block's head; at
        an odd stage the last block fades in over the previous head's 2x
        upsample. Stage 10 renders 128 px."""
        stage = int(stage_floor)
        block = lambda i: getattr(self, f"block{i}")  # noqa: E731
        out = lambda i: getattr(self, f"out{i}")  # noqa: E731
        h = self.linear(torch.cat([z.reshape(z.shape[0], -1), theta * 10], dim=1))
        h = h.reshape(z.shape[0], self.ch, 4, 4).permute(0, 2, 3, 1)
        if stage % 2 == 0:
            k = (stage - 2) // 2
            for i in range(k + 1):
                h = block(i)(h)
            h = out(k)(h)
        else:
            k = (stage - 1) // 2
            for i in range(k):
                h = block(i)(h)
            h = (1.0 - alpha) * upscale2x(out(k - 1)(h)) + alpha * out(k)(block(k)(h))
        depth = 1.0 / (F.softplus(h[..., -1:]) + 1e-4)
        return torch.cat([h[..., :3], depth], dim=-1)


def generator(cfg: dict, dtype: Optional[torch.dtype], generator: Optional[torch.Generator]) -> nn.Module:
    if dtype is not None:
        raise ValueError(f"the DCGAN reference is float32 only, not {dtype}")
    return DCGANGenerator(cfg["ch"], HIDDEN, cfg.get("initial_depth") or 1.0, generator)


def domains(cfg: dict, gen: DCGANGenerator) -> Dict[str, ClippedAdam]:
    """One clipping domain over the whole generator (no mapping network)."""
    return {"gen": ClippedAdam([(list(gen.named_parameters()), cfg["adam_alpha_g"], 1.0)],
                               cfg["adam_beta1"], cfg["adam_beta2"], "gen.")}


def draws(cfg: dict, generator: Optional[torch.Generator], batch: int, device) -> Dict[str, torch.Tensor]:
    """``z`` (batch, ch): a latent a pair, normalised by ``sqrt(sum/ch)``,
    both views of the pair; ``thetas6``: the paired poses."""
    ch = int(cfg["ch"])
    z = torch.randn(batch // 2, ch, generator=generator, device=device)
    z = z / torch.sqrt(torch.sum(z * z, dim=1, keepdim=True) / ch + 1e-8)
    return {"z": z.repeat(2, 1), "thetas6": sample_poses(generator, cfg, batch, device)}


def step(cfg: dict, models, opts, shards, iteration: int) -> Dict[str, torch.Tensor]:
    """RGBD-GAN's ``RGBDUpdater`` (``updater.py:274-448``) with the DCGAN
    generator over ``shards`` (each ``x`` uint8 (b, S, S, 3), ``z``,
    ``thetas6``) at the stage the program's schedule gives at
    ``max_stage``: G renders both views of each pair, its loss the
    non-saturating one plus 2 x (the occlusion-aware L1 3D-consistency loss
    at the yml's ``lambda_geometric`` + ``lambda_depth`` x the floor at
    ``depth_min``); one Adam steps the whole generator. D then sees the
    pre-update fakes, detached, and the reals, and pays R1 every
    ``r1_interval`` steps, weighted by the interval. Returns the metrics
    averaged over the shards (0-dim tensors)."""
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
                                          occlusion_aware=True, lambda_geometric=cfg["lambda_geometric"])
            rot = rot + cfg["lambda_depth"] * depth_floor(x_fake, cfg["depth_min"])
            metrics["gen/loss_rotate"].append(rot.detach())
            return loss + rot * 2.0  # the weight of renders up to 128 px, all DCGAN draws
        return fn

    update(gen, [opts["gen"]], [gen_loss(s) for s in shards])
    interval = int(cfg.get("r1_interval") or 1)
    gp_weight = cfg["lambda_gp"] * interval if iteration % interval == 0 else 0.0
    update(dis, [opts["dis"]], [
        (lambda s=s, f=f: _dis_loss(dis, f, _pool_to(_unit(s["x"]), size), stage, alpha, gp_weight, metrics))
        for s, f in zip(shards, fakes)])
    return {k: torch.stack(v).mean() for k, v in metrics.items()}
