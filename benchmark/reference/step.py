"""Plain PyTorch training steps of RGBD-GAN, for the benchmark's reference:
the parts every architecture shares, and the lookup of the rest.

A frozen copy of the published updaters, as plain as possible: Adam after
a global-norm clip at 5 (``train_rgbd.py:151-161``), the discriminator's
loss and R1 (``lambda_gp`` x the batch mean of the squared input-gradient
norm, by double backward). A step takes its draws from the caller, and a
shard of inputs a rank: data parallelism is the shards' mean gradients.

What depends on the generator's architecture lives in the module
``reference/<generator_architecture>.py``, found by that name; a new
architecture adds its module and edits no other file. The module holds:

- ``generator(cfg, dtype, generator)``: the generator, its weights drawn first
- ``domains(cfg, gen)``: its Adams, ``{name: ClippedAdam}``, each with the
  prefix of its parameters' names (D's, ``dis``, is added here)
- ``draws(cfg, generator, batch, device)``: a checked step's latents and
  poses, in a fixed order (on ``meta``: a shard's shapes, for the FLOP count)
- ``step(cfg, models, opts, shards, iteration)``: at its pinned stage
- ``kernel_calls(local_batch, image_px)``: ``{kind: ((B, N, C), calls)}``
  of the hand-written kernels a rank's step makes
- ``LAZY_R1``: whether a step can skip R1; ``TINY``: the tiny test cells'
  ``keys``, ``rank_batch`` and ``px``
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

MAX_NORM = 5.0
EPS = 1e-8
LOSS_KEYS = ("gen/loss_adv", "gen/loss_rotate", "dis/loss_adv", "dis/loss_gp")


class ClippedAdam:
    """Adam(beta1, beta2, eps 1e-8) after clipping the domain's gradients to
    global norm 5; ``groups``: ``[(named_params, lr, scale)]``; ``prefix``
    makes a leaf's name the parameter's (``gen.gen.`` + ``block0.b0``)."""

    def __init__(self, groups, beta1: float, beta2: float, prefix: str):
        self.beta1, self.beta2, self.prefix = beta1, beta2, prefix
        self.leaves: List[Tuple[str, torch.Tensor, float]] = []
        for named, lr, scale in groups:
            self.leaves += [(name, p, lr * scale) for name, p in named]
        self.count = 0
        self.mu = [torch.zeros_like(p) for _, p, _ in self.leaves]
        self.nu = [torch.zeros_like(p) for _, p, _ in self.leaves]

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for _, p, _ in self.leaves]

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        g = [torch.zeros_like(p) if gi is None else gi for (_, p, _), gi in zip(self.leaves, grads)]
        norm = torch.sqrt(sum(torch.sum(gi.double() ** 2) for gi in g)).float()
        factor = torch.where(norm < MAX_NORM, torch.ones_like(norm), MAX_NORM / norm)
        self.count += 1
        bc1 = float(np.float32(1.0) - np.float32(self.beta1) ** np.int32(self.count))
        bc2 = float(np.float32(1.0) - np.float32(self.beta2) ** np.int32(self.count))
        for i, ((_, p, lr), gi) in enumerate(zip(self.leaves, g)):
            gi = gi * factor
            self.mu[i] = self.beta1 * self.mu[i] + (1.0 - self.beta1) * gi
            self.nu[i] = self.beta2 * self.nu[i] + (1.0 - self.beta2) * gi * gi
            p -= lr * (self.mu[i] / bc1) / (torch.sqrt(self.nu[i] / bc2) + EPS)

    def first_moments(self) -> Dict[str, torch.Tensor]:
        return {name: m for (name, _, _), m in zip(self.leaves, self.mu)}


def architecture(cfg: dict) -> ModuleType:
    """The reference module of ``cfg``'s generator: ``reference/<generator_architecture>.py``."""
    name = f"{__package__}.{cfg['generator_architecture']}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ModuleNotFoundError(f"no reference module {name} for generator_architecture "
                                  f"{cfg['generator_architecture']!r}", name=name) from None


def build(cfg: dict, generator: torch.Generator, device) -> Dict[str, torch.nn.Module]:
    """The generator and the discriminator of ``cfg`` (the configuration's
    yml keys), their weights drawn from ``generator`` on ``device``."""
    from .stylegan import Discriminator  # the shared D; stylegan.py imports this module

    dtype = torch.bfloat16 if cfg.get("mixed16") else None
    with torch.device(device):
        gen = architecture(cfg).generator(cfg, dtype, generator)
        dis = Discriminator(cfg["ch"], bool(cfg.get("res_dis")), dtype, generator)
    # buffers made from numpy (the frustum's lattice) land on the host: move them too
    return {"gen": gen.to(device).requires_grad_(False), "dis": dis.to(device).requires_grad_(False)}


def optimizers(cfg: dict, models) -> Dict[str, ClippedAdam]:
    """One Adam per clipping domain (``train_rgbd.py:314-343``): the
    generator's, as its architecture splits it, and the discriminator's."""
    dis = ClippedAdam([(list(models["dis"].named_parameters()), cfg["adam_alpha_d"], 1.0)],
                      cfg["adam_beta1"], cfg["adam_beta2"], "dis.")
    return {**architecture(cfg).domains(cfg, models["gen"]), "dis": dis}


def update(module, domains: Sequence[ClippedAdam], loss_fns) -> None:
    """One update of ``module``: the shards' mean gradients of every
    domain's leaves in one pass, then each domain's Adam in turn."""
    module.requires_grad_(True)
    grads = _mean_grads(loss_fns, [p for opt in domains for p in opt.params])
    for opt in domains:
        opt.step(grads[:len(opt.params)])
        grads = grads[len(opt.params):]
    module.requires_grad_(False)


def _mean_grads(loss_fns, params):
    """The gradients of each shard's loss, averaged over the shards."""
    total = None
    for fn in loss_fns:
        grads = torch.autograd.grad(fn(), params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        total = grads if total is None else [t + g for t, g in zip(total, grads)]
    return [t / len(loss_fns) for t in total]


def _r1(dis, x: torch.Tensor, stage: int, alpha):
    """D(x) and ``mean_b ||d sum D(x) / dx||^2``, differentiable in D's weights."""
    x = x.detach().requires_grad_(True)
    y = dis(x, stage, alpha)
    (gx,) = torch.autograd.grad(y, x, torch.ones_like(y), create_graph=True)
    gx = gx.float()
    norms = torch.sqrt(torch.sum(gx**2, dim=tuple(range(1, gx.dim()))) + 1e-24)
    return y, torch.mean(norms**2)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) / 127.5 - 1.0


def _pool_to(x: torch.Tensor, size: int) -> torch.Tensor:
    b, h, w, c = x.shape
    s = h // size
    return x if s <= 1 else x.reshape(b, size, s, size, s, c).mean(dim=(2, 4))


def _dis_loss(dis, x_fake_rgb, x_real, stage, alpha, gp_weight: float, metrics):
    in_dtype = x_real if dis.compute_dtype is None else x_real.to(dis.compute_dtype)
    y_fake = dis(x_fake_rgb, stage, alpha)
    if gp_weight > 0:
        y_real, gp = _r1(dis, in_dtype, stage, alpha)
        gp = gp_weight * gp
    else:
        y_real, gp = dis(in_dtype, stage, alpha), torch.zeros((), device=x_real.device)
    metrics["dis/loss_gp"].append(gp.detach())
    loss = torch.mean(F.softplus(y_fake)) + torch.mean(F.softplus(-y_real)) + gp
    metrics["dis/loss_adv"].append(loss.detach())
    return loss
