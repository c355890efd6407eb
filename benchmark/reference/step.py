"""Plain PyTorch training steps of RGBD-GAN, for the benchmark's reference.

A frozen copy of the published updaters as the benchmark's configurations
run them, written as plainly as possible: RGBD-GAN's ``RGBDUpdater``
(``updater.py:274-448``, the StyleGAN step) and ``DeepVoxelsUpdater``
(``updater_deepvoxels.py:76-252``), with Adam after a global-norm clip at 5
(``train_rgbd.py:151-161``). Each step takes its latents and poses from the
caller. Data parallelism is the mean of the per-rank gradients: the step
takes one shard of inputs per rank, computes each shard's gradients with
the same parameters, averages them, and applies one update (the metrics are
averaged too).

One StyleGAN iteration: the generator renders both views of each latent
pair, its loss is the non-saturating adversarial loss plus 2 x (the L1
3D-consistency loss + 10 x the depth floor); Adam steps the mapping network
at alpha/100 (its own clipping domain) and the synthesis network (the
camera layers ``l1``/``l2`` at alpha/100). The discriminator then sees the
pre-update fakes, detached, and the reals, and pays R1 (``lambda_gp`` x
the batch mean of the squared input-gradient norm) every ``r1_interval``
steps, weighted by the interval.

One DeepVoxels iteration: the same G phase with the focal adversarial loss
(gamma from the configuration), the projection intrinsic in the 3D loss,
0.3 x (3D loss + 10 x depth floor), no occlusion mask; the mapping network
is stepped twice from the same gradients (its own optimizer and the whole
generator's); the D phase renders fresh unpaired latents through the
updated generator without gradient, and pays R1 every step.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import deepvoxels as dv
from .geometry import camera_matrices, depth_floor, rotate_consistency_loss, theta_to_9dof
from .stylegan import Discriminator, StyleGANGenerator

MAX_NORM = 5.0
EPS = 1e-8
DEEPVOXELS_STAGE, DEEPVOXELS_ALPHA, DEEPVOXELS_PX = 8, 0.5, 64


class ClippedAdam:
    """Adam(beta1, beta2, eps 1e-8) after clipping the domain's gradients to
    global norm 5; ``groups``: ``[(named_params, lr, scale)]``."""

    def __init__(self, groups, beta1: float, beta2: float):
        self.beta1, self.beta2 = beta1, beta2
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


def build(cfg: dict, generator: torch.Generator, device) -> Dict[str, torch.nn.Module]:
    """The generator and the discriminator of ``cfg`` (the configuration's
    yml keys), their weights drawn from ``generator`` on ``device``."""
    dtype = torch.bfloat16 if cfg.get("mixed16") else None
    with torch.device(device):
        if cfg["generator_architecture"] == "deepvoxels":
            gen = dv.DeepVoxelsGenerator(cfg["ch"], cfg.get("accumulative_threshold") or 4.0, dtype, generator)
        else:
            gen = StyleGANGenerator(cfg["ch"], cfg.get("initial_depth") or 1.0, dtype, generator)
        dis = Discriminator(cfg["ch"], bool(cfg.get("res_dis")), dtype, generator)
    # buffers made from numpy (the frustum's lattice) land on the host: move them too
    return {"gen": gen.to(device).requires_grad_(False), "dis": dis.to(device).requires_grad_(False)}


def optimizers(cfg: dict, models) -> Dict[str, ClippedAdam]:
    """One Adam per clipping domain (``train_rgbd.py:314-343``)."""
    gen, dis = models["gen"], models["dis"]
    a_g, a_d, b1, b2 = cfg["adam_alpha_g"], cfg["adam_alpha_d"], cfg["adam_beta1"], cfg["adam_beta2"]
    opts = {"map": ClippedAdam([(list(gen.mapping.named_parameters()), a_g / 100, 1.0)], b1, b2),
            "dis": ClippedAdam([(list(dis.named_parameters()), a_d, 1.0)], b1, b2)}
    if cfg["generator_architecture"] == "deepvoxels":
        opts["gen"] = ClippedAdam([(list(gen.named_parameters()), a_g, 1.0)], b1, b2)
    else:
        named = list(gen.gen.named_parameters())
        slow = [(n, p) for n, p in named if n.split(".")[0] in ("l1", "l2")]
        fast = [(n, p) for n, p in named if n.split(".")[0] not in ("l1", "l2")]
        opts["gen"] = ClippedAdam([(fast, a_g, 1.0), (slow, a_g, 0.01)], b1, b2)
    return opts


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


def stylegan_step(cfg: dict, models, opts, shards, iteration: int, stage: int, alpha: float) -> Dict[str, torch.Tensor]:
    """One RGBD StyleGAN step over ``shards`` (each a dict of ``x`` uint8
    (b, S, S, 3), ``z`` (b, 2ch), ``thetas6`` (b, 6)); returns the metrics
    averaged over the shards (0-dim tensors)."""
    gen, dis = models["gen"], models["dis"]
    metrics = {k: [] for k in ("gen/loss_adv", "gen/loss_rotate", "dis/loss_adv", "dis/loss_gp")}
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

    gen.requires_grad_(True)
    params = opts["map"].params + opts["gen"].params
    grads = _mean_grads([gen_loss(s) for s in shards], params)
    n_map = len(opts["map"].params)
    opts["map"].step(grads[:n_map])
    opts["gen"].step(grads[n_map:])
    gen.requires_grad_(False)

    interval = int(cfg.get("r1_interval") or 1)
    gp_weight = cfg["lambda_gp"] * interval if iteration % interval == 0 else 0.0
    dis.requires_grad_(True)
    grads = _mean_grads([
        (lambda s=s, f=f: _dis_loss(dis, f, _pool_to(_unit(s["x"]), size), stage, alpha, gp_weight, metrics))
        for s, f in zip(shards, fakes)], opts["dis"].params)
    opts["dis"].step(grads)
    dis.requires_grad_(False)
    return {k: torch.stack(v).mean() for k, v in metrics.items()}


def deepvoxels_step(cfg: dict, models, opts, shards, iteration: int) -> Dict[str, torch.Tensor]:
    """One DeepVoxels step over ``shards`` (each a dict of ``x`` uint8,
    ``z``, ``z2`` (paired), ``thetas6``, ``z_d``, ``z2_d`` (unpaired))."""
    gen, dis = models["gen"], models["dis"]
    stage, alpha = DEEPVOXELS_STAGE, DEEPVOXELS_ALPHA
    gamma = cfg.get("focal_loss_gamma") or 0.0
    metrics = {k: [] for k in ("gen/loss_adv", "gen/loss_rotate", "dis/loss_adv", "dis/loss_gp")}

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
                                          base_k=dv.PROJECTION_INTRINSIC)
            rot = rot + cfg["lambda_depth"] * depth_floor(x_fake, cfg["depth_min"])
            metrics["gen/loss_rotate"].append(rot.detach())
            return loss + rot * 0.3
        return fn

    gen.requires_grad_(True)
    n_map = len(opts["map"].params)
    grads = _mean_grads([gen_loss(s) for s in shards], opts["map"].params + opts["gen"].params)
    opts["map"].step(grads[:n_map])
    opts["gen"].step(grads[n_map:])
    gen.requires_grad_(False)

    def dis_loss(s):
        def fn():
            with torch.no_grad():
                fake = gen(s["z_d"], camera_matrices(s["thetas6"]), s["z2_d"])[..., :3]
            real = _pool_to(_unit(s["x"]), DEEPVOXELS_PX)
            return _dis_loss(dis, fake, real, stage, alpha, cfg["lambda_gp"], metrics)
        return fn

    dis.requires_grad_(True)
    opts["dis"].step(_mean_grads([dis_loss(s) for s in shards], opts["dis"].params))
    dis.requires_grad_(False)
    return {k: torch.stack(v).mean() for k, v in metrics.items()}

