"""The legacy StyleGAN RGB updater and two auxiliary losses of the reference.

Port of :mod:`rgbd_gan_tpu.train.legacy`. No trainer calls these; they are
kept so that the port holds every component the JAX package holds:

- the legacy ``Updater`` (``updater.py:70-211``): RGB StyleGAN with style
  mixing, the learning-rate table's factor for the device count and stage
  multiplying both losses, and a fresh latent rendered by the *updated*
  generator for the D phase
- ``loss_func_dsgan`` (``updater.py:14-23``): the diversity-sensitive GAN
  loss (commented out at its only call site in the reference)
- ``calc_distance`` (``updater.py:63-67``): the two-sided nearest-neighbour
  distance between estimated and sampled camera parameters
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from .losses import dis_adv_loss, dis_out_and_r1, downsize_real, gen_adv_loss
from ..parallel.mesh import world_size
from .optim import get_lr_scale_factor
from .state import TrainState
from .steps import StepSpec, _finish, _to_unit_range, _update_dis, _update_gen


def loss_func_dsgan(x: torch.Tensor, z: torch.Tensor, theta: torch.Tensor, tau: float = 10.0) -> torch.Tensor:
    """Diversity-sensitive GAN loss (``updater.py:14-23``); ``x`` NHWC, RGBD
    or RGB (only RGB counts)."""
    if x.shape[-1] == 4:
        x = x[..., :3]
    dx = torch.sum((x[::2] - x[1::2]) ** 2, dim=tuple(range(1, x.dim())))
    dz = torch.sum((z[::2] - z[1::2]) ** 2, dim=tuple(range(1, z.dim())))
    loss_ds_1 = torch.clamp(torch.sqrt(dx / (dz + 1e-8)), max=tau)
    loss_ds_2 = torch.clamp(torch.sqrt(dx[:, None] / (torch.abs(theta[::2] - theta[1::2]) + 1e-8) / 1000.0), max=tau)
    return -torch.mean(loss_ds_1) - torch.mean(loss_ds_2)


def calc_distance(est_theta: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Two-sided nearest-neighbour squared distance between two sets of
    camera parameters (``updater.py:63-67``)."""
    dist = (
        torch.sum(est_theta**2, dim=1)[:, None]
        + torch.sum(theta**2, dim=1)[None, :]
        - 2.0 * torch.matmul(est_theta, theta.t())
    )
    return torch.mean(torch.min(dist, dim=0).values) + torch.mean(torch.min(dist, dim=1).values)


def make_legacy_train_step(
    make_hidden: Callable[[Optional[torch.Generator], int], torch.Tensor],
    spec: StepSpec,
    total_devices: Optional[int] = None,
):
    """Legacy RGB StyleGAN step with style mixing (``updater.py:115-211``).

    With probability ``spec.style_mixing_rate`` the fine half of each
    latent (the half that drives ``w2``) comes from a second latent; both
    losses are multiplied by ``get_lr_scale_factor(total_devices, stage)``;
    ``total_devices`` defaults to the world size under data parallelism
    (``spec.axis_name``, which also averages the gradients and the metrics
    over the ranks) and to 1 without. R1 whenever ``spec.lambda_gp > 0``. Returns ``step(state, x_real_full,
    alpha, generator=None, *, z=None, z2=None, mix=None, z_d=None,
    z2_d=None, mix_d=None) -> (state, metrics)``: the G phase's latent, its
    second latent and its mixing decision, and the D phase's, replace the
    step's own draws when given. ``dis/loss_adv`` is D's adversarial term
    alone and unscaled, ``gen/loss_adv`` the scaled G loss, as in the JAX
    step.
    """
    stage = spec.stage_floor
    if total_devices is None:
        total_devices = 1 if spec.axis_name is None else world_size()
    lr_scale = float(get_lr_scale_factor(total_devices, stage))

    def sample_z(generator, device, z, z2, mix) -> torch.Tensor:
        if z is None:
            z = make_hidden(generator, spec.batch_size)
        z = z.to(device)
        if spec.style_mixing_rate <= 0:
            return z
        if z2 is None:
            z2 = make_hidden(generator, spec.batch_size)
        if mix is None:
            mix = torch.rand((), generator=generator, device=device) < spec.style_mixing_rate
        half = z.shape[1] // 2
        mixed = torch.cat([z[:, :half], z2.to(device)[:, half:]], dim=1)
        return torch.where(torch.as_tensor(mix, device=device), mixed, z)

    def step(
        state: TrainState,
        x_real_full: torch.Tensor,
        alpha: float,
        generator: Optional[torch.Generator] = None,
        *,
        z: Optional[torch.Tensor] = None,
        z2: Optional[torch.Tensor] = None,
        mix: Optional[bool] = None,
        z_d: Optional[torch.Tensor] = None,
        z2_d: Optional[torch.Tensor] = None,
        mix_d: Optional[bool] = None,
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        gen, dis = state.gen, state.dis
        device = x_real_full.device
        x_real = downsize_real(_to_unit_range(x_real_full), stage, alpha, spec.max_stage)
        z = sample_z(generator, device, z, z2, mix)

        # ---------------- generator phase ----------------
        dis.requires_grad_(False)
        gen.requires_grad_(True)
        x_fake = gen(z, stage, alpha, None)
        loss_gen = gen_adv_loss(dis(x_fake[..., :3], stage, alpha)) * lr_scale
        metrics = {"gen/loss_adv": loss_gen.detach()}
        _update_gen(state, spec, loss_gen)

        # ---------------- discriminator phase ----------------
        # a fresh latent, rendered by the updated generator (updater.py:172-184)
        z_d = sample_z(generator, device, z_d, z2_d, mix_d)
        with torch.no_grad():
            x_fake_rgb = gen(z_d, stage, alpha, None)[..., :3]
        dis.requires_grad_(True)
        y_fake = dis(x_fake_rgb, stage, alpha)
        if spec.lambda_gp > 0:
            y_real, gp_raw = dis_out_and_r1(lambda xr: dis(xr, stage, alpha), x_real)
            loss_adv = dis_adv_loss(y_fake, y_real)
            gp = spec.lambda_gp * gp_raw
            metrics["dis/loss_gp"] = gp.detach()
            loss = loss_adv + gp
        else:
            loss_adv = loss = dis_adv_loss(y_fake, dis(x_real, stage, alpha))
        metrics["dis/loss_adv"] = loss_adv.detach()
        loss_dis = loss * lr_scale
        _update_dis(state, spec, loss_dis)
        return _finish(state, spec, metrics, loss_gen, loss_dis, stage, alpha, x_real.shape[1], device)

    return step
