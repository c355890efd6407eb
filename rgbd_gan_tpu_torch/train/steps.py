"""The RGBD G+D train step (reference ``RGBDUpdater.update_core``,
``updater.py:274-448``) — port of :func:`rgbd_gan_tpu.train.steps.make_rgbd_train_step`.

One iteration:
 1. paired latents ``z = concat([make_hidden(B/2)] * 2)`` and paired 6-DoF
    poses, drawn on the device (or injected by the caller)
 2. camera matrices and the 9-dim conditioning
 3. reals downsized to the stage resolution
 4. G loss: adversarial + 3D consistency + depth floor -> Adam updates of
    the mapping (alpha/100) and synthesis domains (StyleGAN), or of the
    whole generator in one domain (DCGAN, which has no mapping network)
 5. EMA soft copy into the smoothed generator
 6. D loss on the *detached pre-update* fakes and the reals, plus the R1
    penalty by double backward -> Adam update. With ``r1_interval`` k > 1
    (lazy R1) the penalty is taken only when the state's iteration is a
    multiple of k, weighted ``lambda_gp * k``; the other steps run one plain
    D(x_real) forward and report ``dis/loss_gp`` 0.

Under ``mixed16`` the reals reach D's R1 forward already cast to D's compute
dtype, so the input gradient is rounded to bf16 as in the JAX step.

The step mutates the state in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..geometry.camera import camera_matrices, theta_to_9dof
from ..geometry.warp import rotate_consistency_loss
from .ema import soft_copy_params
from .losses import dis_adv_loss, dis_out_and_r1, downsize_real, gen_adv_loss
from .state import TrainState


@dataclasses.dataclass(frozen=True)
class StepSpec:
    """Step configuration (the JAX package compiles one step per value)."""

    stage_floor: int
    batch_size: int
    architecture: str = "stylegan"  # 'stylegan' | 'dcgan' ('deepvoxels' takes its own step)
    use_rotate: bool = False
    occlusion_aware: bool = False
    keep_smoothed_gen: bool = False
    smoothing: float = 0.999
    lambda_gp: float = 1.0
    lambda_depth: float = 10.0
    depth_min: float = 0.6
    lambda_geometric: float = 3.0
    lambda_rotate: float = 2.0
    gather_mode: str = "xla"
    max_stage: int = 17
    r1_interval: int = 1
    # the JAX step's options that are not on the StyleGAN path: refused
    rotate_feature: bool = False
    use_occupancy: bool = False
    sn: bool = False
    axis_name: Optional[str] = None


def _to_unit_range(x: torch.Tensor) -> torch.Tensor:
    """uint8 batches normalise on the device: x/127.5 - 1 in f32."""
    if not torch.is_floating_point(x):
        return x.to(torch.float32) / 127.5 - 1.0
    return x


def _in_dtype_of(dis, x: torch.Tensor) -> torch.Tensor:
    """``x`` in D's compute dtype: the R1 penalty's differentiated input."""
    return x if dis.compute_dtype is None else x.to(dis.compute_dtype)


def make_rgbd_train_step(
    make_hidden: Callable[[Optional[torch.Generator], int], torch.Tensor],
    prior,
    spec: StepSpec,
):
    """Build the StyleGAN or DCGAN RGBD train step for ``spec`` (exact bilinear
    sampling, R1 every ``spec.r1_interval`` steps); raises
    ``NotImplementedError`` for the options that are not ported.

    ``make_hidden(generator, n)`` draws n latents on the state's device.
    Returns ``step(state, x_real_full, alpha, generator=None, *, z=None,
    thetas6=None) -> (state, metrics)``: ``x_real_full`` is the (B, S, S, 3)
    real batch, uint8 or in [-1, 1]; ``z`` and ``thetas6`` replace the
    step's own draws when given. Metrics are 0-dim tensors on the device.
    """
    unported = {
        "rotate_feature": spec.rotate_feature,
        "use_occupancy": spec.use_occupancy,
        "sn": spec.sn,
        "axis_name": spec.axis_name is not None,
    }
    if any(unported.values()):
        raise NotImplementedError(f"not ported yet: {', '.join(k for k, v in unported.items() if v)}")
    stage = spec.stage_floor
    half = spec.batch_size // 2

    def step(
        state: TrainState,
        x_real_full: torch.Tensor,
        alpha: float,
        generator: Optional[torch.Generator] = None,
        *,
        z: Optional[torch.Tensor] = None,
        thetas6: Optional[torch.Tensor] = None,
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        gen, dis = state.gen, state.dis
        device = x_real_full.device
        if z is None:
            z = torch.cat([make_hidden(generator, half)] * 2, dim=0)
        if thetas6 is None:
            thetas6 = prior.sample(generator, spec.batch_size, device)
        z, thetas6 = z.to(device), thetas6.to(device)
        mats = camera_matrices(thetas6)
        theta9 = theta_to_9dof(thetas6)
        x_real = downsize_real(_to_unit_range(x_real_full), stage, alpha, spec.max_stage)
        image_size = x_real.shape[1]

        # ---------------- generator phase ----------------
        dis.requires_grad_(False)
        gen.requires_grad_(True)
        x_fake = gen(z, stage, alpha, theta9)
        y_fake = dis(x_fake[..., :3], stage, alpha)
        loss_gen = gen_adv_loss(y_fake)
        metrics = {"gen/loss_adv": loss_gen.detach()}
        if spec.use_rotate:
            loss_rotate, _ = rotate_consistency_loss(
                x_fake[:half], mats[:half], x_fake[half:], mats[half:],
                occlusion_aware=spec.occlusion_aware,
                lambda_geometric=spec.lambda_geometric,
                gather_mode=spec.gather_mode,
            )
            if spec.lambda_depth > 0:
                # depth floor: push depth above depth_min (updater.py:357-359)
                loss_rotate = loss_rotate + spec.lambda_depth * torch.mean(
                    torch.relu(spec.depth_min - x_fake[..., -1]) ** 2
                )
            metrics["gen/loss_rotate"] = loss_rotate.detach()
            lam = spec.lambda_rotate if image_size <= 128 else spec.lambda_rotate * 2
            loss_gen = loss_gen + loss_rotate * lam

        if spec.architecture == "stylegan":
            # two clipping domains: mapping (alpha/100) and synthesis
            n_map = len(state.opt_map.params)
            grads = torch.autograd.grad(loss_gen, state.opt_map.params + state.opt_gen.params, allow_unused=True)
            state.opt_map.step(grads[:n_map])
            state.opt_gen.step(grads[n_map:])
        else:
            state.opt_gen.step(torch.autograd.grad(loss_gen, state.opt_gen.params, allow_unused=True))
        gen.requires_grad_(False)
        if spec.keep_smoothed_gen and state.ema_gen is not None:
            soft_copy_params(state.ema_gen, gen, 1.0 - spec.smoothing)

        # ---------------- discriminator phase ----------------
        # D sees the *pre-update* fakes, detached (updater.py:407)
        x_fake_rgb = x_fake[..., :3].detach()
        dis.requires_grad_(True)
        y_fake = dis(x_fake_rgb, stage, alpha)
        if spec.lambda_gp > 0:
            x_r1 = _in_dtype_of(dis, x_real)
            if state.iteration % spec.r1_interval == 0:
                # one D(x_real) forward feeds both the adversarial term and R1
                y_real, gp_raw = dis_out_and_r1(lambda xr: dis(xr, stage, alpha), x_r1)
                gp = spec.lambda_gp * spec.r1_interval * gp_raw
            else:
                y_real, gp = dis(x_r1, stage, alpha), torch.zeros((), device=device)
            loss_dis = dis_adv_loss(y_fake, y_real) + gp
            metrics["dis/loss_gp"] = gp.detach()
        else:
            loss_dis = dis_adv_loss(y_fake, dis(x_real, stage, alpha))
        metrics["dis/loss_adv"] = loss_dis.detach()  # the reference reports the total
        dis_params = list(dis.parameters())
        state.opt_dis.step(torch.autograd.grad(loss_dis, dis_params, allow_unused=True))
        dis.requires_grad_(False)

        metrics["stage"] = torch.tensor(float(stage) + float(alpha), device=device)
        metrics["image_size"] = torch.tensor(float(image_size), device=device)
        metrics["nan"] = torch.isnan(loss_gen.detach()) | torch.isnan(loss_dis.detach())
        state.iteration += 1
        return state, metrics

    return step
