"""The RGBD and the RGB G+D train steps (reference ``RGBDUpdater.update_core``,
``updater.py:274-448``, and ``RGBUpdater.update_core``, ``updater.py:503-589``)
— port of :func:`rgbd_gan_tpu.train.steps.make_rgbd_train_step` and
:func:`~rgbd_gan_tpu.train.steps.make_rgb_train_step`.

One iteration:
 1. paired latents ``z = concat([make_hidden(B/2)] * 2)`` and paired 6-DoF
    poses, drawn on the device (or injected by the caller)
 2. camera matrices and the 9-dim conditioning
 3. reals downsized to the stage resolution
 4. G loss: adversarial + 3D consistency + depth floor (+ the feature
    3D-consistency term with ``rotate_feature``, + the occupancy loss with
    ``use_occupancy``) -> Adam updates of the mapping (alpha/100) and
    synthesis domains (StyleGAN), or of the whole generator in one domain
    (DCGAN, which has no mapping network)
 5. EMA soft copy into the smoothed generator
 6. D loss on the *detached pre-update* fakes and the reals, plus the R1
    penalty by double backward -> Adam update. With ``r1_interval`` k > 1
    (lazy R1) the penalty is taken only when the state's iteration is a
    multiple of k, weighted ``lambda_gp * k``; the other steps run one plain
    D(x_real) forward and report ``dis/loss_gp`` 0. With spectral norm
    (``sn``) there is no R1. With ``rotate_feature`` D *maximises* the
    feature 3D-consistency error and, without ``sn``, pays
    ``lambda_gp * ||d sum(features) / d x_fake||^2`` besides.

``rotate_feature`` (``updater.py:340-356``) gathers D's 32x32 feature tap,
with one "depth" channel appended, in the 3D-consistency loss (L2 norm):
that channel is the reals' *last* channel, the blue one, average-pooled to
32 px (the reference's quirk, ``updater.py:347``), so the gather's points
carry no gradient. A spectrally normalised D advances its power-iteration
vectors once per forward: the G phase's, and the D phase's on the fakes and
on the reals, as the JAX step threads its ``sn`` collection.

Under ``mixed16`` the reals reach D's R1 forward already cast to D's compute
dtype, so the input gradient is rounded to bf16 as in the JAX step.

With ``spec.axis_name`` set (data parallelism, :mod:`..parallel.mesh`) the
step is the per-rank step of the JAX package's sharded one: it draws from
the rank's own stream, averages G's and D's gradients over the ranks before
the clip and Adam, averages the metrics and sets the NaN flag on every rank
if any rank saw one.

The RGB step (``rgb: True``) has the same skeleton without camera
conditioning and without any 3D loss: the generator renders RGB from the
latent alone, yet the latents are still drawn in pairs
(``updater.py:525``, the reference's quirk). Its D phase is the RGBD
step's without the feature 3D-consistency terms.

Each part runs in a span of :mod:`..utils.trace` (on only under a
profiler): ``step.inputs``, ``step.gen`` (``.forward``, ``.loss3d``,
``.backward``, ``.adam``), ``step.dis`` (``.forward``, ``.r1``,
``.backward``, ``.adam``) and ``step.finish``.

The step mutates the state in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..geometry.camera import camera_matrices, theta_to_9dof
from ..geometry.warp import occupancy_net_loss, rotate_consistency_loss
from ..parallel.mesh import mean_grads, mean_metrics
from ..utils import trace
from .ema import soft_copy_params
from .losses import _avg_pool_by, dis_adv_loss, dis_out_and_r1, downsize_real, gen_adv_loss, l2_loss
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
    rotate_feature: bool = False
    use_occupancy: bool = False
    lambda_occupancy: float = 1.0
    sn: bool = False
    # the legacy step's chance of taking the fine half of z from a second latent
    style_mixing_rate: float = 0.0
    # data parallelism: the mesh axis to average over (parallel.mesh.DATA_AXIS), or None
    axis_name: Optional[str] = None


def _to_unit_range(x: torch.Tensor) -> torch.Tensor:
    """uint8 batches normalise on the device: x/127.5 - 1 in f32."""
    if not torch.is_floating_point(x):
        return x.to(torch.float32) / 127.5 - 1.0
    return x


def _in_dtype_of(dis, x: torch.Tensor) -> torch.Tensor:
    """``x`` in D's compute dtype: the R1 penalty's differentiated input."""
    return x if dis.compute_dtype is None else x.to(dis.compute_dtype)


def _feature_rotate_loss(feat: torch.Tensor, x_real: torch.Tensor, mats: torch.Tensor, spec: StepSpec):
    """The 3D-consistency loss (L2) on D's feature tap with the reals' blue
    channel, pooled to the tap's size, appended as its depth."""
    half = spec.batch_size // 2
    depth = _avg_pool_by(x_real[..., -1:], x_real.shape[1] // feat.shape[1])
    feat = torch.cat([feat, depth], dim=-1)
    loss, _ = rotate_consistency_loss(
        feat[:half], mats[:half], feat[half:], mats[half:],
        occlusion_aware=spec.occlusion_aware, norm="l2",
        lambda_geometric=spec.lambda_geometric, gather_mode=spec.gather_mode,
    )
    return loss


def _grads(spec: StepSpec, loss: torch.Tensor, params, span: str):
    """d loss / d params (None where the loss does not reach), averaged over
    the ranks under ``spec.axis_name``, in the span ``span``."""
    with trace.span(span):
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return grads if spec.axis_name is None else mean_grads(grads, params)


def _update_gen(state: TrainState, spec: StepSpec, loss_gen: torch.Tensor) -> None:
    """Adam on the generator: for StyleGAN two clipping domains, the mapping
    (alpha/100) and the synthesis network; for DCGAN one over the whole
    generator. Then the EMA soft copy."""
    stylegan = spec.architecture == "stylegan"
    n_map = len(state.opt_map.params) if stylegan else 0
    params = (state.opt_map.params if stylegan else []) + state.opt_gen.params
    grads = _grads(spec, loss_gen, params, "step.gen.backward")
    with trace.span("step.gen.adam"):
        if stylegan:
            state.opt_map.step(grads[:n_map])
        state.opt_gen.step(grads[n_map:])
        state.gen.requires_grad_(False)
        if spec.keep_smoothed_gen and state.ema_gen is not None:
            soft_copy_params(state.ema_gen, state.gen, 1.0 - spec.smoothing)


def _dis_adv_and_penalty(
    state: TrainState, spec: StepSpec, x_fake_rgb: torch.Tensor, x_real: torch.Tensor, stage: int, alpha,
    metrics: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """D's loss on the detached fakes and the reals, plus the R1 penalty
    (every ``r1_interval`` steps, none with SN); returns it and D's feature
    tap on the fakes. Leaves D's parameters requiring gradients."""
    dis = state.dis
    dis.requires_grad_(True)
    y_fake, feat_fake = dis(x_fake_rgb, stage, alpha, return_hidden=True)
    if not spec.sn and spec.lambda_gp > 0:
        x_r1 = _in_dtype_of(dis, x_real)
        if state.iteration % spec.r1_interval == 0:
            # one D(x_real) forward feeds both the adversarial term and R1
            with trace.span("step.dis.r1"):
                y_real, gp_raw = dis_out_and_r1(lambda xr: dis(xr, stage, alpha), x_r1)
            gp = spec.lambda_gp * spec.r1_interval * gp_raw
        else:
            y_real, gp = dis(x_r1, stage, alpha), torch.zeros((), device=x_real.device)
        metrics["dis/loss_gp"] = gp.detach()
        return dis_adv_loss(y_fake, y_real) + gp, feat_fake
    return dis_adv_loss(y_fake, dis(x_real, stage, alpha)), feat_fake


def _update_dis(state: TrainState, spec: StepSpec, loss_dis: torch.Tensor) -> None:
    grads = _grads(spec, loss_dis, list(state.dis.parameters()), "step.dis.backward")
    with trace.span("step.dis.adam"):
        state.opt_dis.step(grads)
    state.dis.requires_grad_(False)


def _finish(state: TrainState, spec: StepSpec, metrics, loss_gen, loss_dis, stage, alpha, image_size, device):
    """The stage and image size into the metrics, and the NaN flag; under
    ``spec.axis_name`` the metrics averaged and the flag any over the ranks."""
    with trace.span("step.finish"):
        metrics["stage"] = torch.tensor(float(stage) + float(alpha), device=device)
        metrics["image_size"] = torch.tensor(float(image_size), device=device)
        nan = torch.isnan(loss_gen.detach()) | torch.isnan(loss_dis.detach())
        if spec.axis_name is None:
            metrics["nan"] = nan
        else:
            metrics = mean_metrics(metrics, nan)
        state.iteration += 1
        return state, metrics


def make_rgbd_train_step(
    make_hidden: Callable[[Optional[torch.Generator], int], torch.Tensor],
    prior,
    spec: StepSpec,
):
    """Build the StyleGAN or DCGAN RGBD train step for ``spec`` (exact bilinear
    sampling, R1 every ``spec.r1_interval`` steps).

    ``make_hidden(generator, n)`` draws n latents on the state's device.
    Returns ``step(state, x_real_full, alpha, generator=None, *, z=None,
    thetas6=None, occupancy_eps=None) -> (state, metrics)``: ``x_real_full``
    is the (B, S, S, 3) real batch, uint8 or in [-1, 1]; ``z``, ``thetas6``
    and ``occupancy_eps`` (the occupancy loss's depth jitter, (B, 1, H*W),
    ``0.05 * N(0, 1)``) replace the step's own draws when given. Metrics are
    0-dim tensors on the device.
    """
    stage = spec.stage_floor
    half = spec.batch_size // 2
    rotate_feature = spec.use_rotate and spec.rotate_feature
    r1 = not spec.sn and spec.lambda_gp > 0
    feature_penalty = rotate_feature and r1

    def step(
        state: TrainState,
        x_real_full: torch.Tensor,
        alpha: float,
        generator: Optional[torch.Generator] = None,
        *,
        z: Optional[torch.Tensor] = None,
        thetas6: Optional[torch.Tensor] = None,
        occupancy_eps: Optional[torch.Tensor] = None,
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        gen, dis = state.gen, state.dis
        device = x_real_full.device
        with trace.span("step.inputs", step=state.iteration):
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
        with trace.span("step.gen"):
            with trace.span("step.gen.forward"):
                dis.requires_grad_(False)
                gen.requires_grad_(True)
                x_fake = gen(z, stage, alpha, theta9)
                y_fake, feat_d = dis(x_fake[..., :3], stage, alpha, return_hidden=True)
                loss_gen = gen_adv_loss(y_fake)
                metrics = {"gen/loss_adv": loss_gen.detach()}
                if spec.use_rotate:
                    with trace.span("step.gen.loss3d"):
                        loss_rotate, _ = rotate_consistency_loss(
                            x_fake[:half], mats[:half], x_fake[half:], mats[half:],
                            occlusion_aware=spec.occlusion_aware,
                            lambda_geometric=spec.lambda_geometric,
                            gather_mode=spec.gather_mode,
                        )
                        if rotate_feature and feat_d is not None:
                            loss_rotate = loss_rotate + _feature_rotate_loss(feat_d, x_real, mats, spec)
                        if spec.lambda_depth > 0:
                            # depth floor: push depth above depth_min (updater.py:357-359)
                            loss_rotate = loss_rotate + spec.lambda_depth * torch.mean(
                                torch.relu(spec.depth_min - x_fake[..., -1]) ** 2
                            )
                        metrics["gen/loss_rotate"] = loss_rotate.detach()
                        lam = spec.lambda_rotate if image_size <= 128 else spec.lambda_rotate * 2
                        loss_gen = loss_gen + loss_rotate * lam
                        if spec.use_occupancy:
                            if occupancy_eps is None:
                                shape = (spec.batch_size, 1, x_fake.shape[1] * x_fake.shape[2])
                                occupancy_eps = 0.05 * torch.randn(shape, generator=generator, device=device)
                            loss_occ = occupancy_net_loss(
                                gen.occupancy_logits, x_fake[..., -1:], mats, z.reshape(z.shape[0], -1),
                                occupancy_eps.to(device),
                            )
                            metrics["gen/loss_occupancy"] = loss_occ.detach()
                            loss_gen = loss_gen + loss_occ * spec.lambda_occupancy
            _update_gen(state, spec, loss_gen)

        # ---------------- discriminator phase ----------------
        with trace.span("step.dis"):
            with trace.span("step.dis.forward"):
                # D sees the *pre-update* fakes, detached (updater.py:407)
                x_fake_rgb = x_fake[..., :3].detach().requires_grad_(feature_penalty)
                loss_dis, feat_fake = _dis_adv_and_penalty(state, spec, x_fake_rgb, x_real, stage, alpha, metrics)
                if rotate_feature and feat_fake is not None:
                    # D *maximises* the feature 3D-consistency error
                    loss_dis = loss_dis - _feature_rotate_loss(feat_fake, x_real, mats, spec)
                    if feature_penalty:
                        # the feature tap's input gradient, kept differentiable for D's parameters
                        (g_fake,) = torch.autograd.grad(feat_fake.sum(), x_fake_rgb, create_graph=True)
                        g_norm = torch.sqrt(torch.sum(g_fake**2, dim=tuple(range(1, g_fake.dim()))) + 1e-24)
                        loss_dis = loss_dis + spec.lambda_gp * l2_loss(g_norm, 0.0)
                metrics["dis/loss_adv"] = loss_dis.detach()  # the reference reports the total
            _update_dis(state, spec, loss_dis)
        return _finish(state, spec, metrics, loss_gen, loss_dis, stage, alpha, image_size, device)

    return step


def make_rgb_train_step(make_hidden: Callable[[Optional[torch.Generator], int], torch.Tensor], spec: StepSpec):
    """Build the StyleGAN or DCGAN RGB train step for ``spec`` (reference
    ``RGBUpdater``): no camera and no 3D loss, paired latents, R1 every
    ``spec.r1_interval`` steps or SN. Returns ``step(state, x_real_full, alpha, generator=None,
    *, z=None) -> (state, metrics)``, the RGBD step's interface without the
    poses; ``z`` replaces the step's own latents when given."""
    stage = spec.stage_floor
    half = spec.batch_size // 2

    def step(
        state: TrainState,
        x_real_full: torch.Tensor,
        alpha: float,
        generator: Optional[torch.Generator] = None,
        *,
        z: Optional[torch.Tensor] = None,
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        device = x_real_full.device
        with trace.span("step.inputs", step=state.iteration):
            if z is None:
                z = torch.cat([make_hidden(generator, half)] * 2, dim=0)  # paired (updater.py:525)
            z = z.to(device)
            x_real = downsize_real(_to_unit_range(x_real_full), stage, alpha, spec.max_stage)

        # ---------------- generator phase ----------------
        with trace.span("step.gen"):
            with trace.span("step.gen.forward"):
                state.dis.requires_grad_(False)
                state.gen.requires_grad_(True)
                x_fake = state.gen(z, stage, alpha, None)
                loss_gen = gen_adv_loss(state.dis(x_fake[..., :3], stage, alpha))
                metrics = {"gen/loss_adv": loss_gen.detach()}
            _update_gen(state, spec, loss_gen)

        # ---------------- discriminator phase ----------------
        with trace.span("step.dis"):
            with trace.span("step.dis.forward"):
                loss_dis, _ = _dis_adv_and_penalty(
                    state, spec, x_fake[..., :3].detach(), x_real, stage, alpha, metrics)
                metrics["dis/loss_adv"] = loss_dis.detach()
            _update_dis(state, spec, loss_dis)
        return _finish(state, spec, metrics, loss_gen, loss_dis, stage, alpha, x_real.shape[1], device)

    return step
