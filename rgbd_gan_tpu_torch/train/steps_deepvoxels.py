"""The DeepVoxels train step (reference ``updater_deepvoxels.py:76-252``) —
port of :func:`rgbd_gan_tpu.train.steps_deepvoxels.make_deepvoxels_train_step`.

What differs from the RGBD step, all as in the reference:

- the stage is pinned at 8.5: the progressive discriminator runs its even
  stage 8 graph at a fixed 64x64, and the reals are average-pooled to 64
- the generator's adversarial loss uses ``focal_loss_gamma``
- the 3D-consistency loss takes the projection intrinsic as K, its weight is
  fixed at 0.3 (the reference's yml key is misspelt, so it cannot be
  overridden), the depth-floor term is added whenever the loss is on, and
  the occlusion-aware mask is never passed
- the discriminator phase renders fresh, unpaired latents through the
  *updated* generator, with no gradient, instead of reusing the G-phase fakes
- the mapping network is updated twice per step: by its own alpha/100
  optimizer and again inside the whole-generator optimizer, from the same
  gradients
- an occlusion net with BatchNorm updates its running statistics in both
  generator forwards
- with a background generator, each generator forward also takes two
  fresh, unpaired background latents ``z3``, ``z4`` (drawn anew for the D
  phase), and the 3D-consistency loss splits into a foreground term (the
  real matrices, pixels nearer than 3) and a background term (the matrices
  with their translation set to 0, pixels farther than 3), so the bilinear
  gather runs twice (``updater_deepvoxels.py:176-190``)
- a spectrally normalised D (``sn``) advances its power-iteration vectors
  once per forward (G phase; D phase on the fakes and on the reals) and
  takes no R1 penalty
- under data parallelism (``spec.axis_name``) the BatchNorm running
  statistics are averaged over the ranks after the step, besides the
  gradients and the metrics (the forwards normalise with each rank's own
  batch: not a synchronised BatchNorm)

The step's spans are the RGBD step's, with the D phase's render in
``step.dis.render``.

The step mutates the state in place.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..geometry.camera import camera_matrices, theta_to_9dof
from ..geometry.warp import rotate_consistency_loss
from ..models.deepvoxels import PROJECTION_INTRINSIC
from .ema import soft_copy_params
from .losses import dis_adv_loss, dis_out_and_r1, gen_adv_loss
from .state import TrainState
from ..parallel.mesh import mean_batch_stats
from ..utils import trace
from .steps import StepSpec, _finish, _grads, _in_dtype_of, _to_unit_range

DEEPVOXELS_STAGE = 8  # floor of the pinned 8.5
IMG_SIZE = 64
LAMBDA_ROTATE_FIXED = 0.3  # the misspelt yml key makes this unoverridable


def _avg_pool_to(x: torch.Tensor, size: int) -> torch.Tensor:
    """Plain average pool of NHWC reals to ``size`` (``updater_deepvoxels.py:23-26``)."""
    scale = x.shape[1] // size
    if scale <= 1:
        return x
    b, h, w, c = x.shape
    return x.reshape(b, size, scale, size, scale, c).mean(dim=(2, 4))


def make_deepvoxels_train_step(
    make_hidden: Callable[[Optional[torch.Generator], int], torch.Tensor],
    prior,
    spec: StepSpec,
    focal_loss_gamma: float = 0.0,
    background_generator: bool = False,
):
    """Build the DeepVoxels train step for ``spec`` (exact bilinear sampling,
    R1 every step unless ``spec.sn``).

    ``make_hidden(generator, n)`` draws n latents on the state's device.
    Returns ``step(state, x_real_full, alpha, generator=None, *, z=None,
    z2=None, thetas6=None, z_d=None, z2_d=None, z3=None, z4=None, z3_d=None,
    z4_d=None) -> (state, metrics)``: the keyword tensors replace the step's
    own draws (``z``, ``z2``: the paired (B, ch) latents of the generator
    phase; ``z_d``, ``z2_d``: the unpaired ones of the discriminator phase;
    ``z3``, ``z4`` and ``z3_d``, ``z4_d``: the background generator's
    unpaired latents of each phase, drawn only with ``background_generator``).
    """
    if spec.r1_interval > 1:
        raise ValueError("r1_interval > 1 is not supported by the deepvoxels step")
    half = spec.batch_size // 2
    stage = DEEPVOXELS_STAGE
    r1 = not spec.sn and spec.lambda_gp > 0

    def rotate_loss(x_fake, mats, **limits):
        loss, _ = rotate_consistency_loss(
            x_fake[:half], mats[:half], x_fake[half:], mats[half:],
            lambda_geometric=spec.lambda_geometric, base_k=PROJECTION_INTRINSIC,
            gather_mode=spec.gather_mode, **limits,
        )
        return loss

    def step(
        state: TrainState,
        x_real_full: torch.Tensor,
        alpha: float,
        generator: Optional[torch.Generator] = None,
        *,
        z: Optional[torch.Tensor] = None,
        z2: Optional[torch.Tensor] = None,
        thetas6: Optional[torch.Tensor] = None,
        z_d: Optional[torch.Tensor] = None,
        z2_d: Optional[torch.Tensor] = None,
        z3: Optional[torch.Tensor] = None,
        z4: Optional[torch.Tensor] = None,
        z3_d: Optional[torch.Tensor] = None,
        z4_d: Optional[torch.Tensor] = None,
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        gen, dis = state.gen, state.dis
        device = x_real_full.device
        with trace.span("step.inputs", step=state.iteration):
            # paired latents for both styles (updater_deepvoxels.py:146-148)
            if z is None:
                z = torch.cat([make_hidden(generator, half)] * 2, dim=0)
            if z2 is None:
                z2 = torch.cat([make_hidden(generator, half)] * 2, dim=0)
            if thetas6 is None:
                thetas6 = prior.sample(generator, spec.batch_size, device)
            if z_d is None:
                z_d = make_hidden(generator, spec.batch_size)
            if z2_d is None:
                z2_d = make_hidden(generator, spec.batch_size)
            background = {}
            if background_generator:
                # unpaired draws, anew in the D phase (steps_deepvoxels.py:75-90)
                background = {k: make_hidden(generator, spec.batch_size) if t is None else t
                              for k, t in (("z3", z3), ("z4", z4), ("z3_d", z3_d), ("z4_d", z4_d))}
            z, z2, thetas6, z_d, z2_d = (t.to(device) for t in (z, z2, thetas6, z_d, z2_d))
            background = {k: t.to(device) for k, t in background.items()}
            mats = camera_matrices(thetas6)
            theta9 = theta_to_9dof(thetas6)
            x_real = _avg_pool_to(_to_unit_range(x_real_full), IMG_SIZE)

        # ---------------- generator phase ----------------
        with trace.span("step.gen"):
            with trace.span("step.gen.forward"):
                dis.requires_grad_(False)
                gen.requires_grad_(True)
                x_fake = gen(z, mats, z2, theta9, background.get("z3"), background.get("z4"))
                y_fake = dis(x_fake[..., :3], stage, alpha)
                loss_gen = gen_adv_loss(y_fake, focal_loss_gamma)
                metrics = {"gen/loss_adv": loss_gen.detach()}
                if spec.use_rotate:
                    with trace.span("step.gen.loss3d"):
                        if background_generator:
                            virtual = mats.clone()
                            virtual[:, :3, 3] = 0.0
                            loss_rotate = (rotate_loss(x_fake, mats, max_depth=3.0)
                                           + rotate_loss(x_fake, virtual, min_depth=3.0))
                        else:
                            loss_rotate = rotate_loss(x_fake, mats)
                        loss_rotate = loss_rotate + spec.lambda_depth * torch.mean(
                            torch.relu(spec.depth_min - x_fake[..., -1]) ** 2
                        )
                        metrics["gen/loss_rotate"] = loss_rotate.detach()
                        loss_gen = loss_gen + loss_rotate * LAMBDA_ROTATE_FIXED

            # the map optimizer first, then the whole-generator optimizer over the
            # same gradients (the mapping is in both: train_rgbd.py:335-343)
            map_params = list(gen.mapping.parameters())
            grads = _grads(spec, loss_gen, map_params + state.opt_gen.params, "step.gen.backward")
            with trace.span("step.gen.adam"):
                state.opt_map.step(grads[: len(map_params)])
                state.opt_gen.step(grads[len(map_params):])
                gen.requires_grad_(False)
                if spec.keep_smoothed_gen and state.ema_gen is not None:
                    soft_copy_params(state.ema_gen, gen, 1.0 - spec.smoothing)

        # ---------------- discriminator phase ----------------
        with trace.span("step.dis"):
            # fresh unpaired latents through the *updated* generator, no gradient
            with trace.span("step.dis.render"), torch.no_grad():
                x_fake_rgb = gen(z_d, mats, z2_d, theta9, background.get("z3_d"), background.get("z4_d"))[..., :3]
            with trace.span("step.dis.forward"):
                dis.requires_grad_(True)
                y_fake = dis(x_fake_rgb, stage, alpha)
                if r1:
                    with trace.span("step.dis.r1"):
                        y_real, gp_raw = dis_out_and_r1(lambda xr: dis(xr, stage, alpha), _in_dtype_of(dis, x_real))
                    gp = spec.lambda_gp * gp_raw
                    loss_dis = dis_adv_loss(y_fake, y_real) + gp
                    metrics["dis/loss_gp"] = gp.detach()
                else:
                    loss_dis = dis_adv_loss(y_fake, dis(x_real, stage, alpha))
                metrics["dis/loss_adv"] = loss_dis.detach()  # the reference reports the total
            grads = _grads(spec, loss_dis, state.opt_dis.params, "step.dis.backward")
            with trace.span("step.dis.adam"):
                state.opt_dis.step(grads)
            dis.requires_grad_(False)
        if spec.axis_name is not None:
            mean_batch_stats(gen)
        return _finish(state, spec, metrics, loss_gen, loss_dis, stage, 0.5, IMG_SIZE, device)

    return step
