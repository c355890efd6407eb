"""Training loop for the StyleGAN and DeepVoxels RGBD paths: builds models,
optimizers and the step from a config and runs the iteration loop.

Port of the StyleGAN and DeepVoxels parts of :mod:`rgbd_gan_tpu.train.trainer`
(reference ``train_rgbd.py:261-474``): model and optimizer wiring (mapping
at alpha/100 in its own clipping domain; for StyleGAN ``l1``/``l2`` at
alpha/100 inside the synthesis domain, for DeepVoxels one optimizer over the
whole generator, mapping included), the piecewise-linear stage schedule
(DeepVoxels is pinned at stage 8.5, 64 px), the per-iteration NaN guard, the
reference's report keys, ``log.jsonl``, snapshots and resume. Float32 stays
float32: TF32 is switched off for matmuls and convs.

Not on these paths yet, and refused: the DCGAN generator, spectral norm,
``rotate_feature``, occupancy, lazy R1, ``mixed16``, ``use_mpi`` and
``step_window > 1``; of DeepVoxels the background generator,
``rendernet_projection`` and ``occlusion_type: occlusion_unet``. Preview
images wait for the eval port.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..core.stage import decompose_stage, parse_stage_interval, stage_at
from ..data.dataset import ImageDataset, prepare_dataset
from ..geometry.prior import CameraParamPrior
from ..models.discriminator import Discriminator
from ..models.deepvoxels import build_deepvoxels_generator
from ..models.generators import StyleGANGenerator, stylegan_make_hidden
from . import checkpoint as ckpt
from .ema import copy_params
from .optim import make_optimizer, make_stylegan_gen_optimizer
from .state import TrainState
from .steps import StepSpec, make_rgbd_train_step
from .steps_deepvoxels import DEEPVOXELS_STAGE, make_deepvoxels_train_step

REPORT_KEYS = [
    "iteration",
    "elapsed_time",
    "stage",
    "batch_size",
    "image_size",
    "gen/loss_adv",
    "dis/loss_adv",
    "gen/loss_recon",
    "dis/loss_gp",
    "gen/loss_rotate",
    "gen/loss_occupancy",
]


ARCHITECTURES = ("stylegan", "deepvoxels")


def _check_config(config) -> None:
    deepvoxels = config.generator_architecture == "deepvoxels"
    if deepvoxels and config.r1_interval and int(config.r1_interval) > 1:
        raise ValueError(
            "r1_interval > 1 is not supported by the deepvoxels step "
            "(lazy R1 belongs to the stylegan/dcgan rgbd and rgb paths only)"
        )
    unported = {
        f"generator_architecture {config.generator_architecture}":
            config.generator_architecture not in ARCHITECTURES,
        "background_generator": deepvoxels and bool(config.background_generator),
        "rendernet_projection": deepvoxels and bool(config.rendernet_projection),
        "occlusion_type occlusion_unet": deepvoxels and config.occlusion_type == "occlusion_unet",
        "rgb": bool(config.rgb),
        "sn": bool(config.sn),
        "rotate_feature": bool(config.rotate_feature),
        "rotate_conv_input": bool(config.rotate_conv_input),
        "use_occupancy_net_loss": bool(config.use_occupancy_net_loss),
        "mixed16": bool(config.mixed16),
        "r1_interval > 1": bool(config.r1_interval) and int(config.r1_interval) > 1,
        "use_mpi": bool(config.use_mpi),
        "step_window > 1": bool(config.step_window) and int(config.step_window) > 1,
        "nvprof": bool(config.nvprof) or bool(config.enable_cuda_profiling),
    }
    missing = [k for k, v in unported.items() if v]
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")
    if config.bigan:
        raise NotImplementedError("bigan is not supported (the reference asserts False on it too)")
    if config.optical_flow:
        raise NotImplementedError("optical flow loss is not supported (updater.py:374)")


def setup_generator(config, generator: Optional[torch.Generator] = None, on_cuda: bool = False):
    """The generator and its latent sampler (``train_rgbd.py:220-246``);
    ``on_cuda`` says where it will run (it decides the DeepVoxels lift mode)."""
    if config.generator_architecture == "deepvoxels":
        return build_deepvoxels_generator(config, generator, on_cuda)
    initial_depth = config.initial_depth if config.initial_depth is not None else 1.0
    gen = StyleGANGenerator(
        config.ch, enable_blur=bool(config.enable_blur), rgbd=True,
        initial_depth=initial_depth, generator=generator,
    )
    return gen, (lambda g, n, device="cpu": stylegan_make_hidden(g, n, config.ch, device))


def setup_discriminator(config, generator: Optional[torch.Generator] = None) -> Discriminator:
    return Discriminator(
        ch=config.ch, enable_blur=bool(config.enable_blur), res=bool(config.res_dis),
        generator=generator,
    )


class Trainer:
    """Owns the train state and runs the iteration loop.

    Weights are drawn on the CPU from ``seed`` and then moved to ``device``,
    so the same seed gives the same initial weights on every device. The
    device is the card unless the caller asks for the CPU; without a card a
    ``"cuda"`` device raises.
    """

    def __init__(
        self,
        config,
        dataset: Optional[np.ndarray] = None,
        seed: int = 0,
        device: torch.device | str = "cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device; pass device='cpu' to train on the CPU")
        _check_config(config)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.stage_interval = parse_stage_interval(config.stage_interval)
        self.max_stage = config.max_stage
        self.prior = CameraParamPrior(config)
        self.batch_size = config.batchsize

        init_gen = torch.Generator().manual_seed(seed)
        self.arch = config.generator_architecture
        gen, make_hidden = setup_generator(config, init_gen, self.device.type == "cuda")
        dis = setup_discriminator(config, init_gen)
        gen.to(self.device).requires_grad_(False)
        dis.to(self.device).requires_grad_(False)
        self.make_hidden = lambda g, n: make_hidden(g, n, self.device)

        a_g, a_d = config.adam_alpha_g, config.adam_alpha_d
        b1, b2 = config.adam_beta1, config.adam_beta2
        ema = copy_params(gen) if config.keep_smoothed_gen else None
        self.state = TrainState(
            gen=gen,
            dis=dis,
            opt_map=make_optimizer(gen.mapping.named_parameters(), a_g / 100, b1, b2),
            # deepvoxels: the mapping is also inside the whole-generator
            # optimizer (train_rgbd.py:335-343)
            opt_gen=(
                make_optimizer(gen.named_parameters(), a_g, b1, b2) if self.arch == "deepvoxels"
                else make_stylegan_gen_optimizer(gen.gen.named_parameters(), a_g, b1, b2)
            ),
            opt_dis=make_optimizer(dis.named_parameters(), a_d, b1, b2),
            ema_gen=ema,
        )
        # the train step's draws (latents and poses) come from this stream
        self.rng = torch.Generator(device=self.device).manual_seed(seed)

        if dataset is None:
            dataset = prepare_dataset(config)
        self.iterator = ImageDataset(dataset, self.batch_size, seed=seed)
        self._step_cache: Dict[StepSpec, Callable] = {}
        self.out = config.out or "out"

    # ------------------------------------------------------------------

    def _spec_for(self, iteration: int, stage_floor: int) -> StepSpec:
        c = self.config
        if self.arch == "deepvoxels":
            stage_floor = DEEPVOXELS_STAGE
        return StepSpec(
            stage_floor=stage_floor,
            batch_size=self.batch_size,
            use_rotate=iteration > (c.start_rotation or 0),
            occlusion_aware=iteration >= (c.start_occlusion_aware or 0),
            keep_smoothed_gen=bool(c.keep_smoothed_gen),
            smoothing=c.smoothing if c.smoothing is not None else 0.999,
            lambda_gp=c.lambda_gp if c.lambda_gp is not None else 1.0,
            lambda_depth=c.lambda_depth if c.lambda_depth is not None else 0.0,
            depth_min=c.depth_min if c.depth_min is not None else 0.6,
            lambda_geometric=c.lambda_geometric if c.lambda_geometric else 3.0,
            lambda_rotate=c.lambda_rotate if c.lambda_rotate else 2.0,
            gather_mode=str(c.gather_mode) if c.gather_mode else "xla",
            max_stage=self.max_stage,
        )

    def _step(self, spec: StepSpec) -> Callable:
        if spec not in self._step_cache:
            if self.arch == "deepvoxels":
                gamma = self.config.focal_loss_gamma
                step = make_deepvoxels_train_step(
                    self.make_hidden, self.prior, spec, focal_loss_gamma=gamma if gamma else 0.0
                )
            else:
                step = make_rgbd_train_step(self.make_hidden, self.prior, spec)
            self._step_cache[spec] = step
        return self._step_cache[spec]

    def stage(self, iteration: Optional[int] = None) -> float:
        if self.arch == "deepvoxels":
            return 8.5  # pinned (updater_deepvoxels.py:105-106)
        it = self.state.iteration if iteration is None else iteration
        return stage_at(it, self.stage_interval, self.max_stage)

    # ------------------------------------------------------------------

    def resume(self) -> bool:
        """Explicit or auto resume (``train_rgbd.py:406-459``)."""
        c = self.config
        tag, where = None, self.out
        if c.get_model_from_interation:
            tag = str(c.get_model_from_interation)
        elif c.auto_resume:
            where = c.auto_resume_dir if c.auto_resume_dir else self.out
            tag = ckpt.scan_auto_resume(where, ckpt.model_names(c))
        if tag is None:
            return False
        rng_state = ckpt.load_snapshot(where, self.state, tag, c)
        if rng_state is not None:
            self.rng.set_state(rng_state)
        return True

    def save(self, tag: str) -> None:
        ckpt.save_snapshot(self.out, self.state, self.rng.get_state(), tag, self.config)

    # ------------------------------------------------------------------

    def run(
        self,
        iterations: Optional[int] = None,
        log_cb: Optional[Callable[[Dict[str, Any]], None]] = None,
    ) -> Dict[str, Any]:
        c = self.config
        total = iterations if iterations is not None else c.iteration
        snapshot_interval = c.snapshot_interval or 10000
        display_interval = c.display_interval or 100
        print("preview images are not written: they wait for the eval port")

        start_time = time.time()
        last_log: Dict[str, Any] = {}
        while self.state.iteration < total:
            st = self.stage(self.state.iteration)
            floor, alpha = decompose_stage(st, self.max_stage)
            spec = self._spec_for(self.state.iteration, floor)
            x = torch.from_numpy(self.iterator.next()).to(self.device)
            _, metrics = self._step(spec)(self.state, x, alpha, self.rng)
            it = self.state.iteration
            # the NaN guard fires every iteration (reference asserts,
            # updater.py:336,439); this is the step's one host sync
            if bool(metrics["nan"]):
                raise FloatingPointError(f"NaN loss at iteration {it} (stage {st:.3f})")
            if it % display_interval == 0 or it == total:
                row = {
                    "iteration": it,
                    "elapsed_time": time.time() - start_time,
                    "batch_size": float(self.batch_size),
                }
                row.update({k: float(v) for k, v in metrics.items() if k != "nan"})
                last_log = row
                if log_cb:
                    log_cb(row)
                os.makedirs(self.out, exist_ok=True)
                with open(os.path.join(self.out, "log.jsonl"), "a") as f:
                    f.write(json.dumps(row) + "\n")
            if it % snapshot_interval == 0:
                self.save(str(it))
        self.save("latest")
        return last_log
