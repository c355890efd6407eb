"""Training loop for the StyleGAN, DCGAN and DeepVoxels RGBD paths and the
StyleGAN and DCGAN RGB paths: builds models, optimizers and the step from a
config and runs the iteration loop.

Port of :mod:`rgbd_gan_tpu.train.trainer` without its step windows
(reference ``train_rgbd.py:261-474``): model and optimizer
wiring (mapping at alpha/100 in its own clipping domain; for StyleGAN
``l1``/``l2`` at alpha/100 inside the synthesis domain, for DeepVoxels one
optimizer over the whole generator, mapping included; DCGAN has no mapping
and one optimizer over the whole generator), the piecewise-linear stage
schedule (DeepVoxels is pinned at stage 8.5, 64 px), the per-iteration NaN
guard, the reference's report keys, ``log.jsonl``, preview grids of the
live and the smoothed generator every ``evaluation_sample_interval``
iterations, snapshots and resume. Float32 stays float32: TF32 is switched
off for matmuls and convs. ``mixed16: True`` runs the generator's and the
discriminator's trunks in bf16 (parameters, gradients, Adam state and EMA
stay float32), with bf16 products accumulated in float32;
``r1_interval: k`` takes the 2D step's R1 penalty every k-th step at weight
``lambda_gp * k``.

``step_window: k`` is accepted and ignored: the JAX package chains k steps
in one compiled scan whose arithmetic is that of k plain steps, and the
port runs those k plain steps, on the same stream of draws, with a report
row and the NaN guard after each.

Every single-chip option of the JAX trainer's step spec is on these paths:
spectral norm (``sn``), ``rotate_feature``, ``rotate_conv_input``,
``use_occupancy_net_loss`` and, of DeepVoxels, ``background_generator`` and
``rendernet_projection``. ``rgb: True`` trains an RGB generator (no camera
conditioning, a 3-channel head) with the RGB step (no 3D loss; the
DeepVoxels step takes precedence, as in the JAX trainer), and its previews
have no pose sweep. ``nvprof: True`` (or ``enable_cuda_profiling``) caps the
run at 10 iterations and records them with ``torch.profiler`` into
``[out]/profile/``, the twin of the JAX trainer's ``jax.profiler`` trace,
with the port's spans and counters (:mod:`..utils.trace`) in ``spans.json``.
:meth:`Trainer.iterate` is one iteration of the loop.
``use_mpi: True`` trains data-parallel when the process group (see
:func:`..parallel.mesh.maybe_initialize_distributed`) holds more than one
rank: each rank takes ``batchsize / world`` images (an even number: the
steps draw their latents in pairs) from its own shard of the dataset and
draws from its own stream, and the steps average the
gradients, the metrics and the BatchNorm statistics over the ranks. Every
rank starts from rank 0's weights, reads a snapshot on resume and runs the
EMA; only rank 0 writes ``log.jsonl``, the previews, the snapshots and the
``nvprof`` trace. With one rank it is the plain path, unchanged.

Refused: lazy R1 on the DeepVoxels step (as in the JAX package),
``occlusion_type: occlusion_unet`` (the JAX package cannot build it), the
eval-mode forward of a background generator (the JAX package's raises),
``bigan`` and ``optical_flow`` (the reference's raise too).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import traceback
import warnings
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..core.stage import decompose_stage, parse_stage_interval, stage_at
from ..data.dataset import ImageDataset, prepare_dataset
from ..eval.preview import sample_generate_light
from ..geometry.prior import CameraParamPrior
from ..models.discriminator import Discriminator
from ..models.deepvoxels import OCCLUSION_UNET_FAULT, build_deepvoxels_generator
from ..models.generators import DCGANGenerator, StyleGANGenerator, dcgan_make_hidden, stylegan_make_hidden
from ..parallel.mesh import DATA_AXIS, all_gather_bytes, is_master, make_mesh, rank, rank_seed, replicate, world_size
from ..utils import trace
from . import checkpoint as ckpt
from .ema import copy_params
from .optim import make_optimizer, make_stylegan_gen_optimizer
from .state import TrainState
from .steps import StepSpec, make_rgb_train_step, make_rgbd_train_step
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


ARCHITECTURES = ("stylegan", "dcgan", "deepvoxels")
# Why a background generator has no eval-mode forward: the JAX reference has none that runs.
BACKGROUND_EVAL_FAULT = (
    "the eval-mode forward of a DeepVoxels generator with background_generator is not ported: the JAX "
    "package's Trainer.gen_apply_eval passes no z3/z4 (rgbd_gan_tpu/train/trainer.py:392-394), so its "
    "forward raises AttributeError at z3.reshape (rgbd_gan_tpu/models/deepvoxels.py:780)"
)
PROFILED_ITERATIONS = 10  # the nvprof run's length (train_rgbd.py:363-364)


def _check_config(config) -> None:
    deepvoxels = config.generator_architecture == "deepvoxels"
    if deepvoxels and config.r1_interval and int(config.r1_interval) > 1:
        raise ValueError(
            "r1_interval > 1 is not supported by the deepvoxels step "
            "(lazy R1 belongs to the stylegan/dcgan rgbd and rgb paths only)"
        )
    if deepvoxels and not config.rendernet_projection and config.occlusion_type == "occlusion_unet":
        raise NotImplementedError(OCCLUSION_UNET_FAULT)
    if config.generator_architecture not in ARCHITECTURES:
        raise NotImplementedError(f"not ported yet: generator_architecture {config.generator_architecture}")
    if config.bigan:
        raise NotImplementedError("bigan is not supported (the reference asserts False on it too)")
    if config.optical_flow:
        raise NotImplementedError("optical flow loss is not supported (updater.py:374)")


def _compute_dtype(config) -> Optional[torch.dtype]:
    """The trunks' dtype: bf16 for ``mixed16: True`` (``train_rgbd.py``'s
    mixed16 global dtype), else float32."""
    return torch.bfloat16 if config.mixed16 else None


def setup_generator(config, generator: Optional[torch.Generator] = None, on_cuda: bool = False):
    """The generator and its latent sampler (``train_rgbd.py:220-246``);
    ``on_cuda`` says where it will run (it decides the DeepVoxels lift mode)."""
    if config.generator_architecture == "deepvoxels":
        return build_deepvoxels_generator(config, generator, on_cuda)
    initial_depth = config.initial_depth if config.initial_depth is not None else 1.0
    rgbd = not config.rgb
    if config.generator_architecture == "dcgan":
        gen = DCGANGenerator(
            in_ch=config.ch,  # quirk: the hidden width stays the default 512
            enable_blur=bool(config.enable_blur), rgbd=rgbd,
            use_occupancy_net=bool(config.use_occupancy_net_loss), initial_depth=initial_depth,
            compute_dtype=_compute_dtype(config), generator=generator,
        )
        return gen, (lambda g, n, device="cpu": dcgan_make_hidden(g, n, config.ch, device))
    gen = StyleGANGenerator(
        config.ch, enable_blur=bool(config.enable_blur), rgbd=rgbd,
        rotate_conv_input=bool(config.rotate_conv_input), use_occupancy_net=bool(config.use_occupancy_net_loss),
        initial_depth=initial_depth, compute_dtype=_compute_dtype(config), generator=generator,
    )
    return gen, (lambda g, n, device="cpu": stylegan_make_hidden(g, n, config.ch, device))


def setup_discriminator(config, generator: Optional[torch.Generator] = None) -> Discriminator:
    return Discriminator(
        ch=config.ch, enable_blur=bool(config.enable_blur), sn=bool(config.sn), res=bool(config.res_dis),
        compute_dtype=_compute_dtype(config), generator=generator,
    )


class Trainer:
    """Owns the train state and runs the iteration loop.

    Weights are drawn on the CPU from ``seed`` and then moved to ``device``,
    so the same seed gives the same initial weights on every device. The
    device is the card unless the caller asks for the CPU; without a card a
    ``"cuda"`` device raises, and so does the index of a card that is not
    there. Under data parallelism rank r's stream of draws is seeded from
    ``(seed, r)`` (:func:`..parallel.mesh.rank_seed`); with one rank from
    ``seed``.
    """

    def __init__(
        self,
        config,
        dataset: Optional[np.ndarray] = None,
        seed: int = 0,
        device: torch.device | str = "cuda",
    ):
        with trace.setup_span("setup.trainer"):
            self.device = torch.device(device)
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("Trainer: no CUDA device; pass device='cpu' to train on the CPU")
            if self.device.type == "cuda" and (self.device.index or 0) >= torch.cuda.device_count():
                raise RuntimeError(f"Trainer: no {self.device}; this machine has {torch.cuda.device_count()} card(s)")
            _check_config(config)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            # bf16 products are summed in float32, as in the JAX package
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
            self.config = config
            self.stage_interval = parse_stage_interval(config.stage_interval)
            self.max_stage = config.max_stage
            self.prior = CameraParamPrior(config)
            self.batch_size = config.batchsize  # global: over every rank
            self.world, self.rank = world_size(), rank()
            self.use_mesh = bool(config.use_mpi) and self.world > 1
            self.local_batch = self.batch_size  # per rank
            if self.use_mesh:
                if self.batch_size % (2 * self.world):
                    # the steps draw their latents in pairs: an odd batch a rank breaks them
                    raise ValueError(f"batchsize {self.batch_size} does not split into an even batch for each of "
                                     f"{self.world} ranks")
                self.local_batch = self.batch_size // self.world
            self.mesh = make_mesh(self.device.type) if self.use_mesh else None

            init_gen = torch.Generator().manual_seed(seed)
            self.arch = config.generator_architecture
            self.rgb = bool(config.rgb)
            gen, make_hidden = setup_generator(config, init_gen, self.device.type == "cuda")
            dis = setup_discriminator(config, init_gen)
            gen.to(self.device).requires_grad_(False)
            dis.to(self.device).requires_grad_(False)
            self.make_hidden = lambda g, n: make_hidden(g, n, self.device)

            a_g, a_d = config.adam_alpha_g, config.adam_alpha_d
            b1, b2 = config.adam_beta1, config.adam_beta2
            ema = copy_params(gen) if config.keep_smoothed_gen else None
            if self.arch == "stylegan":
                opt_gen = make_stylegan_gen_optimizer(gen.gen.named_parameters(), a_g, b1, b2, rgbd=not self.rgb)
            else:
                # dcgan: the whole generator; deepvoxels: the mapping is also
                # inside the whole-generator optimizer (train_rgbd.py:335-343)
                opt_gen = make_optimizer(gen.named_parameters(), a_g, b1, b2)
            self.state = TrainState(
                gen=gen,
                dis=dis,
                opt_map=(None if self.arch == "dcgan"
                         else make_optimizer(gen.mapping.named_parameters(), a_g / 100, b1, b2)),
                opt_gen=opt_gen,
                opt_dis=make_optimizer(dis.named_parameters(), a_d, b1, b2),
                ema_gen=ema,
            )
            # the train step's draws (latents and poses) come from this stream
            self.rng = torch.Generator(device=self.device).manual_seed(
                rank_seed(seed, self.rank, self.world) if self.use_mesh else seed)
            if self.use_mesh:
                replicate(self._modules())

            if dataset is None:
                dataset = prepare_dataset(config)
            shard, shards = (self.rank, self.world) if self.use_mesh else (0, 1)
            self.iterator = ImageDataset(dataset, self.local_batch, seed=seed, shard_index=shard, num_shards=shards)
            self._step_cache: Dict[StepSpec, Callable] = {}
            self._preview_warned = False
            self.out = config.out or "out"

    # ------------------------------------------------------------------

    def _spec_for(self, iteration: int, stage_floor: int) -> StepSpec:
        c = self.config
        if self.arch == "deepvoxels":
            stage_floor = DEEPVOXELS_STAGE
        return StepSpec(
            stage_floor=stage_floor,
            batch_size=self.local_batch,
            # the 2D step's generator (the DeepVoxels step reads none)
            architecture="dcgan" if self.arch == "dcgan" else "stylegan",
            use_rotate=not self.rgb and iteration > (c.start_rotation or 0),
            occlusion_aware=iteration >= (c.start_occlusion_aware or 0),
            rotate_feature=bool(c.rotate_feature),
            use_occupancy=bool(c.use_occupancy_net_loss),
            lambda_occupancy=c.lambda_occupancy if c.lambda_occupancy else 1.0,
            sn=bool(c.sn),
            keep_smoothed_gen=bool(c.keep_smoothed_gen),
            smoothing=c.smoothing if c.smoothing is not None else 0.999,
            lambda_gp=c.lambda_gp if c.lambda_gp is not None else 1.0,
            lambda_depth=c.lambda_depth if c.lambda_depth is not None else 0.0,
            depth_min=c.depth_min if c.depth_min is not None else 0.6,
            lambda_geometric=c.lambda_geometric if c.lambda_geometric else 3.0,
            lambda_rotate=c.lambda_rotate if c.lambda_rotate else 2.0,
            gather_mode=str(c.gather_mode) if c.gather_mode else "xla",
            max_stage=self.max_stage,
            r1_interval=int(c.r1_interval) if c.r1_interval else 1,
            axis_name=DATA_AXIS if self.use_mesh else None,
        )

    def _step(self, spec: StepSpec) -> Callable:
        if spec not in self._step_cache:
            if self.arch == "deepvoxels":
                gamma = self.config.focal_loss_gamma
                step = make_deepvoxels_train_step(
                    self.make_hidden, self.prior, spec, focal_loss_gamma=gamma if gamma else 0.0,
                    background_generator=bool(self.config.background_generator),
                )
            elif self.rgb:
                step = make_rgb_train_step(self.make_hidden, spec)
            else:
                step = make_rgbd_train_step(self.make_hidden, self.prior, spec)
            self._step_cache[spec] = self._first_call_in_setup_span(spec, step)
        return self._step_cache[spec]

    def _first_call_in_setup_span(self, spec: StepSpec, step: Callable) -> Callable:
        """``step``, its first call timed in a ``setup.first_step`` span (on
        the host, enqueue only: cuDNN's heuristics, lazy loads); later calls
        get ``step`` itself."""

        def first_call(*args, **kwargs):
            self._step_cache[spec] = step
            with trace.setup_span("setup.first_step"):
                return step(*args, **kwargs)

        return first_call

    def stage(self, iteration: Optional[int] = None) -> float:
        if self.arch == "deepvoxels":
            return 8.5  # pinned (updater_deepvoxels.py:105-106)
        it = self.state.iteration if iteration is None else iteration
        return stage_at(it, self.stage_interval, self.max_stage)

    @torch.no_grad()
    def gen_apply_eval(self, z, stage_floor, alpha, theta9, mats=None, *, use_ema=False, z2=None):
        """Eval-mode generator forward (``train=False``), without gradients.

        ``use_ema`` renders from the smoothed generator, the model the
        reference previews when ``keep_smoothed_gen`` (``train_rgbd.py:391-396``).
        DeepVoxels runs its BatchNorm on the running statistics (of the live
        generator, also for the smoothed one, as in the JAX package) and
        takes the second style latent ``z2``; by default it is the JAX
        package's fixed draw: ``RandomState(1)`` tiled over 8 columns like
        the preview's z, or one draw per sample for a batch that is not a
        grid of 8 columns (``train_rgbd.py:70-71``). A DeepVoxels generator
        with a background generator raises ``NotImplementedError``: the JAX
        package's eval forward passes it no background latents and fails.
        An RGB generator takes ``theta9=None``.
        """
        if getattr(self.state.gen, "background_generator", False):
            raise NotImplementedError(BACKGROUND_EVAL_FAULT)
        gen = self.state.gen
        if use_ema:
            if self.state.ema_gen is None:
                raise ValueError("use_ema requires keep_smoothed_gen (no EMA parameters in the state)")
            gen = self.state.ema_gen
            for mine, live in zip(gen.buffers(), self.state.gen.buffers()):
                mine.copy_(live)
        z = torch.as_tensor(z, device=self.device)
        theta9 = None if theta9 is None else torch.as_tensor(theta9, device=self.device)
        if self.arch != "deepvoxels":
            return gen(z, stage_floor, float(alpha), theta9, train=False)
        if z2 is None:
            rng, cols = np.random.RandomState(1), 8
            rows = z.shape[0] // cols
            if rows * cols == z.shape[0]:
                z2 = np.tile(self.make_hidden_np(rng, cols)[:, None], (1, rows, 1)).reshape(z.shape[0], -1)
            else:
                z2 = self.make_hidden_np(rng, z.shape[0])
        z2 = torch.as_tensor(z2, device=self.device)
        return gen(z, torch.as_tensor(mats, device=self.device), z2, theta9, train=False)

    def gen_apply_eval_ema(self, z, stage_floor, alpha, theta9, mats=None, *, z2=None):
        """The smoothed generator's eval forward (see :meth:`gen_apply_eval`)."""
        return self.gen_apply_eval(z, stage_floor, alpha, theta9, mats, use_ema=True, z2=z2)

    def make_hidden_np(self, rng: np.random.RandomState, n: int) -> np.ndarray:
        """Host-side latents from a ``RandomState``, for fixed-seed previews."""
        ch = self.config.ch
        if self.arch == "deepvoxels":
            return rng.normal(size=(n, ch)).astype("float32")
        z = rng.normal(size=(n, ch * 2 if self.arch == "stylegan" else ch)).astype("float32")
        return z / np.sqrt((z**2).sum(axis=1, keepdims=True) / ch + 1e-8)

    def _preview(self, previews, iteration: int) -> None:
        """Render the preview grids; a failure warns once and training goes on."""
        try:
            for preview in previews:
                preview(iteration, self.stage(iteration))
        except Exception:
            # best-effort, but never silently: a broken preview path should
            # not go unnoticed for a whole run
            if not self._preview_warned:
                self._preview_warned = True
                warnings.warn(
                    "preview rendering failed (training continues; further failures suppressed):\n"
                    + traceback.format_exc()
                )

    # ------------------------------------------------------------------

    def _modules(self):
        return self.state.gen, self.state.dis, self.state.ema_gen

    def resume(self) -> bool:
        """Explicit or auto resume (``train_rgbd.py:406-459``): every rank
        reads the snapshot and takes back its own stream."""
        c = self.config
        tag, where = None, self.out
        if c.get_model_from_interation:
            tag = str(c.get_model_from_interation)
        elif c.auto_resume:
            where = c.auto_resume_dir if c.auto_resume_dir else self.out
            tag = ckpt.scan_auto_resume(where, ckpt.model_names(c))
        if tag is None:
            return False
        rng_state = ckpt.load_snapshot(where, self.state, tag, c, rank=self.rank if self.use_mesh else 0)
        if rng_state is not None:
            self.rng.set_state(rng_state)
        if self.use_mesh:
            replicate(self._modules())
        return True

    def save(self, tag: str) -> None:
        """Write the snapshot from rank 0, with every rank's stream under data
        parallelism (each rank must call it)."""
        streams = all_gather_bytes(self.rng.get_state(), self.device) if self.use_mesh else []
        if is_master():
            ckpt.save_snapshot(self.out, self.state, self.rng.get_state(), tag, self.config, streams)

    @contextlib.contextmanager
    def _profiled(self) -> Iterator[None]:
        """Record the block with ``torch.profiler`` (the CPU, and the card's
        kernels on a CUDA device) and write its Chrome trace to
        ``[out]/profile/trace.json`` and the port's spans and counters
        (:func:`..utils.trace.summary`: calls and host ms by span, on the
        card also device ms, syncs and the kernels' launches per step) to
        ``[out]/profile/spans.json``. A profiler that records nothing (no
        event; on the card, no kernel) raises instead of leaving the run
        unprofiled."""
        from torch.profiler import ProfilerActivity, profile

        on_cuda = self.device.type == "cuda"
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
        trace.reset()  # spans.json holds the block's spans alone
        with profile(activities=activities) as prof:
            yield
        events = prof.profiler.kineto_results.events()  # the raw records: prof.events() builds a tree, slowly
        if not events or (on_cuda and not any(e.device_type() == torch.autograd.DeviceType.CUDA for e in events)):
            raise RuntimeError("nvprof: torch.profiler recorded no " + ("CUDA kernel" if on_cuda else "event"))
        os.makedirs(os.path.join(self.out, "profile"), exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.out, "profile", "trace.json"))
        with open(os.path.join(self.out, "profile", "spans.json"), "w") as f:
            json.dump(trace.summary(), f, indent=1)
        trace.reset()

    # ------------------------------------------------------------------

    def iterate(self) -> Dict[str, torch.Tensor]:
        """One iteration of the loop: the stage and the step's spec, the
        iterator's next batch moved to the device, the step, and the NaN
        guard; returns the step's metrics (0-dim tensors on the device)."""
        it = self.state.iteration
        st = self.stage(it)
        floor, alpha = decompose_stage(st, self.max_stage)
        spec = self._spec_for(it, floor)
        with trace.span("train.batch", step=it):
            x = torch.from_numpy(self.iterator.next()).to(self.device)
        with trace.span("train.step"):
            _, metrics = self._step(spec)(self.state, x, alpha, self.rng)
        # the NaN guard fires every iteration (reference asserts,
        # updater.py:336,439): a host sync, besides those in the step
        with trace.span("train.nan_sync"):
            if bool(metrics["nan"]):
                raise FloatingPointError(f"NaN loss at iteration {self.state.iteration} (stage {st:.3f})")
        return metrics

    def run(
        self,
        iterations: Optional[int] = None,
        log_cb: Optional[Callable[[Dict[str, Any]], None]] = None,
    ) -> Dict[str, Any]:
        c = self.config
        total = iterations if iterations is not None else c.iteration
        profiling = bool(c.nvprof or c.enable_cuda_profiling)
        if profiling:
            total = PROFILED_ITERATIONS
        snapshot_interval = c.snapshot_interval or 10000
        display_interval = c.display_interval or 100
        preview_interval = c.evaluation_sample_interval or 500
        previews = [sample_generate_light(self.gen_apply_eval, self.make_hidden_np, self.out, c)]
        if c.keep_smoothed_gen:
            # the smoothed generator into its own directory (train_rgbd.py:391-396)
            previews.append(sample_generate_light(
                self.gen_apply_eval_ema, self.make_hidden_np, self.out, c, subdir="preview_smoothed"))

        start_time = time.time()
        last_log: Dict[str, Any] = {}
        with self._profiled() if profiling and is_master() else contextlib.nullcontext():
            while self.state.iteration < total:
                metrics = self.iterate()
                it = self.state.iteration
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
                    if is_master():
                        os.makedirs(self.out, exist_ok=True)
                        with open(os.path.join(self.out, "log.jsonl"), "a") as f:
                            f.write(json.dumps(row) + "\n")
                if it % preview_interval == 0 and is_master():
                    self._preview(previews, it)
                if it % snapshot_interval == 0:
                    self.save(str(it))
        self.save("latest")
        return last_log
