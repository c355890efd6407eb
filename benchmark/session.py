"""One run of one cell on one rank: set-up, the checked steps, the window,
the traced sub-window, and the reference once the window has closed.

The window drives the loop body of the program's ``Trainer.run`` one
iteration after another: the stage and the step's spec, the iterator's
next batch moved to the device, the step, and the NaN guard's host sync.
Nothing compiles inside it: set-up has already run the same step call,
on the same shapes, four times.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import correctness, inputs, trace
from .cell import Cell

WARMUP_STEPS = 1  # after the checked steps, the window's own call without injected draws
PROFILED_MIN_STEPS = 2
PROFILED_MIN_S = 1.5


@dataclasses.dataclass
class RankResult:
    """What one rank measured and kept."""

    window_s: float = 0.0
    iterations: int = 0
    first_iteration_wall: float = 0.0  # time.time() when the window's first iteration began
    peak_bytes: int = 0
    capture: Optional[correctness.Capture] = None
    # traced runs only
    iter_ms: List[float] = dataclasses.field(default_factory=list)
    data_ms: List[float] = dataclasses.field(default_factory=list)
    steady_s: float = 0.0  # seconds of the window's iterations outside the profiled sub-window
    steady_iterations: int = 0
    profiled_steps: int = 0
    profiled_s: float = 0.0
    records: List[dict] = dataclasses.field(default_factory=list)
    spans: List[tuple] = dataclasses.field(default_factory=list)
    annotations: Dict[str, int] = dataclasses.field(default_factory=dict)  # device-side copies left out
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)


def build_program(cell: Cell, seed: int, device, images: np.ndarray):
    """The program's trainer for the cell, its weights replaced by the
    benchmark's."""
    from rgbd_gan_tpu_torch.core.config import Config
    from rgbd_gan_tpu_torch.train.trainer import Trainer

    trainer = Trainer(Config(dict(cell.config)), dataset=images, seed=inputs.trainer_seed(seed), device=device)
    weights = correctness.reference_weights(cell, seed, device)
    with torch.no_grad():
        trainer.state.gen.load_state_dict(weights["gen"])
        trainer.state.dis.load_state_dict(weights["dis"])
    return trainer


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    """The loop body of ``Trainer.run``, one iteration a call; ``spans``
    wraps its parts in ``torch.profiler.record_function`` and times them."""

    def __init__(self, trainer, step_hook: Optional[Callable] = None):
        from rgbd_gan_tpu_torch.core.stage import decompose_stage

        self.trainer, self.decompose = trainer, decompose_stage
        self.step_hook = step_hook  # tests plant faults through it: hook(trainer, step, spec) -> step

    def __call__(self, draws: Optional[Dict[str, torch.Tensor]] = None, spans: bool = False):
        t = self.trainer
        mark = torch.profiler.record_function if spans else (lambda name: contextlib.nullcontext())
        t0 = time.perf_counter()
        floor, alpha = self.decompose(t.stage(t.state.iteration), t.max_stage)
        spec = t._spec_for(t.state.iteration, floor)
        tb = time.perf_counter()
        with mark("entry.batch"):
            x = torch.from_numpy(t.iterator.next()).to(t.device)
        t1 = time.perf_counter()
        with mark("entry.step"):
            step = t._step(spec)
            if self.step_hook is not None:
                step = self.step_hook(t, step, spec)
            _, metrics = step(t.state, x, alpha, t.rng, **(draws or {}))
        with mark("entry.nan_sync"):
            if bool(metrics["nan"]):
                raise FloatingPointError(f"NaN loss at iteration {t.state.iteration}")
        t2 = time.perf_counter()
        return x, metrics, (t2 - t0, t1 - tb)


def checked_steps(loop: Loop, cell: Cell, seed: int, rank: int, device) -> correctness.Capture:
    """The first three steps, through the window's call and feed, with the
    seed's draws; what they produced, kept on the host."""
    trainer = loop.trainer
    cap = correctness.Capture()
    modules = {"gen": trainer.state.gen, "dis": trainer.state.dis}
    init = correctness.params_of(modules)
    for i, d in enumerate(inputs.draws(cell, seed, rank, device)):
        x, metrics, _ = loop(d)
        cap.batches.append(x.to("cpu", copy=True))
        cap.losses.append({k: float(metrics[k]) for k in correctness.LOSS_KEYS})
        if i == 0:
            opts = {"map": trainer.state.opt_map, "gen": trainer.state.opt_gen, "dis": trainer.state.opt_dis}
            opts = {k: o for k, o in opts.items() if o is not None}  # a generator without a mapping network has no map
            cap.grad_norms = correctness.grad_norms_of(opts, cell.config["adam_beta1"])
    cap.params = {k: v - init[k] for k, v in correctness.params_of(modules).items()}
    return cap


def window(loop: Loop, seconds: float, device, traced: bool, stop: Callable[[bool], bool] = bool) -> RankResult:
    """Iterate for ``seconds``; ``stop(over)`` decides together with the
    other ranks. A traced window profiles a steady sub-window of whole steps
    from a quarter of the window on."""
    res = RankResult()
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    profiling_done = False
    p_start = 0.0
    res.first_iteration_wall = time.time()
    start = time.perf_counter()
    while True:
        if traced and prof is None and not profiling_done and time.perf_counter() - start >= seconds / 4:
            prof = _profiler(on_cuda)
            prof.__enter__()
            p_start = time.perf_counter()
        _, _, (it_s, data_s) = loop(spans=traced and prof is not None)
        res.iterations += 1
        if traced:
            if prof is not None:
                res.profiled_steps += 1
                if res.profiled_steps >= PROFILED_MIN_STEPS and time.perf_counter() - p_start >= PROFILED_MIN_S:
                    res.profiled_s = time.perf_counter() - p_start
                    prof.__exit__(None, None, None)
                    profiling_done = True
                    events, prof = prof, None
            else:
                res.iter_ms.append(1e3 * it_s)
                res.data_ms.append(1e3 * data_s)
        if stop(time.perf_counter() - start >= seconds):
            break
    res.window_s = time.perf_counter() - start
    if prof is not None:  # the window closed inside the sub-window
        res.profiled_s = time.perf_counter() - p_start
        prof.__exit__(None, None, None)
        events = prof
    if on_cuda:
        res.peak_bytes = torch.cuda.max_memory_allocated(device)
    if traced:
        res.steady_iterations = len(res.iter_ms)
        res.steady_s = sum(res.iter_ms) / 1e3
        if res.profiled_steps:
            res.records, res.spans, res.annotations = trace.device_records(events.profiler.kineto_results.events())
    return res


def warm_profiler(device) -> None:
    """Start and stop the profiler once on a small product, so that its
    tracer's one-time start-up falls into set-up, not into the window."""
    on_cuda = torch.device(device).type == "cuda"
    x = torch.ones(64, 64, device=device)
    with _profiler(on_cuda):
        (x @ x).sum().item()


def _profiler(on_cuda: bool):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    return profile(activities=activities)


def launch_counts() -> Dict[str, int]:
    """The port's kernel launch counters (they count only on the card)."""
    from rgbd_gan_tpu_torch.ops import bilinear, trilinear

    out = {f"bilinear.{k}": v for k, v in bilinear.launches.items()}
    out.update({f"trilinear.{k}": v for k, v in trilinear.launches.items()})
    return {k: v for k, v in out.items() if v}
