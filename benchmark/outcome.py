"""A run of a one-rank cell, and what the readers and the result line read
from a run.

``run_single`` does set-up, the window and the reference in one process;
``TraceRun`` is what every per-layer reader gets from a traced run.
"""

from __future__ import annotations

import dataclasses
import gc
import subprocess
from typing import Any, Callable, Dict, List, Optional

import torch

from . import bounds, correctness, inputs, session, trace
from .cell import Cell


@dataclasses.dataclass
class TraceRun:
    """A traced run as the per-layer readers see it (rank 0's, with the
    device's busy seconds averaged over the ranks)."""

    cell: Cell
    flops_per_step: float
    peak_flops: float  # of the precision the cell states, over every card it uses
    steady_iterations: int
    steady_s: float
    iter_ms: List[float]
    data_ms: List[float]
    profiled_steps: int
    profiled_s: float
    records: List[dict]
    spans: List[tuple]
    busy_s: float

    def layer_ms_per_step(self, layer: str) -> Optional[float]:
        """Device ms a step in ``layer``, over the profiled steps; None when
        nothing of the layer ran."""
        if not self.profiled_steps or not any(r["layer"] == layer for r in self.records):
            return None
        return 1e3 * trace.layer_seconds(self.records)[layer] / self.profiled_steps


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def device_info(device, count: int, peak_bytes: int) -> Dict[str, Any]:
    dev = torch.device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind, "count": count,
            "memory_peak_bytes": int(peak_bytes), "power_limit": power_limit() if dev.type == "cuda" else None}


def measure(cell: Cell, seed: int, seconds: float, traced: bool, device, rank: int = 0,
            stop: Callable[[bool], bool] = bool, step_hook: Optional[Callable] = None,
            barrier: Optional[Callable[[], None]] = None):
    """Set-up, the checked steps and the window on one rank (``barrier``
    lines the ranks up before it); the program's state is freed before it
    returns. Returns the rank's result and the image set."""
    images = inputs.images(cell, seed)
    trainer = session.build_program(cell, seed, device, images)
    loop = session.Loop(trainer, step_hook)
    capture = session.checked_steps(loop, cell, seed, rank, device)
    for _ in range(session.WARMUP_STEPS):
        loop()
    if traced:
        session.warm_profiler(device)
    session.sync(device)
    if barrier is not None:
        barrier()
    res = session.window(loop, seconds, device, traced, stop)
    res.capture = capture
    if torch.device(device).type == "cuda":
        res.launches = session.launch_counts()
    del loop, trainer
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return res, images


def trace_run(cell: Cell, res: session.RankResult, busy_s: float) -> TraceRun:
    return TraceRun(
        cell=cell, flops_per_step=float(cell.flops_per_step),
        peak_flops=bounds.PEAK_FLOPS[cell.precision] * cell.ranks,
        steady_iterations=res.steady_iterations, steady_s=res.steady_s, iter_ms=res.iter_ms, data_ms=res.data_ms,
        profiled_steps=res.profiled_steps, profiled_s=res.profiled_s, records=res.records, spans=res.spans,
        busy_s=busy_s)


def finish(cell: Cell, seed: int, device, lead: session.RankResult, images, traced: bool, *,
           batches: Optional[List[list]] = None, peaks: Optional[List[int]] = None,
           busy: Optional[List[float]] = None) -> Dict[str, Any]:
    """The reference after the window, and everything the result line
    needs, from rank 0's result and every rank's fed batches, peak memory
    and device busy seconds (by default rank 0's alone)."""
    batches = batches or [lead.capture.batches]
    reference = correctness.run_reference(cell, seed, batches, device)
    bad = correctness.feed_bad_rows([b for rank in batches for b in rank], images)
    values = correctness.readings(lead.capture, reference, bad)
    peak = max(peaks or [lead.peak_bytes])
    out = {"iterations": lead.iterations, "window_s": lead.window_s, "compared": values, "batches": batches,
           "worst_grad_leaves": correctness.worst_leaves(lead.capture.grad_norms, reference.grad_norms),
           "worst_change_leaves": correctness.worst_leaves(*correctness.change_norms(lead.capture, reference)),
           "first_iteration_wall": lead.first_iteration_wall, "peak_bytes": peak, "batch": cell.batch,
           "device": device_info(device, cell.ranks, peak), "launches": lead.launches}
    if traced:
        busy = busy or [trace.busy_seconds(lead.records)]
        run = trace_run(cell, lead, sum(busy) / len(busy))
        out["trace"] = run
        if lead.profiled_steps:
            out["device"]["busy_s"] = run.busy_s
            out["device"]["window_s"] = lead.profiled_s
            out["breakdown"] = trace.breakdown(lead.records, lead.spans)
            out["annotations_left_out"] = lead.annotations
    return out


def run_single(cell: Cell, seed: int, seconds: float, traced: bool, device,
               step_hook: Optional[Callable] = None) -> Dict[str, Any]:
    res, images = measure(cell, seed, seconds, traced, device, step_hook=step_hook)
    return finish(cell, seed, device, res, images, traced)


def end_to_end(name: str, result: Dict[str, Any]) -> float:
    """An end-to-end metric of an untraced run."""
    if name == "img_per_s":
        return result["batch"] * result["iterations"] / result["window_s"]
    if name == "peak_gib":
        return result["peak_bytes"] / 2**30
    if name == "setup_s":
        return result["setup_s"]
    raise KeyError(f"no end-to-end metric {name!r}")
