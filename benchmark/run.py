"""The benchmark of ``rgbd_gan_tpu_torch``: one cell, one run.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix, found by name under
``benchmark/configs/`` and ``benchmark/traffic/``. A run:

1. set-up (``setup_s``, from the process's start to the window's first
   iteration): imports, the kernels' build (the program's ``nvcc`` builds
   land in ``build/`` inside the checkout, so only the first run of a
   checkout compiles), the image set and the weights from the seed, the
   program's ``Trainer`` on the card, three checked steps with injected
   draws and one more of the window's own call
2. the window: ``--seconds`` of the ``Trainer.run`` loop body on the same
   training state; ``img_per_s`` is the global batch times the finished
   iterations over the window's wall time, ``peak_gib`` the card's (the
   fullest card's) peak allocation in it
3. with ``--trace 1``, the same window with the benchmark's host spans on
   every iteration and ``torch.profiler`` over a steady sub-window of whole
   steps; the per-layer metrics are read from them by the readers in
   ``benchmark/metrics/``
4. once the window has closed and the program's state is freed, the plain
   reference (``benchmark/reference/``) follows the checked steps, and the
   numbers compared decide ``correct`` (``benchmark/correctness.py``)

The last line of standard output is one JSON object; the compared numbers
and their limits are also the last lines of standard error. Without a CUDA
card, or with fewer cards than the cell asks for, it prints no result and
exits 2. A data-parallel cell runs one process a card (``benchmark/ranks.py``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "rgbd_gan_tpu")


def process_start_wall() -> float:
    """The wall-clock time at which this process started (from the kernel's
    record of it, so interpreter start-up counts)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORT_WALL


_IMPORT_WALL = time.time()
PROCESS_START = process_start_wall()


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared as whole names."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in list(modules)} & set(FORBIDDEN))


def fixed_cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "torch_extensions"))


def per_layer_readers(workload: str, bench: Dict[str, Any]) -> Dict[str, Any]:
    """The cell's per-layer metrics: name -> (entry, reader module)."""
    here = Path(__file__).resolve().parent
    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{len(out)}", here / "metrics" / f"{m['name']}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        out[m["name"]] = (m, module)
    return out


def end_to_end_entries(workload: str, bench: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="one run of one cell of the benchmark")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from .cell import ROOT, benchmark_json, load_cell

    bench = benchmark_json()
    cell = load_cell(args.workload)
    try:
        import torch
    except ImportError as e:
        print(f"benchmark: PyTorch is missing ({e}); nothing measured", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s), this machine has {have}; nothing measured",
              file=sys.stderr)
        return 2
    fixed_cache_dirs(ROOT)
    if cell.ranks > 1:
        from .ranks import run_ranks

        result = run_ranks(cell, args.seed, args.seconds, bool(args.trace))
    else:
        from .outcome import run_single

        result = run_single(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    return report(cell, bench, result, bool(args.trace))


def report(cell, bench: Dict[str, Any], result: Dict[str, Any], traced: bool) -> int:
    """Print the result line (and the compared numbers last on standard
    error); refuse to print one if a forbidden module was loaded."""
    from . import correctness, outcome

    found = sorted(set(forbidden_modules()) | set(result.get("forbidden", [])))
    if found:
        print(f"benchmark: forbidden modules loaded: {', '.join(found)}; no result", file=sys.stderr)
        return 3
    result["setup_s"] = result["first_iteration_wall"] - PROCESS_START
    if traced:
        metrics = {}
        for name, (entry, reader) in per_layer_readers(cell.workload, bench).items():
            value = reader.read(result["trace"])
            if value is not None:
                metrics[name] = {"value": value, "unit": entry["unit"]}
    else:
        metrics = {}
        for entry in end_to_end_entries(cell.workload, bench):
            metrics[entry["name"]] = {"value": outcome.end_to_end(entry["name"], result), "unit": entry["unit"]}
    values, limits = result["compared"], cell.limits
    correct = correctness.judge(values, limits)
    diag = {}
    run_trace = result.get("trace")
    if traced and run_trace.profiled_steps and run_trace.steady_iterations:
        # how far the profiler slows the host: the profiled steps' wall time against the others'
        diag["ms_per_step"] = {"profiled": 1e3 * run_trace.profiled_s / run_trace.profiled_steps,
                               "unprofiled": 1e3 * run_trace.steady_s / run_trace.steady_iterations,
                               "device_busy": 1e3 * run_trace.busy_s / run_trace.profiled_steps}
        diag["annotations_left_out"] = result.get("annotations_left_out", {})
    print(json.dumps({**diag, "launches": result.get("launches", {}), "readings": values,
                      "worst_grad_leaves": result.get("worst_grad_leaves"),
                      "worst_change_leaves": result.get("worst_change_leaves"),
                      "window_s": result["window_s"], "iterations": result["iterations"],
                      "power_limit": result["device"].get("power_limit")}), file=sys.stderr)
    line = {"correct": correct, "attempted": result["iterations"], "failed": 0, "metrics": metrics,
            "device": {k: v for k, v in result["device"].items() if k != "power_limit"}}
    if traced and result.get("breakdown"):
        line["breakdown"] = result["breakdown"]
    line["compared"] = {k: {"value": values[k], "limit": limit} for k, limit in limits.items()}
    for text in correctness.compared_lines(values, limits):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
