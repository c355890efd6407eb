"""The readings that the limits of ``correct`` are set from, at a cell's own
size, on the card (the benchmark's runs never run this):

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 [--control-seeds 1,2,3] [--faults half_batch]

For each seed: the program's readings (its three checked steps against the
reference, as a run compares them), and on the control seeds the control's
(the reference computed in the precision below the one the configuration
states, put in the program's place: TF32 for float32, float8 for bf16) and
each planted fault's (``half_batch``: half of each rank's pairs left out,
the mean over the rest; ``no_exchange``: rank 0's gradients alone, not the
ranks' mean). A state left unchanged reads 1 by construction and needs no
run. One JSON line a seed and kind; ``--out`` also appends them to a file.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import correctness, outcome
from .cell import load_cell

CONTROL_ROUNDING = {"f32": "tf32", "bf16": "fp8"}


def program_runs(cell, seeds):
    """For each seed, the program's checked steps and a window of one
    iteration, as a run makes them (all ranks of a data-parallel cell, in
    one set of rank processes), with the reference's readings."""
    if cell.ranks > 1:
        from .ranks import run_ranks_seeds

        yield from run_ranks_seeds(cell, list(seeds), 0.0, False)
        return
    for seed in seeds:
        yield outcome.run_single(cell, seed, 0.0, False, "cuda")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--faults", default="")
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    device = "cuda"
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    faults = [f for f in args.faults.split(",") if f]

    def emit(record):
        line = json.dumps(record)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    seeds = [int(s) for s in args.seeds.split(",")]
    t0 = time.time()
    for seed, run in zip(seeds, program_runs(cell, seeds)):
        emit({"workload": cell.workload, "seed": seed, "kind": "program",
              "readings": run["compared"], "worst_grad_leaves": run["worst_grad_leaves"],
              "worst_change_leaves": run["worst_change_leaves"], "seconds": time.time() - t0})
        if seed not in control_seeds:
            continue
        reference = correctness.run_reference(cell, seed, run["batches"], device)
        bad = int(run["compared"]["feed_bad_rows"])
        kinds = [("control", CONTROL_ROUNDING[cell.precision], None)] + [(f"fault.{f}", None, f) for f in faults]
        for kind, rounding, fault in kinds:
            planted = correctness.run_reference(cell, seed, run["batches"], device, rounding=rounding, fault=fault)
            emit({"workload": cell.workload, "seed": seed, "kind": kind,
                  "readings": correctness.readings(planted, reference, bad),
                  "losses": planted.losses, "worst_grad_leaves": correctness.worst_leaves(planted.grad_norms, reference.grad_norms)})
        del reference
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
