"""A data-parallel cell: one process a card, started by the benchmark.

Each rank joins a process group (NCCL on the cards, gloo on the CPU, at
``tcp://localhost:<free port>``), builds the program's trainer with
``use_mpi`` on its own card, runs the checked steps with its own draws,
waits for the others at a barrier, and runs the window; the ranks stop
together (each step ends with a MAX all-reduce of "the window is over",
under the span ``entry.stop``, which the trace leaves out of the layers).
Rank 0 then gathers every rank's fed batches, peak memory and device busy
time, runs the reference (the mean of the per-rank gradients) and hands
the result to the parent, which prints it. The parent imports nothing of
the program.
"""

from __future__ import annotations

import multiprocessing
import queue as queue_module
import socket
import traceback
from typing import Any, Dict, List

from .cell import Cell

JOIN_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_main(rank: int, world: int, port: int, cell: Cell, seeds, seconds: float, traced: bool,
              device_type: str, queue, step_hook=None) -> None:
    try:
        queue.put((rank, _rank(rank, world, port, cell, seeds, seconds, traced, device_type, step_hook)))
    except Exception:  # the parent reports it and exits without a result
        queue.put((rank, {"error": traceback.format_exc()}))


def _rank(rank, world, port, cell, seeds, seconds, traced, device_type, step_hook) -> List[Dict[str, Any]]:
    import torch
    import torch.distributed as dist

    from . import outcome, trace
    from .run import forbidden_modules

    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        def stop(over: bool) -> bool:
            # its own span: the trace leaves this wait for the slowest rank out of the program's layers
            with torch.profiler.record_function(trace.HARNESS_SPAN):
                flag = torch.tensor([1.0 if over else 0.0], device=device)
                dist.all_reduce(flag, op=dist.ReduceOp.MAX)
                return bool(flag.item() > 0)

        outs = []
        for seed in seeds:
            res, images = outcome.measure(cell, seed, seconds, traced, device, rank=rank, stop=stop,
                                          barrier=dist.barrier, step_hook=step_hook)
            mine = {"batches": res.capture.batches, "peak": res.peak_bytes, "first": res.first_iteration_wall,
                    "busy": trace.busy_seconds(res.records), "forbidden": forbidden_modules()}
            every = [None] * world
            dist.all_gather_object(every, mine)
            out: Dict[str, Any] = {"forbidden": sorted({m for e in every for m in e["forbidden"]})}
            if rank == 0:
                out.update(outcome.finish(cell, seed, device, res, images, traced,
                                          batches=[e["batches"] for e in every], peaks=[e["peak"] for e in every],
                                          busy=[e["busy"] for e in every]))
                out["first_iteration_wall"] = max(e["first"] for e in every)
                # numpy through the queue: a tensor would travel as a handle to this process's memory
                out["batches"] = [[b.numpy() for b in rank_batches] for rank_batches in out["batches"]]
            dist.barrier()
            outs.append(out)
        return outs
    finally:
        dist.destroy_process_group()


def run_ranks(cell: Cell, seed: int, seconds: float, traced: bool, device_type: str = "cuda",
              step_hook=None) -> Dict[str, Any]:
    """Run the cell's ranks, wait for every one, and return rank 0's result
    (with the forbidden modules any rank loaded). ``step_hook``, a function
    the ranks can import, plants a fault in tests."""
    return run_ranks_seeds(cell, [seed], seconds, traced, device_type, step_hook)[0]


def run_ranks_seeds(cell: Cell, seeds: List[int], seconds: float, traced: bool, device_type: str = "cuda",
                    step_hook=None) -> List[Dict[str, Any]]:
    """:func:`run_ranks` for each seed in turn, in one set of rank processes."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=rank_main, args=(r, cell.ranks, port, cell, list(seeds), seconds, traced, device_type, queue,
                                                         step_hook))
             for r in range(cell.ranks)]
    for p in procs:
        p.start()
    results: Dict[int, Dict[str, Any]] = {}
    try:
        while len(results) < len(procs):
            try:
                rank, out = queue.get(timeout=5)
            except queue_module.Empty:
                dead = [r for r, p in enumerate(procs) if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} exited without a result")
                continue
            results[rank] = out
            if isinstance(out, dict):
                raise RuntimeError(f"rank {rank} failed:\n{out['error']}")
    finally:
        for p in procs:
            p.join(timeout=JOIN_S)
            if p.is_alive():
                p.kill()
                p.join()
    import torch

    for i, lead in enumerate(results[0]):
        lead["forbidden"] = sorted({m for outs in results.values() for m in outs[i]["forbidden"]})
        lead["batches"] = [[torch.from_numpy(b) for b in rank_batches] for rank_batches in lead["batches"]]
    return results[0]
