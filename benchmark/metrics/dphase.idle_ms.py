"""``dphase.idle_ms``: device idle ms a step in the D phase: the gaps
between the busy intervals of the device trace (``benchmark/trace.py``)
that open while the port's ``step.dis`` span (or one nested in it) is open
on the host, summed, over the steps that span was kept in inside the run's
own ``entry.*`` spans (the profiled sub-window). Host and device times
share the profiler's clock. Silent where the program has no tracer
or kept no such span, or the trace holds no device work."""

import importlib

bench_trace = importlib.import_module("benchmark.trace")

PHASE = "step.dis"


def read(run):
    try:
        from rgbd_gan_tpu_torch.utils import trace
    except ImportError:
        return None
    if not run.spans or not run.records:
        return None
    opens, closes = min(s[1] for s in run.spans), max(s[2] for s in run.spans)
    spans = [r for r in trace.records() if r["name"] == PHASE and opens <= r["start_ns"] <= r["end_ns"] <= closes]
    if not spans:
        return None
    busy = bench_trace.busy_intervals((r["start"], r["end"]) for r in run.records)
    idle = sum(b[0] - a[1] for a, b in zip(busy, busy[1:])
               if any(s["start_ns"] <= a[1] < s["end_ns"] for s in spans))
    return 1e-6 * idle / len({s["step"] for s in spans})
