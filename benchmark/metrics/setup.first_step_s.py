"""``setup.first_step_s``: host seconds in the port's ``setup.first_step``
spans, summed: the first call of each step the run built, enqueue only
(cuDNN's heuristics, lazy module loads, the kernel libraries' load).
Only spans that ended before the run's own first ``entry.*`` span count:
the set-up this window followed. Silent where the program has no tracer
or kept no such span."""


def read(run):
    try:
        from rgbd_gan_tpu_torch.utils import trace
    except ImportError:
        return None
    if not run.spans:
        return None
    opens = min(s[1] for s in run.spans)
    ns = [r["end_ns"] - r["start_ns"] for r in trace.records()
          if r["name"] == "setup.first_step" and r["end_ns"] <= opens]
    return 1e-9 * sum(ns) if ns else None
