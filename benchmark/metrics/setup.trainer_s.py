"""``setup.trainer_s``: host seconds in the port's ``setup.trainer`` span:
the ``Trainer``'s construction (models drawn on the CPU, moved to the card,
the optimizers). Only spans that ended before the run's own first
``entry.*`` span count: the set-up this window followed. Silent where the
program has no tracer or kept no such span."""


def read(run):
    try:
        from rgbd_gan_tpu_torch.utils import trace
    except ImportError:
        return None
    if not run.spans:
        return None
    opens = min(s[1] for s in run.spans)
    ns = [r["end_ns"] - r["start_ns"] for r in trace.records()
          if r["name"] == "setup.trainer" and r["end_ns"] <= opens]
    return 1e-9 * sum(ns) if ns else None
