"""``dphase.ms``: the D phase's device ms a step: the time between the CUDA
events the port's tracer records at the two ends of its ``step.dis`` span
(DeepVoxels' render, D on the fakes and the reals, R1, the backward and
Adam), the mean over the profiled steps: the spans that lie inside the
run's own ``entry.*`` spans, the profiled sub-window. Silent where the
program has no tracer or kept no such span with device times (off the
card)."""


def read(run):
    try:
        from rgbd_gan_tpu_torch.utils import trace
    except ImportError:
        return None
    if not run.spans:
        return None
    opens, closes = min(s[1] for s in run.spans), max(s[2] for s in run.spans)
    ms = [r["device_ms"] for r in trace.records() if r["name"] == "step.dis" and r["device_ms"] is not None
          and opens <= r["start_ns"] <= r["end_ns"] <= closes]
    return sum(ms) / len(ms) if ms else None
