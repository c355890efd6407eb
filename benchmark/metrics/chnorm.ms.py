"""``chnorm.ms``: device ms a step in the generator's channel-norm
epilogues: the time between the CUDA events the port's tracer records at
the two ends of each ``gen.chnorm`` span (the bias, leaky ReLU and L2
normalisation over the channels after each 3x3 conv of the DCGAN
generator's forward), summed over a step, the mean over the profiled
steps: the spans that lie inside the run's own ``entry.*`` spans, the
profiled sub-window. The forward only: autograd's backward of the
epilogue runs under no span. Silent where the program has no tracer or
kept no such span with device times (off the card, or a program without
the span)."""

SPAN = "gen.chnorm"


def read(run):
    try:
        from rgbd_gan_tpu_torch.utils import trace
    except ImportError:
        return None
    if not run.spans:
        return None
    opens, closes = min(s[1] for s in run.spans), max(s[2] for s in run.spans)
    spans = [r for r in trace.records() if r["name"] == SPAN and r["device_ms"] is not None
             and opens <= r["start_ns"] <= r["end_ns"] <= closes]
    if not spans:
        return None
    return sum(r["device_ms"] for r in spans) / len({r["step"] for r in spans})
