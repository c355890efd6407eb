"""``step.syncs``: host-device synchronisations a step inside the port's
``step.*`` spans (the ``sync`` counter its tracer keeps on the card, from
PyTorch's sync debug mode), the mean over the profiled steps: the spans
that lie inside the run's own ``entry.*`` spans, the profiled sub-window.
Silent where the program has no tracer or kept no step span with device
times (off the card)."""


def read(run):
    try:
        from rgbd_gan_tpu_torch.utils import trace
    except ImportError:
        return None
    if not run.spans:
        return None
    opens, closes = min(s[1] for s in run.spans), max(s[2] for s in run.spans)
    spans = [r for r in trace.records()
             if r["name"].startswith("step.") and opens <= r["start_ns"] <= r["end_ns"] <= closes]
    if not any(r["device_ms"] is not None for r in spans):
        return None
    return sum(r["counts"].get("sync", 0) for r in spans) / len({r["step"] for r in spans})
