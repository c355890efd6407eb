"""``chnorm.roofline``: the generator's channel-norm epilogues' least
possible time over their measured device time, in %, over the profiled
steps (the ``gen.chnorm`` spans that ``chnorm.ms`` reads). The least time
is the elements they normalise (the program's ``chnorm.elems`` counter in
the same spans) read once and written once, 4 bytes a side in float32 and
2 in bf16, over 3.35 TB/s (``benchmark/bounds.py``): the bias, the leaky
ReLU and the norm need no other pass over memory. The forward only:
autograd's backward of the epilogue runs under no span. Silent where no
span kept device times."""

import importlib

bounds = importlib.import_module("benchmark.bounds")

SPAN = "gen.chnorm"
COUNTER = "chnorm.elems"
BYTES_A_SIDE = {"f32": 4, "bf16": 2}


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
    spent = 1e-3 * sum(r["device_ms"] for r in spans)
    if spent <= 0:
        return None
    moved = 2 * BYTES_A_SIDE[run.cell.precision] * sum(r["counts"].get(COUNTER, 0) for r in spans)
    return 100.0 * moved / bounds.HBM_BYTES_PER_S / spent
