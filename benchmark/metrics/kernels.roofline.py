"""``kernels.roofline``: the hand-written kernels' least possible time at the
cell's shapes (``benchmark/bounds.py``: the bytes each call must move over
3.35 TB/s) over their measured device time, in %, over the profiled steps.
Silent where none ran or none is known by name."""

import importlib

bounds = importlib.import_module("benchmark.bounds")


def read(run):
    cell = run.cell
    shapes = cell.architecture.kernel_calls(cell.local_batch, cell.image_px)
    bound = spent = 0.0
    for r in run.records:
        kind = bounds.kind_of(r["name"]) if r["layer"] == "kernels" else None
        if kind is None or kind not in shapes:
            continue
        bound += bounds.bound_seconds(kind, shapes[kind][0])
        spent += (r["end"] - r["start"]) * 1e-9
    return 100.0 * bound / spent if spent > 0 else None
