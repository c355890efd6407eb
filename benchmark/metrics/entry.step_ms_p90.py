"""``entry.step_ms_p90``: the 90th percentile of the iteration wall times
(batch, step call, NaN sync) over the traced window's iterations outside
the profiled sub-window (the profiler slows those)."""


def read(run):
    if len(run.iter_ms) < 2:
        return None
    v = sorted(run.iter_ms)
    pos = (len(v) - 1) * 0.9
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
