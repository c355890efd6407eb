"""From a ``torch.profiler`` trace of whole steps to device times by layer.

Only device work counts: kernels, memcpys and memsets. The device-side
copies of host annotations (the benchmark's spans, NCCL's
``nccl:all_reduce``) carry the name of a host range, span work that is
already counted, and are dropped, as is what the benchmark itself
launches under ``entry.stop`` (the ranks'
"the window is over" all-reduce, which waits for the slowest rank). Each
device operation is tied to the host operator that launched it (its linked
correlation id), and that operator to its ancestors on the same host thread
(operators nest in time). Its layer is the first that applies:

- ``kernels``: the port's hand-written kernels (``bilinear_*``, ``lift_*``)
- ``parallel``: NCCL's kernels
- ``dphase.r1``: under ``aten::_convolution_double_backward`` (R1's
  double backward)
- ``dense``: under ``aten::convolution`` or ``aten::convolution_backward``
- ``optim``: under an ``aten::_foreach_*`` operator (the optimizer)
- ``other``: the rest (elementwise, reductions, gathers, copies)

Busy time is the union of the operations' intervals; idle gaps are the
stretches between them, each named by the benchmark's host span
(``entry.batch``, ``entry.step``, ``entry.nan_sync``) that was open when
the device went idle.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

SPANS = ("entry.batch", "entry.step", "entry.nan_sync", "entry.stop")
HARNESS_SPAN = "entry.stop"
LAYERS = ("kernels", "parallel", "dphase.r1", "dense", "optim", "other")
HAND_WRITTEN = re.compile(r"\b(bilinear|lift)_\w*kernel")
DENSE_OPS = ("aten::convolution", "aten::convolution_backward")


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def busy_intervals(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of the intervals as disjoint, sorted intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def layer_of(name: str, ancestors: Sequence[str]) -> str:
    """The layer of a device operation named ``name`` launched under the host
    operators ``ancestors`` (innermost first)."""
    if HAND_WRITTEN.search(name):
        return "kernels"
    if "nccl" in name.lower():
        return "parallel"
    if "aten::_convolution_double_backward" in ancestors:
        return "dphase.r1"
    if any(a in DENSE_OPS for a in ancestors):
        return "dense"
    if any(a.startswith("aten::_foreach_") for a in ancestors):
        return "optim"
    return "other"


def _ancestry(ops: List[tuple]) -> Dict[int, Optional[int]]:
    """Parent correlation id of each host operator: operators on one thread
    nest in time. ``ops``: ``(id, thread, start, end)``."""
    parent: Dict[int, Optional[int]] = {}
    by_thread: Dict[int, List[tuple]] = defaultdict(list)
    for op in ops:
        by_thread[op[1]].append(op)
    for thread_ops in by_thread.values():
        stack: List[tuple] = []
        for op in sorted(thread_ops, key=lambda o: (o[2], -o[3])):
            while stack and stack[-1][3] < op[3]:
                stack.pop()
            parent[op[0]] = stack[-1][0] if stack else None
            stack.append(op)
    return parent


def device_records(events) -> Tuple[List[dict], List[tuple], Dict[str, int]]:
    """Device operations ``{name, start, end, layer}`` (ns), the
    benchmark's host spans ``(name, start, end)`` and the device-side
    annotation copies left out (name: count) from the profiler's raw events
    (``prof.profiler.kineto_results.events()``)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops, names, spans, device, host_names = [], {}, [], [], set()
    for e in events:
        if e.device_type() == cuda:
            device.append(e)
            continue
        host_names.add(e.name())
        if e.linked_correlation_id() == 0:
            ops.append((e.correlation_id(), e.start_thread_id(), e.start_ns(), e.end_ns()))
            names[e.correlation_id()] = e.name()
            if e.name() in SPANS:
                spans.append((e.name(), e.start_ns(), e.end_ns()))
    parent = _ancestry(ops)
    records, annotations = [], defaultdict(int)
    for e in device:
        if e.name() in host_names:  # no kernel is named as a host operator or range
            annotations[e.name()] += 1
            continue
        chain, op = [], e.linked_correlation_id()
        while op is not None and op in names and len(chain) < 256:
            chain.append(names[op])
            op = parent.get(op)
        if HARNESS_SPAN in chain:
            continue
        records.append({"name": e.name(), "start": e.start_ns(), "end": e.end_ns(), "layer": layer_of(e.name(), chain)})
    return records, spans, dict(annotations)


def layer_seconds(records: Sequence[dict]) -> Dict[str, float]:
    """Summed device seconds by layer."""
    out = {layer: 0.0 for layer in LAYERS}
    for r in records:
        out[r["layer"]] += (r["end"] - r["start"]) * 1e-9
    return out


def busy_seconds(records: Sequence[dict]) -> float:
    return union_length((r["start"], r["end"]) for r in records) * 1e-9


def breakdown(records: Sequence[dict], spans: Sequence[tuple], top: int = 10) -> Dict[str, list]:
    """The device operations that took the most time (``layer:name``, summed
    seconds) and the longest idle gaps (the host span open when the device
    went idle, seconds), ``top`` of each."""
    by_name: Dict[str, float] = defaultdict(float)
    for r in records:
        by_name[f"{r['layer']}:{r['name'][:100]}"] += (r["end"] - r["start"]) * 1e-9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = busy_intervals((r["start"], r["end"]) for r in records)
    gaps = []
    start = min((s[1] for s in spans), default=None)
    if busy and start is not None and start < busy[0][0]:
        gaps.append((start, busy[0][0]))
    gaps += [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    named = []
    for g0, g1 in gaps:
        open_spans = [s for s in spans if s[1] <= g0 < s[2]]
        named.append([open_spans[-1][0] if open_spans else "host", (g1 - g0) * 1e-9])
    named.sort(key=lambda kv: -kv[1])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named[:top]}
