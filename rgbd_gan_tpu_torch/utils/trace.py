"""Spans and counters of the training step, on ``torch.profiler``'s clock.

Tracing is on exactly while a ``torch.profiler`` session records (PyTorch's
own flag decides it; there is no switch of its own). So the operator's
``nvprof: True`` run and any caller's profiled window get the spans, and
nothing else does.

- ``span(name)`` is a context manager. Off, it reads that one flag and
  hands back a shared no-op context: nothing is recorded, no
  ``record_function`` is entered and no CUDA event is made. On, it enters
  ``torch.profiler.record_function(name)`` (so the profiler's trace carries
  the range, and every kernel launched inside holds it in its ancestry),
  keeps ``(name, parent, step, start_ns, end_ns)`` with the host times in
  Unix-epoch ns from ``time.time_ns()``, the profiler's own clock, and, once
  CUDA is up, records a pair of timing ``torch.cuda.Event``s on the current
  stream at its two ends, resolved only when the records are read.
  ``span(name, step=i)`` also sets the step index that later records carry
  (the state's iteration, given by the first span of an iteration).
- ``setup_span(name)`` records its host times whether tracing is on or off:
  for set-up, a handful of times a process, never inside a step.
- ``count(name, n)`` adds ``n`` to a counter filed under the innermost open
  span, while tracing is on.
- While tracing is on and CUDA is up, every host-device synchronisation is
  counted as ``sync`` under the open span: PyTorch's sync debug mode is set
  to warn, and its warnings are counted and kept from the output. The first
  span after the profiler stops puts the mode back as it was.

``records()``, ``summary()`` and ``reset()`` read and clear what was kept.
The kernels' launch counts are the ``launches`` dicts of ``ops.bilinear``,
``ops.trilinear`` and ``ops.conv``; ``summary`` reads them, per traced step.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from collections import Counter
from typing import Any, Dict, List, Optional

import torch

SYNC = "sync"
SYNC_WARNING = "called a synchronizing CUDA operation"
_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def _launch_counts() -> Counter:
    from ..ops import bilinear, conv, trilinear

    out = Counter()
    for prefix, module in (("bilinear", bilinear), ("trilinear", trilinear), ("conv", conv)):
        out.update({f"{prefix}.{k}": v for k, v in module.launches.items()})
    return out


class _Span:
    """One open span; with tracing off only ``setup_span`` makes one."""

    __slots__ = ("tracer", "name", "step", "on", "parent", "counts", "function", "events", "start")

    def __init__(self, tracer: "Tracer", name: str, step: Optional[int]):
        self.tracer, self.name, self.step = tracer, name, step

    def __enter__(self) -> "_Span":
        t = self.tracer
        self.on = _profiling()
        if self.on and (t.armed is None or not t.open and t.armed["cuda"] != torch.cuda.is_initialized()):
            if t.armed is not None:  # CUDA came up since: count its syncs too
                t.disarm()
            t.arm()
        elif not self.on and t.armed is not None:
            t.disarm()
        if self.step is not None:
            t.step = self.step
        self.parent = t.open[-1].name if t.open else None
        self.counts: Dict[str, int] = {}
        self.function = self.events = None
        if self.on:
            self.function = torch.profiler.record_function(self.name)
        # the host times enclose the profiler's range: it stamps the range
        # inside record_function's two calls, which can take 100 us each
        self.start = time.time_ns()
        if self.on:
            self.function.__enter__()
            if t.armed["cuda"]:
                self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                self.events[0].record()
        t.open.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        t = self.tracer
        t.open.pop()
        if self.events is not None:
            self.events[1].record()
        if self.function is not None:
            self.function.__exit__(*exc)
        end = time.time_ns()
        t.kept.append({"name": self.name, "parent": self.parent, "step": t.step, "start_ns": self.start,
                       "end_ns": end, "counts": self.counts, "device_ms": None, "_events": self.events})
        return False


class Tracer:
    """What the spans and counters kept; the module's functions use one."""

    def __init__(self):
        self.open: List[_Span] = []
        self.step = -1
        self.armed: Optional[Dict[str, Any]] = None
        self.show_before = warnings.showwarning
        self.reset()

    def reset(self) -> None:
        """Forget every record, count and launch count kept so far; the
        next span under a profiler starts counting afresh."""
        if self.armed is not None:
            self.disarm()
        self.kept: List[dict] = []
        self.loose: Dict[str, int] = {}  # counts made with no span open
        self.launches_base: Optional[Counter] = None  # at the first traced span since

    def span(self, name: str, step: Optional[int] = None):
        if not _profiling():
            if self.armed is not None:
                self.disarm()
            return _OFF
        return _Span(self, name, step)

    def setup_span(self, name: str) -> _Span:
        return _Span(self, name, None)

    def count(self, name: str, n: int = 1) -> None:
        if not _profiling():
            return
        counts = self.open[-1].counts if self.open else self.loose
        counts[name] = counts.get(name, 0) + n

    def arm(self) -> None:
        """Tracing has started: note the launch counts and, on CUDA, count
        the syncs."""
        cuda = torch.cuda.is_initialized()
        self.armed = {"cuda": cuda}
        if self.launches_base is None:
            self.launches_base = _launch_counts()
        if cuda:
            self.armed["mode"] = torch.cuda.get_sync_debug_mode()
            self.show_before = warnings.showwarning
            warnings.filterwarnings("always", message=SYNC_WARNING)
            self.armed["filter"] = warnings.filters[0]
            warnings.showwarning = self._show
            torch.cuda.set_sync_debug_mode("warn")

    def disarm(self) -> None:
        """Tracing has ended: the sync debug mode and the warnings as they were."""
        armed, self.armed = self.armed, None
        if armed["cuda"]:
            torch.cuda.set_sync_debug_mode(armed["mode"])
            with contextlib.suppress(ValueError):
                warnings.filters.remove(armed["filter"])
            if warnings.showwarning == self._show:
                warnings.showwarning = self.show_before

    def _show(self, message, category, filename, lineno, file=None, line=None) -> None:
        if str(message).startswith(SYNC_WARNING):
            self.count(SYNC)
        else:
            self.show_before(message, category, filename, lineno, file, line)

    def records(self) -> List[dict]:
        """Every span kept: ``name``, ``parent``, ``step``, ``start_ns``,
        ``end_ns``, ``counts`` (its own, not its children's) and
        ``device_ms`` (between its CUDA events; None without them)."""
        for r in self.kept:
            events = r.pop("_events", None)
            if events is not None:
                events[1].synchronize()
                r["device_ms"] = events[0].elapsed_time(events[1])
        return [dict(r, counts=dict(r["counts"])) for r in self.kept]

    def summary(self) -> Dict[str, Any]:
        """By span name: the calls, the host ms and each counter (summed),
        with the device ms where CUDA events were kept; the traced steps
        (the distinct step indices of the ``step.*`` spans) and, on CUDA,
        the kernels' launches per traced step: those since the first traced
        span after the last reset, so read it right after the traced block
        (as the ``nvprof`` run does)."""
        spans: Dict[str, Dict[str, Any]] = {}
        records = self.records()
        for r in records:
            s = spans.setdefault(r["name"], {"calls": 0, "host_ms": 0.0})
            s["calls"] += 1
            s["host_ms"] += (r["end_ns"] - r["start_ns"]) * 1e-6
            if r["device_ms"] is not None:
                s["device_ms"] = s.get("device_ms", 0.0) + r["device_ms"]
                s.setdefault(SYNC, 0)
            for k, v in r["counts"].items():
                s[k] = s.get(k, 0) + v
        steps = len({r["step"] for r in records if r["name"].startswith("step.")})
        out: Dict[str, Any] = {"steps": steps, "spans": spans}
        if self.loose:
            out["no_span"] = dict(self.loose)
        if steps and self.launches_base is not None and any(r["device_ms"] is not None for r in records):
            launches = _launch_counts() - self.launches_base
            out["launches_per_step"] = {k: v / steps for k, v in sorted(launches.items())}
        return out


_TRACER = Tracer()
span = _TRACER.span
setup_span = _TRACER.setup_span
count = _TRACER.count
records = _TRACER.records
summary = _TRACER.summary
reset = _TRACER.reset
