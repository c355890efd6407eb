"""The readers of the program's own spans and counters (``gphase.*``,
``dphase.ms``, ``dphase.idle_ms``, ``step.syncs``, ``setup.*``) on a traced
run and tracer records made by hand: the numbers worked out below, and
silence where the program kept nothing of the run or has no tracer."""

from __future__ import annotations

import sys

import pytest

from benchmark.cell import benchmark_json, load_cell
from benchmark.outcome import TraceRun
from benchmark.run import per_layer_readers

NAMES = ("gphase.ms", "dphase.ms", "gphase.idle_ms", "dphase.idle_ms", "step.syncs", "setup.trainer_s",
         "setup.first_step_s")


def _span(name, start, end, step, device_ms=None, sync=0):
    return {"name": name, "parent": None, "step": step, "start_ns": start, "end_ns": end,
            "counts": {"sync": sync} if sync else {}, "device_ms": device_ms}


# two profiled steps inside the harness's entry.step spans [1000, 11000] and [12000, 22000] (ns)
RECORDS = [
    _span("setup.trainer", 100, 600, -1),
    _span("setup.first_step", 650, 900, 0),
    _span("setup.first_step", 950, 990, 0),
    _span("step.gen", 2000, 6000, 0, 3.0, sync=2),
    _span("step.gen.forward", 2100, 3000, 0, 0.5, sync=1),
    _span("step.dis", 6500, 10500, 0, 2.5),
    _span("step.finish", 10600, 10900, 0, 0.1, sync=2),
    _span("step.inputs", 12100, 12900, 1, 0.2, sync=3),
    _span("step.gen", 13000, 17000, 1, 4.0),
    _span("step.dis", 17500, 21500, 1, 3.5),
    _span("step.finish", 21600, 21900, 1, 0.1, sync=2),
    # kept by another run in the same process: outside this run's window
    _span("setup.trainer", 30000, 31000, -1),
    _span("step.gen", 40000, 41000, 7, 100.0, sync=50),
    _span("step.dis", 41000, 42000, 7, 100.0),
]
# device busy [1500, 2500], [2600, 3000], [3500, 5000], [7000, 9000], [9200, 10000], [14000, 16000],
# [18000, 20000]: the gaps opening at 2500, 3000, 5000 (in step 0's step.gen) and at 16000 (in step 1's)
# are 100 + 500 + 2000 + 2000 ns; those at 9000 and 10000 (in step 0's step.dis) 200 + 4000
DEVICE = [(1500, 2500), (2600, 3000), (3500, 5000), (7000, 9000), (9200, 10000), (14000, 16000), (18000, 20000)]
EXPECTED = {
    "gphase.ms": (3.0 + 4.0) / 2,
    "dphase.ms": (2.5 + 3.5) / 2,
    "gphase.idle_ms": 1e-6 * (100 + 500 + 2000 + 2000) / 2,
    "dphase.idle_ms": 1e-6 * (200 + 4000) / 2,
    "step.syncs": (2 + 1 + 2 + 3 + 2) / 2,
    "setup.trainer_s": 1e-9 * 500,
    "setup.first_step_s": 1e-9 * (250 + 40),
}


def _run(records=DEVICE, spans=(("entry.step", 1000, 11000), ("entry.step", 12000, 22000))):
    cell = load_cell("stylegan_ffhq.f32_r1")
    device = [{"name": "k", "start": a, "end": b, "layer": "other"} for a, b in records]
    return TraceRun(cell, float(cell.flops_per_step), 67e12, 10, 5.6, [560.0] * 10, [1.2] * 10, 2, 0.021,
                    device, list(spans), 1e-5)


def _readers():
    readers = per_layer_readers("stylegan_ffhq.f32_r1", benchmark_json())
    assert set(NAMES) <= set(readers)
    return {name: readers[name][1] for name in NAMES}


@pytest.fixture
def kept(monkeypatch):
    from rgbd_gan_tpu_torch.utils import trace

    def use(records):
        monkeypatch.setattr(trace, "records", lambda: [dict(r) for r in records])

    return use


@pytest.mark.parametrize("name", NAMES)
def test_reader_gives_the_worked_out_number(kept, name):
    kept(RECORDS)
    assert _readers()[name].read(_run()) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_reader_silent_when_nothing_was_kept(kept, name):
    kept([])
    assert _readers()[name].read(_run()) is None
    kept(RECORDS)
    assert _readers()[name].read(_run(spans=())) is None  # a run with no profiled window


@pytest.mark.parametrize("name", ["gphase.ms", "dphase.ms", "step.syncs"])
def test_device_readers_silent_off_the_card(kept, name):
    kept([dict(r, device_ms=None) for r in RECORDS])
    assert _readers()[name].read(_run()) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_silent_without_the_tracer(monkeypatch, name):
    """A program that lacks the tracer (the port before it had one)."""
    import rgbd_gan_tpu_torch.utils

    monkeypatch.delattr(rgbd_gan_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "rgbd_gan_tpu_torch.utils.trace", None)
    assert _readers()[name].read(_run()) is None
