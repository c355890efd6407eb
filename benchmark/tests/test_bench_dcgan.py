"""The DCGAN configuration's part of the harness: its draws pinned, the tiny
``dcgan_car.f32_r1`` cell's three checked steps against the reference on
the CPU read ``correct`` under the full cell's limits, its stored FLOP
count and kernel shapes, and the readers of the channel-norm spans
(``chnorm.ms``, ``chnorm.roofline``) on tracer records made by hand."""

from __future__ import annotations

import json
import sys

import pytest
import torch

from benchmark import bounds, correctness, outcome
from benchmark.cell import HERE, benchmark_json, load_cell
from benchmark.flops import config_counts
from benchmark.outcome import TraceRun
from benchmark.run import per_layer_readers
from benchmark.tests.test_bench_architectures import SEED, digest
from benchmark.tests.tiny import tiny

WORKLOAD = "dcgan_car.f32_r1"
DRAWS = [
    ("tiny", "91a2b420d41c4fe7598b9ad138fed9491a931501ba4e9581e7664ef5778d7873"),
    ("full", "eb79835aa3b7907f71dedff39877641d154f8e9a45cf02c1abdf6714b47a72dd"),
]
READERS = ("chnorm.ms", "chnorm.roofline")


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("size, expected", DRAWS)
def test_draws_are_pinned(size, expected):
    assert digest(tiny(WORKLOAD) if size == "tiny" else load_cell(WORKLOAD)) == expected


def test_tiny_cell_is_correct():
    cell = tiny(WORKLOAD)
    assert cell.config["generator_architecture"] == "dcgan" and cell.image_px == 32
    values = outcome.run_single(cell, SEED, 0.3, False, "cpu")["compared"]
    assert correctness.judge(values, cell.limits), values
    assert values["feed_bad_rows"] == 0


def test_stored_count_is_the_counters():
    stored = json.loads((HERE / "configs" / "dcgan_car.json").read_text())["flops_per_step"]
    assert stored == config_counts("dcgan_car")
    # the same D, R1 and 3D loss as the StyleGAN configuration: R1 costs the same
    stylegan = load_cell("stylegan_ffhq.f32_r1").meta["flops_per_step"]
    assert stored["with_r1"] - stored["without_r1"] == stylegan["with_r1"] - stylegan["without_r1"]


def test_kernel_calls():
    cell = load_cell(WORKLOAD)
    calls = cell.architecture.kernel_calls(cell.local_batch, cell.image_px)
    assert calls == {"bilinear_fwd": ((32, 16384, 4), 1), "bilinear_bwd": ((32, 16384, 4), 1)}


def _span(start, end, step, device_ms, elems):
    return {"name": "gen.chnorm", "parent": "step.gen.forward", "step": step, "start_ns": start, "end_ns": end,
            "counts": {"chnorm.elems": elems}, "device_ms": device_ms}


# two profiled steps inside the harness's entry.step spans [1000, 11000] and [12000, 22000] (ns), two
# epilogues a step; the last span was kept by another run in the same process
RECORDS = [_span(2000, 2100, 0, 0.25, 10**8), _span(2200, 2300, 0, 0.75, 3 * 10**8),
           _span(13000, 13100, 1, 0.5, 10**8), _span(13200, 13300, 1, 0.5, 3 * 10**8),
           _span(40000, 40100, 7, 100.0, 10**9)]
EXPECTED = {"chnorm.ms": (1.0 + 1.0) / 2,
            "chnorm.roofline": 100.0 * 8 * 8e8 / bounds.HBM_BYTES_PER_S / 2e-3}


def _run(spans=(("entry.step", 1000, 11000), ("entry.step", 12000, 22000))):
    cell = load_cell(WORKLOAD)
    return TraceRun(cell, float(cell.flops_per_step), 67e12, 10, 6.3, [630.0] * 10, [1.2] * 10, 2, 1.3, [],
                    list(spans), 1.2)


def _readers():
    readers = per_layer_readers(WORKLOAD, benchmark_json())
    return {name: readers[name][1] for name in READERS}


@pytest.fixture
def kept(monkeypatch):
    from rgbd_gan_tpu_torch.utils import trace

    def use(records):
        monkeypatch.setattr(trace, "records", lambda: [dict(r) for r in records])

    return use


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_the_worked_out_number(kept, name):
    kept(RECORDS)
    assert _readers()[name].read(_run()) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_silent_when_nothing_was_kept(kept, name):
    kept([r for r in RECORDS if r["name"] != "gen.chnorm"])  # a program without the span
    assert _readers()[name].read(_run()) is None
    kept([dict(r, device_ms=None) for r in RECORDS])  # off the card
    assert _readers()[name].read(_run()) is None
    kept(RECORDS)
    assert _readers()[name].read(_run(spans=())) is None  # a run with no profiled window


@pytest.mark.parametrize("name", READERS)
def test_reader_silent_without_the_tracer(monkeypatch, name):
    import rgbd_gan_tpu_torch.utils

    monkeypatch.delattr(rgbd_gan_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "rgbd_gan_tpu_torch.utils.trace", None)
    assert _readers()[name].read(_run()) is None


def test_only_the_dcgan_cell_lists_the_channel_norm():
    bench = benchmark_json()
    for m in bench["per_layer"]:
        if m["name"] in READERS:
            assert m["workloads"] == [WORKLOAD] and m["layer"] == "channel norm"
        else:
            assert WORKLOAD in m["workloads"]
