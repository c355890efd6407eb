"""On the card: one short run of a cell through the command, read back.

Run on the chip: ``python3 -m pytest -q benchmark/tests/test_bench_cuda.py``
(about a minute); here it skips."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.cell import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_one_short_run(card, trace):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "stylegan_ffhq.f32_r1",
                          "--seed", str(2**31 + 99), "--seconds", "4", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, out.stderr[-4000:]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert line["device"]["busy_s"] > 0 and "breakdown" in line
        assert 0 < line["metrics"]["step.mfu"]["value"] <= 100
    else:
        assert set(line["metrics"]) == {"img_per_s", "peak_gib", "setup_s"}
