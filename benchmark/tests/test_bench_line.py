"""The run's last line, the refusals, and what the harness and the
reference may load."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.cell import ROOT, benchmark_json, load_cell
from benchmark.outcome import TraceRun


def _result(cell, traced: bool):
    out = {"iterations": 18, "window_s": 10.1, "batch": cell.batch, "peak_bytes": 2**34,
           "first_iteration_wall": run.PROCESS_START + 20.0,
           "compared": {k: 0.0 for k in cell.limits}, "launches": {"bilinear.fwd": 22},
           "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                      "memory_peak_bytes": 2**34, "power_limit": "700.00 W"}}
    if traced:
        records = [{"name": "void bilinear_fwd_kernel<true, true>", "start": 0, "end": 6500, "layer": "kernels"},
                   {"name": "sm80_xmma_fprop", "start": 7000, "end": 500000, "layer": "dense"}]
        out["trace"] = TraceRun(cell, float(cell.flops_per_step), 67e12, 10, 5.6, [560.0] * 10, [1.2] * 10,
                                1, 0.6, records, [("entry.step", 0, 600000)], 0.0004935)
        out["device"].update(busy_s=0.0004935, window_s=0.6)
        out["breakdown"] = {"device_ops": [["dense:sm80_xmma_fprop", 0.000493]], "idle_gaps": [["entry.step", 1e-5]]}
    return out


@pytest.mark.parametrize("traced", [False, True])
def test_last_line_keys(capsys, traced):
    cell = load_cell("stylegan_ffhq.f32_r1")
    assert run.report(cell, benchmark_json(), _result(cell, traced), traced) == 0
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if traced else []) + ["compared"]
    assert list(line) == keys
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    expected = {"entry.data_ms", "entry.step_ms_p90", "step.mfu", "dense.conv_ms", "kernels.ms", "kernels.roofline",
                "device.idle", "optim.ms", "dphase.r1_ms"} if traced else {"img_per_s", "peak_gib", "setup_s"}
    assert set(line["metrics"]) <= expected
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    # the compared numbers and their limits are the last lines of standard error
    tail = captured.err.strip().splitlines()[-len(cell.limits):]
    assert [t.split()[0] for t in tail] == list(cell.limits) and all(" limit " in t for t in tail)


def test_a_forbidden_module_refuses_the_line(capsys):
    cell = load_cell("stylegan_ffhq.f32_r1")
    result = dict(_result(cell, False), forbidden=["jax"])
    assert run.report(cell, benchmark_json(), result, False) != 0
    captured = capsys.readouterr()
    assert captured.out == "" and "jax" in captured.err


def test_whole_name_comparison():
    assert run.forbidden_modules({"rgbd_gan_tpu_torch": 0, "rgbd_gan_tpu_torch.train": 0, "jaxtyping": 0}) == []
    assert run.forbidden_modules({"rgbd_gan_tpu.core.stage": 0, "jax.numpy": 0, "flax": 0, "jaxlib": 0}) == [
        "flax", "jax", "jaxlib", "rgbd_gan_tpu"]


def _python(code: str, cwd=ROOT, env=None):
    env = dict(os.environ, **(env or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True, env=env, timeout=300)


def test_harness_and_program_load_no_jax():
    code = ("import benchmark.run, benchmark.outcome, benchmark.session, benchmark.ranks, benchmark.control, "
            "benchmark.flops, benchmark.trace\n"
            "import rgbd_gan_tpu_torch.train.trainer, rgbd_gan_tpu_torch.core.config\n"
            "print(benchmark.run.forbidden_modules())")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, benchmark.reference.step\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'rgbd_gan_tpu_torch', 'rgbd_gan_tpu', 'jax'}))")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        assert "rgbd_gan_tpu" not in path.read_text(), path


def test_measuring_path_fails_without_a_card():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "stylegan_ffhq.f32_r1", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys\nfrom benchmark.cell import load_cell\nfrom benchmark import outcome\n"
            "cell = load_cell('stylegan_ffhq.f32_r1')\noutcome.run_single(cell, 1, 1.0, False, 'cpu')")
    out = _python(code, cwd=tmp_path, env={"PYTHONPATH": str(tmp_path)})
    assert out.returncode != 0 and "rgbd_gan_tpu_torch" in out.stderr
