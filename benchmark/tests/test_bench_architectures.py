"""Each architecture's part of the harness lives in its reference module
(``reference/<generator_architecture>.py``): the draws and the readings of
``correct`` at seed 0 on the CPU are pinned, which a change to the harness
must leave as they are; a module injected under a new name runs through
every part of the harness; an unknown name fails with the module it
looked for."""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import sys
import types

import pytest
import torch

from benchmark import bounds, correctness, flops, inputs, outcome
from benchmark.cell import HERE, load_cell
from benchmark.reference import step as ref
from benchmark.tests.tiny import tiny

SEED = 0
CONTRACT = ("generator", "domains", "draws", "step", "kernel_calls", "LAZY_R1", "TINY")
THIRD = "third_arch"

# sha256 over each rank's checked steps, each step's draws by key (the key, then the tensor's bytes), seed 0
DRAWS = [
    ("stylegan_ffhq.f32_r1", "tiny", "b6b0399c67df7433ad3c936e55998e93802f23a8d441c006616f7bca4076f8c8"),
    ("stylegan_ffhq.bf16_r1", "tiny", "b6b0399c67df7433ad3c936e55998e93802f23a8d441c006616f7bca4076f8c8"),
    ("deepvoxels_car.f32", "tiny", "4280839f4906949e0fdc0d3f933772d5fa2db26200cea12c7f63907f2159f17d"),
    ("stylegan_ffhq.f32_r1.dp4", "tiny", "1a85f31a000262db40e188d26c1a05f1014ee2b32b6179c8a7390427c351c427"),
    ("stylegan_ffhq.f32_r1", "full", "3163308a7e5dcebf7a381a166c16327b931e8d14e85fbc6aa36e95d3fd168587"),
    ("stylegan_ffhq.bf16_r1", "full", "3163308a7e5dcebf7a381a166c16327b931e8d14e85fbc6aa36e95d3fd168587"),
    ("deepvoxels_car.f32", "full", "b8d66e48794c91b3b338e9dfeabfaa65b5fd82361e1286712bdfd3f64f193e2a"),
]
# the compared numbers of a tiny run at seed 0 on the CPU, two threads (the program's three steps against the reference)
READINGS = {
    "stylegan_ffhq.f32_r1": {
        "loss_gap": 0.0008176178318449402,
        "loss1_gap": 0.0,
        "loss1_gen_gap": 0.0,
        "loss1_gp_gap": 0.0,
        "grad_gap": 0.00028019468644719243,
        "grad_gap_gen": 0.00034629415649719745,
        "grad_gap_kept": 2.867001546358791e-07,
        "change_gap": 0.006945353797260608,
        "change_gap_median": 0.0001196506260163831,
        "feed_bad_rows": 0.0,
        "leaves_left_out": 71.0,
    },
    "stylegan_ffhq.bf16_r1": {
        "loss_gap": 0.7054282299901015,
        "loss1_gap": 0.0,
        "loss1_gen_gap": 0.0,
        "loss1_gp_gap": 0.0,
        "grad_gap": 0.14325746079160973,
        "grad_gap_gen": 0.14325746079160973,
        "grad_gap_kept": 0.0014352883446075932,
        "change_gap": 0.15624890718163148,
        "change_gap_median": 0.027307024004598612,
        "feed_bad_rows": 0.0,
        "leaves_left_out": 71.0,
    },
    "deepvoxels_car.f32": {
        "loss_gap": 0.02926084202362819,
        "loss1_gap": 0.00028940892587059054,
        "loss1_gen_gap": 1.2438077033488776e-07,
        "loss1_gp_gap": 0.0,
        "grad_gap": 0.023978188268377925,
        "grad_gap_gen": 0.0038831604562677684,
        "grad_gap_kept": 0.023978188268377925,
        "change_gap": 0.24934823460465882,
        "change_gap_median": 0.0384920775235528,
        "feed_bad_rows": 0.0,
        "leaves_left_out": 26.0,
    },
}


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def digest(cell) -> str:
    h = hashlib.sha256()
    for rank in range(cell.ranks):
        for d in inputs.draws(cell, SEED, rank, "cpu"):
            for k in sorted(d):
                h.update(k.encode())
                h.update(d[k].contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("workload, size, expected", DRAWS)
def test_draws_are_pinned(workload, size, expected):
    assert digest(tiny(workload) if size == "tiny" else load_cell(workload)) == expected


@pytest.mark.parametrize("workload", list(READINGS))
def test_readings_are_pinned(workload):
    assert outcome.run_single(tiny(workload), SEED, 0.3, False, "cpu")["compared"] == READINGS[workload]


@pytest.fixture
def third(monkeypatch):
    """The tiny StyleGAN cell under a generator_architecture of a new name,
    whose module is a thin re-export of the StyleGAN module's contract."""
    from benchmark.reference import stylegan

    module = types.ModuleType(f"benchmark.reference.{THIRD}")
    module.__dict__.update({k: getattr(stylegan, k) for k in CONTRACT})
    monkeypatch.setitem(sys.modules, module.__name__, module)
    cell = tiny("stylegan_ffhq.f32_r1")
    return dataclasses.replace(cell, config=dict(cell.config, generator_architecture=THIRD))


def test_a_third_architecture_enters_alone(third):
    base = tiny("stylegan_ffhq.f32_r1")
    assert third.architecture.__name__.endswith(THIRD)
    weights, base_weights = (correctness.reference_weights(c, SEED, "cpu") for c in (third, base))
    assert all(torch.equal(weights[m][k], v) for m in base_weights for k, v in base_weights[m].items())
    for d, e in zip(inputs.draws(third, SEED, 0, "cpu"), inputs.draws(base, SEED, 0, "cpu")):
        assert d.keys() == e.keys() and all(torch.equal(d[k], e[k]) for k in d)
    images = inputs.images(third, SEED)
    b, n = third.local_batch, len(images)
    batches = [[torch.from_numpy(images[[(b * i + j) % n for j in range(b)]].transpose(0, 2, 3, 1).copy())
                for i in range(inputs.CHECKED_STEPS)]]
    planted, reference = (correctness.run_reference(c, SEED, batches, "cpu") for c in (third, base))
    values = correctness.readings(planted, reference, correctness.feed_bad_rows(batches[0], images))
    assert correctness.judge(values, third.limits) and values["change_gap"] == 0.0, values
    assert values["leaves_left_out"] > 0 and planted.prefixes == reference.prefixes
    assert flops.step_flops(third) == flops.step_flops(base) > 0
    assert flops.step_flops(third, with_r1=False) == flops.step_flops(base, with_r1=False)
    calls = third.architecture.kernel_calls(third.local_batch, third.image_px)
    assert calls == base.architecture.kernel_calls(base.local_batch, base.image_px)
    assert all(bounds.bound_seconds(kind, shape) > 0 for kind, (shape, _) in calls.items())


def test_an_unknown_architecture_fails_clearly():
    cell = tiny("stylegan_ffhq.f32_r1")
    cell = dataclasses.replace(cell, config=dict(cell.config, generator_architecture="no_such_arch"))
    with pytest.raises(ModuleNotFoundError, match=r"benchmark\.reference\.no_such_arch"):
        inputs.draws(cell, SEED, 0, "cpu")


def _code(path) -> str:
    """The file's code without its docstrings and comments."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.unparse(tree)


def test_no_harness_file_names_an_architecture():
    """Outside the reference modules, no harness file names an architecture
    (a module of ``reference/`` that holds the contract) in its code."""
    names = [p.stem for p in (HERE / "reference").glob("*.py") if "def kernel_calls(" in p.read_text()]
    assert len(names) >= 2
    files = [*HERE.glob("*.py"), *(HERE / "metrics").glob("*.py"), HERE / "tests" / "tiny.py"]
    found = {(p.name, a) for p in files for a in names if a in _code(p).lower()}
    assert not found, found

