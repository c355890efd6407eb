"""The port's tracer (``rgbd_gan_tpu_torch/utils/trace.py``): off without a
profiler, the span tree of the RGBD, RGB and DeepVoxels steps under one,
its host times on the profiler's clock, ``Trainer.iterate``, the set-up
spans, and the all-reduce span and byte counter. CPU, except the last test,
which counts syncs on the card and skips here.

On the card: ``python3 -m pytest --noconftest -q tests/test_torch_trace.py``.
"""

import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rgbd_gan_tpu_torch.core.config import Config
from rgbd_gan_tpu_torch.core.stage import decompose_stage
from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
from rgbd_gan_tpu_torch.parallel import mesh
from rgbd_gan_tpu_torch.train.trainer import Trainer
from rgbd_gan_tpu_torch.utils import trace

# the suite runs several worker processes at once: leave them the other cores
torch.set_num_threads(2)

# the widths of the step tests: StyleGAN ch 16, batch 4, 32 px; DeepVoxels ch 16, batch 2, 64 px
STYLEGAN = dict(
    generator_architecture="stylegan", ch=16, batchsize=4, res_dis=True, sn=False,
    adam_alpha_g=0.001, adam_alpha_d=0.003, adam_beta1=0.0, adam_beta2=0.999,
    lambda_gp=1.0, lambda_depth=10, depth_min=1.0, keep_smoothed_gen=True, smoothing=0.999,
    stage_interval="0,0,0,0,0,0,0", max_stage=7, start_rotation=-1, start_occlusion_aware=0,
    x_rotate=0.3054, y_rotate=1.0472, z_rotate=0, x_translate=0, y_translate=0, z_translate=0,
    iteration=2, display_interval=1, snapshot_interval=10000, evaluation_sample_interval=10000,
)
DEEPVOXELS = dict(
    STYLEGAN, generator_architecture="deepvoxels", batchsize=2, depth_min=0.6, focal_loss_gamma=2.0,
    occlusion_type="accumulative", uniform_distribution=True, stage_interval="0,0,0,0,0,0,0,0", max_stage=11,
    y_rotate=3.1415,
)
CONFIGS = {"rgbd": (STYLEGAN, 32), "rgb": (dict(STYLEGAN, rgb=True), 32), "deepvoxels": (DEEPVOXELS, 64)}

# span -> its parent, in every step of each path
TREE = {
    "train.batch": None, "train.step": None, "train.nan_sync": None,
    "step.inputs": "train.step", "step.gen": "train.step", "step.dis": "train.step", "step.finish": "train.step",
    "step.gen.forward": "step.gen", "step.gen.backward": "step.gen", "step.gen.adam": "step.gen",
    "step.gen.loss3d": "step.gen.forward",
    "step.dis.forward": "step.dis", "step.dis.backward": "step.dis", "step.dis.adam": "step.dis",
    "step.dis.r1": "step.dis.forward", "step.dis.render": "step.dis",
}
ABSENT = {"rgbd": {"step.dis.render"}, "rgb": {"step.dis.render", "step.gen.loss3d"}, "deepvoxels": set()}


@pytest.fixture(autouse=True)
def fresh():
    trace.reset()
    yield
    trace.reset()


def _trainer(path, tmp_path=None):
    cfg, px = CONFIGS[path]
    cfg = dict(cfg, out=str(tmp_path / "out")) if tmp_path is not None else cfg
    return Trainer(Config(cfg), dataset=synthetic_dataset(cfg["batchsize"], px, seed=5), seed=0, device="cpu")


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


def _ranges(prof):
    """The profiler's own record of each range: name -> [(start_ns, end_ns)]."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return out


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("entered with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.span("step.gen", step=3) is trace.span("step.dis")  # the one shared no-op context
    with trace.span("step.gen", step=3), trace.span("step.gen.forward"):
        trace.count(trace.SYNC)
        trace.count("parallel.bytes", 64)
    assert trace.records() == [] and trace.summary() == {"steps": 0, "spans": {}}


@pytest.mark.parametrize("path", ["rgbd", "rgb", "deepvoxels"])
def test_span_tree_once_a_step(path):
    """The first iteration, whose step call sits in ``setup.first_step``,
    and, but for DeepVoxels (7 s a step here), a second one."""
    trainer = _trainer(path)
    iterations = 1 if path == "deepvoxels" else 2
    with _profiler() as prof:
        for _ in range(iterations):
            trainer.iterate()
    records = [r for r in trace.records() if r["name"] != "setup.trainer"]
    names = set(TREE) - ABSENT[path]
    for i in range(iterations):
        mine = [r for r in records if r["step"] == i]
        tree = {r["name"]: r["parent"] for r in mine}
        want = {n: TREE[n] for n in names}
        if i == 0:
            want.update({n: "setup.first_step" for n, p in want.items() if p == "train.step"})
            want["setup.first_step"] = "train.step"
        assert tree == want
        assert len(mine) == len(want)  # each once a step
        spans = {r["name"]: r for r in mine}
        for r in mine:
            if r["parent"] is not None:
                parent = spans[r["parent"]]
                assert parent["start_ns"] <= r["start_ns"] <= r["end_ns"] <= parent["end_ns"], r["name"]
    ranges = _ranges(prof)
    for name in names | {"setup.first_step"}:
        assert len(ranges[name]) == sum(r["name"] == name for r in records), name
    assert all(r["device_ms"] is None and r["counts"] == {} for r in records)


def test_host_times_on_the_profiler_clock():
    """After the first span, each span's host start and end lie within
    100 us of the profiler's own record of the same range. A worker
    descheduled between the two stamps (the suite runs several at once)
    moves one pair by milliseconds: a few such pairs are let through, a
    clock that differs moves every one."""
    x = torch.ones(256, 256)
    with _profiler() as prof:
        for i in range(20):
            with trace.span(f"outer{i}"):
                with trace.span(f"inner{i}"):
                    x @ x
    ranges = _ranges(prof)
    records = trace.records()
    assert len(records) == 40
    first = min(records, key=lambda r: r["start_ns"])
    gaps = []
    for r in records:
        if r is not first:
            ((start, end),) = ranges[r["name"]]
            gaps += [abs(r["start_ns"] - start), abs(r["end_ns"] - end)]
    assert len(gaps) == 78
    assert sum(g < 100_000 for g in gaps) >= 74, sorted(gaps)[-8:]


def _rows_of_the_loop_body(trainer, total):
    """``Trainer.run``'s rows as its loop body gave them before
    ``Trainer.iterate`` held it."""
    rows = []
    while trainer.state.iteration < total:
        st = trainer.stage(trainer.state.iteration)
        floor, alpha = decompose_stage(st, trainer.max_stage)
        spec = trainer._spec_for(trainer.state.iteration, floor)
        x = torch.from_numpy(trainer.iterator.next()).to(trainer.device)
        _, metrics = trainer._step(spec)(trainer.state, x, alpha, trainer.rng)
        assert not bool(metrics["nan"])
        row = {"iteration": trainer.state.iteration, "batch_size": float(trainer.batch_size)}
        row.update({k: float(v) for k, v in metrics.items() if k != "nan"})
        rows.append(row)
    return rows


def test_iterate_advances_one_iteration_and_run_rows_are_unchanged(tmp_path):
    trainer = _trainer("rgb", tmp_path)
    metrics = trainer.iterate()
    assert trainer.state.iteration == 1 and not bool(metrics["nan"])
    assert {"gen/loss_adv", "dis/loss_adv", "dis/loss_gp", "stage", "image_size"} <= set(metrics)

    rows = []
    _trainer("rgb", tmp_path).run(log_cb=rows.append)
    for row in rows:
        assert row.pop("elapsed_time") >= 0
    assert rows == _rows_of_the_loop_body(_trainer("rgb", tmp_path / "before"), 2)
    assert [r["iteration"] for r in rows] == [1, 2]


def test_setup_spans_recorded_without_a_profiler():
    trainer = _trainer("rgb")
    trainer.iterate()
    trainer.iterate()
    records = trace.records()
    assert [(r["name"], r["parent"]) for r in records] == [("setup.trainer", None), ("setup.first_step", None)]
    assert all(r["end_ns"] > r["start_ns"] and r["device_ms"] is None for r in records)
    assert trace.summary()["spans"]["setup.first_step"]["calls"] == 1


def test_count_files_under_the_innermost_span():
    with _profiler():
        trace.count("loose", 2)
        with trace.span("a"):
            trace.count("n")
            with trace.span("b"):
                trace.count("n", 5)
            trace.count("n")
    counts = {r["name"]: r["counts"] for r in trace.records()}
    assert counts == {"a": {"n": 2}, "b": {"n": 5}}
    assert trace.summary()["no_span"] == {"loose": 2}


def test_all_reduce_span_and_bytes(monkeypatch):
    """``all_mean`` and ``mean_metrics`` with ``dist.all_reduce`` and the
    world size stood in for: two ranks that hold the same tensors."""
    handed = []

    def all_reduce(t, op=None):
        handed.append(t.numel() * t.element_size())
        if op is None:
            t.mul_(2)

    monkeypatch.setattr(mesh.dist, "all_reduce", all_reduce)
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    a, b = torch.arange(10, dtype=torch.float32), torch.ones(3, dtype=torch.float64)
    with _profiler() as prof:
        with trace.span("step.gen.backward"):
            means = mesh.all_mean([a, b])
        with trace.span("step.finish"):
            out = mesh.mean_metrics({"x": torch.tensor(1.0), "y": torch.tensor(3.0)}, torch.tensor(False))
    torch.testing.assert_close(means[0], a)
    torch.testing.assert_close(means[1], b)
    assert float(out["x"]) == 1.0 and float(out["y"]) == 3.0 and not bool(out["nan"])
    assert handed == [40, 24, 4, 8]
    records = trace.records()
    reduces = [r for r in records if r["name"] == "parallel.all_reduce"]
    assert [(r["parent"], r["counts"]) for r in reduces] == [
        ("step.gen.backward", {"parallel.bytes": 64}), ("step.finish", {"parallel.bytes": 4}),
        ("step.finish", {"parallel.bytes": 8})]
    assert trace.summary()["spans"]["parallel.all_reduce"] == {
        "calls": 3, "host_ms": pytest.approx(sum(1e-6 * (r["end_ns"] - r["start_ns"]) for r in reduces)),
        "parallel.bytes": 76}
    assert len(_ranges(prof)["parallel.all_reduce"]) == 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (syncs and CUDA events exist only on the card)")


@pytest.mark.cuda
def test_syncs_counted_on_the_card(card):
    """Three pageable copies to the card sync three times; a pinned
    non-blocking one does not. The first span after the profiler stops puts
    the sync debug mode and the warnings back."""
    torch.ones(1, device="cuda")  # CUDA up
    pinned = torch.ones(1 << 20).pin_memory()
    show, filters = warnings.showwarning, list(warnings.filters)
    default = torch.cuda.get_sync_debug_mode()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with trace.span("copies"):
            for _ in range(3):
                torch.tensor([1.0, 2.0], device="cuda")
        with trace.span("pinned"):
            pinned.to("cuda", non_blocking=True)
        assert torch.cuda.get_sync_debug_mode() != default
    with trace.span("after"):
        pass
    assert torch.cuda.get_sync_debug_mode() == default
    assert warnings.showwarning == show and warnings.filters == filters
    records = {r["name"]: r for r in trace.records()}
    assert set(records) == {"copies", "pinned"}
    assert records["copies"]["counts"] == {trace.SYNC: 3} and records["pinned"]["counts"] == {}
    assert records["copies"]["device_ms"] >= 0 and records["pinned"]["device_ms"] >= 0
    assert trace.summary()["spans"]["pinned"][trace.SYNC] == 0
