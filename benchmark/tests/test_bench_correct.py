"""What decides ``correct``, at sizes a test can hold on the CPU: a sound
run is correct; the control (the reference in the precision below the
configuration's, put in the program's place) and each fault that the cell
can have, planted under the timed path, are not."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark import correctness, outcome
from benchmark.tests.tiny import tiny

SEED = 2**31 + 7


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _run(cell, hook=None):
    return outcome.run_single(cell, SEED, 0.3, False, "cpu", step_hook=hook)


def sound_limits(cell):
    """The cell's limits but the worst leaf's change: at these widths a leaf
    holds a few dozen elements, so one element's Adam step, flipped by
    round-off, moves the worst leaf's change by whole percents; the step-1
    numbers and the median leaf's change do not depend on it."""
    return {k: v for k, v in cell.limits.items() if k != "change_gap"}


@pytest.mark.parametrize("workload", ["stylegan_ffhq.f32_r1", "stylegan_ffhq.bf16_r1", "deepvoxels_car.f32"])
def test_sound_run_is_correct(workload):
    cell = tiny(workload)
    values = _run(cell)["compared"]
    assert correctness.judge(values, sound_limits(cell)), values


@pytest.mark.parametrize("workload", ["stylegan_ffhq.f32_r1", "stylegan_ffhq.bf16_r1"])
def test_control_is_not_correct(workload):
    from benchmark.control import CONTROL_ROUNDING

    cell = tiny(workload)
    batches = _run(cell)["batches"]
    reference = correctness.run_reference(cell, SEED, batches, "cpu")
    control = correctness.run_reference(cell, SEED, batches, "cpu", rounding=CONTROL_ROUNDING[cell.precision])
    values = correctness.readings(control, reference, 0)
    assert not correctness.judge(values, cell.limits), values


def test_nought_rule_reads_a_float32_step():
    """Block 0's bias feeds an instance norm over a constant map, which
    cancels it: its gradient is nought. In bf16 its round-off passes a
    thousandth of the median leaf's; the rule reads the reference's float32
    step, where it does not."""
    import statistics

    cell = tiny("stylegan_ffhq.bf16_r1")
    reference = correctness.run_reference(cell, SEED, _run(cell)["batches"], "cpu")
    assert set(reference.rule_grad_norms) == set(reference.grad_norms)
    bf16_median = statistics.median(reference.grad_norms.values())
    assert reference.grad_norms["gen/block0.b0"] >= correctness.NOUGHT_SHARE * bf16_median
    kept = correctness.nought_rule(reference)
    assert "gen/block0.b0" not in kept
    assert "gen/block0.s0.b.weight" in kept and len(kept) > len(reference.grad_norms) // 2


def unchanged(trainer, step, spec):
    """A step that hands back its state unchanged (its losses and moments as computed)."""
    def run(state, *args, **kw):
        modules = (state.gen, state.dis)
        kept = [[p.detach().clone() for p in m.parameters()] for m in modules]
        out = step(state, *args, **kw)
        with torch.no_grad():
            for m, saved in zip(modules, kept):
                for p, v in zip(m.parameters(), saved):
                    p.copy_(v)
        return out
    return run


def half_batch(trainer, step, spec):
    """A step that leaves out half of the batch (half of each half, so the
    pairs stay pairs) and takes the mean over the rest."""
    from rgbd_gan_tpu_torch.train.steps import make_rgbd_train_step

    half_spec = dataclasses.replace(spec, batch_size=spec.batch_size // 2)
    small = make_rgbd_train_step(trainer.make_hidden, trainer.prior, half_spec)
    b, q = spec.batch_size, spec.batch_size // 4
    idx = torch.cat([torch.arange(q), torch.arange(b // 2, b // 2 + q)])

    def run(state, x, alpha, rng, **draws):
        return small(state, x[idx.to(x.device)], alpha, rng, **{k: v[idx.to(v.device)] for k, v in draws.items()})
    return run


def no_exchange(trainer, step, spec):
    """A rank's step that leaves the ranks' exchange out: its own gradients
    and metrics, not their means."""
    from rgbd_gan_tpu_torch.train.steps import make_rgbd_train_step

    return make_rgbd_train_step(trainer.make_hidden, trainer.prior, dataclasses.replace(spec, axis_name=None))


@pytest.mark.parametrize("hook", [unchanged, half_batch])
def test_fault_is_not_correct(hook):
    cell = tiny("stylegan_ffhq.f32_r1")
    values = _run(cell, hook)["compared"]
    assert not correctness.judge(values, cell.limits), values


def test_ranks_sound_and_without_exchange():
    from benchmark.ranks import run_ranks

    cell = tiny("stylegan_ffhq.f32_r1.dp4")
    sound = run_ranks(cell, SEED, 0.3, False, device_type="cpu")["compared"]
    assert correctness.judge(sound, sound_limits(cell)), sound
    faulty = run_ranks(cell, SEED, 0.3, False, device_type="cpu", step_hook=no_exchange)["compared"]
    assert not correctness.judge(faulty, cell.limits), faulty
