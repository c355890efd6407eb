"""The model FLOPs that ``step.mfu`` divides by: the counter against a hand
count of one convolution, and the configurations' stored counts."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch
import torch.nn.functional as F

from benchmark.cell import HERE, load_cell
from benchmark.flops import FlopCount, config_counts, step_flops


def test_one_convolution_by_hand():
    b, c_in, c_out, k, s = 2, 3, 5, 3, 8
    x = torch.randn(b, c_in, s, s, requires_grad=True)
    w = torch.randn(c_out, c_in, k, k, requires_grad=True)
    forward = 2 * b * c_out * c_in * k * k * s * s  # a multiply-add a tap, padding 1 keeps the size
    with FlopCount() as fwd:
        y = F.conv2d(x, w, padding=1)
    with FlopCount() as bwd:  # the input gradient (with its graph, as R1 takes it) and the weight gradient
        gx, _ = torch.autograd.grad(y.sum(), [x, w], create_graph=True)
    with FlopCount() as double:  # R1's double backward: the weight gradient of |gx|^2, and gx's output gradient
        torch.autograd.grad((gx**2).sum(), [w])
    assert fwd.total == forward
    assert bwd.total == 2 * forward
    assert double.total == 2 * forward


def test_linear_by_hand():
    x, w = torch.randn(4, 6, requires_grad=True), torch.randn(5, 6, requires_grad=True)
    with FlopCount() as c:
        F.linear(x, w).sum().backward()
    assert c.total == 3 * 2 * 4 * 6 * 5


@pytest.mark.parametrize("workload", ["stylegan_ffhq.f32_r1", "deepvoxels_car.f32"])
def test_stored_count_is_the_counters(workload):
    cell = load_cell(workload)
    stored = json.loads((HERE / "configs" / f"{cell.config_name}.json").read_text())["flops_per_step"]
    assert stored == config_counts(cell.config_name)
    assert cell.flops_per_step == stored["with_r1"]


def test_the_count_is_the_stepped_precisions():
    # bf16 runs the same products: one count serves both traffics
    assert step_flops(load_cell("stylegan_ffhq.bf16_r1")) == step_flops(load_cell("stylegan_ffhq.f32_r1"))


def test_a_lazy_r1_cell_counts_the_mean_over_its_cycle():
    cell = load_cell("stylegan_ffhq.f32_r1")
    counts = cell.meta["flops_per_step"]
    assert 0 < counts["without_r1"] < counts["with_r1"]
    lazy = dataclasses.replace(cell, config=dict(cell.config, r1_interval=16))
    assert lazy.flops_per_step == pytest.approx((counts["with_r1"] + 15 * counts["without_r1"]) / 16)
