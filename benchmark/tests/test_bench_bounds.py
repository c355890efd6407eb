"""The kernels' least possible times: at PERF.md section 6's shapes the
bound lies under every time the card has measured for the kernel, so a
share of it cannot pass 100 %."""

from __future__ import annotations

import pytest

from benchmark import bounds
from benchmark.cell import load_cell

# (kind, (B, N, C), the card's time in ms at those shapes: PERF.md section 6, NVIDIA H100, 700 W)
MEASURED = [
    ("bilinear_fwd", (32, 16384, 4), 0.0065),
    ("bilinear_bwd", (32, 16384, 4), 0.0103),  # on the 3D loss's points, without the zero fill
    ("bilinear_fwd", (10, 4096, 4), 0.0019),
    ("bilinear_bwd", (10, 4096, 4), 0.0033),
    ("lift_fwd", (10, 229376, 32), 0.1805),
    ("lift_bwd", (10, 229376, 32), 0.2883),
]


@pytest.mark.parametrize("kind, shape, ms", MEASURED)
def test_bound_under_the_measured_time(kind, shape, ms):
    bound_ms = 1e3 * bounds.bound_seconds(kind, shape)
    assert 0.0 < bound_ms < ms


def test_bytes_by_hand():
    assert bounds.bound_bytes("bilinear_fwd", 32, 16384, 4) == 32 * 16384 * (2 * 4 + 4 * 4)
    assert bounds.bound_bytes("bilinear_bwd", 32, 16384, 4) == 32 * 16384 * (4 * 4 + 2 * 4 + 2 * 4)
    assert bounds.bound_bytes("lift_fwd", 10, 229376, 32) == 10 * 229376 * (3 * 4 + 1 + 32 * 4)


@pytest.mark.parametrize("workload, kinds", [
    ("stylegan_ffhq.f32_r1", {"bilinear_fwd": ((32, 16384, 4), 1), "bilinear_bwd": ((32, 16384, 4), 1)}),
    ("deepvoxels_car.f32", {"bilinear_fwd": ((10, 4096, 4), 1), "bilinear_bwd": ((10, 4096, 4), 1),
                            "lift_fwd": ((10, 229376, 32), 2), "lift_bwd": ((10, 229376, 32), 1)}),
])
def test_call_shapes(workload, kinds):
    cell = load_cell(workload)
    assert cell.architecture.kernel_calls(cell.local_batch, cell.image_px) == kinds


@pytest.mark.parametrize("name, kind", [
    ("void (anonymous namespace)::bilinear_fwd_kernel<true, true>(float const*, float*)", "bilinear_fwd"),
    ("void bilinear_bwd_vec4_kernel<true>(float const*)", "bilinear_bwd"),
    ("void bilinear_fwd_lanes_kernel<true, 32, 9>(float const*)", "bilinear_fwd"),
    ("void lift_fwd_vec4_kernel<false, true>(float const*)", "lift_fwd"),
    ("void lift_bwd_vec4_kernel<false, true>(float const*)", "lift_bwd"),
    ("sm80_xmma_fprop_implicit_gemm_f32f32", None),
])
def test_kinds_by_name(name, kind):
    assert bounds.kind_of(name) == kind
