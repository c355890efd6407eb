"""Which hand-written kernel takes a call on the card, decided in Python
from dtype, shape and alignment alone (never on a failure): K6's
``conv.route`` and the lift's ``trilinear.fwd_route`` and ``bwd_route``. Also that
K6's measuring launcher refuses a kernel its route would not pick, before
it touches a device, and that the CPU path launches nothing. Imports no JAX.
"""

import pytest
import torch

from rgbd_gan_tpu_torch.ops import conv, trilinear


@pytest.mark.parametrize("dtype,cin,cout,ptr,want", [
    (torch.bfloat16, 64, 64, 0, "tc"),  # the benchmark's shapes
    (torch.bfloat16, 256, 256, 4096, "tc"),
    (torch.bfloat16, 24, 72, 16, "tc"),  # ragged against the tiles, but TMA can address it
    (torch.bfloat16, 8, 8, 32, "tc"),
    (torch.bfloat16, 16, 256, 48, "tc"),
    (torch.bfloat16, 256, 4, 0, "fma"),  # Cout 4: a row of 8 bytes
    (torch.float32, 64, 64, 0, "fma"),  # TF32 would change float32's numbers
    (torch.float32, 256, 256, 0, "fma"),
    (torch.bfloat16, 3, 5, 0, "fma"),  # the CPU tests' shape: TMA needs strides of 16 bytes
    (torch.bfloat16, 64, 60, 0, "fma"),
    (torch.bfloat16, 12, 64, 0, "fma"),
    (torch.bfloat16, 64, 64, 2, "fma"),  # x 2 bytes past an aligned address
    (torch.bfloat16, 64, 64, 8, "fma"),
])
def test_conv_route(dtype, cin, cout, ptr, want):
    assert conv.route(dtype, cin, cout, ptr) == want


@pytest.mark.parametrize("c,ptr,want", [
    (32, 0, "vec4"),  # every path's C
    (4, 16, "vec4"),
    (12, 0, "vec4"),
    (64, 256, "vec4"),
    (8, 16, "vec4"),
    (36, 0, "vec4"),  # 9 groups of 4 channels
    (2, 0, "generic"),
    (32, 8, "generic"),  # 8 bytes past an aligned address
    (3, 0, "generic"),
    (5, 0, "generic"),
    (32, 4, "generic"),  # the grid 4 bytes past an aligned address
])
def test_lift_forward_route(c, ptr, want):
    assert trilinear.fwd_route(c, ptr) == want


@pytest.mark.parametrize("c,ptr,want", [
    (32, 0, "vec4"),  # every path's C
    (4, 16, "vec4"),
    (8, 32, "vec4"),
    (12, 0, "vec4"),
    (64, 256, "vec4"),
    (6, 0, "generic"),
    (3, 0, "generic"),
    (32, 4, "generic"),  # the cotangent 4 bytes past an aligned address
    (32, 8, "generic"),
    (4, 12, "generic"),
])
def test_lift_backward_route(c, ptr, want):
    assert trilinear.bwd_route(c, ptr) == want


def test_the_cpu_path_launches_no_kernel():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 8, 8, 16, generator=gen).to(torch.bfloat16)
    k = (torch.randn(3, 3, 16, 8, generator=gen) * 0.1).to(torch.bfloat16)
    bias = torch.zeros(8, dtype=torch.bfloat16)
    conv.reset_launches()
    trilinear.reset_launches()
    conv.conv3x3_bias_lrelu(x, k, bias)
    voxel = torch.randn(1, 4, 4, 4, 8, generator=gen)
    coords = torch.rand(1, 3, 32, generator=gen) * 3
    trilinear.trilinear_lift(voxel, coords, torch.ones(1, 32, dtype=torch.bool))
    assert conv.launches == {"conv3x3": 0, "conv3x3_tc": 0}
    assert not any(trilinear.launches.values())


@pytest.mark.parametrize("dtype,cin,cout,offset,which", [
    (torch.float32, 16, 16, 0, "tc"),
    (torch.bfloat16, 3, 8, 0, "tc"),
    (torch.bfloat16, 16, 12, 0, "tc"),
    (torch.bfloat16, 16, 16, 1, "tc"),  # x one element (2 bytes) past an aligned address
    (torch.bfloat16, 16, 16, 0, "mma"),  # no such kernel
])
def test_conv_launch_refuses_a_kernel_that_does_not_take_the_call(dtype, cin, cout, offset, which):
    """``conv.launch(..., which=)`` is for measurements; it never sends a call
    to a kernel that :func:`conv.route` would not pick for it, and says so
    before any device is touched (these tensors lie on the CPU)."""
    shape = (1, 8, 4, cin)
    x = torch.zeros(offset + 8 * 4 * cin, dtype=dtype)[offset:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2 * offset
    k = torch.zeros(3, 3, cin, cout, dtype=dtype)
    bias = torch.zeros(cout, dtype=dtype)
    with pytest.raises(ValueError, match="does not take"):
        conv.launch(x, k, bias, which=which)
