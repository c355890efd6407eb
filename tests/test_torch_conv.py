"""The fused 3x3 conv + bias + leaky ReLU of ``rgbd_gan_tpu_torch.ops.conv``
against the JAX package's Pallas function (``conv3x3_bias_lrelu`` in
interpret mode) on the CPU, where the port's wrapper runs its plain
version; and the refusals both share. The same numpy arrays (HWIO weights)
go to both packages.

Tolerances: float32 atol 1e-5 + rtol 1e-5 (the two sum the taps' products in
another order); bfloat16 one bf16 ulp of the larger of the two values, plus
the same 1e-5 for the float32 sums' order before the one rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rgbd_gan_tpu.ops.conv_pallas import conv3x3_bias_lrelu as jax_conv3x3
from rgbd_gan_tpu_torch.ops import conv
from rgbd_gan_tpu_torch.tools import bench_conv

ATOL, RTOL = 1e-5, 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def one_thread():
    """The suite runs several worker processes at once: take one core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _arrays(shape, seed):
    b, h, w, cin, cout = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) * 0.3).astype(np.float32)
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    return x, k, bias


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(2, 16, 12, 8, 16), (1, 8, 8, 3, 5), (2, 24, 16, 16, 32)])
def test_plain_version_matches_pallas_interpret(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    x, k, bias = _arrays(shape, seed=sum(shape))
    want = jax_conv3x3(*(jnp.asarray(a).astype(jdt) for a in (x, k, bias)), interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    got = conv.conv3x3_bias_lrelu(*(torch.from_numpy(a).to(tdt) for a in (x, k, bias)))
    assert got.dtype == tdt and tuple(got.shape) == shape[:3] + (shape[4],)
    got = got.float()
    if tdt == torch.float32:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    else:
        ulp = bench_conv.bf16_ulp(torch.maximum(got.abs(), want.abs()))
        assert bool(((got - want).abs() <= ulp + ATOL).all())


def test_height_not_a_multiple_of_tile_h_is_refused_by_both():
    x, k, bias = _arrays((1, 12, 8, 3, 4), seed=0)
    with pytest.raises(AssertionError):
        jax_conv3x3(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), interpret=True)
    with pytest.raises(ValueError, match="TILE_H"):
        conv.conv3x3_bias_lrelu(*map(torch.from_numpy, (x, k, bias)))


@pytest.mark.parametrize("which", [0, 1, 2])
def test_inputs_that_require_grad_are_refused(which):
    args = [torch.from_numpy(a) for a in _arrays((1, 8, 8, 3, 4), seed=1)]
    args[which].requires_grad_(True)
    with pytest.raises(ValueError, match="forward only"):
        conv.conv3x3_bias_lrelu(*args)


@pytest.mark.parametrize("bad", ["kernel_shape", "bias_shape", "mixed_dtype", "float64"])
def test_shapes_and_dtypes_the_kernel_does_not_take_are_refused(bad):
    x, k, bias = map(torch.from_numpy, _arrays((1, 8, 8, 3, 4), seed=2))
    if bad == "kernel_shape":
        k = k[:, :, :2]
    elif bad == "bias_shape":
        bias = bias[:3]
    elif bad == "mixed_dtype":
        k = k.to(torch.bfloat16)
    else:
        x, k, bias = x.double(), k.double(), bias.double()
    with pytest.raises((ValueError, TypeError)):
        conv.conv3x3_bias_lrelu(x, k, bias)


def test_plain_version_matches_conv2d_and_counts_no_launch():
    x, k, bias = map(torch.from_numpy, _arrays((2, 16, 12, 8, 16), seed=3))
    want = F.leaky_relu(F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), bias, padding=1), 0.2)
    conv.reset_launches()
    got = conv.conv3x3_bias_lrelu(x, k, bias)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=RTOL, atol=ATOL)
    assert conv.launches == {"conv3x3": 0}


@pytest.mark.parametrize("dtype,bounds_ms,first_bound_by", [
    (torch.float32, [0.577, 1.154, 0.577, 1.154, 0.577], "operations"),
    (torch.bfloat16, [0.040, 0.078, 0.039, 0.078, 0.039], "bytes"),
])
def test_bench_bounds(dtype, bounds_ms, first_bound_by):
    """The least time for each shape: FLOPs over the dtype's peak or bytes
    over 3.35 TB/s, whichever is larger."""
    got = [bench_conv.bound(shape, dtype) for shape in bench_conv.SHAPES]
    assert [round(g["bound_ms"], 3) for g in got] == bounds_ms
    assert got[0]["bound_by"] == first_bound_by
    assert round(1e3 * got[0]["bytes"] / bench_conv.PEAK_BYTES_PER_S, 3) == (0.080 if dtype == torch.float32 else 0.040)


def test_bench_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would measure")
    assert bench_conv.main([]) != 0
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_conv.measure()


def test_bf16_ulp():
    t = torch.tensor([1.0, 1.5, 2.0, -3.0, 0.25])
    assert bench_conv.bf16_ulp(t).tolist() == [2**-7, 2**-7, 2**-6, 2**-6, 2**-9]
