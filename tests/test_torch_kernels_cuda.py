"""The CUDA kernels K1/K2 of ``rgbd_gan_tpu_torch.ops.bilinear``, K3/K4/K5
of ``rgbd_gan_tpu_torch.ops.trilinear`` and K6 of ``rgbd_gan_tpu_torch.ops.conv``
against their plain PyTorch versions, on the card. Without a GPU every test
here skips.

This file imports no JAX, so it also runs on a machine without it:
``python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py``.

K6 takes one of two kernels by ``conv.route``, the lift's forward and
backward one of two each by ``trilinear.fwd_route`` and ``bwd_route``, K1
and K2 one of two each by ``bilinear.fwd_route`` and ``bwd_route`` (C == 4:
the vectorised kernels; any other C: a group of lanes per point), and the
old thread-per-point kernels by name: each case checks which launch count
moved. Tolerance: atol 1e-5 on the forward and on du/dv (du/dv, sums over
the C channels, at atol 1e-5 x sqrt(C / 4) above C = 4); rtol 1e-5 / atol
1e-4 on d img, whose f32 atomics add in an order that changes from run to run. The
lift: rtol/atol 1e-5 on the float32 forward (fused multiply-adds against
separate ones), one bf16 ulp (rtol 2^-7) on the bf16 forward, and rtol 1e-5 /
atol 1e-4 on dV (atomics again). K6: largest absolute error 1e-4 x max|y|
in float32 (the taps' products summed in another order); in bfloat16 one
bf16 ulp of the larger value plus that float32 allowance, taken before the
one rounding.
"""

import numpy as np
import pytest
import torch

from rgbd_gan_tpu_torch.geometry.warp import bilinear_sample
from rgbd_gan_tpu_torch.geometry.camera import camera_matrices
from rgbd_gan_tpu_torch.models.deepvoxels import (
    DeepVoxelsGenerator,
    frustum_camera_coords,
    frustum_voxel_coords,
    lift_frustum,
)
from rgbd_gan_tpu_torch.ops import bilinear, conv, trilinear
from rgbd_gan_tpu_torch.tools.bench_conv import bf16_ulp

ATOL = 1e-5
CONV_REL = 1e-4  # K6 against its plain version, relative to max|y|
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(b, h, w, c, n, seed, device):
    rng = np.random.RandomState(seed)
    img = rng.rand(b, h, w, c).astype("f")
    u = ((rng.rand(b, n) * 1.4 - 0.2) * (h - 1)).astype("f")
    v = ((rng.rand(b, n) * 1.4 - 0.2) * (w - 1)).astype("f")
    u[:, ::7] = np.floor(u[:, ::7])
    v[:, ::5] = np.floor(v[:, ::5])
    g = rng.randn(b, n, c).astype("f")
    return [torch.tensor(a, device=device) for a in (img, u, v, g)]


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("shape", [(2, 16, 16, 4, 300), (2, 16, 24, 3, 257), (32, 128, 128, 4, 16384)])
def test_kernels_match_plain_version(cuda, exact, shape):
    img, u, v, g = _inputs(*shape, seed=3, device=cuda)
    out = bilinear._fwd(img, u, v, exact)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, bilinear.bilinear_gather_reference(img, u, v, exact), rtol=0, atol=ATOL)
    got = bilinear._bwd(img, u, v, g, exact)
    torch.cuda.synchronize()
    want = bilinear.bilinear_gather_reference_vjp(img, u, v, g, exact)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
    for a, b_ in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b_, rtol=0, atol=ATOL)


@pytest.mark.parametrize("exact", [True, False])
def test_kernels_match_plain_version_at_the_feature_gather_shape(cuda, exact):
    """The feature 3D-consistency loss's gather (D's 32x32 tap of 256
    features plus a depth channel): K1 and K2 with a warp per point. du and
    dv sum 257 channels: atol 1e-5 * sqrt(C / 4)."""
    img, u, v, g = _inputs(32, 32, 32, 257, 1024, seed=5, device=cuda)
    assert bilinear.fwd_route(257) == "lanes" and bilinear.bwd_route(257) == "lanes"
    before = dict(bilinear.launches)
    out = bilinear._fwd(img, u, v, exact)
    got = bilinear._bwd(img, u, v, g, exact)
    torch.cuda.synchronize()
    assert bilinear.launches == {**before, "fwd_lanes": before["fwd_lanes"] + 1,
                                 "bwd_lanes": before["bwd_lanes"] + 1}
    torch.testing.assert_close(out, bilinear.bilinear_gather_reference(img, u, v, exact), rtol=0, atol=ATOL)
    want = bilinear.bilinear_gather_reference_vjp(img, u, v, g, exact)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
    for a, b_ in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b_, rtol=0, atol=ATOL * np.sqrt(257 / 4))


def test_nan_and_inf_points_read_nothing_and_give_zero(cuda):
    img, u, v, g = _inputs(2, 16, 16, 4, 300, seed=4, device=cuda)
    u[:, :8] = float("nan")
    v[:, 8:16] = float("inf")
    u[:, 16:24] = -1e30
    out = bilinear._fwd(img, u, v, True)
    dimg, du, dv = bilinear._bwd(img, u, v, g, True)
    torch.cuda.synchronize()
    assert torch.all(out[:, :24] == 0) and torch.all(du[:, :24] == 0) and torch.all(dv[:, :24] == 0)
    assert torch.isfinite(dimg).all()


def test_autograd_counts_one_launch_each_and_matches_cpu(cuda):
    img, u, v, g = _inputs(2, 16, 16, 4, 300, seed=5, device=cuda)
    before = dict(bilinear.launches)
    ti = img.clone().requires_grad_(True)
    tu, tv = u.clone().requires_grad_(True), v.clone().requires_grad_(True)
    bilinear.bilinear_gather(ti, tu, tv).backward(g)
    # C = 4 with aligned tensors: the vectorised backward
    assert bilinear.launches == {**before, "fwd": before["fwd"] + 1, "bwd_vec4": before["bwd_vec4"] + 1}
    ci, cu, cv = (t.detach().cpu().requires_grad_(True) for t in (img, u, v))
    bilinear.bilinear_gather(ci, cu, cv).backward(g.cpu())
    for a, b_ in ((ti, ci), (tu, cu), (tv, cv)):
        torch.testing.assert_close(a.grad.cpu(), b_.grad, rtol=1e-5, atol=1e-4)


def test_bilinear_sample_every_mode_uses_the_kernels(cuda):
    rng = np.random.RandomState(7)
    img = torch.tensor(rng.rand(2, 16, 16, 4).astype("f"), device=cuda)
    zp = torch.tensor((rng.rand(2, 300, 3) * np.array([20, 20, 1.2]) - np.array([2, 2, 0])).astype("f"),
                      device=cuda)
    ref, ref_mask = bilinear_sample(img.cpu(), zp.cpu(), gather_mode="xla")
    for mode in ("xla", "onehot", "hybrid", "pallas"):
        before = dict(bilinear.launches)
        ti = img.clone().requires_grad_(True)
        out, mask = bilinear_sample(ti, zp, gather_mode=mode)
        out.sum().backward()
        assert bilinear.launches == {**before, "fwd": before["fwd"] + 1, "bwd_vec4": before["bwd_vec4"] + 1}
        torch.testing.assert_close(out.detach().cpu(), ref, rtol=0, atol=ATOL)
        torch.testing.assert_close(mask.cpu(), ref_mask, rtol=0, atol=0)


def _warp_inputs(b, h, w, c, n, seed, device):
    """Points as the 3D loss gathers them: one per source pixel in row-major
    order, ceil(n / w) rows of w cut to n, under a smooth warp close to the
    identity (some out of bounds at the edges, some on integer
    coordinates)."""
    rng = np.random.RandomState(seed)
    r, col = np.meshgrid(np.arange(-(-n // w), dtype="f"), np.arange(w, dtype="f"), indexing="ij")
    ph = rng.rand(b, 2, 1, 1).astype("f") * 6.0
    u = r * 1.02 - 0.1 + 0.3 * np.sin(col / 5.0 + ph[:, 0])
    v = col * 0.97 + 0.2 + 0.3 * np.cos(r / 7.0 + ph[:, 1])
    u, v = u.reshape(b, -1)[:, :n].astype("f"), v.reshape(b, -1)[:, :n].astype("f")
    u[:, ::13] = np.floor(u[:, ::13])
    v[:, ::11] = np.floor(v[:, ::11])
    img = rng.rand(b, h, w, c).astype("f")
    g = rng.randn(b, n, c).astype("f")
    return [torch.tensor(np.ascontiguousarray(a), device=device) for a in (img, u, v, g)]


def _assert_bwd_matches(img, u, v, g, exact, route_key, route=None):
    before = dict(bilinear.launches)
    dimg, du, dv = bilinear._bwd(img, u, v, g, exact, route=route)
    torch.cuda.synchronize()
    assert bilinear.launches == {**before, route_key: before[route_key] + 1}
    want = bilinear.bilinear_gather_reference_vjp(img, u, v, g, exact)
    duv_atol = ATOL * max(1.0, np.sqrt(img.shape[3] / 4))  # sums over C channels
    torch.testing.assert_close(dimg, want[0], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(du, want[1], rtol=0, atol=duv_atol)
    torch.testing.assert_close(dv, want[2], rtol=0, atol=duv_atol)
    if exact:
        assert torch.all(du == 0)
    return dimg, du, dv


@pytest.mark.parametrize("points", ["random", "warp"])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("shape", [(2, 16, 16, 4, 300), (2, 16, 24, 4, 257), (32, 128, 128, 4, 16384)])
def test_backward_vec4_matches_plain_version(cuda, shape, exact, points):
    c = shape[3]
    # n = 257 and 300 are no multiple of a run: runs cross from one image into the next
    img, u, v, g = (_inputs if points == "random" else _warp_inputs)(*shape, seed=8, device=cuda)
    assert bilinear.bwd_route(c) == "vec4"
    _assert_bwd_matches(img, u, v, g, exact, "bwd_vec4")


@pytest.mark.parametrize("exact", [True, False])
def test_backward_vec4_masked_points_inside_a_run(cuda, exact):
    img, u, v, g = _warp_inputs(2, 16, 16, 4, 256, seed=9, device=cuda)
    n = u.shape[1]
    # masked points at every position of a run, NaN and inf among them, with
    # a NaN cotangent that the kernel must not read
    for pos, bad in ((1, float("nan")), (2, float("inf")), (5, -3.0), (11, 40.0)):
        u[:, pos::17] = bad
    v[:, 7::19] = float("nan")
    masked = ~((u >= 0) & (u < 15) & (v >= 0) & (v < 15))
    g[masked] = float("nan")
    assert int(masked.sum()) > n // 4
    dimg, du, dv = _assert_bwd_matches(img, u, v, g, exact, "bwd_vec4")
    assert torch.isfinite(dimg).all()
    assert torch.all(du[masked] == 0) and torch.all(dv[masked] == 0)


def test_backward_vec4_nan_and_inf_points_read_nothing(cuda):
    img, u, v, g = _inputs(2, 16, 16, 4, 300, seed=4, device=cuda)
    u[:, :8] = float("nan")
    v[:, 8:16] = float("inf")
    u[:, 16:24] = -1e30
    before = bilinear.launches["bwd_vec4"]
    dimg, du, dv = bilinear._bwd(img, u, v, g, True)
    torch.cuda.synchronize()
    assert bilinear.launches["bwd_vec4"] == before + 1
    assert torch.all(du[:, :24] == 0) and torch.all(dv[:, :24] == 0)
    assert torch.isfinite(dimg).all()


@pytest.mark.parametrize("exact", [True, False])
def test_backward_generic_route_for_three_channels_or_by_name(cuda, exact):
    img, u, v, g = _inputs(2, 16, 24, 3, 257, seed=10, device=cuda)
    # three channels take the lanes kernel, the thread-per-point one only by name
    assert bilinear.bwd_route(3) == "lanes"
    _assert_bwd_matches(img, u, v, g, exact, "bwd_lanes")
    _assert_bwd_matches(img, u, v, g, exact, "bwd", route="generic")
    with pytest.raises(ValueError, match="does not take"):
        bilinear._bwd(img, u, v, g, exact, route="vec4")
    # the old kernel by name, on a call the vectorised one takes
    img, u, v, g = _inputs(2, 16, 24, 4, 257, seed=11, device=cuda)
    _assert_bwd_matches(img, u, v, g, exact, "bwd", route="generic")


@pytest.mark.parametrize("exact", [True, False])
def test_backward_copies_an_unaligned_cotangent_onto_the_vectorised_kernel(cuda, exact):
    img, u, v, g = _inputs(2, 16, 24, 4, 257, seed=11, device=cuda)
    shifted = torch.empty(g.numel() + 1, device=cuda)[1:].view(g.shape)
    shifted.copy_(g)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    # the wrapper refuses it on either route; the autograd backward copies it
    for route in (None, "generic"):
        with pytest.raises(ValueError, match="aligned"):
            bilinear._bwd(img, u, v, shifted, exact, route=route)
    leaves = [t.clone().requires_grad_(True) for t in (img, u, v)]
    before = dict(bilinear.launches)
    bilinear.bilinear_gather(*leaves, exact=exact).backward(shifted)
    torch.cuda.synchronize()
    assert bilinear.launches == {**before, "fwd": before["fwd"] + 1, "bwd_vec4": before["bwd_vec4"] + 1}
    want = bilinear.bilinear_gather_reference_vjp(img, u, v, g, exact)
    torch.testing.assert_close(leaves[0].grad, want[0], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(leaves[1].grad, want[1], rtol=0, atol=ATOL)
    torch.testing.assert_close(leaves[2].grad, want[2], rtol=0, atol=ATOL)


def _assert_fwd_matches(img, u, v, exact, route_key, route=None):
    before = dict(bilinear.launches)
    out = bilinear._fwd(img, u, v, exact, route=route)
    torch.cuda.synchronize()
    assert bilinear.launches == {**before, route_key: before[route_key] + 1}
    torch.testing.assert_close(out, bilinear.bilinear_gather_reference(img, u, v, exact), rtol=0, atol=ATOL)
    return out


@pytest.mark.parametrize("points", ["random", "warp"])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("c", [1, 2, 3, 5, 12, 20, 33, 65, 100, 257, 600])
def test_lanes_kernels_match_plain_version(cuda, c, exact, points):
    """K1 and K2 with a group of lanes per point, every instance: fewer
    lanes than a warp (C = 1, 2, 3, 5, 12), a warp with most of its nine
    register slots a lane predicated off (20, 33, 65, 100), a warp with a
    ragged last channel (257: no multiple of 32, the slots just fill), and
    more channels than a warp holds in registers at once (600: chunks of
    288, the last ragged)."""
    img, u, v, g = (_inputs if points == "random" else _warp_inputs)(2, 16, 24, c, 300, seed=12, device=cuda)
    assert bilinear.fwd_route(c) == "lanes" and bilinear.bwd_route(c) == "lanes"
    _assert_fwd_matches(img, u, v, exact, "fwd_lanes")
    _assert_bwd_matches(img, u, v, g, exact, "bwd_lanes")


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("c", [3, 33, 257])
def test_lanes_kernels_nan_inf_and_out_of_bounds_points(cuda, c, exact):
    """Masked points (NaN, inf, far off the grid) give 0 and receive no
    gradient, and read no cotangent: theirs is NaN. A batch whose every
    point lies out of bounds gives zeros throughout."""
    img, u, v, g = _inputs(3, 16, 16, c, 300, seed=13, device=cuda)
    u[0, :8] = float("nan")
    v[0, 8:16] = float("inf")
    u[0, 16:24] = -1e30
    v[1] = 15.0  # the whole of image 1: v < W - 1 fails
    masked = ~((u >= 0) & (u < 15) & (v >= 0) & (v < 15))
    g[masked] = float("nan")
    out = _assert_fwd_matches(img, u, v, exact, "fwd_lanes")
    dimg, du, dv = _assert_bwd_matches(img, u, v, g.nan_to_num(0.0), exact, "bwd_lanes")
    got = bilinear._bwd(img, u, v, g, exact)
    torch.cuda.synchronize()
    assert torch.all(out[masked] == 0) and torch.all(out[1] == 0)
    assert torch.isfinite(got[0]).all() and torch.all(got[0][1] == 0)
    for a in got[1:]:
        assert torch.all(a[masked] == 0)
    torch.testing.assert_close(got[0], dimg, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("c", [3, 257])
def test_forced_generic_route_matches_the_lanes_route(cuda, c, exact):
    """The thread-per-point kernels, forced by name for measurements, and
    the lanes kernels compute the same gather."""
    img, u, v, g = _inputs(4, 32, 32, c, 1024, seed=14, device=cuda)
    lanes = _assert_fwd_matches(img, u, v, exact, "fwd_lanes")
    generic = _assert_fwd_matches(img, u, v, exact, "fwd", route="generic")
    torch.testing.assert_close(lanes, generic, rtol=0, atol=ATOL)
    d_lanes = _assert_bwd_matches(img, u, v, g, exact, "bwd_lanes")
    d_generic = _assert_bwd_matches(img, u, v, g, exact, "bwd", route="generic")
    torch.testing.assert_close(d_lanes[0], d_generic[0], rtol=1e-5, atol=1e-4)
    for a, b_ in zip(d_lanes[1:], d_generic[1:]):
        torch.testing.assert_close(a, b_, rtol=0, atol=ATOL * max(1.0, np.sqrt(c / 4)))
    with pytest.raises(ValueError, match="does not take"):
        bilinear._fwd(img, u, v, exact, route="vec4")


def test_autograd_at_the_feature_gather_width_launches_the_lanes_kernels(cuda):
    img, u, v, g = _inputs(2, 32, 32, 257, 1024, seed=15, device=cuda)
    before = dict(bilinear.launches)
    leaves = [t.clone().requires_grad_(True) for t in (img, u, v)]
    bilinear.bilinear_gather(*leaves).backward(g)
    torch.cuda.synchronize()
    assert bilinear.launches == {**before, "fwd_lanes": before["fwd_lanes"] + 1,
                                 "bwd_lanes": before["bwd_lanes"] + 1}
    want = bilinear.bilinear_gather_reference_vjp(img, u, v, g, True)
    torch.testing.assert_close(leaves[0].grad, want[0], rtol=1e-5, atol=1e-4)
    for leaf, w in zip(leaves[1:], want[1:]):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=ATOL * np.sqrt(257 / 4))


def test_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    img, u, v, _ = _inputs(2, 16, 16, 4, 300, seed=6, device=cuda)
    with pytest.raises(ValueError):
        bilinear.bilinear_gather(img.transpose(1, 2), u, v)  # not contiguous
    with pytest.raises(TypeError):
        bilinear.bilinear_gather(img.half(), u.half(), v.half())
    with pytest.raises(ValueError):
        bilinear.bilinear_gather(img, u.cpu(), v)


# ---------------------------------------------------------------------------
# the trilinear lift: K3, K4 and the windowed pair K5
# ---------------------------------------------------------------------------


def _lift_inputs(b, g, c, n, seed, device, spread=1.3):
    """A grid that differs along every axis, coordinates inside and outside
    it, integer coordinates, and cells in the last plane of each axis."""
    rng = np.random.RandomState(seed)
    voxel = rng.randn(b, g, g, g, c).astype("f")
    coords = ((rng.rand(b, 3, n) * spread - (spread - 1) / 2) * g).astype("f")
    coords[:, :, ::7] = np.floor(coords[:, :, ::7])
    coords[:, 0, 1::11] = g - 0.25
    coords[:, 1, 2::13] = g - 0.5
    coords[:, 2, 3::17] = g - 0.75
    mask = np.all((coords >= 0) & (coords < g), axis=1)
    cot = rng.randn(b, n, c).astype("f")
    return [torch.tensor(a, device=device) for a in (voxel, coords, mask, cot)]


def _frustum_inputs(b, c, seed, device):
    rng = np.random.RandomState(seed)
    voxel = torch.tensor(rng.randn(b, 32, 32, 32, c).astype("f"), device=device)
    thetas = torch.tensor((rng.uniform(-1, 1, (b, 6)) * [0.3054, 3.1415, 0, 0, 0, 0]).astype("f"), device=device)
    coords_const = torch.tensor(frustum_camera_coords(), device=device)
    vox, mask = frustum_voxel_coords(camera_matrices(thetas), coords_const)
    cot = torch.tensor(rng.randn(b, vox.shape[2], c).astype("f"), device=device)
    return voxel, vox.contiguous(), mask, cot


def _assert_lift_matches(voxel, coords, mask, cot, dtype, window):
    out = trilinear._fwd(voxel, coords, mask, dtype, window)
    dv = trilinear._bwd(voxel.shape, coords, mask, cot, dtype, window)
    torch.cuda.synchronize()
    rtol = 1e-5 if dtype == torch.float32 else 2.0**-7
    torch.testing.assert_close(out, trilinear.trilinear_lift_reference(voxel, coords, mask, dtype, window),
                               rtol=rtol, atol=1e-5)
    torch.testing.assert_close(
        dv, trilinear.trilinear_lift_reference_vjp(voxel.shape, coords, mask, cot, dtype, window),
        rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("window", [None, 4], ids=["full", "win"])
@pytest.mark.parametrize("shape", [(2, 8, 3, 2048), (1, 16, 32, 1024), (3, 8, 5, 3072)])
def test_lift_kernels_match_plain_version(cuda, dtype, window, shape):
    """Random coordinates: with a window of 4 planes the tiles' valid cells
    span more than the window, so the window rule itself is compared."""
    _assert_lift_matches(*_lift_inputs(*shape, seed=11, device=cuda), dtype, window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("window", [None, 16], ids=["full", "win"])
def test_lift_kernels_match_plain_version_on_a_frustum(cuda, dtype, window):
    _assert_lift_matches(*_frustum_inputs(2, 32, seed=12, device=cuda), dtype, window)


def test_full_lift_takes_any_number_of_cells(cuda):
    _assert_lift_matches(*_lift_inputs(2, 8, 3, 1500, seed=13, device=cuda), torch.float32, None)
    voxel, coords, mask, _ = _lift_inputs(2, 8, 3, 1500, seed=13, device=cuda)
    with pytest.raises(ValueError):
        trilinear.trilinear_lift(voxel, coords, mask, None, 4)  # a window needs whole tiles


def test_lift_masked_cells_with_wild_coordinates_read_nothing(cuda):
    voxel, coords, mask, cot = _lift_inputs(2, 8, 3, 2048, seed=14, device=cuda)
    coords[:, :, :8] = float("nan")
    coords[:, 0, 8:16] = float("inf")
    coords[:, 1, 16:24] = -1e30
    mask[:, :24] = False
    for window in (None, 4):
        out = trilinear._fwd(voxel, coords, mask, None, window)
        dv = trilinear._bwd(voxel.shape, coords, mask, cot, None, window)
        torch.cuda.synchronize()
        assert torch.all(out[:, :24] == 0) and torch.isfinite(out).all() and torch.isfinite(dv).all()


def test_lift_autograd_counts_launches_and_matches_cpu(cuda):
    voxel, coords, mask, cot = _lift_inputs(2, 8, 3, 2048, seed=15, device=cuda)
    for window, keys in ((None, ("fwd", "bwd")), (8, ("fwd_win", "bwd_win"))):
        before = dict(trilinear.launches)
        tv = voxel.clone().requires_grad_(True)
        # a strided cotangent reaches the kernel contiguous
        out = trilinear.trilinear_lift(tv, coords, mask, None, window)
        out.backward(cot.transpose(0, 1).contiguous().transpose(0, 1))
        want = dict(before)
        for k in keys:
            want[k] += 1
        assert trilinear.launches == want
        cv = voxel.cpu().requires_grad_(True)
        trilinear.trilinear_lift(cv, coords.cpu(), mask.cpu(), None, window).backward(cot.cpu())
        torch.testing.assert_close(tv.grad.cpu(), cv.grad, rtol=1e-5, atol=1e-4)


def test_lift_frustum_every_mode_uses_the_kernels(cuda):
    """The reference is the plain lift on the CPU from the card's own frustum
    coordinates: coordinates from the CPU's matmul differ by 1e-5 cells and
    flip the mask of cells on the grid's faces."""
    voxel, _, _, _ = _frustum_inputs(1, 4, seed=16, device=cuda)
    mats = camera_matrices(torch.tensor([[0.2, 2.2, 0, 0, 0, 0]], device=cuda))
    coords_const = torch.tensor(frustum_camera_coords(), device=cuda)
    vox, mask = frustum_voxel_coords(mats, coords_const)
    ref = trilinear.trilinear_lift(voxel.cpu(), vox.cpu(), mask.cpu()).reshape(1, 56, 64, 64, 4)
    # C = 4: every forward on the vectorised kernel
    for mode, key, atol in (("gather", "fwd_vec4", 1e-5), ("pallas_f32", "fwd_vec4", 1e-5),
                            ("pallas", "fwd_vec4", 0.05), ("pallas_win_f32", "fwd_win_vec4", 1e-5),
                            ("pallas_win", "fwd_win_vec4", 0.05)):
        before = trilinear.launches[key]
        out = lift_frustum(voxel, mats, coords_const, mode)
        assert trilinear.launches[key] == before + 1
        torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=atol)


@pytest.mark.parametrize("occlusion_type", ["accumulative", "deepvoxels"])
def test_deepvoxels_generator_on_the_card_matches_cpu(cuda, occlusion_type):
    """Float32 lift on both devices; rtol/atol 1e-3 on the output (f32 convs
    in another summation order, TF32 off) and on the BatchNorm statistics."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(17)
    z, z2 = (torch.tensor(rng.randn(2, 16).astype("f")) for _ in range(2))
    mats = camera_matrices(torch.tensor((rng.uniform(-1, 1, (2, 6)) * [0.3054, 3.1415, 0, 0, 0, 0]).astype("f")))
    outs, stats = {}, {}
    for device in ("cpu", cuda):
        gen = DeepVoxelsGenerator(16, occlusion_type=occlusion_type, lift_mode="pallas_win_f32",
                                  generator=torch.Generator().manual_seed(0))  # same weights
        gen.to(device).requires_grad_(False)
        before = trilinear.launches["fwd_win_vec4"]  # C = 32: the vectorised forward
        outs[str(device)] = gen(z.to(device), mats.to(device), z2.to(device)).cpu()
        assert trilinear.launches["fwd_win_vec4"] == before + (device != "cpu")
        stats[str(device)] = {k: v.cpu() for k, v in gen.state_dict().items() if k.endswith(("mean", "var"))}
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=1e-3, atol=1e-3)
    assert (len(stats["cpu"]) == 4) == (occlusion_type == "deepvoxels")
    for k, v in stats["cpu"].items():
        torch.testing.assert_close(stats["cuda"][k], v, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("window,n", [(None, 1500), (4, 2048)], ids=["full_ragged", "win"])
@pytest.mark.parametrize("c", [32, 12, 3])
def test_lift_forward_routes_match_plain_version(cuda, c, window, n, dtype):
    """The vectorised forward (C % 4 == 0; 8 threads a cell at C = 32, 2 at
    C = 12) and the thread-per-(cell, channel) kernel against the plain
    version, each call counted on its own kernel; N = 1500 leaves a ragged
    last tile (the window needs whole tiles of 1024 cells)."""
    voxel, coords, mask, _ = _lift_inputs(2, 8, c, n, seed=24, device=cuda)
    chosen = trilinear.fwd_route(c, voxel.data_ptr())
    assert chosen == ("generic" if c == 3 else "vec4")
    want = trilinear.trilinear_lift_reference(voxel, coords, mask, dtype, window)
    rtol = 1e-5 if dtype == torch.float32 else 2.0**-7
    routes = ("generic",) if c == 3 else ("vec4", "generic")
    for route in routes:
        key = ("fwd" if window is None else "fwd_win") + ("_vec4" if route == "vec4" else "")
        before = dict(trilinear.launches)
        # the chosen kernel through the wrapper's own choice, the other one by name
        got = trilinear._fwd(voxel, coords, mask, dtype, window, route=route if route != chosen else None)
        torch.cuda.synchronize()
        assert trilinear.launches == {**before, key: before[key] + 1}
        torch.testing.assert_close(got, want, rtol=rtol, atol=1e-5)
    if c == 3:
        with pytest.raises(ValueError, match="route"):
            trilinear._fwd(voxel, coords, mask, dtype, window, route="vec4")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("window", [None, 16], ids=["full", "win"])
@pytest.mark.parametrize("c", [4, 8, 32])
def test_lift_backward_vec4_matches_plain_version(cuda, c, window, dtype):
    """The vectorised backward (4 channels a thread, corner sums of a run of
    cells merged in registers, vector reductions) against the plain VJP,
    at 1, 2 and 8 threads a cell; random coordinates, so runs of one corner
    base are short, and a frustum at C = 32, where they are long."""
    cases = [_lift_inputs(2, 16, c, 2048, seed=25, device=cuda)]
    if c == 32:
        voxel, vox, mask, cot = _frustum_inputs(2, 32, seed=26, device=cuda)
        cases.append((voxel, vox, mask, cot))
    for voxel, coords, mask, cot in cases:
        assert trilinear.bwd_route(c, cot.data_ptr()) == "vec4"
        key = "bwd_vec4" if window is None else "bwd_win_vec4"
        before = dict(trilinear.launches)
        got = trilinear._bwd(voxel.shape, coords, mask, cot, dtype, window)
        torch.cuda.synchronize()
        assert trilinear.launches == {**before, key: before[key] + 1}
        want = trilinear.trilinear_lift_reference_vjp(voxel.shape, coords, mask, cot, dtype, window)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("window", [None, 4], ids=["full", "win"])
def test_lift_backward_vec4_masked_cells_give_zero(cuda, window):
    """A tile with no valid cell adds nothing; masked cells with NaN, inf
    or far coordinates and a NaN cotangent read nothing and add nothing."""
    voxel, coords, mask, cot = _lift_inputs(2, 8, 8, 3072, seed=27, device=cuda)
    mask[:, 1024:2048] = False  # the middle tile of each batch item: all masked
    coords[:, :, 1024:2048] = float("nan")
    cot[:, 1024:2048] = float("nan")
    coords[:, 0, :8] = float("inf")
    coords[:, 1, 8:16] = -1e30
    coords[:, 2, 16:24] = float("nan")
    mask[:, :24] = False
    cot[:, :24] = float("inf")
    before = dict(trilinear.launches)
    got = trilinear._bwd(voxel.shape, coords, mask, cot, None, window)
    torch.cuda.synchronize()
    key = "bwd_vec4" if window is None else "bwd_win_vec4"
    assert trilinear.launches == {**before, key: before[key] + 1}
    assert torch.isfinite(got).all()
    want = trilinear.trilinear_lift_reference_vjp(voxel.shape, coords, mask, cot, None, window)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    all_masked = torch.zeros_like(mask)
    got = trilinear._bwd(voxel.shape, coords, all_masked, cot, None, window)
    torch.cuda.synchronize()
    assert torch.all(got == 0)


@pytest.mark.parametrize("window", [None, 4], ids=["full", "win"])
def test_lift_backward_routes_generic_and_by_name(cuda, window):
    """C = 6 takes the thread-per-(cell, channel) kernel; at C = 8 the
    generic kernel taken by name agrees with the vectorised one, and a
    cotangent 4 bytes past an aligned address goes to the generic kernel."""
    key = "bwd" if window is None else "bwd_win"
    voxel, coords, mask, cot = _lift_inputs(2, 8, 6, 2048, seed=28, device=cuda)
    assert trilinear.bwd_route(6, cot.data_ptr()) == "generic"
    before = dict(trilinear.launches)
    got = trilinear._bwd(voxel.shape, coords, mask, cot, None, window)
    torch.cuda.synchronize()
    assert trilinear.launches == {**before, key: before[key] + 1}
    torch.testing.assert_close(got, trilinear.trilinear_lift_reference_vjp(voxel.shape, coords, mask, cot, None,
                                                                           window), rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="route"):
        trilinear._bwd(voxel.shape, coords, mask, cot, None, window, route="vec4")
    voxel, coords, mask, cot = _lift_inputs(2, 8, 8, 2048, seed=29, device=cuda)
    before = dict(trilinear.launches)
    generic = trilinear._bwd(voxel.shape, coords, mask, cot, torch.bfloat16, window, route="generic")
    vec4 = trilinear._bwd(voxel.shape, coords, mask, cot, torch.bfloat16, window)
    torch.cuda.synchronize()
    assert trilinear.launches == {**before, key: before[key] + 1, key + "_vec4": before[key + "_vec4"] + 1}
    torch.testing.assert_close(vec4, generic, rtol=1e-5, atol=1e-4)
    flat = torch.empty(cot.numel() + 1, device=cuda)
    shifted = flat[1:].view(cot.shape)
    shifted.copy_(cot)
    assert trilinear.bwd_route(8, shifted.data_ptr()) == "generic"
    before = dict(trilinear.launches)
    got = trilinear._bwd(voxel.shape, coords, mask, shifted, None, window)
    torch.cuda.synchronize()
    assert trilinear.launches == {**before, key: before[key] + 1}
    torch.testing.assert_close(got, trilinear.trilinear_lift_reference_vjp(voxel.shape, coords, mask, cot, None,
                                                                           window), rtol=1e-5, atol=1e-4)


def test_lift_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    voxel, coords, mask, _ = _lift_inputs(2, 8, 3, 2048, seed=18, device=cuda)
    with pytest.raises(TypeError):
        trilinear.trilinear_lift(voxel.half(), coords, mask)
    with pytest.raises(TypeError):
        trilinear.trilinear_lift(voxel, coords, mask, torch.float16)
    with pytest.raises(ValueError):
        trilinear.trilinear_lift(voxel, coords.cpu(), mask)
    with pytest.raises(ValueError):
        trilinear.trilinear_lift(voxel, coords[:, :2], mask)


def _conv_inputs(shape, dtype, seed, device):
    b, h, w, cin, cout = shape
    rng = np.random.RandomState(seed)
    arrays = (rng.randn(b, h, w, cin), rng.randn(3, 3, cin, cout) * 0.05, rng.randn(cout) * 0.1)
    return [torch.tensor(a.astype("f"), device=device).to(dtype) for a in arrays]


def _assert_conv_matches(x, k, bias, key):
    """K6 through the public wrapper against the plain version; ``key``: the
    launch count that must move by one (the other must not move)."""
    before = dict(conv.launches)
    got = conv.conv3x3_bias_lrelu(x, k, bias)
    torch.cuda.synchronize()
    assert conv.launches == {**before, key: before[key] + 1}
    assert got.dtype == x.dtype and tuple(got.shape) == tuple(x.shape[:3]) + (k.shape[3],)
    want = conv.conv3x3_bias_lrelu_reference(x, k, bias)
    got, want = got.float(), want.float()
    diff, allowed = (got - want).abs(), CONV_REL * want.abs().max()
    if x.dtype == torch.bfloat16:
        allowed = allowed + bf16_ulp(torch.maximum(got.abs(), want.abs()))
    assert bool((diff <= allowed).all()), float((diff - allowed).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (1, 8, 8, 3, 5),  # Cin 3, Cout 5: ragged chunk and channel tile, a W tile of 8 of 16
    (2, 16, 20, 24, 72),  # W, Cin and Cout not multiples of the tiles
    (32, 32, 32, 256, 256),  # the benchmark's last shape
])
def test_conv_kernel_matches_plain_version(cuda, shape, dtype):
    """Each call on the kernel its route names: bf16 with Cin, Cout % 8 == 0
    on the tensor cores, the rest on the FMA kernel."""
    x, k, bias = _conv_inputs(shape, dtype, seed=sum(shape), device=cuda)
    key = "conv3x3_tc" if conv.route(dtype, shape[3], shape[4], x.data_ptr()) == "tc" else "conv3x3"
    assert (key == "conv3x3_tc") == (dtype == torch.bfloat16 and shape[3] != 3)
    _assert_conv_matches(x, k, bias, key)


@pytest.mark.parametrize("shape", [
    (32, 32, 32, 256, 256),  # the benchmark's last shape: 4 x 32 pixel boxes, two 128-channel tiles
    (2, 16, 24, 24, 72),  # W 24 in a 32-wide box, Cin 24 of a 64-channel chunk, Cout 72 of 128
    (2, 8, 128, 64, 64),  # one row of 128 pixels, the 64-channel tile
    (1, 16, 200, 136, 8),  # W 200 over two 128-wide boxes, Cin 136 over three chunks, Cout 8
    (3, 8, 4, 16, 16),  # a 4-wide box of 32 rows, 24 of them below the image (zero-filled, masked)
], ids=["bench_32x32_256", "ragged", "row_of_128", "wide_deep", "narrow"])
def test_conv_tensor_core_kernel_matches_plain_version(cuda, shape):
    x, k, bias = _conv_inputs(shape, torch.bfloat16, seed=sum(shape) + 1, device=cuda)
    assert conv.route(x.dtype, shape[3], shape[4], x.data_ptr()) == "tc"
    _assert_conv_matches(x, k, bias, "conv3x3_tc")


def test_conv_tensor_core_kernel_takes_a_sliced_batch(cuda):
    """An image of the batch starts 16-byte aligned: the slice stays on the
    tensor cores and gives what the same images give alone."""
    x, k, bias = _conv_inputs((3, 16, 24, 24, 72), torch.bfloat16, seed=22, device=cuda)
    part = x[1:]
    assert part.data_ptr() != x.data_ptr() and part.data_ptr() % 16 == 0
    _assert_conv_matches(part, k, bias, "conv3x3_tc")
    torch.testing.assert_close(conv.conv3x3_bias_lrelu(part, k, bias), conv.conv3x3_bias_lrelu(x, k, bias)[1:],
                               rtol=0, atol=0)


@pytest.mark.parametrize("shape", [
    (2, 8, 24, 24, 40),  # W 24 of two 16-wide tiles, Cin 24 in three chunks, Cout 40 of a 64-channel tile
    (2, 16, 32, 64, 64),  # the 64-channel tile, 128 threads
    (1, 8, 16, 6, 66),  # Cin 6: 4-byte halo copies; Cout 66: 4-byte weight copies, two channel tiles
    (32, 64, 64, 128, 256),  # the benchmark's fourth shape
], ids=["ragged", "tile64", "copies4", "bench_64x64_128_256"])
def test_conv_fma_kernel_float32_matches_plain_version(cuda, shape):
    x, k, bias = _conv_inputs(shape, torch.float32, seed=sum(shape) + 2, device=cuda)
    assert conv.route(x.dtype, shape[3], shape[4], x.data_ptr()) == "fma"
    _assert_conv_matches(x, k, bias, "conv3x3")


def test_conv_fma_kernel_takes_unaligned_float32_operands(cuda):
    """x and the weights 4 bytes past a 16-byte-aligned address: the 4-byte
    copies, with the same values as the aligned call."""
    x, k, bias = _conv_inputs((2, 8, 24, 24, 40), torch.float32, seed=30, device=cuda)
    shifted = []
    for t in (x, k):
        flat = torch.empty(t.numel() + 1, device=cuda)
        s = flat[1:].view(t.shape)
        s.copy_(t)
        assert s.data_ptr() % 16 == 4
        shifted.append(s)
    _assert_conv_matches(shifted[0], shifted[1], bias, "conv3x3")
    torch.testing.assert_close(conv.conv3x3_bias_lrelu(shifted[0], shifted[1], bias),
                               conv.conv3x3_bias_lrelu(x, k, bias), rtol=0, atol=0)


def test_conv_fma_kernel_bfloat16_within_one_ulp(cuda):
    """The FMA kernel's bfloat16 instance (widened on load), taken by name
    at Cin 24, and by the route where Cout is not a multiple of 8."""
    for shape in ((2, 8, 24, 24, 40), (2, 8, 24, 24, 36)):
        x, k, bias = _conv_inputs(shape, torch.bfloat16, seed=sum(shape) + 3, device=cuda)
        before = dict(conv.launches)
        got = conv.launch(x, k, bias, which="fma").float()
        torch.cuda.synchronize()
        assert conv.launches == {**before, "conv3x3": before["conv3x3"] + 1}
        want = conv.conv3x3_bias_lrelu_reference(x, k, bias).float()
        allowed = CONV_REL * want.abs().max() + bf16_ulp(torch.maximum(got.abs(), want.abs()))
        assert bool(((got - want).abs() <= allowed).all())
    assert conv.route(torch.bfloat16, 24, 36, x.data_ptr()) == "fma"
    _assert_conv_matches(x, k, bias, "conv3x3")


def test_conv_unaligned_bf16_input_goes_to_the_fma_kernel(cuda):
    x, k, bias = _conv_inputs((2, 8, 12, 16, 8), torch.bfloat16, seed=23, device=cuda)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    shifted = flat[1:].view(x.shape)  # 2 bytes past an aligned address
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 and conv.route(x.dtype, 16, 8, shifted.data_ptr()) == "fma"
    _assert_conv_matches(shifted, k, bias, "conv3x3")


def test_conv_kernel_takes_strided_inputs(cuda):
    x, k, bias = _conv_inputs((2, 8, 12, 16, 8), torch.float32, seed=20, device=cuda)
    x_strided = x.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)  # the same values, other strides
    torch.testing.assert_close(conv.conv3x3_bias_lrelu(x_strided, k, bias), conv.conv3x3_bias_lrelu(x, k, bias),
                               rtol=0, atol=0)


def test_conv_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, k, bias = _conv_inputs((1, 8, 8, 3, 4), torch.float32, seed=21, device=cuda)
    before = conv.launches["conv3x3"]
    with pytest.raises(ValueError, match="TILE_H"):
        conv.conv3x3_bias_lrelu(torch.zeros(1, 12, 8, 3, device=cuda), k, bias)
    with pytest.raises(ValueError, match="forward only"):
        conv.conv3x3_bias_lrelu(x.clone().requires_grad_(True), k, bias)
    with pytest.raises(ValueError, match="one device"):
        conv.conv3x3_bias_lrelu(x, k.cpu(), bias)
    with pytest.raises(TypeError):
        conv.conv3x3_bias_lrelu(x.half(), k.half(), bias.half())
    with pytest.raises(TypeError):
        conv.conv3x3_bias_lrelu(x, k.to(torch.bfloat16), bias)
    assert conv.launches["conv3x3"] == before
