"""The CUDA kernels K1/K2 of ``rgbd_gan_tpu_torch.ops.bilinear`` and K3/K4/K5
of ``rgbd_gan_tpu_torch.ops.trilinear`` against their plain PyTorch versions,
on the card. Without a GPU every test here skips.

This file imports no JAX, so it also runs on a machine without it:
``python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py``.

Tolerance: atol 1e-5 on the forward and on du/dv; rtol 1e-5 / atol 1e-4 on
d img, whose f32 atomics add in an order that changes from run to run. The
lift: rtol/atol 1e-5 on the float32 forward (fused multiply-adds against
separate ones), one bf16 ulp (rtol 2^-7) on the bf16 forward, and rtol 1e-5 /
atol 1e-4 on dV (atomics again).
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
from rgbd_gan_tpu_torch.ops import bilinear, trilinear

ATOL = 1e-5
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
    assert bilinear.launches == {"fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
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
        before = bilinear.launches["fwd"]
        out, mask = bilinear_sample(img, zp, gather_mode=mode)
        assert bilinear.launches["fwd"] == before + 1
        torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=ATOL)
        torch.testing.assert_close(mask.cpu(), ref_mask, rtol=0, atol=0)


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
    for mode, key, atol in (("gather", "fwd", 1e-5), ("pallas_f32", "fwd", 1e-5), ("pallas", "fwd", 0.05),
                            ("pallas_win_f32", "fwd_win", 1e-5), ("pallas_win", "fwd_win", 0.05)):
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
        before = trilinear.launches["fwd_win"]
        outs[str(device)] = gen(z.to(device), mats.to(device), z2.to(device)).cpu()
        assert trilinear.launches["fwd_win"] == before + (device != "cpu")
        stats[str(device)] = {k: v.cpu() for k, v in gen.state_dict().items() if k.endswith(("mean", "var"))}
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=1e-3, atol=1e-3)
    assert (len(stats["cpu"]) == 4) == (occlusion_type == "deepvoxels")
    for k, v in stats["cpu"].items():
        torch.testing.assert_close(stats["cuda"][k], v, rtol=1e-3, atol=1e-3)


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
