"""The port's trilinear lift (plain PyTorch version, the CPU path) against the
JAX package: the Pallas kernels in interpret mode and the dense gather route
of ``lift_frustum``. The CUDA kernels are held against the same plain version
on the card by ``tests/test_torch_kernels_cuda.py``.

Inputs come from numpy seeds. Tolerances: float32 forward and dV atol 1e-5
against the Pallas kernels and the gather route (another summation order);
bf16 operands within one bf16 ulp of the Pallas bf16 kernel (atol 2^-8 for
values below 1: the order of a four-term float32 sum decides a rounding) and
within 2e-2 of the float32 gather for a grid of values in [0, 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_gan_tpu.geometry.camera import camera_matrices as jax_camera_matrices
from rgbd_gan_tpu.models import deepvoxels as jdv
from rgbd_gan_tpu.ops.trilinear_pallas import TILE_N as JAX_TILE_N
from rgbd_gan_tpu.ops.trilinear_pallas import trilinear_lift as jax_trilinear_lift
from rgbd_gan_tpu_torch.models import deepvoxels as tdv
from rgbd_gan_tpu_torch.ops import trilinear

# the suite runs several worker processes at once: leave them the other cores
torch.set_num_threads(2)

G = jdv.GRID_DIM
ATOL = 1e-5
BF16_ULP = 2.0**-8  # one bf16 ulp just below 1.0
CAMERAS = [(0.0, 0.0), (0.0, 0.9), (0.0, 2.4), (0.3054, 3.1415), (-0.3054, -3.1415), (0.3054, 1.5708)]
MODES = {"f32-full": (None, None), "f32-win": (None, 16), "bf16-full": ("bf16", None), "bf16-win": ("bf16", 16)}


def _dtypes(name):
    return (jnp.bfloat16, torch.bfloat16) if name == "bf16" else (None, None)


def _frustum_slice(thetas, c, seed, k0=80, tiles=2):
    """Voxel grid, frustum coordinates of ``tiles`` mid-frustum tiles (depth
    planes that cross the grid) under cameras ``thetas`` (x, y rotation), mask
    and cotangent, as numpy arrays."""
    rng = np.random.RandomState(seed)
    b = len(thetas)
    voxel = rng.rand(b, G, G, G, c).astype("f")
    th = np.zeros((b, 6), "f")
    th[:, :2] = thetas
    mats = jax_camera_matrices(jnp.asarray(th))
    vox, ib = jdv.frustum_voxel_coords(mats, jnp.asarray(jdv.frustum_camera_coords()))
    s = slice(k0 * JAX_TILE_N, (k0 + tiles) * JAX_TILE_N)
    vox, ib = np.asarray(vox[:, :, s]), np.asarray(ib[:, s])
    assert ib.any()
    cot = rng.rand(b, vox.shape[2], c).astype("f")
    return voxel, vox, ib, cot


def _jax_lift_and_dv(voxel, vox, ib, cot, dtype, window):
    fn = lambda v: jax_trilinear_lift(v, jnp.asarray(vox), jnp.asarray(ib), True, dtype, window)  # noqa: E731
    out, vjp = jax.vjp(fn, jnp.asarray(voxel))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(cot))[0])


def _torch_lift_and_dv(voxel, vox, ib, cot, dtype, window):
    tv = torch.tensor(voxel, requires_grad=True)
    out = trilinear.trilinear_lift(tv, torch.tensor(vox), torch.tensor(ib), dtype, window)
    out.backward(torch.tensor(cot))
    return out.detach().numpy(), tv.grad.numpy()


def test_tile_size_and_constants_are_the_jax_package_s():
    assert trilinear.TILE_N == JAX_TILE_N == 1024
    for name in ("GRID_DIM", "PROJ_DIM", "FRUSTUM_DEPTH", "NUM_GRID_FEATS", "LIFT_WINDOW", "VOXEL_SIZE",
                 "NEAR_PLANE", "FOCAL", "CENTER"):
        assert getattr(tdv, name) == getattr(jdv, name), name
    np.testing.assert_array_equal(tdv.PROJECTION_INTRINSIC, jdv.PROJECTION_INTRINSIC)
    assert tdv.lift_window_span_bound() == jdv.lift_window_span_bound()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("half", [0, 1])
def test_plain_lift_matches_pallas_interpret(mode, half):
    """Forward and dV under three cameras each; the windowed modes under the
    production prior's extremes, where the span invariant holds."""
    name, window = MODES[mode]
    jdt, tdt = _dtypes(name)
    args = _frustum_slice(CAMERAS[3 * half: 3 * half + 3], c=4, seed=half)
    want_out, want_dv = _jax_lift_and_dv(*args, jdt, window)
    got_out, got_dv = _torch_lift_and_dv(*args, tdt, window)
    if name == "bf16":
        # dV sums hundreds of bf16-rounded terms per voxel: one ulp of the largest
        np.testing.assert_allclose(got_out, want_out, atol=BF16_ULP)
        np.testing.assert_allclose(got_dv, want_dv, atol=BF16_ULP * max(1.0, np.abs(want_dv).max()))
    else:
        np.testing.assert_allclose(got_out, want_out, atol=ATOL)
        np.testing.assert_allclose(got_dv, want_dv, atol=3e-5)  # as tests/test_trilinear_pallas.py


@pytest.mark.parametrize("theta", CAMERAS[1:4])
def test_every_mode_against_the_dense_gather_lift(theta):
    """The whole frustum of one camera through ``lift_frustum``: every float32
    mode equals the JAX gather route, the bf16 modes stay in its envelope."""
    rng = np.random.RandomState(3)
    voxel = rng.rand(1, G, G, G, 4).astype("f")
    th = np.zeros((1, 6), "f")
    th[0, :2] = theta
    coords = jdv.frustum_camera_coords()
    np.testing.assert_array_equal(coords, tdv.frustum_camera_coords())
    want = np.asarray(jdv.lift_frustum(jnp.asarray(voxel), jax_camera_matrices(jnp.asarray(th)), jnp.asarray(coords)))
    from rgbd_gan_tpu_torch.geometry.camera import camera_matrices

    mats = camera_matrices(torch.tensor(th))
    # every mode under the first camera; under the others the f32 full and the bf16 windowed lift
    for mode in tdv.LIFT_MODES if theta == CAMERAS[1] else ("gather", "pallas_win"):
        got = tdv.lift_frustum(torch.tensor(voxel), mats, torch.tensor(coords), mode).numpy()
        assert got.shape == want.shape == (1, jdv.FRUSTUM_DEPTH, 64, 64, 4)
        np.testing.assert_allclose(got, want, atol=ATOL if mode in ("gather", "pallas_f32", "pallas_win_f32") else 2e-2,
                                   err_msg=mode)


def test_gradient_against_the_dense_gather_lift():
    voxel, vox, ib, cot = _frustum_slice([(0.3054, 2.2), (0.0, 0.7)], c=3, seed=4)
    b, n = ib.shape

    def gather_lift(v):  # the gather route's arithmetic on the slice (deepvoxels.py:192-233)
        xi, yi, zi = (jnp.asarray(vox[:, r]) for r in (2, 1, 0))
        i0 = [jnp.clip(a.astype(jnp.int32), 0, G - 1) for a in (xi, yi, zi)]
        i1 = [jnp.clip(a + 1, 0, G - 1) for a in i0]
        f = [a - a0.astype(a.dtype) for a, a0 in zip((xi, yi, zi), i0)]
        vflat = v.reshape(b * G**3, -1)
        base = (jnp.arange(b) * G**3)[:, None]
        out = 0.0
        for cx in (0, 1):
            for cy in (0, 1):
                for cz in (0, 1):
                    ix, iy, iz = (i1 if cx else i0)[0], (i1 if cy else i0)[1], (i1 if cz else i0)[2]
                    w = (f[0] if cx else 1 - f[0]) * (f[1] if cy else 1 - f[1]) * (f[2] if cz else 1 - f[2])
                    out = out + jnp.take(vflat, (base + (ix * G + iy) * G + iz).reshape(-1), axis=0).reshape(
                        b, n, -1) * w[..., None]
        return out * jnp.asarray(ib)[..., None]

    want_out, vjp = jax.vjp(gather_lift, jnp.asarray(voxel))
    got_out, got_dv = _torch_lift_and_dv(voxel, vox, ib, cot, None, None)
    np.testing.assert_allclose(got_out, np.asarray(want_out), atol=ATOL)
    np.testing.assert_allclose(got_dv, np.asarray(vjp(jnp.asarray(cot))[0]), atol=3e-5)


def test_axis_roles_on_a_grid_that_differs_along_each_axis():
    """Trilinear interpolation reproduces a linear field: with the field
    ``100*d0 + 10*d1 + d2`` any swap of coordinate rows shows."""
    d = np.arange(G, dtype="f")
    field = 100 * d[:, None, None] + 10 * d[None, :, None] + d[None, None, :]
    voxel = torch.tensor(field[None, ..., None])
    rng = np.random.RandomState(5)
    coords = rng.uniform(0, G - 1, (1, 3, 1024)).astype("f")
    out = trilinear.trilinear_lift(voxel, torch.tensor(coords), torch.ones(1, 1024, dtype=torch.bool))
    want = 100 * coords[:, 2] + 10 * coords[:, 1] + coords[:, 0]  # row 2 -> dim0, row 0 -> dim2
    np.testing.assert_allclose(out.numpy()[..., 0], want, rtol=1e-5, atol=1e-3)


def _mixed_tiles(seed, c=4):
    """Tile 0 all masked (far outside), tile 1 random cells inside and outside
    the grid, integer coordinates and cells in the last planes."""
    rng = np.random.RandomState(seed)
    voxel = rng.rand(1, G, G, G, c).astype("f")
    inside = (rng.rand(1, 3, JAX_TILE_N) * 1.3 - 0.15) * G
    inside[:, :, ::7] = np.floor(inside[:, :, ::7])
    inside[:, 0, 1::11] = G - 0.25
    inside[:, 1, 2::13] = G - 0.5
    inside[:, 2, 3::17] = G - 0.75
    vox = np.concatenate([np.full((1, 3, JAX_TILE_N), -7.0), inside], axis=2).astype("f")
    ib = np.all((vox >= 0) & (vox < G), axis=1)
    cot = rng.rand(1, 2 * JAX_TILE_N, c).astype("f")
    return voxel, vox, ib, cot


@pytest.mark.parametrize("window", [None, 16])
def test_cells_outside_the_grid_and_an_all_masked_tile(window):
    """Random cells span all 32 planes, so with ``window=16`` the invariant is
    broken: the port drops the same corners as the Pallas windowed kernel,
    and its result differs from the full lift."""
    args = _mixed_tiles(6)
    want_out, want_dv = _jax_lift_and_dv(*args, None, window)
    got_out, got_dv = _torch_lift_and_dv(*args, None, window)
    np.testing.assert_allclose(got_out, want_out, atol=ATOL)
    np.testing.assert_allclose(got_dv, want_dv, atol=3e-5)
    assert np.all(got_out[:, :JAX_TILE_N] == 0) and np.all(got_out[~args[2]] == 0)
    if window:
        full_out, _ = _torch_lift_and_dv(*args, None, None)
        dropped = np.abs(full_out - got_out).max(axis=-1) > 1e-3
        assert dropped.sum() > 100  # the window really cut valid cells
        assert np.all(got_out[dropped & (args[1][:, 1] >= 17)] == 0)  # both dim1 corners beyond [s, s+16)


def test_window_rule_on_a_tile_spanning_more_than_the_window_bf16():
    args = _mixed_tiles(7)
    want_out, want_dv = _jax_lift_and_dv(*args, jnp.bfloat16, 16)
    got_out, got_dv = _torch_lift_and_dv(*args, torch.bfloat16, 16)
    np.testing.assert_allclose(got_out, want_out, atol=BF16_ULP)
    np.testing.assert_allclose(got_dv, want_dv, atol=BF16_ULP * max(1.0, np.abs(want_dv).max()))


def test_masked_cells_with_wild_coordinates_give_zero_and_no_gradient():
    """A masked cell's coordinates may be NaN or inf. The port tests the mask
    first: an exact 0 and a finite dV. The Pallas kernel (interpret mode)
    multiplies a NaN weight by the 0 mask and returns NaN there."""
    voxel, vox, ib, cot = _mixed_tiles(8)
    vox[:, :, JAX_TILE_N: JAX_TILE_N + 8] = np.nan
    vox[:, 0, JAX_TILE_N + 8: JAX_TILE_N + 16] = np.inf
    vox[:, 1, JAX_TILE_N + 16: JAX_TILE_N + 24] = -1e30
    ib[:, JAX_TILE_N: JAX_TILE_N + 24] = False
    for dtype, window in ((None, None), (None, 16), (torch.bfloat16, None)):
        out, dv = _torch_lift_and_dv(voxel, vox, ib, cot, dtype, window)
        assert np.all(out[:, JAX_TILE_N: JAX_TILE_N + 24] == 0)
        assert np.isfinite(out).all() and np.isfinite(dv).all()
    jax_out, _ = _jax_lift_and_dv(voxel, vox, ib, cot, None, None)
    assert np.isnan(jax_out[:, JAX_TILE_N: JAX_TILE_N + 8]).all()


def test_vjp_matches_autograd_of_the_plain_forward():
    voxel, vox, ib, cot = _mixed_tiles(9, c=3)
    for window in (None, 16):
        tv = torch.tensor(voxel, requires_grad=True)
        out = trilinear.trilinear_lift_reference(tv, torch.tensor(vox), torch.tensor(ib), None, window)
        out.backward(torch.tensor(cot))
        dv = trilinear.trilinear_lift_reference_vjp(voxel.shape, torch.tensor(vox), torch.tensor(ib),
                                                    torch.tensor(cot), None, window)
        np.testing.assert_allclose(dv.numpy(), tv.grad.numpy(), atol=ATOL)


def test_wrapper_refuses_bad_arguments():
    voxel, vox, ib, _ = (torch.tensor(a) for a in _mixed_tiles(10))
    with pytest.raises(ValueError, match="N % 1024"):
        trilinear.trilinear_lift(voxel, vox[:, :, :1000], ib[:, :1000], None, 16)
    with pytest.raises(ValueError, match="window"):
        trilinear.trilinear_lift(voxel, vox, ib, None, 33)
    with pytest.raises(TypeError):
        trilinear.trilinear_lift(voxel, vox, ib, torch.float16)
    with pytest.raises(TypeError):
        trilinear.trilinear_lift(voxel.double(), vox, ib)
    with pytest.raises(ValueError):
        trilinear.trilinear_lift(voxel, vox[:, :2], ib)
    with pytest.raises(ValueError):
        tdv.lift_frustum(voxel, torch.eye(4)[None], torch.tensor(tdv.frustum_camera_coords()), "pallas_bf16")
    # the full lift takes any number of cells
    assert trilinear.trilinear_lift(voxel, vox[:, :, :1500], ib[:, :1500]).shape == (1, 1500, 4)
    assert not any(trilinear.launches.values())  # the CPU path counts no launch


@pytest.mark.parametrize("requested,z_rotate,on_cuda,want", [
    (None, 0.0, True, "pallas_win"), (None, 0.5, True, "pallas"), ("pallas", 0.5, True, "pallas"),
    ("pallas_f32", 0.0, True, "pallas_f32"), ("pallas_win_f32", 0.0, True, "pallas_win_f32"),
    ("gather", 0.5, True, "gather"), ("gather", 0.0, False, "gather"),
    (None, 0.0, False, "gather"), ("pallas_win", 0.5, False, "gather"), ("pallas", 0.0, False, "gather"),
])
def test_resolve_lift_mode(monkeypatch, requested, z_rotate, on_cuda, want):
    """The JAX resolver with 'a kernel is available' in the place of 'the
    generator runs on a CUDA device'."""
    import rgbd_gan_tpu.ops.bilinear_pallas as bp

    assert tdv._resolve_lift_mode(requested, z_rotate, on_cuda) == want
    monkeypatch.setattr(bp, "pallas_available", lambda: on_cuda)
    assert jdv._resolve_lift_mode(requested, z_rotate) == want


def test_resolve_lift_mode_gates():
    with pytest.raises(ValueError, match="z_rotate"):
        tdv._resolve_lift_mode("pallas_win", 0.5, on_cuda=True)
    with pytest.raises(ValueError, match="z_rotate"):
        tdv._resolve_lift_mode("pallas_win_f32", 0.5, on_cuda=True)


def test_span_bound_follows_the_constants(monkeypatch):
    base = tdv.lift_window_span_bound()
    assert base + 3.0 <= tdv.LIFT_WINDOW
    monkeypatch.setattr(tdv, "FOCAL", tdv.FOCAL / 4.0)
    assert tdv.lift_window_span_bound() > base
    assert tdv._resolve_lift_mode(None, 0.0, on_cuda=True) == "pallas"
    with pytest.raises(ValueError, match="span bound"):
        tdv._resolve_lift_mode("pallas_win", 0.0, on_cuda=True)
    monkeypatch.undo()
    monkeypatch.setattr(tdv, "TILE_N", 1000)
    assert tdv.lift_window_span_bound() == float("inf")
    assert tdv._resolve_lift_mode(None, 0.0, on_cuda=True) == "pallas"
