"""The port's bilinear gather against the JAX package's Pallas kernel and xla route.

On the CPU the port runs its plain PyTorch version (the CUDA kernels' twin);
the JAX side runs ``bilinear_gather_pallas`` in interpret mode. Inputs come
from a seeded numpy generator. Tolerance: atol 1e-5 (float32 sums taken in
another order). The CUDA kernels themselves are checked on the card by
``tests/test_torch_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_gan_tpu.geometry.warp import bilinear_sample as jax_bilinear_sample
from rgbd_gan_tpu.ops.bilinear_pallas import bilinear_gather_pallas
from rgbd_gan_tpu_torch.geometry.warp import bilinear_sample
from rgbd_gan_tpu_torch.ops import bilinear

B, H, W, C, N = 2, 16, 16, 4, 300  # N is not a tile multiple
# a channel count above a warp's 32 lanes and no multiple of it: on the card
# such a C takes the kernels with a group of lanes per point
WIDE = dict(b=2, h=8, w=8, c=33, n=64)
ATOL = 1e-5


def _inputs(seed=0, b=B, h=H, w=W, c=C, n=N):
    rng = np.random.RandomState(seed)
    img = rng.rand(b, h, w, c).astype("f")
    # in-bounds, out-of-bounds and integer points
    u = ((rng.rand(b, n) * 1.4 - 0.2) * (h - 1)).astype("f")
    v = ((rng.rand(b, n) * 1.4 - 0.2) * (w - 1)).astype("f")
    u[:, ::7] = np.floor(u[:, ::7])
    v[:, ::5] = np.floor(v[:, ::5])
    g = rng.randn(b, n, c).astype("f")
    return img, u, v, g


def _jax_vjp(img, u, v, g, exact):
    out, vjp = jax.vjp(
        lambda i, uu, vv: bilinear_gather_pallas(i, uu, vv, exact, True),
        jnp.asarray(img), jnp.asarray(u), jnp.asarray(v),
    )
    return np.asarray(out), [np.asarray(a) for a in vjp(jnp.asarray(g))]


def _torch_vjp(fn, img, u, v, g):
    ti, tu, tv = (torch.tensor(a, requires_grad=True) for a in (img, u, v))
    out = fn(ti, tu, tv)
    out.backward(torch.tensor(g))
    return out.detach().numpy(), [t.grad.numpy() for t in (ti, tu, tv)]


@pytest.mark.parametrize("route,exact,shape", [
    pytest.param(route, exact, shape, id=f"{route}-{exact}" + ("-wide" if shape else ""))
    for shape in ({}, WIDE) for route in ("function", "reference") for exact in (True, False)
])
def test_forward_and_grads_match_pallas(exact, route, shape):
    img, u, v, g = _inputs(**shape)
    fn = bilinear.bilinear_gather if route == "function" else bilinear.bilinear_gather_reference
    out_t, grads_t = _torch_vjp(lambda i, uu, vv: fn(i, uu, vv, exact), img, u, v, g)
    out_j, grads_j = _jax_vjp(img, u, v, g, exact)
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)
    for a, b_, name in zip(grads_t, grads_j, ["dimg", "du", "dv"]):
        np.testing.assert_allclose(a, b_, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("exact", [True, False])
def test_reference_vjp_matches_autograd(exact):
    img, u, v, g = _inputs(seed=1)
    _, grads = _torch_vjp(
        lambda i, uu, vv: bilinear.bilinear_gather_reference(i, uu, vv, exact), img, u, v, g
    )
    closed = bilinear.bilinear_gather_reference_vjp(*(torch.tensor(a) for a in (img, u, v, g)), exact)
    for a, b_, name in zip(closed, grads, ["dimg", "du", "dv"]):
        np.testing.assert_allclose(a.numpy(), b_, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("mode", ["xla", "pallas"])
def test_bilinear_sample_matches_jax_xla_route(exact, mode):
    rng = np.random.RandomState(7)
    img = rng.rand(2, 16, 16, 4).astype("f")
    zp = (rng.rand(2, 300, 3) * np.array([20, 20, 1.2]) - np.array([2, 2, 0])).astype("f")
    cot = rng.randn(2 * 300, 4).astype("f")

    def jloss(i, z):
        w, _ = jax_bilinear_sample(i, z, exact=exact)
        return jnp.sum(w * cot)

    (wj, mj) = jax_bilinear_sample(jnp.asarray(img), jnp.asarray(zp), exact=exact)
    gj = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(zp))

    ti, tz = torch.tensor(img, requires_grad=True), torch.tensor(zp, requires_grad=True)
    wt, mt = bilinear_sample(ti, tz, exact=exact, gather_mode=mode)
    (wt * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(wt.detach().numpy(), np.asarray(wj), atol=ATOL)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(gj[0]), atol=ATOL)
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(gj[1]), atol=ATOL)


def test_masked_points_are_zero_with_no_gradient_even_for_nan():
    img, u, v, g = _inputs(seed=2)
    u[:, :8] = -5.0
    u[:, 8:12] = np.nan
    v[:, 12:16] = np.inf
    out, (dimg, du, dv) = _torch_vjp(
        lambda i, uu, vv: bilinear.bilinear_gather(i, uu, vv, True), img, u, v, g
    )
    assert np.all(out[:, :16] == 0.0)
    assert np.all(du[:, :16] == 0.0) and np.all(dv[:, :16] == 0.0)
    assert np.isfinite(dimg).all()


def test_cpu_path_counts_no_launches():
    img, u, v, g = _inputs()
    before = dict(bilinear.launches)
    ti = torch.tensor(img, requires_grad=True)
    bilinear.bilinear_gather(ti, torch.tensor(u), torch.tensor(v)).sum().backward()
    assert bilinear.launches == before


def test_wrapper_rejects_bad_inputs():
    img, u, v, _ = _inputs()
    ti, tu, tv = torch.tensor(img), torch.tensor(u), torch.tensor(v)
    with pytest.raises(TypeError):
        bilinear.bilinear_gather(ti.double(), tu.double(), tv.double())
    with pytest.raises(ValueError):
        bilinear.bilinear_gather(ti, tu[:, :10], tv)
    with pytest.raises(ValueError):
        bilinear.bilinear_gather(ti[0], tu, tv)
