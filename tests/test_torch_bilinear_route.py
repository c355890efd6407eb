"""Which kernel takes K1 and K2 (the bilinear gather's forward and backward)
on the card, decided in Python from the channel count alone:
``bilinear.fwd_route`` and ``bwd_route``, ``_fwd``'s and ``_bwd``'s refusal of
a forced route that cannot take the call, before they touch a device, and
the copy that gives the vectorised backward an aligned cotangent.
Also the yardsticks of ``tools/bilinear_yardstick.py`` that ``chip_smoke.py``
prints and times beside K1 and K2: the modelled count of the vectorised
kernel's merged reductions, and the library calls (``F.grid_sample`` and its
backward) against the plain version. Imports no JAX.

Tolerance of the library calls: atol 1e-5 (the same weights computed from a
normalised coordinate). d u and d v are compared only away from grid lines:
on a grid line the normalised coordinate's rounding may pick the other
one-sided derivative.
"""

import numpy as np
import pytest
import torch

from rgbd_gan_tpu_torch.ops import bilinear
from rgbd_gan_tpu_torch.tools import bilinear_yardstick as yardstick

ATOL = 1e-5


def _inputs(b=2, h=16, w=24, c=4, n=300, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.rand(b, h, w, c).astype("f")
    # in-bounds, out-of-bounds, integer and NaN / inf points
    u = ((rng.rand(b, n) * 1.4 - 0.2) * (h - 1)).astype("f")
    v = ((rng.rand(b, n) * 1.4 - 0.2) * (w - 1)).astype("f")
    u[:, ::7] = np.floor(u[:, ::7])
    v[:, ::5] = np.floor(v[:, ::5])
    u[:, 3::50] = np.nan
    v[:, 4::50] = np.inf
    g = rng.randn(b, n, c).astype("f")
    return [torch.tensor(a) for a in (img, u, v, g)]


@pytest.mark.parametrize("c,want", [
    (4, "vec4"),  # every path's C
    (1, "lanes"),  # float4 corners need C == 4
    (2, "lanes"),
    (3, "lanes"),
    (5, "lanes"),
    (8, "lanes"),
    (12, "lanes"),
    (16, "lanes"),
])
def test_backward_route(c, want):
    assert bilinear.bwd_route(c) == want


@pytest.mark.parametrize("c,want", [
    (4, "vec4"),  # every path's C
    (1, "lanes"),
    (3, "lanes"),
    (5, "lanes"),
    (33, "lanes"),  # above a warp, no multiple of it
    (257, "lanes"),  # the feature 3D-consistency loss's gather (ch 256 + depth)
])
def test_forward_route(c, want):
    assert bilinear.fwd_route(c) == want


@pytest.mark.parametrize("c,route", [
    (3, "vec4"),
    (1, "vec4"),
    (8, "vec4"),
    (4, "scalar"),  # no such kernel
])
def test_backward_refuses_a_forced_route_that_does_not_take_the_call(c, route):
    """``_bwd(..., route=)`` is for measurements; it never sends a call to a
    kernel that cannot take it, and says so before any device is touched
    (these tensors lie on the CPU)."""
    img, u, v, g = _inputs(c=c)
    with pytest.raises(ValueError, match="does not take"):
        bilinear._bwd(img, u, v, g, True, route=route)


@pytest.mark.parametrize("c,route", [
    (3, "vec4"),
    (257, "vec4"),
    (8, "vec4"),
    (4, "scalar"),  # no such kernel
])
def test_forward_refuses_a_forced_route_that_does_not_take_the_call(c, route):
    img, u, v, _ = _inputs(c=c)
    bilinear.reset_launches()
    with pytest.raises(ValueError, match="does not take"):
        bilinear._fwd(img, u, v, True, route=route)
    assert not any(bilinear.launches.values())


def _shifted(t, offset):
    """A contiguous copy of ``t`` ``offset`` elements (4 bytes each) past an
    aligned address."""
    out = torch.zeros(offset + t.numel())[offset:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4 * offset % 16
    return out


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_aligned_gives_the_vectorised_kernel_an_aligned_cotangent(offset):
    _, _, _, g = _inputs(seed=5)
    shifted = _shifted(g, offset)
    got = bilinear._aligned(shifted)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous()
    assert (got.data_ptr() == shifted.data_ptr()) == (offset == 0)  # copied only where needed
    torch.testing.assert_close(got, g, rtol=0, atol=0)
    # a strided view comes back contiguous and aligned too
    got = bilinear._aligned(g.transpose(0, 1))
    assert got.is_contiguous() and got.data_ptr() % 16 == 0


@pytest.mark.parametrize("exact", [True, False])
def test_autograd_backward_takes_an_unaligned_cotangent(exact):
    """The autograd backward hands ``_bwd`` an aligned copy of a cotangent
    that lies off a 16-byte boundary: the gradients equal those of the
    aligned cotangent."""
    img, u, v, g = _inputs(seed=6)
    grads = []
    for cot in (g, _shifted(g, 1)):
        leaves = [t.clone().requires_grad_(True) for t in (img, u, v)]
        bilinear.bilinear_gather(*leaves, exact=exact).backward(cot)
        grads.append([t.grad for t in leaves])
    for a, b_ in zip(*grads):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)


@pytest.mark.parametrize("route", [None, "generic", "vec4", "lanes"])
def test_backward_on_the_cpu_runs_the_plain_version_and_launches_nothing(route):
    img, u, v, g = _inputs(seed=1)
    bilinear.reset_launches()
    got = bilinear._bwd(img, u, v, g, True, route=route)
    want = bilinear.bilinear_gather_reference_vjp(img, u, v, g, True)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)
    assert not any(bilinear.launches.values())


@pytest.mark.parametrize("c,route", [(4, None), (4, "generic"), (4, "vec4"), (4, "lanes"), (33, None),
                                     (33, "generic")])
def test_forward_on_the_cpu_runs_the_plain_version_and_launches_nothing(c, route):
    img, u, v, _ = _inputs(c=c, seed=1)
    bilinear.reset_launches()
    got = bilinear._fwd(img, u, v, True, route=route)
    torch.testing.assert_close(got, bilinear.bilinear_gather_reference(img, u, v, True), rtol=0, atol=0)
    assert not any(bilinear.launches.values())
    assert set(bilinear.launches) == {"fwd", "fwd_lanes", "bwd", "bwd_vec4", "bwd_lanes"}


@pytest.mark.parametrize("exact", [True, False])
def test_merge_factor_counts_the_handed_over_columns(exact):
    """A row-major grid of points one column apart: within a warp of 32
    lanes every point but the first hands its right corner column to the
    next, so 32 points reduce 33 columns instead of 64."""
    h, w = 9, 33  # 8 in-bounds rows of 32 points: one warp a row
    r, col = torch.meshgrid(torch.arange(h, dtype=torch.float32), torch.arange(w, dtype=torch.float32),
                            indexing="ij")
    u = (r + 0.25).reshape(1, -1)
    v = (col + 0.5).reshape(1, -1)
    # the last row and column lie out of bounds; drop them so that rows of 32 fill the warps
    keep = (r < h - 1).reshape(-1) & (col < w - 1).reshape(-1)
    u, v = u[:, keep], v[:, keep]
    assert yardstick.modelled_merge_factor(u, v, h, w, exact) == pytest.approx(64 / 33)
    # a masked point in each warp breaks its chain once on each side
    u[:, 5::32] = float("nan")
    assert yardstick.modelled_merge_factor(u, v, h, w, exact) == pytest.approx(62 / 33)
    # uniform random points share no corner column
    _, ru, rv, _ = _inputs(seed=2)
    assert yardstick.modelled_merge_factor(ru, rv, 16, 24, exact) == pytest.approx(1.0, abs=0.02)


@pytest.mark.parametrize("exact", [True, False])
def test_library_forward_matches_plain_version(exact):
    img, u, v, _ = _inputs(seed=3)
    grid = yardstick.library_grid(u, v, 16, 24, exact)
    got = yardstick.gather(img, grid)
    torch.testing.assert_close(got, bilinear.bilinear_gather_reference(img, u, v, exact), rtol=0, atol=ATOL)


@pytest.mark.parametrize("exact", [True, False])
def test_library_backward_matches_plain_version_away_from_grid_lines(exact):
    img, u, v, g = _inputs(seed=4)
    grid = yardstick.library_grid(u, v, 16, 24, exact)
    dimg, du, dv = yardstick.gather_vjp(img, grid, g, exact)
    rdimg, rdu, rdv = bilinear.bilinear_gather_reference_vjp(img, u, v, g, exact)
    torch.testing.assert_close(dimg, rdimg, rtol=0, atol=ATOL)
    mask = (u >= 0) & (u < 15) & (v >= 0) & (v < 23)
    assert torch.all(du[~mask] == 0) and torch.all(dv[~mask] == 0)
    on_v, on_u = mask & (v == torch.floor(v)), mask & (u == torch.floor(u))
    assert int(on_v.sum()) > 0 and int((mask & ~on_v).sum()) > 200
    torch.testing.assert_close(dv[~on_v], rdv[~on_v], rtol=0, atol=ATOL)
    if exact:
        assert torch.all(du == 0)
    else:
        torch.testing.assert_close(du[~on_u], rdu[~on_u], rtol=0, atol=ATOL)
