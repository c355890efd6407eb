"""Yardsticks for K1 and K2 (the bilinear gather and its backward), used
nowhere in the port: ``chip_smoke.py`` times and checks them beside the
kernels.

- :func:`library_grid`, :func:`gather` and :func:`gather_vjp` compute the
  gather of ``ops/bilinear.py`` with one PyTorch call each
  (``F.grid_sample`` and ``aten.grid_sampler_2d_backward``);
  :func:`grid_sampler_backward` is that backward's one call, as it is timed.
- :func:`modelled_merge_factor` models, from the points alone, how many
  corner additions ``bilinear_bwd_vec4_kernel`` folds into one vector
  reduction. It restates the kernel's lane rule in Python and is not
  counted on the card: a change to the kernel's rule does not move it.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def library_grid(u: torch.Tensor, v: torch.Tensor, h: int, w: int, exact: bool = True) -> torch.Tensor:
    """The (B, 1, N, 2) grid at which ``F.grid_sample(..., align_corners=True)``
    samples what the gather samples: (v, u) normalised to [-1, 1], u
    truncated in exact mode (nearest along u, linear along v), and every
    out-of-bounds point sent outside the image, where zero padding gives 0
    and no gradient (so no cotangent needs masking)."""
    mask = (u >= 0) & (u < h - 1) & (v >= 0) & (v < w - 1)
    rows = torch.trunc(u) if exact else u
    grid = torch.stack([v * (2.0 / (w - 1)) - 1.0, rows * (2.0 / (h - 1)) - 1.0], dim=-1)
    grid = torch.where(mask[..., None], grid, torch.full_like(grid, -2.0))
    return grid[:, None].contiguous()


def gather(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """The gather as one ``F.grid_sample`` on a channels-last NCHW view of
    ``img``, at :func:`library_grid`'s grid: (B, N, C), a strided view."""
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    return out[:, :, 0].transpose(1, 2)


def gather_vjp(
    img: torch.Tensor, grid: torch.Tensor, g: torch.Tensor, exact: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d img, d u, d v) as one ``aten.grid_sampler_2d_backward`` at
    :func:`library_grid`'s grid, the grid's gradient scaled back to pixels;
    d u is 0 in exact mode (truncation has no gradient). At a point that
    lies on a grid line the normalised coordinate's rounding may pick the
    other one-sided derivative, so d u and d v agree with the gather's only
    away from grid lines."""
    b, h, w, c = img.shape
    dimg, dgrid = grid_sampler_backward(img, grid, g)
    dv = dgrid[:, 0, :, 0] * (2.0 / (w - 1))
    du = torch.zeros_like(dv) if exact else dgrid[:, 0, :, 1] * (2.0 / (h - 1))
    return dimg.permute(0, 2, 3, 1), du, dv


def grid_sampler_backward(img: torch.Tensor, grid: torch.Tensor, g: torch.Tensor):
    """The one library call of :func:`gather_vjp`: d input (B, C, H, W) and
    d grid (B, 1, N, 2), normalised."""
    return torch.ops.aten.grid_sampler_2d_backward(
        g.transpose(1, 2)[:, :, None], img.permute(0, 3, 1, 2), grid, 0, 0, True, [True, True]
    )


def modelled_merge_factor(u: torch.Tensor, v: torch.Tensor, h: int, w: int, exact: bool = True) -> float:
    """Corner additions per vector reduction of ``bilinear_bwd_vec4_kernel``
    on these points, as its lane rule gives them: a thread per point of the
    flat B x N index; a point whose (u0, v0) corner is the (u0, v0 + 1)
    corner of the point before it, in the same warp of 32 and in bounds,
    takes over that corner column, one reduction per corner row fewer (1 row
    in exact mode, 2 otherwise). 1.0 means no merge."""
    b, n = u.shape
    mask = (u >= 0) & (u < h - 1) & (v >= 0) & (v < w - 1)
    u0 = torch.where(mask, u, torch.zeros_like(u)).to(torch.int64)
    v0 = torch.where(mask, v, torch.zeros_like(v)).to(torch.int64)
    batch = torch.arange(b, device=u.device)[:, None]
    key, valid = ((batch * h + u0) * w + v0).reshape(-1), mask.reshape(-1)
    first_lane = torch.arange(key.numel(), device=u.device)[1:] % 32 == 0
    handoffs = int((valid[1:] & valid[:-1] & ~first_lane & (key[1:] == key[:-1] + 1)).sum())
    rows = 1 if exact else 2
    additions = 2 * rows * int(valid.sum())
    return additions / max(additions - rows * handoffs, 1)
