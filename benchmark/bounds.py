"""The least time the card could take for the port's hand-written kernels at
a cell's shapes (each architecture's ``kernel_calls``), and the card's peaks.

Each bound counts only what any implementation must move for the call:
its outputs written once and the inputs it must read in full. Reads that
depend on where the points land (the image pixels the in-bounds corners
touch, the voxels the valid cells touch) and the zero fill of a scattered
gradient, which a separate fill kernel may do, are not counted, so a
kernel's share of its bound cannot pass 100 %. The operations are a few
multiply-adds a channel, far below the bytes' time, so bytes decide.

- bilinear gather forward (K1): reads the row and column coordinates
  (2 x 4 bytes a point), writes (B, N, C) float32
- its backward (K2): reads the cotangent (B, N, C) and the coordinates,
  writes the coordinates' gradients (2 x 4 bytes a point)
- trilinear lift forward (K3/K5): reads the (B, 3, N) voxel coordinates
  and the (B, N) bool mask, writes (B, N, C) float32
- its backward (K4/K5): reads the coordinates, the mask and the cotangent
  (B, N, C)
"""

from __future__ import annotations

import re
from typing import Optional

# NVIDIA H100 SXM data sheet: dense rates, 700 W
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12

def bound_bytes(kind: str, b: int, n: int, c: int) -> int:
    if kind == "bilinear_fwd":
        return b * n * (8 + 4 * c)
    if kind == "bilinear_bwd":
        return b * n * (4 * c + 8 + 8)
    if kind in ("lift_fwd", "lift_bwd"):
        return b * n * (12 + 1 + 4 * c)
    raise ValueError(f"unknown kernel kind {kind!r}")


_KIND = re.compile(r"\b(bilinear|lift)_(fwd|bwd)\w*kernel")


def kind_of(kernel_name: str) -> Optional[str]:
    """``bilinear_fwd`` ... ``lift_bwd`` for a hand-written kernel's name."""
    m = _KIND.search(kernel_name)
    return f"{m.group(1)}_{m.group(2)}" if m else None


def bound_seconds(kind: str, shape: tuple) -> float:
    return bound_bytes(kind, *shape) / HBM_BYTES_PER_S
