"""The least time the card could take for the port's hand-written kernels at
a cell's shapes, and the table of the card's peaks.

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
from typing import Dict, Optional

# NVIDIA H100 SXM data sheet: dense rates, 700 W
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12

FRUSTUM_CELLS = 56 * 64 * 64
VOXEL_FEATURES = 32
IMAGE_CHANNELS = 4  # RGB and depth


def call_shapes(deepvoxels: bool, local_batch: int, image_px: int) -> Dict[str, tuple]:
    """(B, N, C) of each kernel kind one step calls, and how often.

    The 3D-consistency loss gathers both directions of each render pair in
    one call, so K1/K2 see the whole local batch, N = H*W points, C = 4.
    DeepVoxels lifts every render: twice forward (G phase, D phase) and
    once backward, at B = the local batch."""
    px = 64 if deepvoxels else image_px
    shapes = {"bilinear_fwd": ((local_batch, px * px, IMAGE_CHANNELS), 1),
              "bilinear_bwd": ((local_batch, px * px, IMAGE_CHANNELS), 1)}
    if deepvoxels:
        shapes["lift_fwd"] = ((local_batch, FRUSTUM_CELLS, VOXEL_FEATURES), 2)
        shapes["lift_bwd"] = ((local_batch, FRUSTUM_CELLS, VOXEL_FEATURES), 1)
    return shapes


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
