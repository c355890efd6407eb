"""Auxiliary heads (PyTorch). Port of the part of
:mod:`rgbd_gan_tpu.models.extras` that the DeepVoxels generator owns:
``CameraParamGenerator`` (reference ``net.py:795-813``). The encoder, the
BigBiGAN heads and the camera-parameter discriminator are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.layers import EqualizedLinear, leaky_relu


class CameraParamGenerator(nn.Module):
    """z (B, 8) -> 9-dim camera params with normalised rotation pairs."""

    def __init__(self, in_dim: int = 8, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.l0 = EqualizedLinear(in_dim, 64, generator=generator)
        self.l1 = EqualizedLinear(64, 64, generator=generator)
        self.l2 = EqualizedLinear(64, 9, generator=generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = leaky_relu(self.l0(z))
        h = leaky_relu(self.l1(h))
        h = self.l2(h)
        inv = 1.0 / torch.sqrt(torch.square(h[:, :3]) + torch.square(h[:, 3:6]) + 1e-8)
        return torch.cat([h[:, :3] * inv, h[:, 3:6] * inv, h[:, 6:]], dim=1)
