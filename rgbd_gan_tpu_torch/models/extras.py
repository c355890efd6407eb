"""Auxiliary heads (PyTorch). Port of :mod:`rgbd_gan_tpu.models.extras`
(reference ``net.py:776-973``):

- ``CameraParamGenerator`` (``net.py:795-813``), owned by the DeepVoxels
  generator, and ``OccupancyNet`` (``net.py:951-973``), owned by the
  StyleGAN and DCGAN generators with ``use_occupancy_net_loss``
- the encoder (``EncoderBlockBase``, ``Encoder``, ``net.py:777-890``):
  a progressive PGGAN-down trunk of BatchNorm blocks that estimates a
  latent and normalised camera parameters
- ``MLP`` (``net.py:893-917``), ``CameraParamDiscriminator``
  (``net.py:816-828``) and ``BigBiGANDiscriminator`` (``net.py:920-948``)

The encoder and the BigBiGAN heads are declared in the reference and
blocked at run time there (``updater.py:330-331``), so no step trains them
and ``bigan: True`` raises; they are ported for the inventory, each held
to its JAX twin.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.layers import BatchNorm, EqualizedConv2D, EqualizedLinear, SNLinear, downscale2x, leaky_relu
from .discriminator import MAX_STAGE, Discriminator, DiscriminatorBlock


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


class OccupancyNet(nn.Module):
    """Occupancy MLP on ``[z tiled over the points, world xyz * sqrt(z_dim)]``
    (``net.py:951-973``): three equalized linears of width ``hidden_ch``,
    ``hidden_ch`` and 1, leaky ReLU between. ``in_ch`` is ``z_dim + 3``."""

    def __init__(self, in_ch: int, hidden_ch: int = 32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.l0 = EqualizedLinear(in_ch, hidden_ch, generator=generator)
        self.l1 = EqualizedLinear(hidden_ch, hidden_ch, generator=generator)
        self.l2 = EqualizedLinear(hidden_ch, 1, generator=generator)

    def forward(self, z: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        """``z`` (B, z_dim), ``coords`` (B, 3, HW) -> logits (B*HW, 1), rows in
        (sample, point) order."""
        b, z_dim = z.shape
        hw = coords.shape[2]
        h = torch.cat([z[:, None, :].expand(b, hw, z_dim), coords.transpose(1, 2) * (z_dim**0.5)], dim=-1)
        h = leaky_relu(self.l0(h.reshape(b * hw, z_dim + 3)))
        h = leaky_relu(self.l1(h))
        return self.l2(h)


class EncoderBlockBase(nn.Module):
    """The encoder's 4x4 head (``net.py:777-792``): 3x3 conv, BatchNorm,
    leaky ReLU, 4x4 valid conv, BatchNorm, leaky ReLU, a gain-1 linear to
    ``dim_z`` outputs."""

    def __init__(self, ch: int, dim_z: int = 256, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.c0 = EqualizedConv2D(ch, ch, 3, 1, 1, generator=generator)
        self.bn0 = BatchNorm(ch)
        self.c1 = EqualizedConv2D(ch, ch, 4, 1, 0, generator=generator)
        self.bn1 = BatchNorm(ch)
        self.l2 = EqualizedLinear(ch, dim_z, gain=1.0, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        h = leaky_relu(self.bn0(self.c0(x), train))
        h = leaky_relu(self.bn1(self.c1(h), train))
        return self.l2(h)


class Encoder(nn.Module):
    """Progressive encoder (``net.py:831-890``): the discriminator's trunk
    with BatchNorm blocks and a head of ``dim_z + 9`` outputs. Returns the
    latent estimate (B, dim_z) and the camera parameters (B, 9), whose
    cosine and sine triples are normalised to ``cos^2 + sin^2 = 1``."""

    def __init__(self, ch: int = 512, dim_z: int = 256, enable_blur: bool = False, res: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.block0 = EncoderBlockBase(ch, dim_z + 9, generator=generator)
        chans = [(ch, ch), (ch, ch), (ch, ch), (ch // 2, ch), (ch // 4, ch // 2)]
        for i, (c_in, c_out) in enumerate(chans):
            self.add_module(f"block{i + 1}", DiscriminatorBlock(
                c_in, c_out, enable_blur=enable_blur, res=res, bn=True, generator=generator))
        for i, c in enumerate([ch, ch, ch, ch, ch // 2, ch // 4]):
            self.add_module(f"in{i}", EqualizedConv2D(3, c, 1, 1, 0, generator=generator))

    def _in(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(getattr(self, f"in{i}")(x))

    def forward(self, x: torch.Tensor, stage_floor: int, alpha=0.0, train: bool = True):
        stage = min(int(stage_floor), MAX_STAGE - 1)

        def run(i, h):
            return getattr(self, f"block{i}")(h, train)

        if stage % 2 == 0:
            k = (stage - 2) // 2
            h = self._in(k + 1, x)
            for i in reversed(range(0, k + 2)):
                h = run(i, h)
        else:
            k = (stage - 1) // 2
            h_0 = self._in(k, downscale2x(x))
            h_1 = run(k + 1, self._in(k + 1, x))
            h = (1.0 - alpha) * h_0 + alpha * h_1
            for i in reversed(range(0, k + 1)):
                h = run(i, h)
        cos_part, sin_part = h[:, -9:-6], h[:, -6:-3]
        inv = 1.0 / torch.sqrt(torch.square(cos_part) + torch.square(sin_part) + 1e-8)
        return h[:, :-9], torch.cat([cos_part * inv, sin_part * inv, h[:, -3:]], dim=1)


class MLP(nn.Module):
    """Three linears of widths ``ch``, ``ch``, ``out_ch`` with leaky ReLU
    between, equalized or spectrally normalised (``net.py:893-917``)."""

    def __init__(self, in_ch: int, ch: int, out_ch: int, sn: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()

        def lin(i, o):
            return SNLinear(i, o, generator=generator) if sn else EqualizedLinear(i, o, generator=generator)

        self.l0, self.l1, self.l2 = lin(in_ch, ch), lin(ch, ch), lin(ch, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.l2(leaky_relu(self.l1(leaky_relu(self.l0(x)))))


class CameraParamDiscriminator(nn.Module):
    """9 camera parameters -> a realness logit (``net.py:816-828``)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.l0 = EqualizedLinear(9, 64, generator=generator)
        self.l1 = EqualizedLinear(64, 64, generator=generator)
        self.l2 = EqualizedLinear(64, 1, generator=generator)

    def forward(self, camera_param: torch.Tensor) -> torch.Tensor:
        return self.l2(leaky_relu(self.l1(leaky_relu(self.l0(camera_param)))))


class BigBiGANDiscriminator(nn.Module):
    """Joint (x, z, camera) discriminator (``net.py:920-948``): a PGGAN
    discriminator with ``ch`` outputs for x, MLPs for z and the camera, a
    joint MLP on the three, and one linear score each. Returns
    ``(s_xzcp, s_x, s_z, s_cp)``."""

    def __init__(self, ch: int, dim_z: int, enable_blur: bool = False, sn: bool = False, res: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.f = Discriminator(ch, out_dim=ch, enable_blur=enable_blur, sn=sn, res=res, generator=generator)
        self.h_z = MLP(dim_z, ch, ch, sn=sn, generator=generator)
        self.h_cp = MLP(9, 9, ch, sn=sn, generator=generator)
        self.j = MLP(ch * 3, ch * 3, 1, sn=sn, generator=generator)

        def lin():
            return SNLinear(ch, 1, generator=generator) if sn else EqualizedLinear(ch, 1, generator=generator)

        self.s_x, self.s_z, self.s_cp = lin(), lin(), lin()

    def forward(self, x: torch.Tensor, z: torch.Tensor, cp: torch.Tensor, stage_floor: int, alpha=0.0):
        f = self.f(x, stage_floor, alpha)
        h_z, h_cp = self.h_z(z), self.h_cp(cp)
        s_xzcp = self.j(torch.cat([f, h_z, h_cp], dim=1))
        return s_xzcp, self.s_x(f), self.s_z(h_z), self.s_cp(h_cp)
