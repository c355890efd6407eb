"""PGGAN discriminators (NHWC) — port of :mod:`rgbd_gan_tpu.models.discriminator`
(reference ``net.py:357-599``).

D sees RGB only. Progressive fade-in mirrors the generator; the 32x32
hidden feature (tapped before ``block3``) is returned with
``return_hidden=True``. ``res=True`` adds a conv shortcut per block.
``compute_dtype=torch.bfloat16`` (the yml's ``mixed16``) casts the input at
entry and runs the trunk in bf16 with float32 parameters; the logit and the
hidden tap are returned in float32. ``sn=True`` swaps every conv and
linear for its spectrally normalised twin (``nn.layers.SNConv2D`` /
``SNLinear``), whose power-iteration vectors ``u`` are buffers advanced by
each training-mode forward: the JAX package's mutable ``sn`` collection.
``DiscriminatorBlock(bn=True)`` puts flax's BatchNorm after each conv (the
encoder's blocks); ``DisentangledDiscriminator`` (``net.py:507-599``,
declared in the reference and unused by the shipped configs) runs a shared
trunk into camera, z and adversarial heads.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.layers import (
    BatchNorm,
    EqualizedConv2D,
    EqualizedLinear,
    SNConv2D,
    SNLinear,
    blur3x3,
    downscale2x,
    leaky_relu,
)

MAX_STAGE = 17


def _conv(sn: bool, in_ch: int, out_ch: int, k: int, stride: int, pad: int, generator) -> nn.Module:
    if sn:
        return SNConv2D(in_ch, out_ch, k, stride, pad, generator=generator)
    return EqualizedConv2D(in_ch, out_ch, k, stride, pad, generator=generator)


def _linear(sn: bool, in_features: int, out_features: int, generator) -> nn.Module:
    if sn:
        return SNLinear(in_features, out_features, generator=generator)
    return EqualizedLinear(in_features, out_features, gain=1.0, generator=generator)


class DiscriminatorBlockBase(nn.Module):
    """Final 4x4 head: 3x3 conv -> 4x4 valid conv -> linear (``net.py:357-377``)."""

    def __init__(self, ch: int, out_dim: int = 1, sn: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.c0 = _conv(sn, ch, ch, 3, 1, 1, generator)
        self.c1 = _conv(sn, ch, ch, 4, 1, 0, generator)
        self.l2 = _linear(sn, ch, out_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = leaky_relu(self.c0(x))
        h = leaky_relu(self.c1(h))
        return self.l2(h)


class DiscriminatorBlock(nn.Module):
    """conv x2 (+ BatchNorm after each with ``bn``, + residual conv shortcut)
    then 2x2 average pool (``net.py:380-426``). ``train`` picks the batch's
    statistics (updating the running ones) or the running ones."""

    def __init__(
        self,
        in_ch: int,
        out_ch: int,
        enable_blur: bool = False,
        res: bool = False,
        sn: bool = False,
        bn: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.in_ch, self.enable_blur, self.res, self.bn = in_ch, enable_blur, res, bn
        self.c0 = _conv(sn, in_ch, out_ch, 3, 1, 1, generator)
        self.c1 = _conv(sn, out_ch, out_ch, 3, 1, 1, generator)
        if bn:
            self.b0 = BatchNorm(out_ch)
            self.b1 = BatchNorm(out_ch)
        if res:
            self.c_sc = _conv(sn, in_ch, out_ch, 3, 1, 1, generator)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        h = self.c0(x)
        if self.bn:
            h = self.b0(h, train)
        h = self.c1(leaky_relu(h))
        if self.bn:
            h = self.b1(h, train)
        if self.res:
            h = h + self.c_sc(x)
        h = downscale2x(leaky_relu(h))
        return blur3x3(h) if self.enable_blur else h


def _dis_block_channels(ch: int):
    """(in, out) for blocks 1..5 at 8/16/32/64/128 px (``net.py:438-445``)."""
    return [(ch, ch), (ch, ch), (ch, ch), (ch // 2, ch), (ch // 4, ch // 2)]


def _dis_in_channels(ch: int):
    return [ch, ch, ch, ch, ch // 2, ch // 4]


class Discriminator(nn.Module):
    """Progressive PGGAN discriminator (``net.py:429-504``)."""

    def __init__(
        self,
        ch: int = 512,
        out_dim: int = 1,
        enable_blur: bool = False,
        sn: bool = False,
        res: bool = False,
        compute_dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.block0 = DiscriminatorBlockBase(ch, out_dim, sn=sn, generator=generator)
        for i, (c_in, c_out) in enumerate(_dis_block_channels(ch)):
            self.add_module(
                f"block{i + 1}",
                DiscriminatorBlock(c_in, c_out, enable_blur=enable_blur, res=res, sn=sn, generator=generator),
            )
        for i, c in enumerate(_dis_in_channels(ch)):
            self.add_module(f"in{i}", _conv(sn, 3, c, 1, 1, 0, generator))

    def _run_block(self, i: int, h: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"block{i}")(h)

    def _in(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(getattr(self, f"in{i}")(x))

    def forward(self, x: torch.Tensor, stage_floor: int, alpha=0.0, *, return_hidden: bool = False):
        stage = min(int(stage_floor), MAX_STAGE - 1)
        feat = None
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        if stage % 2 == 0:
            k = (stage - 2) // 2
            h = self._in(k + 1, x)
            for i in reversed(range(0, k + 2)):  # k+1 .. 0
                if i == 3:
                    feat = h  # 32x32 tap for the feature 3D-consistency loss
                h = self._run_block(i, h)
        else:
            k = (stage - 1) // 2
            h_0 = self._in(k, downscale2x(x))
            h_1 = self._run_block(k + 1, self._in(k + 1, x))
            # the JAX trainer passes alpha as a float32 array, which promotes a
            # bf16 trunk: every block after the fade-in runs in float32
            h = (1.0 - alpha) * h_0.float() + alpha * h_1.float()
            for i in reversed(range(0, k + 1)):  # k .. 0
                if i == 3:
                    feat = h
                h = self._run_block(i, h)
        h = h.float()
        if return_hidden:
            return h, (feat.float() if feat is not None else None)
        return h


class DisentangledDiscriminator(nn.Module):
    """A shared trunk of seven blocks, then three block + head pairs: the 9
    camera parameters, ``ch * num_z`` latent estimates and the adversarial
    logit (``net.py:507-599``). Returns ``(logit, camera, z)``."""

    def __init__(
        self,
        ch: int = 512,
        enable_blur: bool = False,
        sn: bool = False,
        res: bool = False,
        num_z: int = 2,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        shared = [(ch, ch), (ch, ch), (ch // 2, ch), (ch // 4, ch // 2), (ch // 8, ch // 4),
                  (ch // 16, ch // 8), (ch // 32, ch // 16)]

        def block(c_in, c_out):
            return DiscriminatorBlock(c_in, c_out, enable_blur=enable_blur, res=res, sn=sn, generator=generator)

        for i, (c_in, c_out) in enumerate(shared):
            self.add_module(f"shared{i}", block(c_in, c_out))
        self.cam_block = block(ch, ch)
        self.cam_head = DiscriminatorBlockBase(ch, out_dim=9, sn=sn, generator=generator)
        self.z_block = block(ch, ch)
        self.z_head = DiscriminatorBlockBase(ch, out_dim=ch * num_z, sn=sn, generator=generator)
        self.adv_block = block(ch, ch)
        self.adv_head = DiscriminatorBlockBase(ch, out_dim=1, sn=sn, generator=generator)
        ins = [ch, ch, ch, ch, ch // 2, ch // 4, ch // 8, ch // 16, ch // 32]
        for i, c in enumerate(ins):
            self.add_module(f"in{i}", _conv(sn, 3, c, 1, 1, 0, generator))

    def _shared(self, i: int, h: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"shared{i}")(h)

    def _in(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(getattr(self, f"in{i}")(x))

    def forward(self, x: torch.Tensor, stage_floor: int, alpha=0.0):
        stage = min(int(stage_floor), MAX_STAGE - 1)
        if stage % 2 == 0:
            k = (stage - 2) // 2
            h = self._in(k + 1, x)
            for i in reversed(range(0, k)):
                h = self._shared(i, h)
        else:
            k = (stage - 1) // 2
            h_0 = self._in(k, downscale2x(x))
            h_1 = self._shared(k - 1, self._in(k + 1, x))
            h = (1.0 - alpha) * h_0 + alpha * h_1
            for i in reversed(range(0, k - 1)):
                h = self._shared(i, h)
        est_camera = self.cam_head(self.cam_block(h))
        est_z = self.z_head(self.z_block(h))
        return self.adv_head(self.adv_block(h)), est_camera, est_z
