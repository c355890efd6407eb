"""Plain PyTorch StyleGAN RGBD generator and progressive PGGAN discriminator
(NHWC), for the benchmark's reference.

A frozen copy of the published architecture (RGBD-GAN ``net.py:22-504``)
as the configurations run it: the mapping network (PixelNorm, 8 equalized
linears), the progressive synthesis stack (const 4x4, upsample, conv, bias,
leaky ReLU, AdaIN), camera conditioning of blocks 0-1 (``[w, theta*16]``
through two linears), ``w2`` from block 3 on, the inverse-depth head
``1/(softplus(h) + 1e-4)``, and the residual discriminator. Noise is never
added (``net.py:243``). ``compute_dtype`` runs the trunks in bf16 with
float32 parameters; the mapping, the heads and the blend stay float32.

Parameter names and construction order are those of the published
checkpoints (``gen.block0.c1.weight``, ``block5.c_sc.weight``), so one state
dict loads into either implementation.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (
    AdaINBlock,
    EqualizedConv2D,
    EqualizedLinear,
    NoiseBlock,
    downscale2x,
    init_depth_head_,
    leaky_relu,
    pixel_norm,
    upscale2x,
)

MAX_STAGE = 17


class MappingNetwork(nn.Module):
    def __init__(self, ch: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        for i in range(8):
            self.add_module(f"l{i}", EqualizedLinear(ch, ch, generator=generator))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = pixel_norm(z.reshape(z.shape[0], -1))
        for i in range(8):
            h = leaky_relu(getattr(self, f"l{i}")(h))
        return h


class SynthesisBlock(nn.Module):
    def __init__(self, ch: int, ch_in: int, w_dim: int, upsample: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ch_in, self.upsample = ch_in, upsample
        if upsample:
            self.c0 = EqualizedConv2D(ch_in, ch, 3, 1, 1, use_bias=False, generator=generator)
        else:
            self.const = nn.Parameter(torch.ones(4, 4, ch_in))
        self.n0 = NoiseBlock(ch)
        self.b0 = nn.Parameter(torch.zeros(ch))
        self.s0 = AdaINBlock(w_dim, ch, generator=generator)
        self.c1 = EqualizedConv2D(ch, ch, 3, 1, 1, use_bias=False, generator=generator)
        self.n1 = NoiseBlock(ch)
        self.b1 = nn.Parameter(torch.zeros(ch))
        self.s1 = AdaINBlock(w_dim, ch, generator=generator)

    def forward(self, w: torch.Tensor, x: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.upsample:
            h = self.c0(upscale2x(x))
        else:
            h = self.const[None].expand(w.shape[0], 4, 4, self.ch_in).to(w.dtype)
        h = self.s0(w, leaky_relu(h + self.b0.to(h.dtype)))
        h = self.c1(h)
        return self.s1(w, leaky_relu(h + self.b1.to(h.dtype)))


class StyleGenerator(nn.Module):
    """Synthesis blocks at 4, 8, 16, 32, 64, 128 px, each with its toRGBD head."""

    def __init__(self, ch: int, initial_depth: float = 1.0, compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        chans = ((ch, ch), (ch, ch), (ch, ch), (ch, ch), (ch // 2, ch), (ch // 4, ch // 2))
        for i, (c_out, c_in) in enumerate(chans):
            self.add_module(f"block{i}", SynthesisBlock(c_out, c_in, ch, upsample=(i != 0), generator=generator))
            out = EqualizedConv2D(c_out, 4, 1, 1, 0, gain=1.0, generator=generator)
            init_depth_head_(out, initial_depth)
            self.add_module(f"out{i}", out)
        self.l1 = EqualizedLinear(ch + 9, ch, generator=generator)
        self.l2 = EqualizedLinear(ch, ch, generator=generator)

    def _w(self, i: int, w: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
        if i >= 2:
            return w
        return leaky_relu(self.l2(leaky_relu(self.l1(torch.cat([w, theta * 16], dim=1)))))

    def forward(self, w: torch.Tensor, w2: torch.Tensor, stage_floor: int, alpha, theta: torch.Tensor):
        stage = min(int(stage_floor), MAX_STAGE - 1)
        if self.compute_dtype is not None:
            w, w2, theta = w.to(self.compute_dtype), w2.to(self.compute_dtype), theta.to(self.compute_dtype)
        block = lambda i: getattr(self, f"block{i}")  # noqa: E731
        out = lambda i: getattr(self, f"out{i}")  # noqa: E731
        h = None
        if stage % 2 == 0:
            k = (stage - 2) // 2
            for i in range(0, k + 2):
                if i == 3:
                    w = w2
                h = block(i)(self._w(i, w, theta), x=h)
            h = out(k + 1)(h.float())
        else:
            k = (stage - 1) // 2
            for i in range(0, k + 1):
                if i == 3:
                    w = w2
                h = block(i)(self._w(i, w, theta), x=h)
            h_0 = upscale2x(out(k)(h.float()))
            h_1 = out(k + 1)(block(k + 1)(w, x=h).float())  # the fade-in block takes the unconditioned w
            h = (1.0 - alpha) * h_0 + alpha * h_1
        depth = 1.0 / (F.softplus(h[..., -1:]) + 1e-4)
        return torch.cat([h[..., :3], depth], dim=-1)


class StyleGANGenerator(nn.Module):
    def __init__(self, ch: int, initial_depth: float = 1.0, compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mapping = MappingNetwork(ch, generator=generator)
        self.gen = StyleGenerator(ch, initial_depth, compute_dtype, generator=generator)

    def forward(self, z: torch.Tensor, stage_floor: int, alpha, theta: torch.Tensor) -> torch.Tensor:
        z1, z2 = torch.chunk(z.reshape(z.shape[0], -1), 2, dim=1)
        return self.gen(self.mapping(z1), self.mapping(z2), stage_floor, alpha, theta)


class DiscriminatorBlockBase(nn.Module):
    def __init__(self, ch: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.c0 = EqualizedConv2D(ch, ch, 3, 1, 1, generator=generator)
        self.c1 = EqualizedConv2D(ch, ch, 4, 1, 0, generator=generator)
        self.l2 = EqualizedLinear(ch, 1, gain=1.0, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.l2(leaky_relu(self.c1(leaky_relu(self.c0(x)))))


class DiscriminatorBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, res: bool, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.res = res
        self.c0 = EqualizedConv2D(in_ch, out_ch, 3, 1, 1, generator=generator)
        self.c1 = EqualizedConv2D(out_ch, out_ch, 3, 1, 1, generator=generator)
        if res:
            self.c_sc = EqualizedConv2D(in_ch, out_ch, 3, 1, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.c1(leaky_relu(self.c0(x)))
        if self.res:
            h = h + self.c_sc(x)
        return downscale2x(leaky_relu(h))


class Discriminator(nn.Module):
    def __init__(self, ch: int, res: bool = True, compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.block0 = DiscriminatorBlockBase(ch, generator=generator)
        for i, (c_in, c_out) in enumerate([(ch, ch), (ch, ch), (ch, ch), (ch // 2, ch), (ch // 4, ch // 2)]):
            self.add_module(f"block{i + 1}", DiscriminatorBlock(c_in, c_out, res, generator=generator))
        for i, c in enumerate([ch, ch, ch, ch, ch // 2, ch // 4]):
            self.add_module(f"in{i}", EqualizedConv2D(3, c, 1, 1, 0, generator=generator))

    def forward(self, x: torch.Tensor, stage_floor: int, alpha=0.0) -> torch.Tensor:
        stage = min(int(stage_floor), MAX_STAGE - 1)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        block = lambda i: getattr(self, f"block{i}")  # noqa: E731
        stem = lambda i, t: leaky_relu(getattr(self, f"in{i}")(t))  # noqa: E731
        if stage % 2 == 0:
            k = (stage - 2) // 2
            h = stem(k + 1, x)
            for i in reversed(range(0, k + 2)):
                h = block(i)(h)
        else:
            k = (stage - 1) // 2
            h_0 = stem(k, downscale2x(x))
            h_1 = block(k + 1)(stem(k + 1, x))
            # a float32 alpha promotes the trunk after the fade-in
            h = (1.0 - alpha) * h_0.float() + alpha * h_1.float()
            for i in reversed(range(0, k + 1)):
                h = block(i)(h)
        return h.float()
