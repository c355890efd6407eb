"""Plain PyTorch layers of the RGBD-GAN steps (NHWC), for the benchmark's
reference.

A frozen, self-contained copy of the equalized-learning-rate layers, the
norms and the resampling that the StyleGAN and DeepVoxels training steps
run (reference ``common/networks/component/``: ``pggan.py``, ``adain.py``,
``rescale.py``), written without any kernel, cache or fused path and
importing nothing of the measured program.

- equalized conv/linear: weights drawn N(0, 1), the *input* scaled at run
  time by ``gain * sqrt(1 / fan_in)``; biases added after the product
- PixelNorm and AdaIN (instance norm, biased variance, eps 1e-5, then a
  per-channel style affine), computed in float32
- nearest 2x upscale, 2x2 average pool
- bf16 trunks (``compute_dtype``): parameters stay float32 and are cast at
  each use, a Python constant is rounded to the activation's dtype first

Every convolution and linear product passes its operands through
:func:`operand`, which rounds them to a lower precision inside
:func:`rounded_operands` (the benchmark's control: the same arithmetic in
the next precision down).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

_ROUNDING: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar("operand_rounding", default=None)
ROUNDINGS = ("tf32", "fp8")


@contextlib.contextmanager
def rounded_operands(kind: Optional[str]) -> Iterator[None]:
    """Round every conv and linear operand to ``kind`` inside the block:
    ``"tf32"`` (10 mantissa bits, round to nearest) or ``"fp8"`` (e4m3 with
    one scale per tensor, its largest magnitude at 448); ``None`` leaves
    them as they are."""
    if kind is not None and kind not in ROUNDINGS:
        raise ValueError(f"unknown rounding {kind!r}; expected one of {ROUNDINGS}")
    token = _ROUNDING.set(kind)
    try:
        yield
    finally:
        _ROUNDING.reset(token)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """A float32 tensor rounded to TF32's 10 mantissa bits (to nearest, ties
    away from zero), as a tensor core reads it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale per tensor, back in its dtype."""
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / 448.0
    q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


def operand(x: torch.Tensor) -> torch.Tensor:
    """A product's operand, rounded as :func:`rounded_operands` asks."""
    kind = _ROUNDING.get()
    if kind is None:
        return x
    if kind == "fp8":
        return round_fp8(x)
    if x.dtype != torch.float32:
        return x
    return x + (round_tf32(x.detach()) - x).detach()


@functools.lru_cache(maxsize=None)
def weak_scalar(c: float, dtype: torch.dtype) -> float:
    """The constant ``c`` rounded to ``dtype`` (JAX's weak typing)."""
    return float(torch.tensor(c, dtype=dtype, device="cpu"))


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, weak_scalar(slope, x.dtype))


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)).to(x.dtype)


def adain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    axes = tuple(range(1, x.dim() - 1))
    xf = x.float()
    mean = torch.mean(xf, dim=axes, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=axes, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + eps)
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    return (xn * scale.reshape(shape).float() + bias.reshape(shape).float()).to(x.dtype)


def upscale2x(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def upscale2x_3d(x: torch.Tensor) -> torch.Tensor:
    b, d, h, w, c = x.shape
    x = x[:, :, None, :, None, :, None, :].expand(b, d, 2, h, 2, w, 2, c)
    return x.reshape(b, 2 * d, 2 * h, 2 * w, c)


def downscale2x(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    return y if bias is None else y + bias.to(y.dtype)


class EqualizedLinear(nn.Module):
    def __init__(self, in_features: int, out_features: int, gain: float = math.sqrt(2.0), bias_init: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.inv_c = gain * math.sqrt(1.0 / in_features)
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        nn.init.normal_(self.weight, 0.0, 1.0, generator=generator)
        self.bias = nn.Parameter(torch.full((out_features,), float(bias_init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        x = x * weak_scalar(self.inv_c, x.dtype)
        return _add_bias(F.linear(operand(x), operand(self.weight.to(x.dtype))), self.bias)


class EqualizedConv2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1, stride: int = 1, padding: int = 0,
                 gain: float = math.sqrt(2.0), use_bias: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.inv_c = gain * math.sqrt(1.0 / (in_ch * kernel_size**2))
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        nn.init.normal_(self.weight, 0.0, 1.0, generator=generator)
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x * weak_scalar(self.inv_c, x.dtype)
        y = F.conv2d(operand(x.permute(0, 3, 1, 2)), operand(self.weight.to(x.dtype)), None, self.stride,
                     self.padding)
        return _add_bias(y.permute(0, 2, 3, 1), self.bias)


class EqualizedConv3D(nn.Module):
    """NDHWC; ``inv_c`` uses ``k**2`` (the reference's quirk). A 1x1x1 conv
    is a product over the channel axis."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1, stride: int = 1, padding: int = 0,
                 gain: float = math.sqrt(2.0), use_bias: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.inv_c = gain * math.sqrt(1.0 / (in_ch * kernel_size**2))
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size, kernel_size))
        nn.init.normal_(self.weight, 0.0, 1.0, generator=generator)
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x * weak_scalar(self.inv_c, x.dtype)
        weight = operand(self.weight.to(x.dtype))
        if self.kernel_size == 1 and self.stride == 1 and self.padding == 0:
            y = F.linear(operand(x), weight.flatten(1))
        else:
            y = F.conv3d(operand(x.permute(0, 4, 1, 2, 3)), weight, None, self.stride, self.padding)
            y = y.permute(0, 2, 3, 4, 1)
        return _add_bias(y, self.bias)


class NoiseBlock(nn.Module):
    """The noise gain exists (checkpoint layout); noise is never added."""

    def __init__(self, channels: int):
        super().__init__()
        self.gain = nn.Parameter(torch.zeros(channels))


class AdaINBlock(nn.Module):
    def __init__(self, w_dim: int, features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.s = EqualizedLinear(w_dim, features, gain=1.0, bias_init=1.0, generator=generator)
        self.b = EqualizedLinear(w_dim, features, gain=1.0, bias_init=0.0, generator=generator)

    def forward(self, w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return adain(h, self.s(w), self.b(w))


def init_depth_head_(conv: EqualizedConv2D, initial_depth: float) -> None:
    """The depth channel's weights zeroed, its bias at
    ``log(e^initial_depth - 1)`` (``net.py:211-214``)."""
    with torch.no_grad():
        conv.weight[-1].zero_()
        conv.bias.zero_()
        conv.bias[-1] = math.log(math.e**initial_depth - 1.0)
