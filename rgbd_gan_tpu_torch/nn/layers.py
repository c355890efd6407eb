"""NN components on the StyleGAN and DeepVoxels RGBD paths (PyTorch, NHWC).

Port of the subset of :mod:`rgbd_gan_tpu.nn.layers` that the StyleGAN and
DeepVoxels train steps run (reference ``common/networks/component/``):

- equalized-learning-rate conv/linear (``pggan.py:13-50``): weights drawn
  N(0, 1), the *input* scaled at run time by ``inv_c = gain * sqrt(1/fan_in)``
  (the reference's ``lrmul`` is 1 on this path)
- PixelNorm (``pggan.py:7-10``) and AdaIN as instance norm (biased
  variance, eps 1e-5) plus a per-channel style affine (``adain.py:10-77``)
- nearest 2x upscale, 2x2 average pool, [1,2,1]^2 blur (``rescale.py``)
- noise injection with one noise map broadcast over channels (``net.py:72-81``)
- the toRGBD depth-head initialisers (``net.py:211-214``)
- spectrally normalised conv and linear layers, the twins of Chainer's
  SpectralNormalization hook: a power-iteration vector ``u`` kept as a
  buffer and advanced once by every training-mode forward
- flax's ``nn.BatchNorm`` (the DeepVoxels occlusion nets and RenderNet, the
  encoder and a discriminator block with ``bn``)
- the 3D twins for the voxel generator: equalized 3D conv (``pggan.py:27-38``,
  with its ``k**2`` fan-in quirk), nearest 2x unpool over (D, H, W), and
  Chainer's ``F.normalize`` over channels

Activations are NHWC, as in the JAX package. Conv weights are PyTorch's
(out, in, kh, kw) and linear weights (out, in); a convolution runs on a
permuted NCHW *view* of the NHWC tensor (channels-last strides), so no
layout copy is made.

A bf16 activation (the JAX package's ``compute_dtype``) is rounded where the
JAX modules round it: parameters stay float32 and are cast to the
activation's dtype at each use, a Python constant scales it as JAX's weak
typing does (rounded to the activation's dtype first), biases are added
after the product, and the norms compute their statistics and affine in
float32 and return the input's dtype.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


@functools.lru_cache(maxsize=None)
def weak_scalar(c: float, dtype: torch.dtype) -> float:
    """The Python constant ``c`` as JAX's weak typing applies it to an array
    of ``dtype``: rounded to that dtype (0.2 is 0.2001953125 in bf16)."""
    return float(torch.tensor(c, dtype=dtype))


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """Chainer's default leaky ReLU slope is 0.2."""
    return F.leaky_relu(x, weak_scalar(slope, x.dtype))


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """x / sqrt(mean(x^2 over the last axis) + eps) (``pggan.py:7-10``),
    computed in float32."""
    xf = x.float()
    return (xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)).to(x.dtype)


def adain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Adaptive instance norm over the spatial axes of an NHWC tensor, biased
    variance, then ``xn * scale + bias`` with (B, C) style vectors; computed
    in float32."""
    axes = tuple(range(1, x.dim() - 1))
    xf = x.float()
    mean = torch.mean(xf, dim=axes, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=axes, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + eps)
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    return (xn * scale.reshape(shape).float() + bias.reshape(shape).float()).to(x.dtype)


def l2_normalize_channels(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Chainer ``F.normalize``: x / (||x||_2 + eps) over the last axis, computed
    in float32."""
    xf = x.float()
    return (xf / (torch.sqrt(torch.sum(xf * xf, dim=-1, keepdim=True)) + eps)).to(x.dtype)


def upscale2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x unpool (``rescale.py:4-5``). NHWC."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def upscale2x_3d(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x unpool over (D, H, W). NDHWC."""
    b, d, h, w, c = x.shape
    x = x[:, :, None, :, None, :, None, :].expand(b, d, 2, h, 2, w, 2, c)
    return x.reshape(b, 2 * d, 2 * h, 2 * w, c)


def downscale2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool (``rescale.py:12-13``). NHWC."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def blur3x3(x: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 [1,2,1]^2/16 blur, pad 1 (``rescale.py:21-26``). NHWC."""
    c = x.shape[-1]
    k = torch.tensor([1.0, 2.0, 1.0], dtype=x.dtype, device=x.device)
    k = (k[:, None] * k[None, :]) / 16.0
    weight = k.expand(c, 1, 3, 3)
    return conv2d_nhwc(x, weight, padding=1, groups=c)


def conv2d_nhwc(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: int = 0,
    groups: int = 1,
) -> torch.Tensor:
    """2D convolution of an NHWC tensor with an (out, in, kh, kw) weight."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride, padding, 1, groups)
    return y.permute(0, 2, 3, 1)


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``y + bias`` after the product, in y's dtype, as the JAX layers add it
    (a bias passed into the product would be added before its rounding)."""
    return y if bias is None else y + bias.to(y.dtype)


class EqualizedLinear(nn.Module):
    """Linear with equalized learning rate (``pggan.py:40-50``)."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        gain: float = math.sqrt(2.0),
        bias_init: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.inv_c = gain * math.sqrt(1.0 / in_features)
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        nn.init.normal_(self.weight, 0.0, 1.0, generator=generator)
        self.bias = nn.Parameter(torch.full((out_features,), float(bias_init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        return _add_bias(F.linear(x * weak_scalar(self.inv_c, x.dtype), self.weight.to(x.dtype)), self.bias)


class EqualizedConv2D(nn.Module):
    """Conv with equalized learning rate (``pggan.py:13-24``), NHWC:
    ``inv_c = gain * sqrt(1 / (in_ch * k^2))`` multiplies the input."""

    def __init__(
        self,
        in_ch: int,
        out_ch: int,
        kernel_size: int = 1,
        stride: int = 1,
        padding: int = 0,
        gain: float = math.sqrt(2.0),
        use_bias: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.inv_c = gain * math.sqrt(1.0 / (in_ch * kernel_size**2))
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        nn.init.normal_(self.weight, 0.0, 1.0, generator=generator)
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_nhwc(x * weak_scalar(self.inv_c, x.dtype), self.weight.to(x.dtype), None, self.stride, self.padding)
        return _add_bias(y, self.bias)


class EqualizedConv3D(nn.Module):
    """3D conv with equalized learning rate (``pggan.py:27-38``), NDHWC, weight
    (out, in, kd, kh, kw). Quirk kept: ``inv_c`` uses ``k**2``, not ``k**3``.
    A 1x1x1 conv runs as a matmul over the channel axis, which needs no
    layout change of a large frustum volume."""

    def __init__(
        self,
        in_ch: int,
        out_ch: int,
        kernel_size: int = 1,
        stride: int = 1,
        padding: int = 0,
        gain: float = math.sqrt(2.0),
        use_bias: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.inv_c = gain * math.sqrt(1.0 / (in_ch * kernel_size**2))
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size, kernel_size))
        nn.init.normal_(self.weight, 0.0, 1.0, generator=generator)
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x * weak_scalar(self.inv_c, x.dtype)
        weight = self.weight.to(x.dtype)
        if self.kernel_size == 1 and self.stride == 1 and self.padding == 0:
            y = F.linear(x, weight.flatten(1))
        else:
            y = F.conv3d(x.permute(0, 4, 1, 2, 3), weight, None, self.stride, self.padding).permute(0, 2, 3, 4, 1)
        return _add_bias(y, self.bias)


class NoiseBlock(nn.Module):
    """Noise injection (``net.py:65-87``): one noise map broadcast to every
    channel (quirk kept), scaled by a zero-initialised per-channel gain."""

    def __init__(self, channels: int):
        super().__init__()
        self.gain = nn.Parameter(torch.zeros(channels))

    def forward(self, h: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        noise = torch.randn(h.shape[:-1] + (1,), generator=generator, device=h.device, dtype=h.dtype)
        return h + noise * self.gain.to(h.dtype)


class AdaINBlock(nn.Module):
    """StyleBlock (``net.py:90-102``): two gain-1 equalized linears give the
    AdaIN scale (bias initialised to one) and bias from ``w``."""

    def __init__(self, w_dim: int, features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.s = EqualizedLinear(w_dim, features, gain=1.0, bias_init=1.0, generator=generator)
        self.b = EqualizedLinear(w_dim, features, gain=1.0, bias_init=0.0, generator=generator)

    def forward(self, w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return adain(h, self.s(w), self.b(w))


def _power_iteration(w_mat: torch.Tensor, u: torch.Tensor, eps: float = 1e-12):
    """One power-iteration step on ``w_mat`` (out, in) from ``u`` (1, out):
    ``(sigma, u_new)``. Differentiable through ``w_mat`` (``v`` and
    ``u_new`` included); the caller passes ``u`` without a gradient."""
    v = torch.matmul(u, w_mat)
    v = v * torch.rsqrt(torch.sum(v * v) + eps)
    u_new = torch.matmul(v, w_mat.t())
    u_new = u_new * torch.rsqrt(torch.sum(u_new * u_new) + eps)
    return torch.sum(u_new * torch.matmul(v, w_mat.t())), u_new


class _SpectralNorm(nn.Module):
    """The weight divided by its largest singular value, estimated by one
    power iteration from the buffer ``u`` (1, out). A training-mode forward
    advances ``u`` (without a gradient) and lets sigma carry a gradient
    through the weight; an eval-mode forward leaves ``u`` as it is and
    stops sigma's gradient, as the JAX package does when its ``sn``
    collection is not mutable. The weight is drawn U(-1, 1) (Chainer's
    ``initializers.Uniform(1)``, no equalized scale); ``u`` starts N(0, 1)
    and takes one power iteration at construction, as the flax init does."""

    def _init_sn(self, shape, out_features: int, generator: Optional[torch.Generator]) -> None:
        self.weight = nn.Parameter(torch.empty(shape).uniform_(-1.0, 1.0, generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_features))
        u = torch.randn(1, out_features, generator=generator)
        self.register_buffer("u", _power_iteration(self.weight.detach().flatten(1), u)[1])

    def normalized_weight(self) -> torch.Tensor:
        w_mat = self.weight.flatten(1)
        if not self.training:
            with torch.no_grad():
                sigma, _ = _power_iteration(w_mat, self.u)
            return self.weight / sigma
        sigma, u_new = _power_iteration(w_mat, self.u.clone())
        with torch.no_grad():
            self.u.copy_(u_new)
        return self.weight / sigma


class SNConv2D(_SpectralNorm):
    """Spectrally normalised conv (``SNConv2D`` of the JAX package), NHWC; the
    normalised kernel is cast to the input's dtype, the bias added after."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1, stride: int = 1, padding: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self._init_sn((out_ch, in_ch, kernel_size, kernel_size), out_ch, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_nhwc(x, self.normalized_weight().to(x.dtype), None, self.stride, self.padding)
        return _add_bias(y, self.bias)


class SNLinear(_SpectralNorm):
    """Spectrally normalised linear layer (``SNLinear`` of the JAX package)."""

    def __init__(self, in_features: int, out_features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self._init_sn((out_features, in_features), out_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        return _add_bias(F.linear(x, self.normalized_weight().to(x.dtype)), self.bias)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis: momentum 0.99, eps 1e-5,
    batch variance ``mean(x^2) - mean(x)^2``, and running statistics updated
    with the *biased* batch variance (``torch.nn.BatchNorm3d`` takes the
    unbiased one). ``scale``/``bias`` are parameters, ``mean``/``var``
    buffers, under flax's names."""

    momentum = 0.99
    eps = 1e-5

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if train:
            axes = tuple(range(x.dim() - 1))
            mean = torch.mean(x, dim=axes)
            var = torch.clamp(torch.mean(x * x, dim=axes) - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(mean.detach(), alpha=1.0 - self.momentum)
                self.var.mul_(self.momentum).add_(var.detach(), alpha=1.0 - self.momentum)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


def init_depth_head_(conv: EqualizedConv2D, initial_depth: float) -> None:
    """toRGBD init (``net.py:211-214``): the depth (last) output channel's
    weights zeroed; bias zero except the depth channel at
    ``log(e^initial_depth - 1)``, so the initial inverse depth is about
    ``1/initial_depth``."""
    with torch.no_grad():
        conv.weight[-1].zero_()
        conv.bias.zero_()
        conv.bias[-1] = math.log(math.e**initial_depth - 1.0)
