"""RGBD generators: StyleGAN (mapping network and progressive synthesis) and
DCGAN, NHWC.

Port of the StyleGAN and DCGAN parts of :mod:`rgbd_gan_tpu.models.generators`
(reference ``net.py:22-354`` and ``:603-773``). Progressive growing takes an
integer ``stage_floor`` (which blocks run) and a fade-in ``alpha``. Quirks kept:

- camera conditioning of blocks 0-1 via ``rotate_w`` (concat
  ``[w, theta*16]`` -> two lrelu-linears, ``net.py:220-224``), or with
  ``rotate_conv_input`` via ``w_from_theta`` (the two linears on the pose
  alone, so ``l1`` takes 9 inputs, ``net.py:226-230``); the fade-in block of
  an odd stage gets the *unconditioned* ``w`` (``net.py:290``)
- ``w2`` takes over at block 3, 32 px (``net.py:258,276``)
- inverse-depth head ``1/(softplus(h) + 1e-4)`` (``net.py:294-299``)
- ``add_noise`` forced off in forward (``net.py:243``); the noise gains
  exist for checkpoint parity
- ``stylegan_make_hidden`` divides the 2*ch-dim z by sqrt(sum/ch)
  (``net.py:333-343``)
- DCGAN: the pose enters the stem linear as ``concat([z, theta*10])``, whose
  output is reshaped in the reference's NCHW layout (``net.py:729-734``);
  each block normalises with Chainer's ``F.normalize`` (an L2 norm over the
  channels); a stage below 2 raises, as in the JAX package
- eval mode (``train=False``) nearest-repeats an output below 64 px up to
  64 px (``net.py:305-311``)

``compute_dtype=torch.bfloat16`` (the yml's ``mixed16``) runs the synthesis
trunk (DCGAN: the stem and the blocks) in bf16 with float32 parameters; the
mapping network, the toRGBD heads, the fade-in blend and the depth decode
stay float32, and the output and the StyleGAN feature tap are float32.

With ``use_occupancy_net`` both generators own an ``OccupancyNet``
(``models/extras.py``) on ``[z, xyz]``: StyleGAN's takes the whole 2*ch latent
(``2*ch + 3`` inputs), DCGAN's its ``in_ch`` latent (``in_ch + 3``), and
``occupancy_logits(z, coords)`` runs it for the step's occupancy loss.

Parameter names follow the flax tree (``gen.block0.c1.weight`` is
``gen/block0/c1/kernel``), so :mod:`..bridge` maps one onto the other.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import (
    AdaINBlock,
    EqualizedConv2D,
    EqualizedLinear,
    NoiseBlock,
    blur3x3,
    init_depth_head_,
    l2_normalize_channels,
    leaky_relu,
    pixel_norm,
    upscale2x,
)
from ..utils import trace
from .extras import OccupancyNet

MAX_STAGE = 17
MIN_SAMPLE_IMAGE_SIZE = 64  # eval-mode minimum output size (net.py:306)


def mapping_make_hidden(
    generator: Optional[torch.Generator], batch_size: int, ch: int, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """Plain N(0, 1) (B, ch) latent of the legacy RGB path (``net.py:47-56``)."""
    return torch.randn(batch_size, ch, generator=generator, device=device)


def stylegan_make_hidden(
    generator: Optional[torch.Generator], batch_size: int, ch: int, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """(B, 2*ch) Gaussian normalised by sqrt(sum(z^2)/ch + 1e-8) — ``ch``, not
    ``2*ch`` (reference quirk)."""
    z = torch.randn(batch_size, ch * 2, generator=generator, device=device)
    return z / torch.sqrt(torch.sum(z * z, dim=1, keepdim=True) / ch + 1e-8)


def dcgan_make_hidden(
    generator: Optional[torch.Generator], batch_size: int, in_ch: int, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """(B, in_ch) Gaussian normalised by sqrt(sum(z^2)/in_ch + 1e-8) (``net.py:697-707``)."""
    z = torch.randn(batch_size, in_ch, generator=generator, device=device)
    return z / torch.sqrt(torch.sum(z * z, dim=1, keepdim=True) / in_ch + 1e-8)


def _rgbd_head(h: torch.Tensor, rgbd: bool) -> torch.Tensor:
    """Inverse-depth decode of the last channel: ``1/(softplus(h) + 1e-4)``
    (``net.py:294-299``)."""
    if not rgbd:
        return h
    depth = 1.0 / (F.softplus(h[..., -1:]) + 1e-4)
    return torch.cat([h[..., :3], depth], dim=-1)


def _eval_upsample(h: torch.Tensor) -> torch.Tensor:
    """Eval mode: nearest-repeat an output below 64 px up to 64 px (``net.py:305-311``)."""
    if h.shape[1] >= MIN_SAMPLE_IMAGE_SIZE:
        return h
    scale = MIN_SAMPLE_IMAGE_SIZE // h.shape[1]
    return h.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)


class MappingNetwork(nn.Module):
    """8x (equalized linear + leaky ReLU) on a PixelNorm'd latent (``net.py:22-62``)."""

    def __init__(self, ch: int = 512, generator: Optional[torch.Generator] = None):
        super().__init__()
        for i in range(8):
            self.add_module(f"l{i}", EqualizedLinear(ch, ch, generator=generator))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = pixel_norm(z.reshape(z.shape[0], -1))
        for i in range(8):
            h = leaky_relu(getattr(self, f"l{i}")(h))
        return h


class SynthesisBlock(nn.Module):
    """One synthesis block (``net.py:105-161``): const 4x4 input (ones) or
    upsample -> conv, then twice { conv -> bias -> lrelu -> AdaIN }. The
    noise gains ``n0``/``n1`` exist only with ``noise`` (the StyleGAN
    generator's blocks, whose JAX init adds noise once); the DeepVoxels
    background generator's blocks have none. Noise is never added in
    forward."""

    def __init__(
        self,
        ch: int,
        ch_in: int,
        w_dim: int,
        upsample: bool = True,
        enable_blur: bool = False,
        noise: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.ch, self.ch_in = ch, ch_in
        self.upsample, self.enable_blur = upsample, enable_blur
        if upsample:
            self.c0 = EqualizedConv2D(ch_in, ch, 3, 1, 1, use_bias=False, generator=generator)
        else:
            self.const = nn.Parameter(torch.ones(4, 4, ch_in))
        if noise:
            self.n0 = NoiseBlock(ch)
        self.b0 = nn.Parameter(torch.zeros(ch))
        self.s0 = AdaINBlock(w_dim, ch, generator=generator)
        self.c1 = EqualizedConv2D(ch, ch, 3, 1, 1, use_bias=False, generator=generator)
        if noise:
            self.n1 = NoiseBlock(ch)
        self.b1 = nn.Parameter(torch.zeros(ch))
        self.s1 = AdaINBlock(w_dim, ch, generator=generator)

    def forward(self, w: torch.Tensor, x: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.upsample:
            h = upscale2x(x)
            if self.enable_blur:
                h = blur3x3(h)
            h = self.c0(h)
        else:
            h = self.const[None].expand(w.shape[0], 4, 4, self.ch_in).to(w.dtype)
        h = self.s0(w, leaky_relu(h + self.b0.to(h.dtype)))
        h = self.c1(h)
        return self.s1(w, leaky_relu(h + self.b1.to(h.dtype)))


def _stylegan_block_channels(ch: int):
    """(ch_out, ch_in) per block: 4, 8, 16, 32, 64, 128 px (``net.py:174-184``)."""
    return ((ch, ch), (ch, ch), (ch, ch), (ch, ch), (ch // 2, ch), (ch // 4, ch // 2))


class StyleGenerator(nn.Module):
    """Progressive StyleGAN synthesis stack (``net.py:164-311``)."""

    def __init__(
        self,
        ch: int = 512,
        enable_blur: bool = False,
        rgbd: bool = False,
        rotate_conv_input: bool = False,
        use_occupancy_net: bool = False,
        initial_depth: float = 1.0,
        compute_dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.rgbd, self.compute_dtype = rgbd, compute_dtype
        self.rotate_conv_input = rotate_conv_input
        out_ch = 4 if rgbd else 3
        for i, (c_out, c_in) in enumerate(_stylegan_block_channels(ch)):
            self.add_module(
                f"block{i}",
                SynthesisBlock(c_out, c_in, ch, upsample=(i != 0), enable_blur=enable_blur, generator=generator),
            )
            out = EqualizedConv2D(c_out, out_ch, 1, 1, 0, gain=1.0, generator=generator)
            if rgbd:
                init_depth_head_(out, initial_depth)
            self.add_module(f"out{i}", out)
        if rgbd:
            # flax sizes l1 from its first input: the pose alone for w_from_theta
            self.l1 = EqualizedLinear(9 if rotate_conv_input else ch + 9, ch, generator=generator)
            self.l2 = EqualizedLinear(ch, ch, generator=generator)
        if use_occupancy_net:
            self.occupancy = OccupancyNet(ch * 2 + 3, 32, generator=generator)  # the whole 2*ch latent (net.py:209)

    def block(self, i: int) -> SynthesisBlock:
        return getattr(self, f"block{i}")

    def out(self, i: int) -> EqualizedConv2D:
        return getattr(self, f"out{i}")

    def rotate_w(self, w: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
        """Camera conditioning ``[w, theta*16]`` -> two lrelu-linears."""
        h = leaky_relu(self.l1(torch.cat([w, theta * 16], dim=1)))
        return leaky_relu(self.l2(h))

    def w_from_theta(self, theta: torch.Tensor) -> torch.Tensor:
        """Style from the pose alone (``net.py:226-230``)."""
        return leaky_relu(self.l2(leaky_relu(self.l1(theta))))

    def _conditioned_w(self, i: int, w: torch.Tensor, theta: Optional[torch.Tensor]) -> torch.Tensor:
        if not (self.rgbd and i < 2):
            return w
        return self.w_from_theta(theta) if self.rotate_conv_input else self.rotate_w(w, theta)

    def forward(
        self,
        w: torch.Tensor,
        w2: torch.Tensor,
        stage_floor: int,
        alpha,
        theta: Optional[torch.Tensor] = None,
        *,
        train: bool = True,
        return_feature: bool = False,
    ):
        stage = min(int(stage_floor), MAX_STAGE - 1)
        if self.rgbd and theta is None:
            raise ValueError("theta is required for an RGBD generator")
        if self.compute_dtype is not None:
            w, w2 = w.to(self.compute_dtype), w2.to(self.compute_dtype)
            if theta is not None:
                theta = theta.to(self.compute_dtype)
        feat = None
        h = None
        if stage % 2 == 0:
            k = (stage - 2) // 2
            for i in range(0, k + 2):  # 0 .. k+1
                if i == 3:  # resolution 32 switches to the second style
                    w = w2
                h = self.block(i)(self._conditioned_w(i, w, theta), x=h)
                if return_feature and i == 3:
                    feat = h
            h = self.out(k + 1)(h.float())
        else:
            k = (stage - 1) // 2
            for i in range(0, k + 1):  # 0 .. k
                if i == 3:
                    w = w2
                h = self.block(i)(self._conditioned_w(i, w, theta), x=h)
                if return_feature and i == 3:
                    feat = h
            h_0 = upscale2x(self.out(k)(h.float()))
            # the fade-in block gets the *unconditioned* w (net.py:290)
            h_1 = self.out(k + 1)(self.block(k + 1)(w, x=h).float())
            h = (1.0 - alpha) * h_0 + alpha * h_1

        h = _rgbd_head(h, self.rgbd)
        if not train:
            return _eval_upsample(h)
        if feat is not None:
            feat = feat.float()
        return (h, feat) if return_feature else h


class StyleGANGenerator(nn.Module):
    """Mapping + synthesis (``net.py:314-354``)."""

    def __init__(
        self,
        ch: int,
        enable_blur: bool = False,
        rgbd: bool = False,
        rotate_conv_input: bool = False,
        use_occupancy_net: bool = False,
        initial_depth: float = 1.0,
        compute_dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.mapping = MappingNetwork(ch, generator=generator)
        self.gen = StyleGenerator(
            ch, enable_blur=enable_blur, rgbd=rgbd, rotate_conv_input=rotate_conv_input,
            use_occupancy_net=use_occupancy_net, initial_depth=initial_depth, compute_dtype=compute_dtype,
            generator=generator,
        )

    def occupancy_logits(self, z: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        """Occupancy logits at world ``coords`` (B, 3, HW) from the raw latent
        ``z``, not ``w`` (``updater.py:367-371``)."""
        return self.gen.occupancy(z.reshape(z.shape[0], -1), coords)

    def forward(
        self,
        z: torch.Tensor,
        stage_floor: int,
        alpha,
        theta: Optional[torch.Tensor] = None,
        *,
        train: bool = True,
        return_feature: bool = False,
    ):
        z = z.reshape(z.shape[0], -1)
        z1, z2 = torch.chunk(z, 2, dim=1)  # low-res / high-res styles
        w = self.mapping(z1)
        w2 = self.mapping(z2)
        return self.gen(w, w2, stage_floor, alpha, theta, train=train, return_feature=return_feature)


class DCGANBlock(nn.Module):
    """upsample -> conv -> bias -> lrelu -> L2-channel-normalise, twice
    (``net.py:603-648``). The noise gains ``n0``/``n1`` exist for checkpoint
    parity: noise is forced off, so they get no gradient."""

    def __init__(self, ch: int, ch_in: int, enable_blur: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.enable_blur = enable_blur
        self.c0 = EqualizedConv2D(ch_in, ch, 3, 1, 1, use_bias=False, generator=generator)
        self.n0 = NoiseBlock(ch)
        self.b0 = nn.Parameter(torch.zeros(ch))
        self.c1 = EqualizedConv2D(ch, ch, 3, 1, 1, use_bias=False, generator=generator)
        self.n1 = NoiseBlock(ch)
        self.b1 = nn.Parameter(torch.zeros(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = upscale2x(x)
        if self.enable_blur:
            h = blur3x3(h)
        h = _chnorm_epilogue(self.c0(h), self.b0)
        return _chnorm_epilogue(self.c1(h), self.b1)


def _chnorm_epilogue(h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """A DCGAN conv's epilogue: bias, leaky ReLU, the L2 norm over the
    channels, in the span ``gen.chnorm``, counting the elements normalised
    (``chnorm.elems``)."""
    with trace.span("gen.chnorm"):
        trace.count("chnorm.elems", h.numel())
        return l2_normalize_channels(leaky_relu(h + bias.to(h.dtype)))


class DCGANGenerator(nn.Module):
    """Progressive DCGAN generator (``net.py:651-773``): a stem linear on
    ``concat([z, theta*10])`` to a 4x4 map, then blocks at 8-128 px. The
    trainer passes ``config.ch`` as ``in_ch`` while the hidden width ``ch``
    stays 512 (``train_rgbd.py:229-232``)."""

    def __init__(
        self,
        in_ch: int = 128,
        ch: int = 512,
        enable_blur: bool = False,
        rgbd: bool = False,
        use_occupancy_net: bool = False,
        initial_depth: float = 1.0,
        compute_dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.ch, self.rgbd, self.compute_dtype = ch, rgbd, compute_dtype
        self.linear = EqualizedLinear(in_ch + (9 if rgbd else 0), ch * 4 * 4, generator=generator)
        chans = ((ch, ch), (ch, ch), (ch, ch), (ch // 2, ch), (ch // 4, ch // 2))  # 8 .. 128 px
        out_ch = 4 if rgbd else 3
        for i, (c_out, c_in) in enumerate(chans):
            self.add_module(f"block{i}", DCGANBlock(c_out, c_in, enable_blur=enable_blur, generator=generator))
            out = EqualizedConv2D(c_out, out_ch, 1, 1, 0, gain=1.0, generator=generator)
            if rgbd:
                init_depth_head_(out, initial_depth)
            self.add_module(f"out{i}", out)
        if use_occupancy_net:
            self.occupancy = OccupancyNet(in_ch + 3, 32, generator=generator)

    def occupancy_logits(self, z: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        """Occupancy logits at world ``coords`` (B, 3, HW) from the latent ``z``."""
        return self.occupancy(z.reshape(z.shape[0], -1), coords)

    def block(self, i: int) -> DCGANBlock:
        return getattr(self, f"block{i}")

    def out(self, i: int) -> EqualizedConv2D:
        return getattr(self, f"out{i}")

    def _stem(self, z: torch.Tensor, theta: Optional[torch.Tensor]) -> torch.Tensor:
        if self.compute_dtype is not None:
            z = z.to(self.compute_dtype)
            if theta is not None:
                theta = theta.to(self.compute_dtype)
        h = self.linear(torch.cat([z, theta * 10], dim=1) if self.rgbd else z)
        # the reference's NCHW view of the stem vector, then NHWC
        return h.reshape(z.shape[0], self.ch, 4, 4).permute(0, 2, 3, 1)

    def forward(
        self,
        z: torch.Tensor,
        stage_floor: int,
        alpha,
        theta: Optional[torch.Tensor] = None,
        *,
        train: bool = True,
        return_feature: bool = False,
    ):
        stage = min(int(stage_floor), MAX_STAGE - 1)
        if self.rgbd and theta is None:
            raise ValueError("theta is required for an RGBD generator")
        if stage < 2:
            raise ValueError(
                "DCGANGenerator requires stage >= 2 (the reference indexes outs[-1] "
                "below that, which is a shape error there too)"
            )
        feat = None
        h = self._stem(z.reshape(z.shape[0], -1), theta)
        if stage % 2 == 0:
            k = (stage - 2) // 2
            for i in range(0, k + 1):  # 0 .. k
                h = self.block(i)(h)
                if return_feature and i == 2:
                    feat = h
            h = self.out(k)(h.float())
        else:
            k = (stage - 1) // 2
            for i in range(0, k):  # 0 .. k-1
                h = self.block(i)(h)
                if return_feature and i == 2:
                    feat = h
            h_0 = upscale2x(self.out(k - 1)(h.float()))
            h_1 = self.out(k)(self.block(k)(h).float())
            h = (1.0 - alpha) * h_0 + alpha * h_1

        h = _rgbd_head(h, self.rgbd)
        if not train:
            return _eval_upsample(h)
        return (h, feat) if return_feature else h
