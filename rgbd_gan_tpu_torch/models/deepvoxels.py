"""DeepVoxels generator family (PyTorch, NDHWC/NHWC).

Port of :mod:`rgbd_gan_tpu.models.deepvoxels` (reference
``deepvoxels_generator.py`` + ``deepvoxel/``). The pipeline: mapping -> 3D
StyleGAN voxel generator (4^3 -> 32^3, 32 features) -> perspective
resampling of the voxel grid into each camera's view frustum (the trilinear
lift of :mod:`..ops.trilinear`) -> occlusion network collapsing the frustum's
depth axis into visibility weights and an expected depth -> 2D style
refiner to RGB -> concat depth.

The frustum is a fixed-shape dense resampling: the (4, D*H*W) lattice of
frustum cells is a constant, transformed by the batch of cam2world
matrices, sampled trilinearly with clamped indices, and zeroed outside the
grid by a mask.

Quirks kept:
- the frustum's y coordinate uses float division ``tmp / W`` (not ``//``),
  a +x/W skew on y (``projection.py:67``) — ``exact_lifting=True``
- the depth decode ``(d + 0.5) * ceil(sqrt(3)*32) * voxel_size + near``
  (``deepvoxel.py:903-904``)
- the refiner's output conv has gain 0.5 (``deepvoxels_generator.py:200``)
- ``AccumulativeOcclusionNet``'s threshold defaults to 4 (``deepvoxel.py:556``)
- the latent is a plain N(0, 1) draw, not normalised

The occlusion net is the softmax ``OcclusionNetLight`` (``deepvoxels``),
the alpha-compositing ``AccumulativeOcclusionNet`` (``accumulative``) or
``RenderNetProjection`` (``rendernet``: the depth axis flattened into
channels and two 1x1 convs, with a constant depth of ones). With
``background_generator`` a camera-conditioned 2D ``BackgroundFeatureGenerator``
fills in behind the foreground: features are blended by the foreground's
total visibility and a fixed spherical depth at distance 4 fills in behind
it. ``DeepVoxelsDiscriminator`` is the reference's fixed 64 px
discriminator, which no trainer builds (the reference trains DeepVoxels
with the progressive one).

``compute_dtype=torch.bfloat16`` (the yml's ``mixed16``) runs the 3D voxel
generator and the 2D refiner in bf16 with float32 parameters; the mapping,
the lift, the occlusion net, the background generator and the depth decode
stay float32.

Not ported, raising ``NotImplementedError``: ``occlusion_type:
occlusion_unet`` (the U-Net ``OcclusionNet``, ``Unet3d``, ``Unet``), which
the JAX package cannot build either (see :data:`OCCLUSION_UNET_FAULT`).

Parameter names follow the flax tree (``voxel_gen.block1.c0.weight`` is
``voxel_gen/block1/c0/kernel``), so :mod:`..bridge` maps one onto the other.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import (
    AdaINBlock,
    BatchNorm,
    EqualizedConv2D,
    EqualizedConv3D,
    EqualizedLinear,
    l2_normalize_channels,
    leaky_relu,
    upscale2x,
    upscale2x_3d,
)
from ..ops.trilinear import TILE_N, trilinear_lift
from .discriminator import DiscriminatorBlock, DiscriminatorBlockBase, _conv
from .extras import CameraParamGenerator
from .generators import MappingNetwork, SynthesisBlock

# ---------------------------------------------------------------------------
# geometry constants (deepvoxels_generator.py:230-253)
# ---------------------------------------------------------------------------

GRID_DIM = 32
PROJ_DIM = 64
SCALE = 0.5
NEAR_PLANE = math.sqrt(3) / 4
VOXEL_SIZE = (1.0 / GRID_DIM) * 1.1 * SCALE
FRUSTUM_DEPTH = int(np.ceil(np.sqrt(3) * GRID_DIM))  # 56
NUM_GRID_FEATS = 32
FOCAL = PROJ_DIM * 2.0  # 128
CENTER = float(GRID_DIM)  # 32 (principal point of the 64 px lift intrinsic)
# dim1-window width of the 'pallas_win' lift modes. That every tile's reach
# along grid dim1 fits one window is derived from these constants by
# :func:`lift_window_span_bound` and enforced in :func:`_resolve_lift_mode`.
LIFT_WINDOW = 16

# The JAX package's names, kept so that its ymls load. Here 'gather' is the
# same code path as 'pallas_f32' (float32 operands, no window): there is no
# dense gather route on a CUDA tensor, and on the CPU every mode is the plain
# version.
LIFT_MODES = ("gather", "pallas", "pallas_f32", "pallas_win", "pallas_win_f32")

# Why ``occlusion_type: occlusion_unet`` is not ported: the JAX reference
# cannot build it, so there is nothing to hold a port against.
OCCLUSION_UNET_FAULT = (
    "occlusion_type occlusion_unet (OcclusionNet, Unet3d, Unet) is not ported: the JAX package cannot "
    "build it either. Its UpBlock3D and UpBlock2D use flax nn.ConvTranspose(kernel 4, stride 2, padding "
    "[(1, 1)]), which gives 2n - 2, not 2n, so the U-Net's skip concatenation fails and OcclusionNet.init "
    "raises TypeError (rgbd_gan_tpu/models/deepvoxels.py:312,397)"
)

PROJECTION_INTRINSIC = np.array(
    [
        [FOCAL, 0.0, CENTER, 0.0],
        [0.0, FOCAL, CENTER, 0.0],
        [0.0, 0.0, 1.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ],
    dtype="float32",
)


def lift_window_span_bound() -> float:
    """Worst-case float span along grid dim1 of one tile of the windowed
    lift, from the geometry constants.

    A tile is ``TILE_N`` consecutive frustum cells in depth-major order; when
    ``PROJ_DIM**2 % TILE_N == 0`` it never straddles depth planes, so its
    camera-space z is constant and it covers frustum-v values spanning
    ``dy = (TILE_N - 1) / PROJ_DIM`` (float-division y quirk included). With
    ``z_rotate == 0`` row 1 of the cam2world rotation has no frustum-u
    component, so the tile's dim1 span is
    ``|cos x_rot| * dy * zc / (FOCAL * VOXEL_SIZE)``, largest at
    ``|cos| = 1`` and at the farthest depth plane. Returns ``inf`` when a tile
    straddles depth planes. The integer reach per tile is at most
    ``floor(span) + 2`` planes; the resolver asks for ``span + 3 <= LIFT_WINDOW``.
    """
    if (PROJ_DIM * PROJ_DIM) % TILE_N != 0:
        return float("inf")
    dy = (TILE_N - 1) / PROJ_DIM
    zc_max = NEAR_PLANE + (FRUSTUM_DEPTH - 1) * VOXEL_SIZE
    return dy * zc_max / (FOCAL * VOXEL_SIZE)


def frustum_camera_coords(exact_lifting: bool = True) -> np.ndarray:
    """Homogeneous camera-space coords of every frustum cell: (4, D*H*W),
    depth-major then row-major (``projection.py:56-80``)."""
    n = PROJ_DIM * PROJ_DIM * FRUSTUM_DEPTH
    lin = np.arange(n)
    zi = lin // (PROJ_DIM * PROJ_DIM)
    tmp = lin - zi * PROJ_DIM * PROJ_DIM
    if exact_lifting:
        y = tmp / PROJ_DIM  # reference quirk: float division (projection.py:67)
    else:
        y = tmp // PROJ_DIM
    x = tmp % PROJ_DIM
    zc = zi * VOXEL_SIZE + NEAR_PLANE
    xc = (x - CENTER) / FOCAL * zc
    yc = (y - CENTER) / FOCAL * zc
    return np.stack([xc, yc, zc, np.ones_like(zc)]).astype("float32")


def frustum_voxel_coords(cam2world: torch.Tensor, coords_const: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Voxel-space frustum coordinates ``vox`` (B, 3, N) and the validity
    mask ``in_bounds`` (B, N) per camera (``projection.py:81-99``)."""
    g = GRID_DIM
    grid_coords = torch.matmul(cam2world, coords_const)  # (B, 4, N)
    vox = grid_coords[:, :3] / VOXEL_SIZE + g / 2
    in_bounds = torch.all(vox >= 0, dim=1) & torch.all(vox < g, dim=1)
    return vox, in_bounds


def lift_frustum(
    voxel: torch.Tensor, cam2world: torch.Tensor, coords_const: torch.Tensor, lift_mode: str = "gather"
) -> torch.Tensor:
    """Resample the voxel grid (B, G, G, G, C) into each camera's view
    frustum (B, FRUSTUM_DEPTH, H, W, C).

    ``lift_mode``: 'gather' and 'pallas_f32' sample with float32 operands,
    'pallas' with bf16 operands and float32 accumulation; 'pallas_win' and
    'pallas_win_f32' restrict each tile to ``LIFT_WINDOW`` dim1-planes, which
    is the same function only when the cameras keep every tile's reach inside
    one window (see :func:`_resolve_lift_mode`). Every mode is the trilinear
    lift of :mod:`..ops.trilinear`: its CUDA kernels on a CUDA tensor, its
    plain version on a CPU tensor.
    """
    if lift_mode not in LIFT_MODES:
        raise ValueError(f"unknown lift_mode {lift_mode!r}")
    b, c = voxel.shape[0], voxel.shape[-1]
    vox, in_bounds = frustum_voxel_coords(cam2world, coords_const)
    dtype = torch.bfloat16 if lift_mode in ("pallas", "pallas_win") else torch.float32
    window = LIFT_WINDOW if lift_mode.startswith("pallas_win") else None
    out = trilinear_lift(voxel, vox, in_bounds, dtype, window)
    return out.reshape(b, FRUSTUM_DEPTH, PROJ_DIM, PROJ_DIM, c)


def _depth_coords() -> np.ndarray:
    """Normalised per-slice depth coordinates (1, D, 1, 1, 1) in [-0.5, 0.5)
    (``deepvoxel.py:479-482``)."""
    d = np.arange(-FRUSTUM_DEPTH // 2, FRUSTUM_DEPTH // 2) / FRUSTUM_DEPTH
    return d.reshape(1, FRUSTUM_DEPTH, 1, 1, 1).astype("float32")


def decode_depth(depth_map: torch.Tensor) -> torch.Tensor:
    """Normalised [-0.5, 0.5] expected depth -> metric (``deepvoxel.py:903-904``)."""
    return (depth_map + 0.5) * FRUSTUM_DEPTH * VOXEL_SIZE + NEAR_PLANE


# ---------------------------------------------------------------------------
# reflect-pad conv and BatchNorm
# ---------------------------------------------------------------------------


class Conv3dSame(nn.Module):
    """Equalized 3D conv with 'same' reflect padding (``deepvoxel.py:149-176``). NDHWC."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        ka = kernel_size // 2
        kb = ka - 1 if kernel_size % 2 == 0 else ka
        self.pad = (ka, kb)
        self.conv = EqualizedConv3D(in_ch, out_ch, kernel_size, 1, 0, use_bias=use_bias, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ka, kb = self.pad
        if ka or kb:
            # F.pad reflects the trailing axes: pad (D, H, W) in the NCDHW view
            x = F.pad(x.permute(0, 4, 1, 2, 3), (ka, kb) * 3, mode="reflect").permute(0, 2, 3, 4, 1)
        return self.conv(x)


# ---------------------------------------------------------------------------
# occlusion networks (deepvoxel.py:497-587)
# ---------------------------------------------------------------------------


def _with_depth_coords(frustum: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    dc = torch.from_numpy(_depth_coords()).to(frustum).expand(frustum.shape[:-1] + (1,))
    return dc, torch.cat([dc, frustum], dim=-1)


class OcclusionNetLight(nn.Module):
    """Softmax visibility over the frustum's depth axis (``deepvoxel.py:497-541``)."""

    def __init__(self, in_ch: int = NUM_GRID_FEATS, occnet_nf: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.prep = Conv3dSame(in_ch + 1, occnet_nf, 3, use_bias=False, generator=generator)
        self.prep_bn = BatchNorm(occnet_nf)
        self.net = Conv3dSame(occnet_nf, occnet_nf, 3, use_bias=False, generator=generator)
        self.net_bn = BatchNorm(occnet_nf)
        self.softmax_conv = Conv3dSame(2 * occnet_nf + 1, 1, 3, use_bias=True, generator=generator)

    def forward(self, frustum: torch.Tensor, train: bool = True):
        dc, h = _with_depth_coords(frustum)
        prep = leaky_relu(self.prep_bn(self.prep(h), train))
        feats = leaky_relu(self.net_bn(self.net(prep), train))
        logits = self.softmax_conv(torch.cat([prep, feats, dc], dim=-1))
        weights = torch.softmax(logits, dim=1)  # over the depth axis
        depth_map = torch.sum(dc * weights, dim=1)  # (B, H, W, 1), -0.5..0.5
        return weights, depth_map


class AccumulativeOcclusionNet(nn.Module):
    """Per-cell density -> clipped cumulative transmittance differences
    (alpha compositing; ``deepvoxel.py:544-587``). The prefix sum over depth
    is ``torch.cumsum``; the JAX package takes it as a triangular matmul, the
    same function up to the order of the float32 sums."""

    def __init__(self, in_ch: int = NUM_GRID_FEATS, occnet_nf: int = 4, accumulative_threshold: float = 4.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.accumulative_threshold = accumulative_threshold
        self.c0 = Conv3dSame(in_ch + 1, occnet_nf, 1, use_bias=True, generator=generator)
        self.c1 = Conv3dSame(occnet_nf, 1, 1, use_bias=True, generator=generator)

    def forward(self, frustum: torch.Tensor, train: bool = True):
        dc, h = _with_depth_coords(frustum)
        h = self.c1(leaky_relu(self.c0(h)))
        density = torch.sigmoid(h - self.accumulative_threshold)
        cumsum = torch.clamp(torch.cumsum(density, dim=1), 0.0, 1.0)
        cumsum = torch.cat([torch.zeros_like(cumsum[:, :1]), cumsum], dim=1)
        weights = cumsum[:, 1:] - cumsum[:, :-1]
        depth_map = torch.sum(dc * weights, dim=1)
        return weights, depth_map


class RenderNetProjection(nn.Module):
    """The frustum's depth axis flattened into channels, then two 1x1
    equalized convs, each with a flax-style BatchNorm and a leaky ReLU
    (``deepvoxel.py:590-618``): (B, D, H, W, C) -> (B, H, W, occnet_nf)."""

    def __init__(self, in_ch: int = FRUSTUM_DEPTH * NUM_GRID_FEATS, occnet_nf: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.c0 = EqualizedConv2D(in_ch, occnet_nf, 1, 1, 0, generator=generator)
        self.bn0 = BatchNorm(occnet_nf)
        self.c1 = EqualizedConv2D(occnet_nf, occnet_nf, 1, 1, 0, generator=generator)
        self.bn1 = BatchNorm(occnet_nf)

    def forward(self, frustum: torch.Tensor, train: bool = True) -> torch.Tensor:
        b, d, h, w, c = frustum.shape
        x = frustum.permute(0, 2, 3, 1, 4).reshape(b, h, w, d * c)
        x = leaky_relu(self.bn0(self.c0(x), train))
        return leaky_relu(self.bn1(self.c1(x), train))


# ---------------------------------------------------------------------------
# 3D StyleGAN voxel generator (deepvoxels_generator.py:112-188)
# ---------------------------------------------------------------------------


class SynthesisBlock3D(nn.Module):
    """3D twin of ``SynthesisBlock`` (``deepvoxels_generator.py:112-168``);
    the voxel generator never adds noise, so no noise gains exist."""

    def __init__(self, ch: int, ch_in: int, w_dim: int, upsample: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ch_in, self.upsample = ch_in, upsample
        if upsample:
            self.c0 = EqualizedConv3D(ch_in, ch, 3, 1, 1, use_bias=False, generator=generator)
        else:
            self.const = nn.Parameter(torch.ones(4, 4, 4, ch_in))
        self.b0 = nn.Parameter(torch.zeros(ch))
        self.s0 = AdaINBlock(w_dim, ch, generator=generator)
        self.c1 = EqualizedConv3D(ch, ch, 3, 1, 1, use_bias=False, generator=generator)
        self.b1 = nn.Parameter(torch.zeros(ch))
        self.s1 = AdaINBlock(w_dim, ch, generator=generator)

    def forward(self, w: torch.Tensor, x: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.upsample:
            h = self.c0(upscale2x_3d(x))
        else:
            h = self.const[None].expand(w.shape[0], 4, 4, 4, self.ch_in).to(w.dtype)
        h = self.s0(w, leaky_relu(h + self.b0.to(h.dtype)))
        h = self.c1(h)
        return self.s1(w, leaky_relu(h + self.b1.to(h.dtype)))


class VoxelGenerator(nn.Module):
    """4^3 const -> 32^3 feature grid (``deepvoxels_generator.py:171-188``)."""

    def __init__(self, ch: int, ch_out: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        chans = [
            (ch // 4, ch // 4, False),
            (ch // 4, ch // 4, True),
            (ch // 8, ch // 4, True),
            (ch // 8, ch // 8, True),
        ]
        for i, (c_out, c_in, up) in enumerate(chans):
            self.add_module(f"block{i}", SynthesisBlock3D(c_out, c_in, ch, upsample=up, generator=generator))
        self.out = EqualizedConv3D(ch // 8, ch_out, 1, 1, 0, generator=generator)

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        h = None
        for i in range(4):
            h = getattr(self, f"block{i}")(w, h)
        return self.out(h)


# ---------------------------------------------------------------------------
# 2D style refiner (deepvoxels_generator.py:191-222)
# ---------------------------------------------------------------------------


class RefinerStyleGenerator(nn.Module):
    """U-shaped style refiner: 64 -> 16 -> 64 px, skip concats, RGB out."""

    def __init__(self, w_dim: int, in_ch: int = NUM_GRID_FEATS, hidden_ch: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hc = hidden_ch
        convs = {
            "c0": (in_ch, hc * 2, 4, 2), "c1": (hc * 2, hc * 4, 4, 2), "c4": (hc * 4, hc * 4, 3, 1),
            "c5": (hc * 4, hc * 2, 3, 1), "c6": (hc * 4, hc, 3, 1),
        }
        for name, (c_in, c_out, k, stride) in convs.items():
            self.add_module(name, EqualizedConv2D(c_in, c_out, k, stride, 1, generator=generator))
            self.add_module("s" + name[1:], AdaINBlock(w_dim, c_out, generator=generator))
        self.c7 = EqualizedConv2D(hc + in_ch, 3, 3, 1, 1, gain=0.5, generator=generator)

    def forward(self, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        h1 = self.s0(w, leaky_relu(self.c0(h)))
        h2 = self.s1(w, leaky_relu(self.c1(h1)))
        h3 = upscale2x(self.s4(w, leaky_relu(self.c4(h2))))
        h3 = leaky_relu(self.c5(h3))
        h3 = upscale2x(torch.cat([self.s5(w, h3), h1], dim=-1))
        h3 = leaky_relu(self.c6(h3))
        return self.c7(torch.cat([self.s6(w, h3), h], dim=-1))


class BackgroundFeatureGenerator(nn.Module):
    """Camera-conditioned 2D background features with a fixed spherical depth
    at virtual distance 4 (``deepvoxels_generator.py:433-492``): five
    StyleGAN synthesis blocks without noise, 4 -> 64 px, at width ``ch``
    (the last ``ch // 2``), then a gain-1 1x1 conv to ``out_ch`` features.
    Blocks 0-1 take ``rotate_w(w)`` (``[w, theta * 16]`` -> two lrelu
    linears, so ``l1`` takes ``ch + 9`` inputs), block 2 ``w`` and blocks 3-4
    ``w2``. Always float32."""

    IMG_SIZE = 64
    BACKGROUND_DEPTH = 4.0

    def __init__(self, ch: int = 512, out_ch: int = NUM_GRID_FEATS, enable_blur: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        chans = [(ch, ch, False), (ch, ch, True), (ch, ch, True), (ch, ch, True), (ch // 2, ch, True)]
        for i, (c, c_in, up) in enumerate(chans):
            self.add_module(f"block{i}", SynthesisBlock(c, c_in, ch, upsample=up, enable_blur=enable_blur,
                                                        noise=False, generator=generator))
        self.conv = EqualizedConv2D(ch // 2, out_ch, 1, 1, 0, gain=1.0, generator=generator)
        self.l1 = EqualizedLinear(ch + 9, ch, generator=generator)
        self.l2 = EqualizedLinear(ch, ch, generator=generator)
        s = self.IMG_SIZE
        xs, ys = np.meshgrid(np.arange(s) - s // 2, np.arange(s) - s // 2)
        depth = self.BACKGROUND_DEPTH * s * 2 / np.sqrt((s * 2) ** 2 + xs**2 + ys**2)
        self.register_buffer("depth_map", torch.from_numpy(depth.astype("float32")), persistent=False)

    def rotate_w(self, w: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
        h = leaky_relu(self.l1(torch.cat([w, theta * 16], dim=1)))
        return leaky_relu(self.l2(h))

    def forward(self, w: torch.Tensor, w2: torch.Tensor, theta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, ch) styles and (B, 9) pose -> features (B, 64, 64, out_ch) and
        depth (B, 64, 64, 1)."""
        h = None
        for i in range(5):
            if i == 3:
                w = w2
            h = getattr(self, f"block{i}")(self.rotate_w(w, theta) if i < 2 else w, x=h)
        h = self.conv(h)
        s = self.IMG_SIZE
        return h, self.depth_map.to(h.dtype)[None, :, :, None].expand(w.shape[0], s, s, 1)


class DeepVoxelsDiscriminator(nn.Module):
    """The reference's fixed 64 px, non-progressive discriminator
    (``deepvoxels_generator.py:387-430``): ``in0`` (1x1 to ``ch // 2``), then
    residual blocks 4 to 1 down to 4x4, then the 4x4 head, (B, 1). flax sizes
    each conv from its input, so ``block4`` takes ``ch // 2`` channels and
    ``block1`` ``ch``. ``sn=True`` makes every conv and the linear
    spectrally normalised, as in ``Discriminator`` (the JAX class has no such
    field; its blocks and head do). No trainer builds it: the reference
    trains DeepVoxels with the progressive discriminator
    (``train_rgbd.py:249-258``)."""

    def __init__(self, ch: int = 512, enable_blur: bool = False, sn: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in0 = _conv(sn, 3, ch // 2, 1, 1, 0, generator)
        for i in (4, 3, 2, 1):
            self.add_module(f"block{i}", DiscriminatorBlock(ch // 2 if i == 4 else ch, ch, enable_blur=enable_blur,
                                                            res=True, sn=sn, generator=generator))
        self.block0 = DiscriminatorBlockBase(ch, 1, sn=sn, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = leaky_relu(self.in0(x))
        for i in (4, 3, 2, 1):
            h = getattr(self, f"block{i}")(h)
        return self.block0(h)


# ---------------------------------------------------------------------------
# top-level generator (deepvoxels_generator.py:225-323)
# ---------------------------------------------------------------------------


def deepvoxels_make_hidden(
    generator: Optional[torch.Generator], batch_size: int, ch: int, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """Plain N(0, 1) latent, unnormalised (``updater_deepvoxels.py:119-121``)."""
    return torch.randn(batch_size, ch, generator=generator, device=device)


class DeepVoxelsGenerator(nn.Module):
    """Voxel-volume renderer generator producing 64x64 RGBD."""

    def __init__(
        self,
        ch: int,
        occlusion_type: str = "deepvoxels",
        background_generator: bool = False,
        accumulative_threshold: float = 4.0,
        exact_lifting: bool = True,
        lift_mode: str = "gather",
        compute_dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        if lift_mode not in LIFT_MODES:
            raise ValueError(f"unknown lift_mode {lift_mode!r}")
        self.occlusion_type, self.lift_mode = occlusion_type, lift_mode
        self.mapping = MappingNetwork(ch, generator=generator)
        self.voxel_gen = VoxelGenerator(ch, NUM_GRID_FEATS, generator=generator)
        if occlusion_type == "deepvoxels":
            self.occlusion_net = OcclusionNetLight(generator=generator)
        elif occlusion_type == "accumulative":
            self.occlusion_net = AccumulativeOcclusionNet(
                accumulative_threshold=accumulative_threshold, generator=generator
            )
        elif occlusion_type == "rendernet":
            self.occlusion_net = RenderNetProjection(generator=generator)
        elif occlusion_type == "occlusion_unet":
            raise NotImplementedError(OCCLUSION_UNET_FAULT)
        else:
            raise ValueError(f"unknown occlusion_type {occlusion_type!r}")
        self.style_generator = RefinerStyleGenerator(ch, generator=generator)
        # owned for checkpoint parity; the train step never runs it
        self.camera_param_generator = CameraParamGenerator(generator=generator)
        # the JAX package builds the background generator only for the
        # occlusion nets that give visibility weights (not for RenderNet)
        self.background_generator = background_generator and occlusion_type != "rendernet"
        if self.background_generator:
            self.background_gen = BackgroundFeatureGenerator(ch, NUM_GRID_FEATS, generator=generator)
        self.register_buffer(
            "frustum_coords", torch.from_numpy(frustum_camera_coords(exact_lifting)), persistent=False
        )

    def forward(
        self,
        z: torch.Tensor,
        camera_matrices: torch.Tensor,
        z2: torch.Tensor,
        theta: Optional[torch.Tensor] = None,
        z3: Optional[torch.Tensor] = None,
        z4: Optional[torch.Tensor] = None,
        train: bool = True,
    ) -> torch.Tensor:
        """(B, ch) latents, (B, 4, 4) cam2world -> (B, 64, 64, 4) RGBD. ``theta``
        (B, 9) and the latents ``z3``, ``z4`` (the background's styles) feed
        only the background generator."""
        w = self.mapping(z.reshape(z.shape[0], -1))
        w2 = self.mapping(z2.reshape(z2.shape[0], -1))
        if self.compute_dtype is not None:
            w, w2 = w.to(self.compute_dtype), w2.to(self.compute_dtype)
        voxel = self.voxel_gen(w).float()  # (B, 32, 32, 32, feats)
        frustum = lift_frustum(voxel, camera_matrices, self.frustum_coords, self.lift_mode)
        if self.occlusion_type == "rendernet":
            novel_feats = self.occlusion_net(frustum, train)
            depth = torch.ones(novel_feats.shape[:3] + (1,), dtype=novel_feats.dtype, device=novel_feats.device)
        else:
            weights, depth_norm = self.occlusion_net(frustum, train)
            novel_feats = torch.sum(weights * frustum, dim=1)  # (B, H, W, C)
            depth = decode_depth(depth_norm)
            if self.background_generator:
                if z3 is None or z4 is None:
                    raise ValueError("a background generator needs the latents z3 and z4")
                background_visible = 1.0 - torch.sum(weights, dim=1)
                w3 = self.mapping(z3.reshape(z3.shape[0], -1))
                w4 = self.mapping(z4.reshape(z4.shape[0], -1))
                background, background_depth = self.background_gen(w3, w4, theta)
                novel_feats = (l2_normalize_channels(novel_feats)
                               + l2_normalize_channels(background) * background_visible)
                depth = depth + background_depth * background_visible
        novel_img = self.style_generator(novel_feats.to(w2.dtype), w2).float()
        return torch.cat([novel_img, depth.float()], dim=-1)


def _resolve_lift_mode(requested, z_rotate: float = 0.0, on_cuda: bool = False) -> str:
    """The lift mode a generator on a CUDA device (``on_cuda``) or on the CPU
    runs for the yml's ``lift_mode`` and camera prior.

    On the card the default is the bf16 lift, windowed ('pallas_win') when
    the camera prior proves that every tile's reach along grid dim1 fits one
    window: ``z_rotate == 0`` (a z-rotation couples the 64-column frustum-u
    reach into dim1) and :func:`lift_window_span_bound` + 3 planes fitting
    ``LIFT_WINDOW``. An explicit 'pallas_win*' that fails either raises,
    because the windowed kernels would drop valid corners. On the CPU every
    'pallas*' request and the default resolve to 'gather' (float32, full).
    """
    windowable = float(z_rotate or 0.0) == 0.0 and lift_window_span_bound() + 3.0 <= LIFT_WINDOW
    if requested and str(requested).startswith("pallas"):
        if not on_cuda:
            return "gather"
        req = str(requested)
        if req.startswith("pallas_win") and not windowable:
            raise ValueError(
                "lift_mode 'pallas_win*' requires z_rotate == 0 and a per-tile "
                "grid-dim1 span bound that fits LIFT_WINDOW "
                f"(span bound {lift_window_span_bound():.2f} + 3 margin vs "
                f"window {LIFT_WINDOW}); the windowed kernel would silently "
                "zero out-of-window contributions otherwise"
            )
        return req
    if not requested:
        if not on_cuda:
            return "gather"
        return "pallas_win" if windowable else "pallas"
    return str(requested)


def build_deepvoxels_generator(config, generator: Optional[torch.Generator] = None, on_cuda: bool = False):
    """The trainer's factory (``train_rgbd.py:233-243`` occlusion-type mapping);
    ``on_cuda`` says where the generator will run, which decides the lift mode."""
    if config.rendernet_projection:
        occlusion_type = "rendernet"
    elif config.occlusion_type:
        occlusion_type = config.occlusion_type
    else:
        occlusion_type = "deepvoxels"
    gen = DeepVoxelsGenerator(
        config.ch,
        occlusion_type=occlusion_type,
        background_generator=bool(config.background_generator),
        accumulative_threshold=config.accumulative_threshold if config.accumulative_threshold else 4.0,
        lift_mode=_resolve_lift_mode(config.lift_mode, config.z_rotate, on_cuda),
        compute_dtype=torch.bfloat16 if config.mixed16 else None,
        generator=generator,
    )
    return gen, (lambda g, n, device="cpu": deepvoxels_make_hidden(g, n, config.ch, device))
