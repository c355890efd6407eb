"""Inception-v3 feature extractor for FID and the Inception Score.

Port of :mod:`rgbd_gan_tpu.eval.inception` (the OpenAI
``inception-2015-12-05`` graph the reference uses,
``source/inception/inception_score.py:157-655``): a stem of five conv+BN
layers with two 3x3/2 max pools, mixed blocks 0-10, an 8x8 global average
pool to a 2048-d feature and a 1008-way logit head (indices 1-1000 are the
ImageNet classes). Quirks kept: ``mixed_10``'s pool branch takes the *max*
(torchvision's variant takes the mean), inputs in uint8 range are
preprocessed ``(x - 128) * 0.0078125``, BatchNorm has eps 1e-3 and runs on
its stored statistics, the 3x3/2 max pools are VALID, and the padded 3x3/1
average pools count the zero padding (flax's ``avg_pool``).

The modules run NCHW (cuDNN's layout); :class:`InceptionV3` takes NHWC
images, as the JAX model does, and permutes once. Module and parameter
names follow the flax tree (``mixed_4.b7x7_1.conv.weight`` is
``params/mixed_4/b7x7_1/conv/kernel``, the BN statistics
``batch_stats/.../bn/{mean,var}``), so :func:`load_params` reads the
flat-key npz that :func:`convert_tf_checkpoint` (or the JAX package's)
writes from ``classify_image_graph_def.pb``. Without one it warns and keeps
random He-normal weights: the scores are then consistent between runs of
the port but not comparable with the literature. Nothing is downloaded.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

import numpy as np

from ..bridge import load_jax_variables, variables_to_jax
from ..train.checkpoint import load_tree

FEATURE_DIM = 2048
NUM_LOGITS = 1008
INPUT_SIZE = 299
BN_EPS = 1e-3


class _BatchNorm(nn.Module):
    """Inference BatchNorm with flax's leaf names: ``scale``, ``bias`` and the
    statistics ``mean``, ``var`` as buffers."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.mean, self.var, self.scale, self.bias, False, 0.0, BN_EPS)


class ConvBN(nn.Module):
    """conv (no bias) -> BatchNorm (inference statistics) -> ReLU.

    He-normal init (flax's: truncated normal, fan-in), not LeCun: converted
    weights replace it, but the random fallback must keep the activations'
    scale through about 90 ReLU layers; under LeCun they decay about 2x a
    layer, the pool features collapse to about 1e-4 and FID and IS become
    exactly 0 and 1 for any two image sets."""

    def __init__(
        self,
        in_ch: int,
        features: int,
        kernel: Tuple[int, int] = (1, 1),
        stride: int = 1,
        padding: Tuple[int, int] = (0, 0),
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, kernel, stride, padding, bias=False)
        # flax's he_normal: N(0, 2/fan_in) truncated at 2 sigma, the
        # variance corrected for the truncation
        std = math.sqrt(2.0 / (in_ch * kernel[0] * kernel[1])) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.conv.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
        self.bn = _BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_3x3(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _max_pool_3x3(x):
    return F.max_pool2d(x, 3, 1, 1)


def _max_pool_3x3_s2(x):
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    """35x35 block (reference ``mixed``/``mixed_1``/``mixed_2``)."""

    def __init__(self, in_ch: int, pool_features: int, generator=None):
        super().__init__()
        g = generator
        self.b1x1 = ConvBN(in_ch, 64, generator=g)
        self.b5x5_1 = ConvBN(in_ch, 48, generator=g)
        self.b5x5_2 = ConvBN(48, 64, (5, 5), padding=(2, 2), generator=g)
        self.b3x3dbl_1 = ConvBN(in_ch, 64, generator=g)
        self.b3x3dbl_2 = ConvBN(64, 96, (3, 3), padding=(1, 1), generator=g)
        self.b3x3dbl_3 = ConvBN(96, 96, (3, 3), padding=(1, 1), generator=g)
        self.bpool = ConvBN(in_ch, pool_features, generator=g)

    def forward(self, x):
        b0 = self.b1x1(x)
        b1 = self.b5x5_2(self.b5x5_1(x))
        b2 = self.b3x3dbl_3(self.b3x3dbl_2(self.b3x3dbl_1(x)))
        b3 = self.bpool(_avg_pool_3x3(x))
        return torch.cat([b0, b1, b2, b3], dim=1)


class InceptionB(nn.Module):
    """35 -> 17 reduction (reference ``mixed_3``)."""

    def __init__(self, in_ch: int, generator=None):
        super().__init__()
        g = generator
        self.b3x3 = ConvBN(in_ch, 384, (3, 3), stride=2, generator=g)
        self.b3x3dbl_1 = ConvBN(in_ch, 64, generator=g)
        self.b3x3dbl_2 = ConvBN(64, 96, (3, 3), padding=(1, 1), generator=g)
        self.b3x3dbl_3 = ConvBN(96, 96, (3, 3), stride=2, generator=g)

    def forward(self, x):
        b0 = self.b3x3(x)
        b1 = self.b3x3dbl_3(self.b3x3dbl_2(self.b3x3dbl_1(x)))
        return torch.cat([b0, b1, _max_pool_3x3_s2(x)], dim=1)


class InceptionC(nn.Module):
    """17x17 factorised-7x7 block (reference ``mixed_4``..``mixed_7``)."""

    def __init__(self, in_ch: int, channels_7x7: int, generator=None):
        super().__init__()
        c7, g = channels_7x7, generator
        self.b1x1 = ConvBN(in_ch, 192, generator=g)
        self.b7x7_1 = ConvBN(in_ch, c7, generator=g)
        self.b7x7_2 = ConvBN(c7, c7, (1, 7), padding=(0, 3), generator=g)
        self.b7x7_3 = ConvBN(c7, 192, (7, 1), padding=(3, 0), generator=g)
        self.b7x7dbl_1 = ConvBN(in_ch, c7, generator=g)
        self.b7x7dbl_2 = ConvBN(c7, c7, (7, 1), padding=(3, 0), generator=g)
        self.b7x7dbl_3 = ConvBN(c7, c7, (1, 7), padding=(0, 3), generator=g)
        self.b7x7dbl_4 = ConvBN(c7, c7, (7, 1), padding=(3, 0), generator=g)
        self.b7x7dbl_5 = ConvBN(c7, 192, (1, 7), padding=(0, 3), generator=g)
        self.bpool = ConvBN(in_ch, 192, generator=g)

    def forward(self, x):
        b0 = self.b1x1(x)
        b1 = self.b7x7_3(self.b7x7_2(self.b7x7_1(x)))
        b2 = self.b7x7dbl_1(x)
        for i in range(2, 6):
            b2 = getattr(self, f"b7x7dbl_{i}")(b2)
        b3 = self.bpool(_avg_pool_3x3(x))
        return torch.cat([b0, b1, b2, b3], dim=1)


class InceptionD(nn.Module):
    """17 -> 8 reduction (reference ``mixed_8``)."""

    def __init__(self, in_ch: int, generator=None):
        super().__init__()
        g = generator
        self.b3x3_1 = ConvBN(in_ch, 192, generator=g)
        self.b3x3_2 = ConvBN(192, 320, (3, 3), stride=2, generator=g)
        self.b7x7x3_1 = ConvBN(in_ch, 192, generator=g)
        self.b7x7x3_2 = ConvBN(192, 192, (1, 7), padding=(0, 3), generator=g)
        self.b7x7x3_3 = ConvBN(192, 192, (7, 1), padding=(3, 0), generator=g)
        self.b7x7x3_4 = ConvBN(192, 192, (3, 3), stride=2, generator=g)

    def forward(self, x):
        b0 = self.b3x3_2(self.b3x3_1(x))
        b1 = self.b7x7x3_4(self.b7x7x3_3(self.b7x7x3_2(self.b7x7x3_1(x))))
        return torch.cat([b0, b1, _max_pool_3x3_s2(x)], dim=1)


class InceptionE(nn.Module):
    """8x8 expanded block (reference ``mixed_9``/``mixed_10``); ``pool='max'``
    is ``mixed_10``'s quirk (``inception_score.py`` max-pools there)."""

    def __init__(self, in_ch: int, pool: str = "avg", generator=None):
        super().__init__()
        g = generator
        self.pool = pool
        self.b1x1 = ConvBN(in_ch, 320, generator=g)
        self.b3x3_1 = ConvBN(in_ch, 384, generator=g)
        self.b3x3_2a = ConvBN(384, 384, (1, 3), padding=(0, 1), generator=g)
        self.b3x3_2b = ConvBN(384, 384, (3, 1), padding=(1, 0), generator=g)
        self.b3x3dbl_1 = ConvBN(in_ch, 448, generator=g)
        self.b3x3dbl_2 = ConvBN(448, 384, (3, 3), padding=(1, 1), generator=g)
        self.b3x3dbl_3a = ConvBN(384, 384, (1, 3), padding=(0, 1), generator=g)
        self.b3x3dbl_3b = ConvBN(384, 384, (3, 1), padding=(1, 0), generator=g)
        self.bpool = ConvBN(in_ch, 192, generator=g)

    def forward(self, x):
        b0 = self.b1x1(x)
        b1 = self.b3x3_1(x)
        b1 = torch.cat([self.b3x3_2a(b1), self.b3x3_2b(b1)], dim=1)
        b2 = self.b3x3dbl_2(self.b3x3dbl_1(x))
        b2 = torch.cat([self.b3x3dbl_3a(b2), self.b3x3dbl_3b(b2)], dim=1)
        pooled = _max_pool_3x3(x) if self.pool == "max" else _avg_pool_3x3(x)
        return torch.cat([b0, b1, b2, self.bpool(pooled)], dim=1)


class InceptionV3(nn.Module):
    """The FID Inception-v3; ``forward`` takes NHWC images in uint8 range
    (0..255, float) and returns the (B, 2048) pool features or the (B, 1008)
    softmax."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.conv = ConvBN(3, 32, (3, 3), stride=2, generator=g)  # 149
        self.conv_1 = ConvBN(32, 32, (3, 3), generator=g)  # 147
        self.conv_2 = ConvBN(32, 64, (3, 3), padding=(1, 1), generator=g)
        self.conv_3 = ConvBN(64, 80, generator=g)  # after a pool: 73
        self.conv_4 = ConvBN(80, 192, (3, 3), generator=g)  # 71, then a pool: 35
        self.mixed = InceptionA(192, 32, generator=g)
        self.mixed_1 = InceptionA(256, 64, generator=g)
        self.mixed_2 = InceptionA(288, 64, generator=g)
        self.mixed_3 = InceptionB(288, generator=g)  # 17
        self.mixed_4 = InceptionC(768, 128, generator=g)
        self.mixed_5 = InceptionC(768, 160, generator=g)
        self.mixed_6 = InceptionC(768, 160, generator=g)
        self.mixed_7 = InceptionC(768, 192, generator=g)
        self.mixed_8 = InceptionD(768, generator=g)  # 8
        self.mixed_9 = InceptionE(1280, pool="avg", generator=g)
        self.mixed_10 = InceptionE(2048, pool="max", generator=g)
        self.logit = nn.Linear(FEATURE_DIM, NUM_LOGITS)
        with torch.no_grad():  # flax Dense: LeCun-normal kernel, zero bias
            std = math.sqrt(1.0 / FEATURE_DIM) / 0.87962566103423978
            nn.init.trunc_normal_(self.logit.weight, 0.0, std, -2 * std, 2 * std, generator=g)
            self.logit.bias.zero_()

    def forward(self, x: torch.Tensor, get_feature: bool = False) -> torch.Tensor:
        h = ((x - 128.0) * 0.0078125).permute(0, 3, 1, 2)  # reference preprocessing, NHWC -> NCHW
        h = self.conv_2(self.conv_1(self.conv(h)))
        h = self.conv_4(self.conv_3(_max_pool_3x3_s2(h)))
        h = _max_pool_3x3_s2(h)
        for name in ("mixed", "mixed_1", "mixed_2", "mixed_3", "mixed_4", "mixed_5", "mixed_6", "mixed_7",
                     "mixed_8", "mixed_9", "mixed_10"):
            h = getattr(self, name)(h)
        h = torch.mean(h, dim=(2, 3))  # 8x8 global average pool -> (B, 2048)
        if get_feature:
            return h
        return torch.softmax(self.logit(h), dim=-1)


def load_params(path: Optional[str], device: torch.device | str = "cpu", seed: int = 0) -> InceptionV3:
    """The model with the converted weights of ``path`` (the flat-key npz of
    :func:`convert_tf_checkpoint`, or the JAX package's: ``params/...`` and
    ``batch_stats/...``), strictly; without a path, random weights drawn
    from ``seed``, with a loud warning. In eval mode, without gradients,
    on ``device``."""
    if path is None:
        warnings.warn(
            "No Inception weights supplied: using random init. FID/IS values will be "
            "internally consistent but not comparable to the literature. Convert "
            "inception-2015-12-05's classify_image_graph_def.pb with "
            "python -m rgbd_gan_tpu_torch.tools.convert_inception and pass the npz it writes."
        )
        model = InceptionV3(torch.Generator().manual_seed(seed))
    else:
        model = _undrawn()  # the strict load writes every leaf
        load_jax_variables(model, load_tree(path))
    return model.eval().requires_grad_(False).to(device)


# ---------------------------------------------------------------------------
# TF-checkpoint conversion (no tensorflow needed: see eval/tf_graphdef.py)
# ---------------------------------------------------------------------------

# TF scope (inside a mixed block) -> the branch module's name, per block
# shape, from the reference converter's tower walk
# (source/inception/download.py:70-180)
_MAP_A = [  # mixed / mixed_1 / mixed_2 (35x35)
    ("conv", "b1x1"),
    ("tower/conv", "b5x5_1"), ("tower/conv_1", "b5x5_2"),
    ("tower_1/conv", "b3x3dbl_1"), ("tower_1/conv_1", "b3x3dbl_2"), ("tower_1/conv_2", "b3x3dbl_3"),
    ("tower_2/conv", "bpool"),
]
_MAP_B = [  # mixed_3 (35 -> 17 reduction)
    ("conv", "b3x3"),
    ("tower/conv", "b3x3dbl_1"), ("tower/conv_1", "b3x3dbl_2"), ("tower/conv_2", "b3x3dbl_3"),
]
_MAP_C = [  # mixed_4..mixed_7 (17x17)
    ("conv", "b1x1"),
    ("tower/conv", "b7x7_1"), ("tower/conv_1", "b7x7_2"), ("tower/conv_2", "b7x7_3"),
    ("tower_1/conv", "b7x7dbl_1"), ("tower_1/conv_1", "b7x7dbl_2"), ("tower_1/conv_2", "b7x7dbl_3"),
    ("tower_1/conv_3", "b7x7dbl_4"), ("tower_1/conv_4", "b7x7dbl_5"),
    ("tower_2/conv", "bpool"),
]
_MAP_D = [  # mixed_8 (17 -> 8 reduction)
    ("tower/conv", "b3x3_1"), ("tower/conv_1", "b3x3_2"),
    ("tower_1/conv", "b7x7x3_1"), ("tower_1/conv_1", "b7x7x3_2"), ("tower_1/conv_2", "b7x7x3_3"),
    ("tower_1/conv_3", "b7x7x3_4"),
]
_MAP_E = [  # mixed_9 / mixed_10 (8x8)
    ("conv", "b1x1"),
    ("tower/conv", "b3x3_1"), ("tower/mixed/conv", "b3x3_2a"), ("tower/mixed/conv_1", "b3x3_2b"),
    ("tower_1/conv", "b3x3dbl_1"), ("tower_1/conv_1", "b3x3dbl_2"),
    ("tower_1/mixed/conv", "b3x3dbl_3a"), ("tower_1/mixed/conv_1", "b3x3dbl_3b"),
    ("tower_2/conv", "bpool"),
]
_BLOCK_MAPS = {
    "mixed": _MAP_A, "mixed_1": _MAP_A, "mixed_2": _MAP_A,
    "mixed_3": _MAP_B,
    "mixed_4": _MAP_C, "mixed_5": _MAP_C, "mixed_6": _MAP_C, "mixed_7": _MAP_C,
    "mixed_8": _MAP_D,
    "mixed_9": _MAP_E, "mixed_10": _MAP_E,
}
_STEM = ["conv", "conv_1", "conv_2", "conv_3", "conv_4"]


def iter_conv_mappings():
    """Yield every (tf_conv_scope, module_path) conv+BN pair.

    ``tf_conv_scope`` owns the consts ``{scope}/conv2d_params`` and
    ``{scope}/batchnorm/{gamma,beta,moving_mean,moving_variance}``;
    ``module_path`` is the ``/``-joined :class:`ConvBN` path in
    :class:`InceptionV3` (e.g. ``mixed_4/b7x7_1``).
    """
    for name in _STEM:
        yield name, name
    for block, pairs in _BLOCK_MAPS.items():
        for tf_scope, branch in pairs:
            yield f"{block}/{tf_scope}", f"{block}/{branch}"


def _undrawn() -> InceptionV3:
    """The model on the CPU with its leaves allocated but not drawn (random
    init takes seconds); for a strict load, or for the shapes alone."""
    with torch.device("meta"):
        model = InceptionV3()
    return model.to_empty(device="cpu")


def template_shapes() -> Dict[str, Tuple[int, ...]]:
    """The flat keys that :func:`load_params` reads, with their shapes in the
    flat layout (conv kernels HWIO, the logit kernel (in, out))."""
    return {k: v.shape for k, v in variables_to_jax(_undrawn(), "batch_stats").items()}


def convert_tf_checkpoint(pb_path: str, out_npz: str) -> dict:
    """Convert the TF ``inception-2015-12-05`` GraphDef to the flat-key npz
    that :func:`load_params` reads, and return the dict it wrote.

    The twin of the JAX package's ``convert_tf_checkpoint`` (the same keys
    and values) and a TF-free twin of the reference converter
    (``source/inception/download.py:35-246``): the Const tensors are read
    straight out of the protobuf wire format. TF conv kernels are HWIO, the
    flat keys' layout, and the 2048x1008 logit MatMul weight is (in, out).
    Completeness and every shape are checked against :class:`InceptionV3`.
    """
    from .tf_graphdef import GraphDef

    with open(pb_path, "rb") as f:
        graph = GraphDef(f.read())

    flat = {}
    for tf_scope, module_path in iter_conv_mappings():
        flat[f"params/{module_path}/conv/kernel"] = graph.const_tensor(f"{tf_scope}/conv2d_params")
        bn = f"{tf_scope}/batchnorm"
        flat[f"params/{module_path}/bn/scale"] = graph.const_tensor(f"{bn}/gamma")
        flat[f"params/{module_path}/bn/bias"] = graph.const_tensor(f"{bn}/beta")
        flat[f"batch_stats/{module_path}/bn/mean"] = graph.const_tensor(f"{bn}/moving_mean")
        flat[f"batch_stats/{module_path}/bn/var"] = graph.const_tensor(f"{bn}/moving_variance")
        if graph.has_attr(bn, "variance_epsilon"):  # a synthetic graph may omit the op node
            eps = graph.float_attr(bn, "variance_epsilon")
            if abs(eps - BN_EPS) > 1e-9:
                warnings.warn(f"{bn}: variance_epsilon={eps} differs from the model's "
                              f"hardcoded {BN_EPS}; converted scores will drift")

    # the logit head: the MatMul's weight operand and the bias const (download.py:172-180)
    w = np.asarray(graph.const_tensor(graph.node_input("softmax/logits/MatMul", 1)))
    flat["params/logit/kernel"] = w.reshape(FEATURE_DIM, NUM_LOGITS)
    flat["params/logit/bias"] = np.asarray(graph.const_tensor("softmax/biases")).reshape(NUM_LOGITS)

    template = template_shapes()
    missing = sorted(set(template) - set(flat))
    if missing:
        raise ValueError(f"conversion incomplete; missing keys: {missing[:10]}...")
    for k, v in flat.items():
        if k in template and tuple(np.shape(v)) != template[k]:
            raise ValueError(f"shape mismatch for {k}: graph {np.shape(v)} vs model {template[k]}")

    np.savez(out_npz, **flat)
    return flat
