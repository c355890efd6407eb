"""TF-free GraphDef executor for the ``inception-2015-12-05`` op set, in
PyTorch on an explicit device — port of :mod:`rgbd_gan_tpu.eval.graphdef_exec`.

The reference's TF-side IS/FID path (``source/inception/inception_score_tf.py:
29-46,130-153``) imports the raw ``classify_image_graph_def.pb`` into
TensorFlow, feeds ``ExpandDims:0`` and fetches ``pool_3:0``. Neither package
has TensorFlow, so this module *interprets* the parsed GraphDef
(:mod:`.tf_graphdef`) with TensorFlow's op semantics, as the JAX package's
numpy executor does:

- ``SAME`` padding is TF's asymmetric split (the extra row/col at the END),
  padded explicitly before a ``padding=0`` conv or pool;
- ``AvgPool`` divides by the number of un-padded elements in each window
  (count-EXCLUDE-padding; the reference's Chainer reimplementation and the
  port's :class:`.inception.InceptionV3` count the padding), summing in
  float64 as the numpy executor does;
- ``ResizeBilinear`` uses TF1's asymmetric (non-half-pixel) source grid,
  ``src = dst * (in/out)``, with the ``align_corners`` attr honoured,
  weights in float64;
- ``BatchNormWithGlobalNormalization`` follows the deprecated op's formula
  with the ``scale_after_normalization`` switch;
- ``Concat`` takes its axis first, ``ConcatV2`` last.

Activations stay NHWC, as in the graph (a conv or pool sees an NCHW view of
them); float constants live on the executor's device, int32 constants
(axes, shapes, sizes) on the host. Convolutions run in float32 with TF32
off. :meth:`GraphExecutor.run` returns tensors on the device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .tf_graphdef import GraphDef

__all__ = ["GraphExecutor"]

Value = Union[torch.Tensor, np.ndarray]


# ---------------------------------------------------------------------------
# op helpers (NHWC tensors)
# ---------------------------------------------------------------------------


def _same_pad(in_size: int, k: int, s: int) -> Tuple[int, int]:
    """TF SAME padding: total = max((ceil(in/s)-1)*s + k - in, 0), the odd
    element goes AFTER (bottom/right)."""
    out = -(-in_size // s)
    total = max((out - 1) * s + k - in_size, 0)
    before = total // 2
    return before, total - before


def _pad2d(x: torch.Tensor, k: Tuple[int, int], s: Tuple[int, int], padding: str, fill: float) -> torch.Tensor:
    """``x`` (NHWC) padded for a ``padding`` window of size ``k``, stride ``s``."""
    if padding == "VALID":
        return x
    if padding != "SAME":
        raise ValueError(f"unsupported padding {padding!r}")
    ph = _same_pad(x.shape[1], k[0], s[0])
    pw = _same_pad(x.shape[2], k[1], s[1])
    return F.pad(x, (0, 0, *pw, *ph), value=fill)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _conv2d(x: torch.Tensor, w: torch.Tensor, strides: Sequence[int], padding: str) -> torch.Tensor:
    """NHWC x, HWIO w."""
    sh, sw = int(strides[1]), int(strides[2])
    kh, kw, ci, _ = w.shape
    if x.shape[-1] != ci:
        raise ValueError(f"conv channel mismatch {tuple(x.shape)} vs {tuple(w.shape)}")
    x = _pad2d(x, (kh, kw), (sh, sw), padding, 0.0)
    return _nhwc(F.conv2d(_nchw(x), w.permute(3, 2, 0, 1), stride=(sh, sw)))


def _pool2d(x: torch.Tensor, ksize: Sequence[int], strides: Sequence[int], padding: str, kind: str) -> torch.Tensor:
    k = (int(ksize[1]), int(ksize[2]))
    s = (int(strides[1]), int(strides[2]))
    if kind == "max":
        return _nhwc(F.max_pool2d(_nchw(_pad2d(x, k, s, padding, -float("inf"))), k, s))
    # TF AvgPool: the window's sum over the count of elements NOT from padding
    total = F.avg_pool2d(_nchw(_pad2d(x.to(torch.float64), k, s, padding, 0.0)), k, s, divisor_override=1)
    ones = torch.ones(x.shape[:3] + (1,), dtype=torch.float64, device=x.device)
    count = F.avg_pool2d(_nchw(_pad2d(ones, k, s, padding, 0.0)), k, s, divisor_override=1)
    return _nhwc(total / count).to(x.dtype)


def _resize_bilinear(x: torch.Tensor, size: Sequence[int], align_corners: bool) -> torch.Tensor:
    """TF1 ResizeBilinear (half_pixel_centers=False)."""
    _, h, w, _ = x.shape
    oh, ow = int(size[0]), int(size[1])

    def grid(in_s: int, out_s: int):
        steps = torch.arange(out_s, dtype=torch.float64, device=x.device)
        src = steps * (in_s - 1) / (out_s - 1) if align_corners and out_s > 1 else steps * (in_s / out_s)
        i0 = torch.clamp(torch.floor(src).long(), 0, in_s - 1)
        i1 = torch.clamp(i0 + 1, max=in_s - 1)
        return i0, i1, src - i0

    y0, y1, fy = grid(h, oh)
    x0, x1, fx = grid(w, ow)
    xd = x.to(torch.float64)
    fx, fy = fx[None, None, :, None], fy[None, :, None, None]

    def row(y):
        r = xd[:, y]
        return r[:, :, x0] * (1 - fx) + r[:, :, x1] * fx

    return (row(y0) * (1 - fy) + row(y1) * fy).to(torch.float32)


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------


def _strip(tensor_name: str) -> str:
    return tensor_name.split(":")[0].lstrip("^")


def _ints(v: Value) -> List[int]:
    return [int(d) for d in np.ravel(v.cpu().numpy() if isinstance(v, torch.Tensor) else v)]


class GraphExecutor:
    """Evaluate tensors of a parsed GraphDef with PyTorch on ``device``.

    ``run(fetch, feeds)`` accepts node or ``node:0`` names for both the fetch
    and the feed keys (only output :0 is modelled: the inception graph is
    single-output throughout); feeds are numpy arrays or tensors. Node
    results are memoised per ``run`` call, constants for the executor's life.
    """

    def __init__(self, graph: GraphDef, device: torch.device | str = "cpu"):
        self.graph = graph
        self.device = torch.device(device)
        self._consts: Dict[str, Value] = {}  # each Const node's value, read from the wire once

    # -- public --------------------------------------------------------------

    def run(self, fetch: Union[str, Sequence[str]], feeds: Dict[str, Value] = None):
        cache: Dict[str, Value] = {_strip(k): self._on_device(v) for k, v in (feeds or {}).items()}
        fetches = [fetch] if isinstance(fetch, str) else list(fetch)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False  # float32 convolutions, as TF's
        try:
            with torch.no_grad():
                outs = [self._eval(_strip(f), cache) for f in fetches]
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        return outs[0] if isinstance(fetch, str) else outs

    # -- evaluation ----------------------------------------------------------

    def _on_device(self, v: Value) -> Value:
        """Float values onto the device; int32 values (axes, shapes) on the host."""
        if isinstance(v, torch.Tensor):
            return v.to(self.device) if v.is_floating_point() else v.cpu().numpy()
        v = np.asarray(v)
        return torch.from_numpy(np.ascontiguousarray(v)).to(self.device) if v.dtype.kind == "f" else v

    def _eval(self, name: str, cache: Dict[str, Value]) -> Value:
        """Iterative post-order evaluation (the real pb is about 100 levels
        deep; no recursion)."""
        stack: List[str] = [name]
        while stack:
            cur = stack[-1]
            if cur in cache:
                stack.pop()
                continue
            node = self.graph.nodes.get(cur)
            if node is None:
                raise KeyError(f"no node named {cur!r} in graph (and not fed)")
            deps = [_strip(i) for i in node["inputs"]]
            missing = [d for d in deps if d not in cache]
            if missing:
                stack.extend(missing)
                continue
            stack.pop()
            cache[cur] = self._apply(cur, node, [cache[d] for d in deps])
        return cache[name]

    def _apply(self, name: str, node: dict, ins: List[Value]) -> Value:
        op = node["op"]
        g = self.graph
        if op == "Const":
            if name not in self._consts:
                self._consts[name] = self._on_device(g.const_tensor(name))
            return self._consts[name]
        if op in ("Identity", "CheckNumerics", "StopGradient"):
            return ins[0]
        if op in ("Placeholder", "DecodeJpeg"):
            raise KeyError(f"node {name!r} (op {op}) must be fed")
        if op == "Cast":
            v = ins[0] if isinstance(ins[0], torch.Tensor) else torch.from_numpy(np.asarray(ins[0]))
            return v.to(self.device, torch.float32)
        if op == "ExpandDims":
            return torch.unsqueeze(ins[0], _ints(ins[1])[0])
        if op == "Squeeze":
            dims = g.int_list_attr(name, "squeeze_dims") if g.has_attr(name, "squeeze_dims") else []
            return torch.squeeze(ins[0], tuple(dims)) if dims else torch.squeeze(ins[0])
        if op == "Reshape":
            return torch.reshape(ins[0], _ints(ins[1]))
        if op == "ResizeBilinear":
            ac = g.bool_attr(name, "align_corners") if g.has_attr(name, "align_corners") else False
            return _resize_bilinear(ins[0], _ints(ins[1]), ac)
        if op == "Sub":
            return ins[0] - ins[1]
        if op in ("Add", "AddV2", "BiasAdd"):
            return ins[0] + ins[1]
        if op == "Mul":
            return ins[0] * ins[1]
        if op == "Relu":
            return torch.relu(ins[0])
        if op == "Softmax":
            return torch.softmax(ins[0], dim=-1)
        if op == "MatMul":
            a, b = ins
            if g.has_attr(name, "transpose_a") and g.bool_attr(name, "transpose_a"):
                a = a.T
            if g.has_attr(name, "transpose_b") and g.bool_attr(name, "transpose_b"):
                b = b.T
            return a @ b
        if op == "Conv2D":
            return _conv2d(ins[0], ins[1], g.int_list_attr(name, "strides"), g.str_attr(name, "padding"))
        if op in ("MaxPool", "AvgPool"):
            return _pool2d(ins[0], g.int_list_attr(name, "ksize"), g.int_list_attr(name, "strides"),
                           g.str_attr(name, "padding"), "max" if op == "MaxPool" else "avg")
        if op == "BatchNormWithGlobalNormalization":
            x, mean, var, beta, gamma = ins
            eps = g.float_attr(name, "variance_epsilon")
            scale_after = (
                g.bool_attr(name, "scale_after_normalization")
                if g.has_attr(name, "scale_after_normalization") else True
            )
            inv = 1.0 / torch.sqrt(var + eps)
            if scale_after:
                return (x - mean) * inv * gamma + beta
            return (x - mean) * inv + beta
        if op in ("Concat", "ConcatV2"):
            # Concat: the axis first; ConcatV2: the axis last
            if op == "Concat":
                axis, tensors = _ints(ins[0])[0], ins[1:]
            else:
                axis, tensors = _ints(ins[-1])[0], ins[:-1]
            return torch.cat(list(tensors), dim=axis)
        raise NotImplementedError(f"GraphDef op {op!r} (node {name!r})")
