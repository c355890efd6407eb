"""TF-free twin of the reference's TF-side IS/FID module over the port's
GraphDef executor — port of :mod:`rgbd_gan_tpu.eval.inception_score_compat`.

Mirrors ``source/inception/inception_score_tf.py`` function for function —
``inception_forward`` / ``get_mean_and_cov`` / ``get_fid`` /
``get_inception_score`` / ``get_inception_accuracy`` — but executes the raw
``classify_image_graph_def.pb`` through :class:`.graphdef_exec.GraphExecutor`
(PyTorch, on the card unless :func:`_init_inception` is given the CPU)
instead of TensorFlow.

Faithful behaviours (cited against the reference file):

- images arrive NCHW in [0, 255] and are transposed to NHWC, batched at 100,
  and fed at ``ExpandDims:0`` (``inception_score_tf.py:29-46``);
- the softmax head multiplies the squeezed ``pool_3`` features by the
  ``softmax/logits/MatMul`` WEIGHT only: the reference never adds the bias
  (``inception_score_tf.py:150-153``); preserved, flagged quirk;
- the IS KL uses plain ``np.log`` with no epsilon (``:80``);
- FID-over-splits compares each split of the generated features against the
  FULL reference stats (``:56-70``).

Deliberate divergences, as in the JAX package: ``_init_inception`` is lazy
and reads a local pb (the reference downloads at import time, ``:112-134``),
and ``get_fid(images, ref_stats=...)`` unpacks the given ``(m, cov)`` (the
reference hits an unbound ``m_ref`` there, ``:56-63``). The pb is the path
given to :func:`_init_inception` or ``$RGBD_GAN_INCEPTION_PB``; unlike the
JAX package, no default directory is read.

The production eval path is :mod:`.fid` on :class:`.inception.InceptionV3`;
this module is the reference's TF-path API and an independent execution
route for checking the weight converter.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np
import torch

from .graphdef_exec import GraphExecutor
from .tf_graphdef import GraphDef

PB_NAME = "classify_image_graph_def.pb"
PB_ENV = "RGBD_GAN_INCEPTION_PB"

# set by _init_inception (None before, like the reference's module globals)
softmax: Optional[str] = None
last_layer: Optional[str] = None

_executor: Optional[GraphExecutor] = None
_logit_w: Optional[np.ndarray] = None


def _init_inception(pb_path: Optional[str] = None, device: torch.device | str = "cuda") -> None:
    """Load the GraphDef onto ``device`` and expose the two fetchable layers:
    the twin of ``inception_score_tf.py:112-153`` without the download. Reads
    ``pb_path``, else ``$RGBD_GAN_INCEPTION_PB``."""
    global softmax, last_layer, _executor, _logit_w
    path = pb_path or os.environ.get(PB_ENV)
    if not path:
        raise FileNotFoundError(f"no {PB_NAME}: pass its path to _init_inception or set ${PB_ENV}")
    with open(path, "rb") as f:
        graph = GraphDef(f.read())
    _executor = GraphExecutor(graph, device)
    # the softmax head the reference builds by hand: pool_3 @ W, no bias
    w_node = graph.node_input("softmax/logits/MatMul", 1)
    _logit_w = np.asarray(graph.const_tensor(w_node), np.float32)
    last_layer = "last_layer"
    softmax = "softmax"


def _require_init() -> GraphExecutor:
    if _executor is None:
        _init_inception()
    return _executor


def inception_forward(images: np.ndarray, layer: str) -> np.ndarray:
    """Run NCHW [0,255] images through the graph; twin of
    ``inception_score_tf.py:29-46`` (same asserts, batch 100, ExpandDims
    feed)."""
    ex = _require_init()
    assert type(images[0]) == np.ndarray  # noqa: E721 (the reference's assert)
    assert len(images[0].shape) == 3
    assert np.max(images[0]) > 10
    assert np.min(images[0]) >= 0.0
    bs = 100
    images = np.asarray(images).transpose(0, 2, 3, 1)
    preds = []
    n_batches = int(math.ceil(float(len(images)) / float(bs)))
    for i in range(n_batches):
        inp = images[(i * bs): min((i + 1) * bs, len(images))]
        pool3 = ex.run("pool_3:0", {"ExpandDims:0": inp.astype(np.float32)})
        feats = pool3.reshape(pool3.shape[0], -1).cpu().numpy()  # tf.squeeze(pool_3)
        if layer == "last_layer":
            preds.append(feats)
        elif layer == "softmax":
            logits = feats @ _logit_w  # no bias: inception_score_tf.py:150-153
            z = logits - logits.max(axis=-1, keepdims=True)
            e = np.exp(z)
            preds.append(e / e.sum(axis=-1, keepdims=True))
        else:
            raise ValueError(f"unknown layer {layer!r}")
    return np.concatenate(preds, 0)


def get_mean_and_cov(images: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``inception_score_tf.py:49-53``."""
    before_preds = inception_forward(images, last_layer)
    m = np.mean(before_preds, 0)
    cov = np.cov(before_preds, rowvar=False)
    return m, cov


def get_fid(images: np.ndarray, ref_stats=None, images_ref=None, splits: int = 10) -> Tuple[float, float]:
    """FID per split against the full reference stats (``:56-70``)."""
    import scipy.linalg

    before_preds = inception_forward(images, last_layer)
    if ref_stats is None:
        if images_ref is None:
            raise ValueError("images_ref should be provided if ref_stats is None")
        m_ref, cov_ref = get_mean_and_cov(images_ref)
    else:
        m_ref, cov_ref = ref_stats  # divergence: the reference never unpacks this
    fids = []
    n = before_preds.shape[0]
    for i in range(splits):
        part = before_preds[(i * n // splits): ((i + 1) * n // splits), :]
        m_gen = np.mean(part, 0)
        cov_gen = np.cov(part, rowvar=False)
        fid = np.sum((m_ref - m_gen) ** 2) + np.trace(
            cov_ref + cov_gen - 2 * scipy.linalg.sqrtm(np.dot(cov_ref, cov_gen))
        )
        fids.append(np.real(fid))
    return float(np.mean(fids)), float(np.std(fids))


def get_inception_score(images: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """``inception_score_tf.py:75-83`` (plain log, no epsilon)."""
    preds = inception_forward(images, softmax)
    scores = []
    n = preds.shape[0]
    for i in range(splits):
        part = preds[(i * n // splits): ((i + 1) * n // splits), :]
        kl = part * (np.log(part) - np.log(np.expand_dims(np.mean(part, 0), 0)))
        kl = np.mean(np.sum(kl, 1))
        scores.append(np.exp(kl))
    return float(np.mean(scores)), float(np.std(scores))


def get_inception_accuracy(images, labels) -> float:
    """``inception_score_tf.py:88-108``, with a numpy argmax accuracy for
    ``chainer.functions.accuracy``."""
    if isinstance(images, (list, tuple)):
        ys_list = [inception_forward(ims, softmax)[:, 1:1001] for ims in images]
        ys = sum(ys_list) / len(ys_list)
    else:
        ys = inception_forward(images, softmax)[:, 1:1001]
    return float(np.mean(np.argmax(ys, axis=1) == np.asarray(labels)))
