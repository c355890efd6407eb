"""FID and the Inception Score: Inception features on the device, the
algebra on the host.

Port of :mod:`rgbd_gan_tpu.eval.fid` (reference ``evaluation.py:16-200``
and the stat cache of ``common/evaluation/fid.py:44-121``):

- ``gen_images``: n uint8 images from a ``gen(batchsize)`` callable; the
  RGBD generators are adapted by :func:`rgbd_image_sampler` and
  :func:`deepvoxels_image_sampler`, each drawing from one
  ``torch.Generator`` carried across calls (as the JAX key is split)
- ``get_mean_cov``: a bilinear resize to 299, the Inception features, and
  their mean and covariance
- ``FID = ||m0-m1||^2 + tr(c0 + c1 - 2 sqrt(c0 c1))`` with scipy's sqrtm
- ``inception_score``: the KL-based IS over the softmax, in 10 splits
- ``compute_dataset_stat``: the real data's (mean, cov), cached in an npz
- ``calc_FID`` / ``calc_inception``: extension factories writing
  ``stats/fid_*.txt`` / ``stats/inception_score_*.txt``

The resize matches ``jax.image.resize(..., "bilinear")``: half-pixel
centres (``align_corners=False``), antialiased when it shrinks.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..geometry.camera import camera_matrices, theta_to_9dof
from .inception import FEATURE_DIM, INPUT_SIZE, NUM_LOGITS, InceptionV3


def rgbd_image_sampler(
    gen_apply: Callable, make_hidden: Callable, stage_floor: int, alpha: float,
    theta9_sampler: Optional[Callable] = None, generator: Optional[torch.Generator] = None,
) -> Callable:
    """Adapt an RGBD generator to ``gen(batchsize)`` (``evaluation.py:16``):
    draw latents and poses from ``generator``, render, keep RGB.
    ``make_hidden(generator, n)`` and ``theta9_sampler(generator, n)`` draw
    on the generator's device."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)

    def gen(batchsize: int):
        z = make_hidden(generator, batchsize)
        theta9 = theta9_sampler(generator, batchsize) if theta9_sampler else None
        return gen_apply(z, stage_floor, alpha, theta9)[..., :3]

    return gen


def deepvoxels_image_sampler(
    gen_apply: Callable, make_hidden: Callable, prior, stage_floor: int, alpha: float,
    generator: Optional[torch.Generator] = None,
) -> Callable:
    """The DeepVoxels twin of :func:`rgbd_image_sampler`: the generator takes
    the camera matrices beside the 9-DoF pose. The generator is carried
    across calls: a fixed draw would make every batch the same and the
    feature covariance degenerate."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)

    def gen(batchsize: int):
        z = make_hidden(generator, batchsize)
        thetas6 = prior.sample(generator, batchsize, generator.device)
        return gen_apply(z, stage_floor, alpha, theta_to_9dof(thetas6), camera_matrices(thetas6))[..., :3]

    return gen


def gen_images(gen: Callable, n: int = 50000, batchsize: int = 100) -> np.ndarray:
    """n uint8 NHWC images from ``gen(batchsize)`` (tanh range in;
    ``evaluation.py:16-28``)."""
    ims = []
    for _ in range(0, n, batchsize):
        x = gen(batchsize).float().cpu().numpy()
        ims.append(np.asarray(np.clip(x * 127.5 + 127.5, 0.0, 255.0), dtype=np.uint8))
    return np.concatenate(ims, axis=0)[:n]


def resize_to_input(x: torch.Tensor, size: int = INPUT_SIZE) -> torch.Tensor:
    """(B, H, W, C) -> (B, size, size, C), as ``jax.image.resize(...,
    "bilinear")``: half-pixel centres, antialiased when shrinking."""
    if x.shape[1] == size and x.shape[2] == size:
        return x
    shrink = x.shape[1] > size or x.shape[2] > size
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear", align_corners=False,
                      antialias=shrink)
    return y.permute(0, 2, 3, 1)


def _model_outputs(model: InceptionV3, ims: np.ndarray, batch_size: int, get_feature: bool) -> np.ndarray:
    device = next(model.parameters()).device
    out = np.empty((len(ims), FEATURE_DIM if get_feature else NUM_LOGITS), dtype=np.float32)
    with torch.no_grad():
        for i in range(0, len(ims), batch_size):
            batch = torch.as_tensor(np.asarray(ims[i:i + batch_size], dtype=np.float32), device=device)
            out[i:i + batch.shape[0]] = model(resize_to_input(batch), get_feature=get_feature).cpu().numpy()
    return out


def inception_features(model: InceptionV3, ims: np.ndarray, batch_size: int = 100) -> np.ndarray:
    """(n, 2048) pool features; ``ims`` NHWC, uint8 or float in [0, 255]."""
    return _model_outputs(model, ims, batch_size, get_feature=True)


def inception_softmax(model: InceptionV3, ims: np.ndarray, batch_size: int = 100) -> np.ndarray:
    """(n, 1008) softmax of the logits."""
    return _model_outputs(model, ims, batch_size, get_feature=False)


def get_mean_cov(model: InceptionV3, ims: np.ndarray, batch_size: int = 100):
    """Feature mean and covariance (``evaluation.py:140-169``)."""
    ys = inception_features(model, ims, batch_size)
    return np.mean(ys, axis=0), np.cov(ys.T)


def fid_score(m0, c0, m1, c1) -> float:
    """The Frechet distance between two feature Gaussians (``evaluation.py:172-176``)."""
    import scipy.linalg

    ret = np.sum((m0 - m1) ** 2)
    ret += np.trace(c0 + c1 - 2.0 * scipy.linalg.sqrtm(np.dot(c0, c1)))
    return float(np.real(ret))


def inception_score(model: InceptionV3, ims: np.ndarray, batch_size: int = 100, splits: int = 10) -> Tuple[float, float]:
    """IS = exp(E_x KL(p(y|x) || p(y))) over ``splits`` folds
    (``inception_score.py:43-71``; classes 1-1000 of the 1008 logits)."""
    ys = inception_softmax(model, ims, batch_size)[:, 1:1001]
    scores = []
    n = len(ys)
    for i in range(splits):
        part = ys[(i * n // splits):((i + 1) * n // splits)]
        kl = part * (np.log(part + 1e-12) - np.log(np.mean(part, axis=0, keepdims=True) + 1e-12))
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(scores)), float(np.std(scores))


def compute_dataset_stat(model: InceptionV3, ims: np.ndarray, stat_path: str, batch_size: int = 100):
    """The real data's (mean, cov), loaded from ``stat_path`` or computed
    and cached there (``common/evaluation/fid.py:44-121``)."""
    if os.path.exists(stat_path):
        with np.load(stat_path) as f:
            return f["mean"], f["cov"]
    mean, cov = get_mean_cov(model, ims, batch_size)
    os.makedirs(os.path.dirname(stat_path) or ".", exist_ok=True)
    np.savez(stat_path, mean=mean, cov=cov)
    return mean, cov


def calc_FID(gen: Callable, model: InceptionV3, stat_file: str, dst: Optional[str] = None,
             batchsize: int = 100, n_ims: int = 5000) -> Callable:
    """Extension factory (``evaluation.py:179-200``): ``evaluation(iteration)``
    returns the FID of ``n_ims`` generated images against ``stat_file``."""

    def evaluation(iteration: Optional[int] = None) -> float:
        with np.load(stat_file) as stat:
            m0, c0 = stat["mean"], stat["cov"]
        ims = gen_images(gen, n_ims, batchsize=batchsize).astype("f")
        mean, cov = get_mean_cov(model, ims, batch_size=batchsize)
        fid = fid_score(m0, c0, mean, cov)
        if dst is not None:
            stats_dir = os.path.join(dst, "stats")
            os.makedirs(stats_dir, exist_ok=True)
            np.savetxt(os.path.join(stats_dir, "fid_{:0>8}.txt".format(iteration)), np.array([fid]))
        return fid

    return evaluation


def calc_inception(gen: Callable, model: InceptionV3, dst: Optional[str] = None, batchsize: int = 100,
                   n_ims: int = 50000, splits: int = 10) -> Callable:
    """Extension factory (``evaluation.py:121-137``): ``evaluation(iteration)``
    returns the Inception Score (mean, std) of ``n_ims`` generated images."""

    def evaluation(iteration: Optional[int] = None) -> Tuple[float, float]:
        ims = gen_images(gen, n_ims, batchsize=batchsize).astype("f")
        mean, std = inception_score(model, ims, batch_size=batchsize, splits=splits)
        if dst is not None:
            stats_dir = os.path.join(dst, "stats")
            os.makedirs(stats_dir, exist_ok=True)
            np.savetxt(os.path.join(stats_dir, "inception_score_{:0>8}.txt".format(iteration)),
                       np.array([mean, std]))
        return mean, std

    return evaluation
