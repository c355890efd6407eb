"""Preview rendering: camera-sweep grids with interleaved RGB and depth rows.

Port of :mod:`rgbd_gan_tpu.eval.preview`: ``sample_generate_light``
(``train_rgbd.py:39-92``) and ``convert_batch_images``
(``common/utils/save_images.py:9-24``).

- fixed seed; the same z is tiled down each column and the yaw sweeps
  ``linspace(-test_y_rotate, +test_y_rotate, rows)``
- rendered in chunks of 16 images, so the grid's forward does not need the
  memory of 64 at once beside the train state
- depth rows are colourised as ``clip(1/depth * 128, 0, 255)``
- with ``rgb: True`` there is no sweep: the generator gets no pose, and the
  grid holds the RGB rows alone
- writes ``[out]/preview/image_latest.png`` and the image named after the
  iteration floored to 10k; without PIL the grid goes to
  ``[out]/preview_latest.npy``
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from ..core.stage import decompose_stage
from ..geometry.camera import camera_matrices

PREVIEW_CHUNK = 16


def convert_batch_images(x: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """(rows*cols, C, H, W) float in [-1, 1] (plus an inverse-depth channel)
    -> uint8 (H', W', 3) grid; an RGBD input gives RGB and depth row pairs."""
    rgbd = x.shape[1] == 4
    if rgbd:
        depth = np.tile(x[:, -1:], (1, 3, 1, 1))
        x = x[:, :-1]
    x = np.asarray(np.clip(x * 127.5 + 127.5, 0.0, 255.0), dtype=np.uint8)
    _, _, h, w = x.shape
    x = x.reshape((rows, cols, 3, h, w))
    if rgbd:
        depth = np.asarray(np.clip(1 / depth * 128, 0.0, 255.0), dtype=np.uint8)
        depth = depth.reshape((rows, cols, 3, h, w))
        x = np.concatenate([x, depth], axis=1).reshape(rows * 2, cols, 3, h, w)
    x = x.transpose(0, 3, 1, 4, 2)
    return x.reshape((-1, cols * w, 3))


def render_preview_float(
    gen_apply: Callable, make_hidden: Callable, config, stage: float, rows: int = 8, cols: int = 8, seed: int = 0
) -> np.ndarray:
    """The grid's images before conversion: (rows*cols, C, H, W) float32.

    ``gen_apply(z, stage_floor, alpha, theta9, mats)`` returns NHWC images
    (``mats`` is for the DeepVoxels generator; the others ignore it);
    ``make_hidden(np_rng, n)`` draws latents on the host, so the fixed seed
    gives the reference's ``np.random.seed(seed)`` latents. An RGB config
    (``rgb: True``) passes ``theta9`` and ``mats`` as ``None``
    (``eval/preview.py:67-69`` of the JAX package)."""
    rng = np.random.RandomState(seed)
    z = make_hidden(rng, cols)
    # the same z down each column (train_rgbd.py:52)
    z = np.tile(z[:, None], (1, rows) + (1,) * (z.ndim - 1)).reshape(rows * cols, *z.shape[1:])
    theta9 = mats = None
    if not config.rgb:
        theta = np.zeros((rows * cols, 6), dtype="float32")
        theta[:, 1] = np.tile(np.linspace(-config.test_y_rotate, config.test_y_rotate, rows), cols)
        theta9 = np.concatenate([np.cos(theta[:, :3]), np.sin(theta[:, :3]), theta[:, 3:]], axis=1).astype("float32")
        mats = camera_matrices(torch.from_numpy(theta)).numpy()
    floor, alpha = decompose_stage(stage, config.max_stage or 17)
    outs = []
    for i in range(0, z.shape[0], PREVIEW_CHUNK):
        sl = slice(i, i + PREVIEW_CHUNK)
        t9, ms = (None, None) if theta9 is None else (theta9[sl], mats[sl])
        outs.append(gen_apply(z[sl], floor, alpha, t9, ms).float().cpu().numpy())
    return np.concatenate(outs, axis=0).transpose(0, 3, 1, 2)  # NHWC -> NCHW


def render_preview_grid(
    gen_apply: Callable, make_hidden: Callable, config, stage: float, rows: int = 8, cols: int = 8, seed: int = 0
) -> np.ndarray:
    """The camera-sweep preview grid as a uint8 (H, W, 3) array (see
    :func:`render_preview_float`)."""
    x = render_preview_float(gen_apply, make_hidden, config, stage, rows, cols, seed)
    return convert_batch_images(x, rows, cols)


def sample_generate_light(
    gen_apply: Callable,
    make_hidden: Callable,
    dst: str,
    config,
    rows: int = 8,
    cols: int = 8,
    seed: int = 0,
    subdir: str = "preview",
) -> Callable:
    """Trainer extension: ``extension(iteration, stage)`` writes
    ``image_latest.png`` and the 10k-floored image (``train_rgbd.py:83-90``)
    and returns the path of the first."""

    def extension(iteration: int, stage: float) -> str:
        grid = render_preview_grid(gen_apply, make_hidden, config, stage, rows, cols, seed)
        try:
            from PIL import Image
        except ImportError:
            os.makedirs(dst, exist_ok=True)
            path = os.path.join(dst, f"{subdir}_latest.npy")
            np.save(path, grid)
            return path
        preview_dir = os.path.join(dst, subdir)
        os.makedirs(preview_dir, exist_ok=True)
        img = Image.fromarray(grid)
        latest = os.path.join(preview_dir, "image_latest.png")
        img.save(latest)
        img.save(os.path.join(preview_dir, "image{:0>8}.png".format(iteration // 10000 * 10000)))
        return latest

    return extension
