"""Image post-processing helpers (``common/utils/image_processing.py:11-33``).

Port of :mod:`rgbd_gan_tpu.utils.image_processing`: each takes a tensor on
any device, or an array, and returns a host numpy array.
"""

from __future__ import annotations

import numpy as np
import torch


def to_host(imgs) -> np.ndarray:
    """A tensor (detached, moved to the host) or an array -> numpy (the
    reference's ``copy_to_cpu``)."""
    if isinstance(imgs, torch.Tensor):
        return imgs.detach().cpu().numpy()
    return np.asarray(imgs)


def postprocessing_tanh(imgs) -> np.ndarray:
    """[-1, 1] -> uint8."""
    imgs = (to_host(imgs) + 1) * 127.5
    return np.clip(imgs, 0, 255).astype(np.uint8)


def postprocessing_sigmoid(imgs) -> np.ndarray:
    """[0, 1] -> uint8."""
    imgs = to_host(imgs) * 255.0
    return np.clip(imgs, 0, 255).astype(np.uint8)
