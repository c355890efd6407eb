"""GAN losses, R1 gradient penalty, real-image progressive resize (PyTorch).

Port of :mod:`rgbd_gan_tpu.train.losses` (reference
``common/loss_functions.py:7-28``, ``updater.py:414-418``,
``common/utils/pggan.py:6-49``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..nn.layers import upscale2x


def l2_loss(h: torch.Tensor, t) -> torch.Tensor:
    """``loss_l2``: sum((h - t)^2) / numel (``loss_functions.py:7-8``)."""
    return torch.mean((h - t) ** 2)


def gen_adv_loss(y_fake: torch.Tensor, focal_loss_gamma: Optional[float] = 0.0) -> torch.Tensor:
    """Non-saturating softplus generator loss with optional focal weighting
    ``sigmoid(-y)**gamma`` (``loss_functions.py:11-14``). The RGBD updater
    calls it with gamma 0 whatever the yml says; the DeepVoxels updater
    passes the yml's ``focal_loss_gamma``."""
    loss = F.softplus(-y_fake)
    if focal_loss_gamma:
        loss = loss * torch.sigmoid(-y_fake) ** focal_loss_gamma
    return torch.mean(loss)


def dis_adv_loss(y_fake: torch.Tensor, y_real: torch.Tensor) -> torch.Tensor:
    """Softplus discriminator loss (``loss_functions.py:17-28``)."""
    return torch.mean(F.softplus(y_fake)) + torch.mean(F.softplus(-y_real))


def dis_out_and_r1(
    dis_fn: Callable[[torch.Tensor], torch.Tensor], x_real: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """D(x_real) and its zero-centred R1 penalty from one forward.

    ``mean_b(||d sum(D(x)) / dx||^2)`` (``updater.py:414-418``); the input
    gradient is taken with ``create_graph=True`` so that the penalty stays
    differentiable with respect to the discriminator's parameters. The
    gradient has ``x_real``'s dtype (bf16 under ``mixed16``); the penalty's
    arithmetic is float32.
    """
    x = x_real.detach().requires_grad_(True)
    y_real = dis_fn(x)
    (grad_x,) = torch.autograd.grad(y_real, x, torch.ones_like(y_real), create_graph=True)
    grad_x = grad_x.float()
    sq_norms = torch.sum(grad_x**2, dim=tuple(range(1, grad_x.dim())))
    return y_real, l2_loss(torch.sqrt(sq_norms + 1e-24), 0.0)


def _avg_pool_by(x: torch.Tensor, scale: int) -> torch.Tensor:
    """NHWC average pool with kernel = stride = scale."""
    if scale <= 1:
        return x
    b, h, w, c = x.shape
    return x.reshape(b, h // scale, scale, w // scale, scale, c).mean(dim=(2, 4))


def downsize_real(x_real: torch.Tensor, stage_floor: int, alpha, max_stage: int = 17) -> torch.Tensor:
    """Resize full-resolution reals (NHWC) to the active stage's size.

    Even stage: average-pool to ``4*2**(s/2)``. Odd stage: blend
    ``(1-alpha) * upscale(pool(low)) + alpha * pool(high)``.
    """
    if x_real.shape[1] != x_real.shape[2]:
        raise ValueError(f"square images expected, got {tuple(x_real.shape)}")
    input_size = x_real.shape[1]
    stage = min(int(stage_floor), max_stage - 1)
    if stage % 2 == 0:
        image_size = 4 * (2 ** ((stage - 2) // 2 + 1))
        if image_size > input_size:
            raise ValueError(f"stage {stage} needs {image_size} px reals, got {input_size}")
        return _avg_pool_by(x_real, input_size // image_size)
    k = (stage - 1) // 2
    size_low, size_high = 4 * (2**k), 4 * (2 ** (k + 1))
    if size_high > input_size:
        raise ValueError(f"stage {stage} needs {size_high} px reals, got {input_size}")
    result_low = x_real
    if input_size // size_low > 1:
        result_low = upscale2x(_avg_pool_by(x_real, input_size // size_low))
    result_high = _avg_pool_by(x_real, input_size // size_high)
    return (1.0 - alpha) * result_low + alpha * result_high
