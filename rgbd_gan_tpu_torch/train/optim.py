"""Adam after a global-norm clip at 5, with per-group learning rates.

Port of :mod:`rgbd_gan_tpu.train.optim`. The reference builds one Chainer
Adam per model with a ``GradientClipping(5)`` hook (``train_rgbd.py:151-161``);
for StyleGAN the mapping network is its own optimizer (own clipping domain)
at ``alpha/100`` and the camera-conditioning layers ``l1``/``l2`` step at
``alpha/100`` inside the synthesis optimizer (``train_rgbd.py:314-327``).

The multi-GPU learning-rate table (``config.py:3-17``) comes along keyed on
the device count; the legacy step multiplies both losses by its factor.

The arithmetic is optax's ``chain(clip_by_global_norm(5), adam(...))``:
gradients are scaled only when their global norm is not below 5, and the
step is ``mu_hat / (sqrt(nu_hat) + eps)`` with bias corrections taken in
float32. A parameter with no gradient counts as a zero gradient, as a
flax tree would.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

NamedParams = Sequence[Tuple[str, torch.nn.Parameter]]
MAX_NORM = 5.0  # GradientClipping(5)
EPS = 1e-8

# per-(device-count, stage) learning-rate multiplier (reference config.py:3-17)
LR_SCALE_TABLE = {
    1: {15: 1.5, 16: 1.5, 17: 1.5},
    2: {13: 1.5, 14: 1.5, 15: 2, 16: 2, 17: 2},
    3: {11: 1.5, 12: 1.5, 13: 2, 14: 2, 15: 2.5, 16: 2.5, 17: 2.5},
    4: {11: 1.5, 12: 1.5, 13: 2, 14: 2, 15: 3, 16: 3, 17: 3},
    8: {9: 1.5, 10: 1.5, 11: 2, 12: 2, 13: 3, 14: 3, 15: 3, 16: 3, 17: 3},
}


def get_lr_scale_factor(total_devices: int, stage: float) -> float:
    """The table's factor at the floor of ``stage``; an unknown device count
    reads the one-device row, a stage from 18 on reads stage 17's."""
    table = LR_SCALE_TABLE.get(total_devices, LR_SCALE_TABLE[1])
    stage = math.floor(stage)
    if stage >= 18:
        return table[17]
    return table.get(stage, 1)


class ClippedAdam:
    """Adam(beta1, beta2, eps 1e-8) on the gradients of one clipping domain,
    clipped to global norm 5. ``groups`` is a list of ``(named_params, lr)``;
    ``update_scales`` multiplies each group's step after the learning rate."""

    def __init__(
        self,
        groups: Sequence[Tuple[NamedParams, float]],
        beta1: float,
        beta2: float,
        update_scales: Optional[Sequence[float]] = None,
    ):
        self.beta1, self.beta2 = beta1, beta2
        self.names: List[str] = []
        self.params: List[torch.nn.Parameter] = []
        self.group_slices: List[Tuple[int, int, float, float]] = []
        scales = update_scales or [1.0] * len(groups)
        for (named, lr), scale in zip(groups, scales):
            start = len(self.params)
            for name, p in named:
                self.names.append(name)
                self.params.append(p)
            self.group_slices.append((start, len(self.params), lr, scale))
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        """Apply one update from ``grads``, aligned with ``self.params``."""
        g = [torch.zeros_like(p) if gi is None else gi for p, gi in zip(self.params, grads)]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        factor = torch.where(norm < MAX_NORM, torch.ones_like(norm), MAX_NORM / norm)
        g = torch._foreach_mul(g, factor)

        b1, b2 = self.beta1, self.beta2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2))
        self.count += 1
        one = np.float32(1.0)
        bc1 = float(one - np.float32(b1) ** np.int32(self.count))
        bc2 = float(one - np.float32(b2) ** np.int32(self.count))
        mu_hat = torch._foreach_div(self.mu, bc1)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(denom, EPS)
        upd = torch._foreach_div(mu_hat, denom)
        for start, stop, lr, scale in self.group_slices:
            if start == stop:  # an empty group (the RGB generator has no l1/l2)
                continue
            u = torch._foreach_mul(upd[start:stop], -lr)
            if scale != 1.0:
                torch._foreach_mul_(u, scale)
            torch._foreach_add_(self.params[start:stop], u)

    def state_dict(self) -> Dict[str, object]:
        return {
            "count": self.count,
            "mu": dict(zip(self.names, self.mu)),
            "nu": dict(zip(self.names, self.nu)),
        }

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object]) -> None:
        self.count = int(state["count"])
        for i, name in enumerate(self.names):
            self.mu[i].copy_(state["mu"][name])
            self.nu[i].copy_(state["nu"][name])


def make_optimizer(named_params: NamedParams, alpha: float, beta1: float, beta2: float) -> ClippedAdam:
    """Adam(alpha, beta1, beta2, eps=1e-8) after the global-norm clip at 5."""
    return ClippedAdam([(list(named_params), alpha)], beta1, beta2)


def make_stylegan_gen_optimizer(
    named_params: NamedParams, alpha: float, beta1: float, beta2: float, rgbd: bool
) -> ClippedAdam:
    """Synthesis-network optimizer: one clipping domain; for an RGBD
    generator the ``l1``/``l2`` camera-conditioning layers step at
    ``alpha/100`` (``train_rgbd.py:323-327``). An RGB generator has no
    camera conditioning: with ``rgbd=False`` every parameter steps at
    ``alpha``, whatever its name."""
    named = list(named_params)

    def slow(name: str) -> bool:
        parts = name.split(".")
        return rgbd and ("l1" in parts or "l2" in parts)

    fast = [(n, p) for n, p in named if not slow(n)]
    slow_ = [(n, p) for n, p in named if slow(n)]
    # optax scales the learning-rate step by 0.01 for the slow label
    return ClippedAdam([(fast, alpha), (slow_, alpha)], beta1, beta2, update_scales=[1.0, 0.01])
