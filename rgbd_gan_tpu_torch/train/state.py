"""Training state: the modules, one optimizer per clipping domain, the EMA
generator and the iteration counter — what the JAX package's ``TrainState``
pytree holds. The train step updates it in place.

BatchNorm statistics (the JAX package's ``gen_state``, DeepVoxels with the
softmax occlusion net) are buffers of the generator module, so they travel
with ``gen``; ``opt_gen`` covers the synthesis network for StyleGAN and the
whole generator, mapping included, for DeepVoxels, and the whole generator
for DCGAN."""

from __future__ import annotations

import dataclasses
from typing import Optional

from torch import nn

from .optim import ClippedAdam


@dataclasses.dataclass
class TrainState:
    gen: nn.Module
    dis: nn.Module
    opt_map: Optional[ClippedAdam]  # the mapping network's own optimizer (stylegan, deepvoxels; None for dcgan)
    opt_gen: ClippedAdam
    opt_dis: ClippedAdam
    ema_gen: Optional[nn.Module] = None  # smoothed generator (None if disabled)
    iteration: int = 0
