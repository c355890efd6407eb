"""Progressive-growing stage schedule (pure host-side functions).

Copy of :mod:`rgbd_gan_tpu.core.stage`. The schedule maps an iteration
count to a float ``stage``; its floor selects the active block set and its
fractional part is the fade-in blend ``alpha``. Semantics match the
reference scheduler (``updater.py:252-256``,
``common/utils/pggan.py:6-49`` in nogu-atsu/RGBD-GAN):

- even stage ``s``   -> stable resolution ``4 * 2**(s/2)``
- odd  stage ``s``   -> fade-in from ``4*2**((s-1)/2)`` to ``4*2**((s+1)/2)``
  with blend weight ``alpha = frac(stage)``
- stage is clamped to ``max_stage - 1e-8``
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

STAGE_EPS = 1e-8
MAX_STAGE_DEFAULT = 17


def parse_stage_interval(stage_interval: str) -> List[int]:
    """Parse the yml ``stage_interval`` comma string into iteration boundaries."""
    return [int(s) for s in str(stage_interval).split(",")]


def stage_at(iteration: int, stage_interval: Sequence[int], max_stage: int) -> float:
    """Piecewise-linear stage schedule (reference ``updater.py:252-256``).

    Each entry ``stage_interval[i]`` is the iteration at which stage ``i``
    ends; within ``(stage_interval[i-1], stage_interval[i]]`` the stage
    interpolates linearly from ``i-1`` to ``i``. Past the last boundary the
    stage saturates at ``max_stage - 1e-8``. Note the reference's Python
    negative-index wraparound for ``i == 0`` is preserved (never hit with the
    shipped leading-zero configs since ``iteration + 1 <= 0`` is false).
    """
    for i, interval in enumerate(stage_interval):
        if iteration + 1 <= interval:
            prev = stage_interval[i - 1]
            return (i - 1) + (iteration - prev) / (interval - prev)
    return max_stage - STAGE_EPS


def legacy_stage_at(iteration: int, stage_interval: int, max_stage: int) -> float:
    """Linear schedule of the legacy RGB updater (``updater.py:96-98``)."""
    return min(iteration / stage_interval, max_stage - STAGE_EPS)


def decompose_stage(stage: float, max_stage: int = MAX_STAGE_DEFAULT) -> Tuple[int, float]:
    """Clamp and split a float stage into (floor, fade-in alpha).

    Mirrors the clamp+floor+frac performed at the top of every generator /
    discriminator forward in the reference (``net.py:245-247`` etc.).
    """
    stage = min(stage, max_stage - STAGE_EPS)
    floor = math.floor(stage)
    return int(floor), stage - floor
