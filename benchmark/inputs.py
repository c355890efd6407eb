"""Everything a run feeds the program, made from ``--seed``.

- the image set: ``count`` uint8 images of the cell's size, uniform noise
  (the dataset's content changes no shape and no amount of work)
- the weights: drawn by the reference's own constructors on the card from
  a ``torch.Generator`` seeded from the seed, and handed to the program and
  the reference alike
- the latents and poses of the checked steps, one set a rank and a step,
  drawn on the card by the architecture's reference module, one stream a rank

Every seed gives the same sizes and the same amount of work; only the
values differ. Seeds of any size are folded into the streams' ranges.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .cell import Cell

CHECKED_STEPS = 3
_STREAMS = {"images": 0, "weights": 1, "draws": 2, "trainer": 3}


def stream_seed(seed: int, stream: str, rank: int = 0) -> int:
    """A 63-bit seed for one stream of one rank, from any whole ``seed``."""
    ss = np.random.SeedSequence([int(seed) % 2**64, _STREAMS[stream], rank])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def images(cell: Cell, seed: int) -> np.ndarray:
    """(count, 3, px, px) uint8, the layout of the trainer's image cache."""
    rng = np.random.default_rng(stream_seed(seed, "images"))
    n, px = int(cell.meta["images"]["count"]), cell.image_px
    return rng.integers(0, 256, size=(n, 3, px, px), dtype=np.uint8)


def weights_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, "weights"))


def trainer_seed(seed: int) -> int:
    """The seed handed to the program's trainer (its shuffle and its own
    draws inside the window), below 2**31."""
    return stream_seed(seed, "trainer") % 2**31


def draws(cell: Cell, seed: int, rank: int, device) -> List[Dict[str, torch.Tensor]]:
    """The injected draws of the checked steps for ``rank``: one dict a step."""
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, "draws", rank))
    return [cell.architecture.draws(cell.config, g, cell.local_batch, device) for _ in range(CHECKED_STEPS)]
