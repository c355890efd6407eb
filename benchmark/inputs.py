"""Everything a run feeds the program, made from ``--seed``.

- the image set: ``count`` uint8 images of the cell's size, uniform noise
  (the dataset's content changes no shape and no amount of work)
- the weights: drawn by the reference's own constructors on the card from
  a ``torch.Generator`` seeded from the seed, and handed to the program and
  the reference alike
- the latents and poses of the checked steps, one set a rank and a step,
  drawn on the card: the StyleGAN latent (2ch, normalised by
  ``sqrt(sum/ch)``, in pairs), the DeepVoxels latents (plain N(0, 1): two
  paired ones for the G phase, two unpaired for the D phase) and paired
  6-DoF poses from the configuration's ranges

Every seed gives the same sizes and the same amount of work; only the
values differ. Seeds of any size are folded into the streams' ranges.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .cell import Cell
from .reference.geometry import sample_poses

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


def _stylegan_latents(g: torch.Generator, n: int, ch: int, device) -> torch.Tensor:
    z = torch.randn(n, ch * 2, generator=g, device=device)
    return z / torch.sqrt(torch.sum(z * z, dim=1, keepdim=True) / ch + 1e-8)


def draws(cell: Cell, seed: int, rank: int, device) -> List[Dict[str, torch.Tensor]]:
    """The injected draws of the checked steps for ``rank``: one dict a step."""
    c = cell.config
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, "draws", rank))
    b, ch, half = cell.local_batch, int(c["ch"]), cell.local_batch // 2
    ranges = [c["x_rotate"], c["y_rotate"], c["z_rotate"], c["x_translate"], c["y_translate"], c["z_translate"]]
    out = []
    for _ in range(CHECKED_STEPS):
        if cell.deepvoxels:
            d = {"z": torch.randn(half, ch, generator=g, device=device).repeat(2, 1),
                 "z2": torch.randn(half, ch, generator=g, device=device).repeat(2, 1)}
        else:
            d = {"z": _stylegan_latents(g, half, ch, device).repeat(2, 1)}
        d["thetas6"] = sample_poses(g, b, ranges, ranges[:3], bool(c.get("uniform_distribution")), device)
        if cell.deepvoxels:
            d["z_d"] = torch.randn(b, ch, generator=g, device=device)
            d["z2_d"] = torch.randn(b, ch, generator=g, device=device)
        out.append(d)
    return out
