"""Model FLOPs of one training step, counted from the shapes.

PyTorch's table of FLOP formulas (``torch.utils.flop_counter``) counts
every convolution and matrix product that the reference step dispatches on
the ``meta`` device, where no data exists and only shapes flow (those of
the architecture's own draws): each forward, each input- and
weight-gradient product, R1's double backward and any second generator
forward of the D phase. Elementwise work and the gathers are not counted.
The count is taken at the global batch (data parallelism runs the same
products, split over the ranks) and kept in the configuration's file as
``flops_per_step``: ``with_r1``, a step that pays R1, and, where the
architecture's step can skip R1 (its ``LAZY_R1``: ``r1_interval`` > 1),
``without_r1``. A cell's count a step is their mean over its R1 cycle
(``Cell.flops_per_step``), so a traffic mix that sets ``r1_interval``
needs no count of its own:

    python3 -m benchmark.flops stylegan_ffhq [deepvoxels_car ...]

prints each configuration's counts; the test of this module holds the
counter to a hand count of one convolution's forward, backward and double
backward.
"""

from __future__ import annotations

import sys
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .cell import make_cell
from .reference import step as ref

META = torch.device("meta")


class FlopCount(TorchDispatchMode):
    """Sums the FLOPs of every dispatched operator that the table knows
    (FlopCounterMode's count without its module hooks, which refuse
    ``autograd.grad`` on leaves)."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.total += int(count(*args, **kwargs, out_val=out))
        return out


def step_flops(cell, with_r1: bool = True) -> int:
    """FLOPs of one reference step of ``cell`` at its global batch (one
    shard), with R1 or, where the architecture's step can skip it, without."""
    arch = cell.architecture
    if not with_r1 and not arch.LAZY_R1:
        raise ValueError(f"{cell.config_name}: the step pays R1 on every step")
    cfg = dict(cell.config, r1_interval=1 if with_r1 else 2)
    with torch.device(META):
        models = ref.build(cfg, None, META)
    opts = ref.optimizers(cfg, models)
    b, px = cell.batch, cell.image_px
    shard = dict(arch.draws(cfg, None, b, META), x=torch.empty(b, px, px, 3, dtype=torch.uint8, device=META))
    with FlopCount() as counter:
        arch.step(cfg, models, opts, [shard], 0 if with_r1 else 1)
    return counter.total


def config_counts(name: str) -> Dict[str, int]:
    """The ``flops_per_step`` entry of the configuration ``name`` (on the f32
    traffic: no other key of a mix changes a count but ``r1_interval``)."""
    cell = make_cell(name, name, "f32", 1)
    out = {"with_r1": step_flops(cell)}
    if cell.architecture.LAZY_R1:
        out["without_r1"] = step_flops(cell, with_r1=False)
    return out


if __name__ == "__main__":
    for name in sys.argv[1:]:
        print(name, config_counts(name))
