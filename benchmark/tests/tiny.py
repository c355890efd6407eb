"""Tiny cells for the CPU tests: the configurations' own keys at widths and
batches that a test can run (StyleGAN ch 16, batch 4 at 32 px, stage 6;
DeepVoxels ch 8, batch 2), with the limits of the full-size cell."""

from __future__ import annotations

import dataclasses

from benchmark.cell import make_cell


def tiny(workload: str):
    config_name, traffic = workload.split(".", 1)
    cell = make_cell(workload, config_name, traffic, 4 if traffic.endswith(".dp4") else 1)
    config, meta = dict(cell.config), dict(cell.meta)
    if cell.deepvoxels:
        config.update(ch=8, batchsize=2 * cell.ranks)
    else:
        config.update(ch=16, batchsize=4 * cell.ranks, max_stage=7, stage_interval="0,0,0,0,0,0,0,0")
        meta["images"] = dict(meta["images"], px=32)
    meta["images"] = dict(meta["images"], count=8 * cell.ranks)
    return dataclasses.replace(cell, config=config, meta=meta)
