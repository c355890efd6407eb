"""Tiny cells for the CPU tests: the configurations' own keys at the widths,
batches and image sizes that a test can run (each architecture's ``TINY``,
in its reference module), with the limits of the full-size cell."""

from __future__ import annotations

import dataclasses

from benchmark.cell import make_cell


def tiny(workload: str):
    config_name, traffic = workload.split(".", 1)
    cell = make_cell(workload, config_name, traffic, 4 if traffic.endswith(".dp4") else 1)
    config, meta, small = dict(cell.config), dict(cell.meta), cell.architecture.TINY
    config.update(small["keys"], batchsize=small["rank_batch"] * cell.ranks)
    meta["images"] = dict(meta["images"], px=small.get("px", cell.image_px), count=8 * cell.ranks)
    return dataclasses.replace(cell, config=config, meta=meta)
