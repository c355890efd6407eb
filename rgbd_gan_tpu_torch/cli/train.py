"""CLI entry point: ``python -m rgbd_gan_tpu_torch.cli.train --config_path configs/X.yml``.

Same interface as :mod:`rgbd_gan_tpu.cli.train` (reference
``train_rgbd.py:261-265``), plus ``--device``. The run is on the card
(``--device cuda``, the default; ``--gpu`` picks its index) unless
``--device cpu`` asks for the CPU: without a card and without
``--device cpu`` it exits with an error and does not fall back.

Data parallelism (``use_mpi: True``) runs under ``torchrun``, one process a
rank, NCCL on the cards (rank r on ``cuda:LOCAL_RANK``) or gloo on the CPU::

    python -m torch.distributed.run --nproc_per_node 2 -m rgbd_gan_tpu_torch.cli.train \
        --config_path configs/X.yml [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Callable, Dict, Optional

import torch

from ..core.config import Config, load_config
from ..parallel.mesh import maybe_initialize_distributed
from ..train.trainer import REPORT_KEYS, Trainer


def run(
    config: Config,
    iterations: Optional[int] = None,
    on_row: Optional[Callable[[Dict[str, Any]], None]] = None,
    device: str = "cuda",
) -> Trainer:
    """Everything ``main`` does after loading the config; ``on_row`` also
    receives each report row. ``device`` is ``"cuda"`` (card ``config.gpu``,
    or ``LOCAL_RANK`` under ``torchrun``) or ``"cpu"``."""
    if device == "cuda":
        device = f"cuda:{os.environ.get('LOCAL_RANK', config.gpu or 0)}"
    print(config.stage_interval)
    trainer = Trainer(config, device=device)
    if trainer.resume():
        print(f"Resumed at iteration {trainer.state.iteration}")

    header_printed = False

    def log_cb(row):
        nonlocal header_printed
        if not header_printed:
            print("  ".join(REPORT_KEYS))
            header_printed = True
        print("  ".join(
            f"{row.get(k, float('nan')):.6g}" if isinstance(row.get(k), float) else str(row.get(k, ""))
            for k in REPORT_KEYS
        ))
        if on_row is not None:
            on_row(row)

    trainer.run(iterations=iterations, log_cb=log_cb)
    return trainer


def main(argv=None) -> Trainer:
    parser = argparse.ArgumentParser()
    parser.add_argument("--gpu", "-g", type=int, default=0, help="CUDA device index")
    parser.add_argument("--config_path", type=str, default="configs/ffhq_stylegan_occlusion.yml")
    parser.add_argument("--iterations", type=int, default=None, help="override config.iteration")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="train on the card (default) or, when asked, on the CPU")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("rgbd_gan_tpu_torch.cli.train: no CUDA device; pass --device cpu to train on the CPU")
    # one process a rank under torchrun (a no-op without it): before the Trainer
    maybe_initialize_distributed("nccl" if args.device == "cuda" else "gloo")
    config = load_config(args.config_path)
    config.gpu = args.gpu
    trainer = run(config, iterations=args.iterations, device=args.device)
    if torch.distributed.is_initialized():
        # every rank waits until rank 0 has written its snapshot: a rank that
        # tears its group down while another still runs can abort
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
