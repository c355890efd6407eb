"""Where one full-width train step spends its time on the card.

``python -m rgbd_gan_tpu_torch.tools.profile_step configs/deepvoxels_shapenet_car.yml``
(or ``configs/ffhq_stylegan_occlusion.yml`` or ``configs/dcgan_shapenet_car.yml``;
``--mixed16`` for the bf16 trunk) builds the port's trainer from the yml
on synthetic images, with the 3D-consistency loss on from the first
iteration and, for StyleGAN and DCGAN, the schedule pinned at the yml's last stage;
runs 3 warm-up steps, times ``--steps`` synchronised steps on the host
clock, then traces 2 steps with ``torch.profiler`` and prints one
JSON object: the card's name and power limit, the median wall time per step,
the CUDA kernels' time per step (the sum of their durations, and the time
in which at least one ran: the union of their intervals), the device's idle
share (1 - that union / median wall time of the untraced steps: tracing
slows the host, not the kernels), peak memory, and the kernels that take
most of the time, by name, with the longest single call of each.
It needs a CUDA device and fails without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from ..core.config import load_config
from ..core.stage import decompose_stage
from ..data.dataset import synthetic_dataset
from ..train.trainer import Trainer

WARMUP, TRACED = 3, 2


def _union_us(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _steps(trainer: Trainer, n: int):
    """Run n iterations the way ``Trainer.run`` does; yields after each, synchronised."""
    for _ in range(n):
        floor, alpha = decompose_stage(trainer.stage(), trainer.max_stage)
        spec = trainer._spec_for(trainer.state.iteration, floor)
        x = torch.from_numpy(trainer.iterator.next()).to(trainer.device)
        _, metrics = trainer._step(spec)(trainer.state, x, alpha, trainer.rng)
        if bool(metrics["nan"]):
            raise FloatingPointError(f"NaN loss at iteration {trainer.state.iteration}")
        torch.cuda.synchronize()
        yield


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("config_path")
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--top", type=int, default=15)
    parser.add_argument("--lift_mode", default=None, help="override the yml's lift_mode (deepvoxels)")
    parser.add_argument("--mixed16", action="store_true", help="set the yml's mixed16: the bf16 trunk")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device; this tool measures only on a GPU", file=sys.stderr)
        return 1

    config = load_config(args.config_path)
    config.start_rotation = -1
    if args.lift_mode:
        config.lift_mode = args.lift_mode
    if args.mixed16:
        config.mixed16 = True
    if config.generator_architecture == "deepvoxels":
        image_px = 64
    else:  # pin the schedule at the yml's last stage
        last = int(config.max_stage) - 1
        config.stage_interval = ",".join(["0"] * (last + 1))
        image_px = 4 * 2 ** (last // 2)
    trainer = Trainer(config, dataset=synthetic_dataset(64, image_px), seed=0, device="cuda")
    for _ in _steps(trainer, WARMUP):
        pass
    torch.cuda.reset_peak_memory_stats()
    wall, t0 = [], time.perf_counter()
    for _ in _steps(trainer, args.steps):
        wall.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()

    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in _steps(trainer, TRACED):
            pass
    traced_ms = 1e3 * (time.perf_counter() - t0) / TRACED
    by_name, longest, spans = {}, {}, []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.device_time / 1e3 / TRACED, n + 1)
            longest[e.name] = max(longest.get(e.name, 0.0), e.device_time / 1e3)
            spans.append((e.time_range.start, e.time_range.end))
    kernel_ms = sum(ms for ms, _ in by_name.values())
    busy_ms = _union_us(spans) / 1e3 / TRACED
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[: args.top]
    ours = {k: v for k, v in by_name.items() if "::lift_" in k or "::bilinear_" in k}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({
        "card": smi, "config": args.config_path, "architecture": config.generator_architecture,
        "batch": trainer.batch_size, "image_px": image_px, "mixed16": bool(config.mixed16),
        "r1_interval": int(config.r1_interval or 1),
        "lift_mode": getattr(trainer.state.gen, "lift_mode", None),
        "wall_ms_per_step_median": statistics.median(wall), "wall_ms_per_step": [round(t, 3) for t in wall],
        "traced_wall_ms_per_step": traced_ms, "kernel_ms_per_step": kernel_ms, "kernel_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / statistics.median(wall) if busy_ms else None,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "top_kernels_ms_per_step": [{"name": k[:120], "ms": round(ms, 4), "calls_per_step": n / TRACED,
                                     "longest_call_ms": round(longest[k], 4)} for k, (ms, n) in top],
        "hand_written_kernels_ms_per_step": {k[:120]: {"ms": round(ms, 4), "calls_per_step": n / TRACED}
                                             for k, (ms, n) in ours.items()},
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
