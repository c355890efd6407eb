"""FID and Inception Score across a run's snapshots, through the port's
evaluation CLI.

    python -m rgbd_gan_tpu_torch.tools.fid_trend [--config configs/structured_spheres_stylegan.yml] \
        [--tags 4000,12000,24000] [--n 10000] [--batchsize 100] [--ema] [--out fid_trend.json] [--device cuda|cpu]

The twin of the root ``tools/fid_trend.py``: it runs
``rgbd_gan_tpu_torch.cli.evaluate --fid --inception --preview`` once per
snapshot tag (on the card unless ``--device cpu``), reads the FID and IS it
wrote under ``[out]/stats/``, and records them with the wall time per tag in
one JSON file, rewritten after each tag. With the evaluation CLI's random
Inception-v3 the values are not the literature's; their trend across
snapshots is what the tool shows.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..cli import evaluate as eval_cli
from ..core.config import load_config


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="configs/structured_spheres_stylegan.yml")
    ap.add_argument("--tags", default="4000,12000,24000")
    ap.add_argument("--n", type=int, default=10000)
    ap.add_argument("--batchsize", type=int, default=100)
    ap.add_argument("--ema", action="store_true")
    ap.add_argument("--out", default="fid_trend.json")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    run_out = load_config(args.config).out or "out"
    rows = []
    for tag in [t.strip() for t in args.tags.split(",") if t.strip()]:
        argv = ["--config_path", args.config, "--snapshot", tag, "--fid", "--inception", "--preview",
                "--n_images", str(args.n), "--batchsize", str(args.batchsize), "--device", args.device]
        if args.ema:
            argv.append("--ema")
        t0 = time.perf_counter()
        eval_cli.main(argv)
        wall = time.perf_counter() - t0
        fid = float(np.loadtxt(os.path.join(run_out, "stats", f"fid_{int(tag):0>8}.txt")))
        is_mean, is_std = np.loadtxt(os.path.join(run_out, "stats", f"inception_score_{int(tag):0>8}.txt"))
        rows.append(dict(tag=int(tag), fid=fid, is_mean=float(is_mean), is_std=float(is_std), wall_s=round(wall, 1)))
        print(f"[fid_trend] tag={tag} FID={fid:.3f} IS={is_mean:.3f} wall={wall:.0f}s", flush=True)
        with open(args.out, "w") as f:
            json.dump(dict(config=args.config, n=args.n, ema=args.ema, device=args.device, rows=rows), f, indent=1)
    print(f"[fid_trend] wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
