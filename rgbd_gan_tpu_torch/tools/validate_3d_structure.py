"""Scripted 3D-structure check of a trained port RGBD run.

    python -m rgbd_gan_tpu_torch.tools.validate_3d_structure --config_path configs/X.yml \
        [--snapshot latest] [--ema] [--cols 6] [--rows 7] [--out strip.png] [--device cuda|cpu]

The twin of the root ``tools/validate_3d_structure.py`` for the port: it
loads a snapshot (the port's or the JAX package's files), renders a
fixed-latent camera sweep (the preview's parameterisation: yaw in
``linspace(-test_y_rotate, +test_y_rotate, rows)``, the same latent down
each column) on the card, or on the CPU with ``--device cpu``, and scores
whether the generated depth carries 3D structure rather than a flat plane:

1. ``depth_relative_spread``: the per-frame spread of inverse depth over
   its mean (about 0 for a flat depth head).
2. ``silhouette_depth_corr``: the per-frame Pearson correlation between the
   RGB foreground (luminance above the background) and inverse depth
   (positive when objects sit closer than the background).
3. ``fg_radial_depth_corr``: inside the foreground, the correlation between
   the distance from its centroid and depth (positive for a convex object
   seen head-on).
4. ``sweep_depth_change``: per-pixel depth variance across the sweep over
   the within-frame spread; a diagnostic only (a rotationally symmetric
   object's correct depth does not change with yaw).

It prints one JSON line with the metrics and pass/fail against the
thresholds, and writes a strip png (an RGB row over an inverse-depth row)
with ``--out``. The metrics are the root tool's numpy code, copied.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..core.config import load_config
from ..core.stage import decompose_stage
from ..geometry.camera import camera_matrices
from ..train import checkpoint as ckpt
from ..train.trainer import Trainer


def render_sweep(trainer: Trainer, config, rows: int, cols: int, ema: bool, seed: int = 0) -> np.ndarray:
    """(rows, cols, H, W, 4) RGBD sweep: the same z down each column, yaw
    down the rows."""
    rng = np.random.RandomState(seed)
    z = trainer.make_hidden_np(rng, cols)
    z = np.tile(z[:, None], (1, rows) + (1,) * (z.ndim - 1)).reshape(rows * cols, *z.shape[1:])
    theta = np.zeros((rows * cols, 6), dtype="float32")
    theta[:, 1] = np.tile(np.linspace(-config.test_y_rotate, config.test_y_rotate, rows), cols)
    theta9 = np.concatenate([np.cos(theta[:, :3]), np.sin(theta[:, :3]), theta[:, 3:]], axis=1).astype("float32")
    mats = camera_matrices(torch.from_numpy(theta)).numpy()
    floor, alpha = decompose_stage(trainer.stage(), trainer.max_stage)
    gen_apply = trainer.gen_apply_eval_ema if ema else trainer.gen_apply_eval
    outs = []
    for i in range(0, z.shape[0], 16):
        sl = slice(i, i + 16)
        outs.append(gen_apply(z[sl], floor, alpha, theta9[sl], mats[sl]).float().cpu().numpy())
    x = np.concatenate(outs, axis=0)  # (rows*cols, H, W, 4) NHWC, cols-major z
    h, w = x.shape[1:3]
    return x.reshape(cols, rows, h, w, 4).transpose(1, 0, 2, 3, 4)


def structure_metrics(sweep: np.ndarray) -> dict:
    """sweep: (rows, cols, H, W, 4) with RGB in [-1,1] and depth last."""
    rgb = sweep[..., :3]
    inv_depth = 1.0 / np.clip(sweep[..., 3], 1e-3, 1e3)

    lum = rgb.mean(axis=-1)  # [-1, 1]
    # background = darkest quartile per frame; foreground = clearly brighter
    lo = np.quantile(lum, 0.25, axis=(2, 3), keepdims=True)
    hi = np.quantile(lum, 0.75, axis=(2, 3), keepdims=True)
    fg = lum > (lo + 0.5 * (hi - lo))

    spread = inv_depth.std(axis=(2, 3)) / (np.abs(inv_depth.mean(axis=(2, 3))) + 1e-6)

    # per-frame Pearson corr(fg, inv_depth)
    f = fg.astype(np.float64)
    d = inv_depth.astype(np.float64)
    fm = f.mean(axis=(2, 3), keepdims=True)
    dm = d.mean(axis=(2, 3), keepdims=True)
    cov = ((f - fm) * (d - dm)).mean(axis=(2, 3))
    corr = cov / (f.std(axis=(2, 3)) * d.std(axis=(2, 3)) + 1e-9)

    # radial depth profile inside the foreground: for a convex object the
    # rim must sit farther than the center. Per-frame corr(radius, depth)
    # over fg pixels, weighted by fg size.
    h, w = lum.shape[2:]
    yy, xx = np.mgrid[0:h, 0:w]
    radial_corrs = []
    depth = np.clip(sweep[..., 3], 1e-3, 1e3)
    for i in range(sweep.shape[0]):
        for j in range(sweep.shape[1]):
            m = fg[i, j]
            if m.sum() < 16:
                continue
            cy, cx = yy[m].mean(), xx[m].mean()
            r = np.sqrt((yy[m] - cy) ** 2 + (xx[m] - cx) ** 2)
            d = depth[i, j][m]
            if r.std() < 1e-6 or d.std() < 1e-9:
                continue
            radial_corrs.append(np.corrcoef(r, d)[0, 1])
    radial = float(np.mean(radial_corrs)) if radial_corrs else 0.0

    # diagnostic: per-pixel depth variance across yaw over within-frame
    # spread (LOW for a pose-consistent rotationally-symmetric object)
    var_over_yaw = inv_depth.std(axis=0).mean()
    within = inv_depth.std(axis=(2, 3)).mean() + 1e-9

    return {
        "depth_relative_spread": float(spread.mean()),
        "silhouette_depth_corr": float(corr.mean()),
        "fg_radial_depth_corr": radial,
        "sweep_depth_change": float(var_over_yaw / within),
    }


def save_strip(sweep: np.ndarray, path: str) -> None:
    """RGB row over inverse-depth row for the middle latent, yaw across."""
    from PIL import Image

    rows, cols, h, w, _ = sweep.shape
    col = sweep[:, cols // 2]  # (rows, H, W, 4) one latent across yaw
    rgb = np.clip(col[..., :3] * 127.5 + 127.5, 0, 255).astype(np.uint8)
    dep = np.clip(1.0 / np.clip(col[..., 3], 1e-3, 1e3) * 128, 0, 255).astype(np.uint8)
    dep = np.tile(dep[..., None], (1, 1, 1, 3))
    strip = np.concatenate([np.concatenate(list(rgb), axis=1), np.concatenate(list(dep), axis=1)], axis=0)
    Image.fromarray(strip).save(path)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--config_path", required=True)
    p.add_argument("--snapshot", default="latest")
    p.add_argument("--ema", action="store_true")
    p.add_argument("--rows", type=int, default=7)
    p.add_argument("--cols", type=int, default=6)
    p.add_argument("--out", default=None, help="sweep strip png path")
    p.add_argument("--min_spread", type=float, default=0.05)
    p.add_argument("--min_corr", type=float, default=0.2)
    p.add_argument("--min_radial", type=float, default=0.1)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="render on the card (default) or, when asked, on the CPU")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("validate_3d_structure: no CUDA device; pass --device cpu to render on the CPU")

    config = load_config(args.config_path)
    if config.rgb:
        raise SystemExit("validate_3d_structure: an rgb: True run renders no depth")
    trainer = Trainer(config, device=args.device)
    rng_state = ckpt.load_snapshot(trainer.out, trainer.state, args.snapshot, config)
    if rng_state is not None:
        trainer.rng.set_state(rng_state)
    print(f"loaded iteration {trainer.state.iteration}", file=sys.stderr)

    sweep = render_sweep(trainer, config, args.rows, args.cols, args.ema)
    m = structure_metrics(sweep)
    m["iteration"] = trainer.state.iteration
    m["pass"] = bool(
        m["depth_relative_spread"] > args.min_spread
        and m["silhouette_depth_corr"] > args.min_corr
        and m["fg_radial_depth_corr"] > args.min_radial
    )
    if args.out:
        save_strip(sweep, args.out)
        m["strip"] = args.out
    print(json.dumps(m))
    return m


if __name__ == "__main__":
    main()
