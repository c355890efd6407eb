"""Evaluation CLI: FID, Inception Score and the camera-sweep preview of a run
(of an RGB run, ``rgb: True``, the preview without a sweep and the scores of
images rendered without a pose).

    python -m rgbd_gan_tpu_torch.cli.evaluate --config_path configs/X.yml \
        [--snapshot latest] [--preview] [--fid [--stat_file stats.npz]] \
        [--inception] [--ema] [--n_images 5000] [--batchsize 100] \
        [--inception_weights w.npz] [--device cuda|cpu]

Same interface as :mod:`rgbd_gan_tpu.cli.evaluate`, plus ``--device``: the
card by default; without a card it exits with an error unless
``--device cpu`` is given. It loads the snapshot ``--snapshot`` of the
config's ``out`` directory, written by the port or by the JAX package.
FID needs the real data's statistics: ``--stat_file``, built on first use
from the configured dataset. Without converted Inception weights
(``--inception_weights``, the npz that
``python -m rgbd_gan_tpu_torch.tools.convert_inception`` writes) the scores
come from a randomly initialised network: consistent between runs, not
comparable with the literature.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional

import torch

from ..core.config import Config, load_config
from ..core.stage import decompose_stage
from ..eval import fid as fid_mod
from ..eval.inception import load_params
from ..eval.preview import sample_generate_light
from ..geometry.camera import theta_to_9dof
from ..train import checkpoint as ckpt
from ..train.trainer import Trainer


def run(
    config: Config,
    snapshot: str = "latest",
    preview: bool = False,
    fid: bool = False,
    inception: bool = False,
    ema: bool = False,
    stat_file: Optional[str] = None,
    inception_weights: Optional[str] = None,
    n_images: int = 5000,
    batchsize: int = 100,
    device: str = "cuda",
) -> Dict[str, Any]:
    """Everything ``main`` does after parsing; returns what it printed:
    ``preview`` (the image's path), ``fid`` and ``inception_score``
    ((mean, std)) where asked for."""
    if device == "cuda":
        device = f"cuda:{config.gpu or 0}"
    trainer = Trainer(config, device=device)
    try:
        rng_state = ckpt.load_snapshot(trainer.out, trainer.state, snapshot, config)
        if rng_state is not None:
            trainer.rng.set_state(rng_state)
        print(f"Loaded snapshot '{snapshot}' (iteration {trainer.state.iteration})")
    except FileNotFoundError:
        print("No snapshot found: evaluating the freshly initialised model")
    if ema and trainer.state.ema_gen is None:
        raise SystemExit("--ema requires a snapshot trained with keep_smoothed_gen")

    results: Dict[str, Any] = {}
    stage = trainer.stage()
    floor, alpha = decompose_stage(stage, trainer.max_stage)
    gen_apply = trainer.gen_apply_eval_ema if ema else trainer.gen_apply_eval
    if preview:
        results["preview"] = sample_generate_light(gen_apply, trainer.make_hidden_np, trainer.out, config)(
            trainer.state.iteration, stage)
        print(f"preview -> {results['preview']}")

    if fid or inception:
        model = load_params(inception_weights, trainer.device)
        draws = torch.Generator(device=trainer.device).manual_seed(0)
        if trainer.arch == "deepvoxels":
            gen = fid_mod.deepvoxels_image_sampler(gen_apply, trainer.make_hidden, trainer.prior, floor, alpha, draws)
        else:
            # an RGB generator takes no pose (cli/evaluate.py:91 of the JAX package)
            theta9_sampler = None if config.rgb else (
                lambda g, n: theta_to_9dof(trainer.prior.sample(g, n, trainer.device)))
            gen = fid_mod.rgbd_image_sampler(gen_apply, trainer.make_hidden, floor, alpha, theta9_sampler, draws)
        if fid:
            stat_file = stat_file or os.path.join(trainer.out, "real_stats.npz")
            if not os.path.exists(stat_file):
                print(f"building real-data stats -> {stat_file}")
                reals = trainer.iterator.images[:n_images].astype("float32")
                fid_mod.compute_dataset_stat(model, reals, stat_file, batch_size=batchsize)
            evaluate = fid_mod.calc_FID(gen, model, stat_file, dst=trainer.out, batchsize=batchsize, n_ims=n_images)
            results["fid"] = evaluate(trainer.state.iteration)
            print(f"FID@{n_images}: {results['fid']:.3f}")
        if inception:
            evaluate = fid_mod.calc_inception(gen, model, dst=trainer.out, batchsize=batchsize, n_ims=n_images)
            results["inception_score"] = evaluate(trainer.state.iteration)
            print("Inception Score: {:.3f} +- {:.3f}".format(*results["inception_score"]))
    return results


def main(argv=None) -> Dict[str, Any]:
    p = argparse.ArgumentParser()
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--snapshot", type=str, default="latest")
    p.add_argument("--fid", action="store_true")
    p.add_argument("--inception", action="store_true")
    p.add_argument("--preview", action="store_true")
    p.add_argument("--stat_file", type=str, default=None)
    p.add_argument("--inception_weights", type=str, default=None)
    p.add_argument("--n_images", type=int, default=5000)
    p.add_argument("--batchsize", type=int, default=100)
    p.add_argument(
        "--ema", action="store_true",
        help="evaluate the smoothed (EMA) generator, the model the reference "
        "previews when keep_smoothed_gen (train_rgbd.py:391-396)",
    )
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="evaluate on the card (default) or, when asked, on the CPU")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("rgbd_gan_tpu_torch.cli.evaluate: no CUDA device; pass --device cpu to evaluate on the CPU")
    return run(
        load_config(args.config_path), snapshot=args.snapshot, preview=args.preview, fid=args.fid,
        inception=args.inception, ema=args.ema, stat_file=args.stat_file, inception_weights=args.inception_weights,
        n_images=args.n_images, batchsize=args.batchsize, device=args.device,
    )


if __name__ == "__main__":
    main()
