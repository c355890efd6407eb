"""Checkpoints in the JAX package's artifact layout and npz keys.

``Generator_{tag}.npz``, ``Discriminator_{tag}.npz``,
``SmoothedGenerator_{tag}.npz`` and ``snapshot_iter_{tag}.npz`` hold flat
``/``-joined keys with JAX layouts (``train/checkpoint.py:31-118`` of the
JAX package), so either package reads the other's model files. A generator
with BatchNorm statistics (DeepVoxels with the softmax occlusion net) is
written as ``params/...`` plus ``batch_stats/...`` (the softmax occlusion
net's and RenderNet's statistics); a DeepVoxels run also writes its mapping
network to ``Map_{tag}.npz``. The discriminator's file holds ``params/...``
and, when it is spectrally normalised, its power-iteration vectors under
``sn/.../u``. The trainer
snapshot stores the optimizer moments under the optax state paths
(``opt_gen/1/0/mu/...``), the iteration, and the state of the port's
``torch.Generator`` under ``rng_state`` (the JAX package stores a PRNG key);
a run of several ranks keeps rank 0's stream there and every rank's under
``rank_rng_state/{rank}``, keys that the JAX package's non-strict loader
ignores. A DCGAN state has no mapping optimizer: like the JAX package's ``None``
leaf, it writes and reads no ``opt_map/...`` key.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..bridge import (
    jax_to_torch,
    load_jax_params,
    load_jax_variables,
    module_to_jax,
    params_to_jax,
    strip_prefix,
    torch_to_jax,
    variables_to_jax,
)
from .optim import ClippedAdam
from .state import TrainState

RANK_RNG_STATE = "rank_rng_state"  # every rank's stream, under /{rank}


def save_tree(path: str, flat: Dict[str, np.ndarray]) -> None:
    np.savez(path, **flat)


def load_tree(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def model_names(config) -> List[str]:
    names = ["Generator", "Discriminator"]
    if config.keep_smoothed_gen:
        names.append("SmoothedGenerator")
    return names


def _opt_to_flat(opt: Optional[ClippedAdam], prefix: str) -> Dict[str, np.ndarray]:
    if opt is None:
        return {}
    sd = opt.state_dict()
    flat = {f"{prefix}/1/0/count": np.asarray(sd["count"], dtype=np.int32)}
    for moment in ("mu", "nu"):
        for k, v in torch_to_jax(sd[moment]).items():
            flat[f"{prefix}/1/0/{moment}/{k}"] = v
    return flat


def _opt_from_flat(opt: Optional[ClippedAdam], flat: Dict[str, np.ndarray], prefix: str) -> None:
    if opt is None:
        return
    state = {"count": int(flat[f"{prefix}/1/0/count"])}
    for moment in ("mu", "nu"):
        state[moment] = jax_to_torch(strip_prefix(flat, f"{prefix}/1/0/{moment}/"))
    opt.load_state_dict(state)


def save_snapshot(
    out_dir: str, state: TrainState, rng_state: torch.Tensor, tag: str, config,
    rank_rng_states: Sequence[torch.Tensor] = (),
) -> None:
    """Write the per-model and trainer artifacts for ``tag`` (an iteration or
    'latest'); ``rank_rng_states`` are every rank's streams, in rank order,
    in a run of several ranks."""
    os.makedirs(out_dir, exist_ok=True)
    save_tree(os.path.join(out_dir, f"Generator_{tag}.npz"), module_to_jax(state.gen))
    if config.generator_architecture == "deepvoxels":
        # extra mapping artifact for layout parity (train_rgbd.py:374-377)
        save_tree(os.path.join(out_dir, f"Map_{tag}.npz"), params_to_jax(state.gen.mapping))
    save_tree(os.path.join(out_dir, f"Discriminator_{tag}.npz"), variables_to_jax(state.dis, "sn"))
    if config.keep_smoothed_gen and state.ema_gen is not None:
        save_tree(
            os.path.join(out_dir, f"SmoothedGenerator_{tag}.npz"),
            params_to_jax(state.ema_gen),
        )
    trainer = {
        **_opt_to_flat(state.opt_map, "opt_map"),
        **_opt_to_flat(state.opt_gen, "opt_gen"),
        **_opt_to_flat(state.opt_dis, "opt_dis"),
        "iteration": np.asarray(state.iteration, dtype=np.int32),
        "rng_state": rng_state.cpu().numpy(),
        **{f"{RANK_RNG_STATE}/{r}": t.cpu().numpy() for r, t in enumerate(rank_rng_states)},
    }
    save_tree(os.path.join(out_dir, f"snapshot_iter_{tag}.npz"), trainer)


def load_snapshot(out_dir: str, state: TrainState, tag: str, config, rank: int = 0) -> Optional[torch.Tensor]:
    """Load the artifacts for ``tag`` into ``state`` in place; returns the
    saved ``torch.Generator`` state of ``rank`` (its own stream when the
    snapshot holds one, else rank 0's ``rng_state``), or None when the
    snapshot came from the JAX package or holds no stream for a rank above
    0."""
    load_jax_variables(state.gen, load_tree(os.path.join(out_dir, f"Generator_{tag}.npz")))
    load_jax_variables(state.dis, load_tree(os.path.join(out_dir, f"Discriminator_{tag}.npz")), "sn")
    ema_path = os.path.join(out_dir, f"SmoothedGenerator_{tag}.npz")
    if config.keep_smoothed_gen and state.ema_gen is not None and os.path.exists(ema_path):
        load_jax_params(state.ema_gen, load_tree(ema_path), params_only=True)
    trainer = load_tree(os.path.join(out_dir, f"snapshot_iter_{tag}.npz"))
    _opt_from_flat(state.opt_map, trainer, "opt_map")
    _opt_from_flat(state.opt_gen, trainer, "opt_gen")
    _opt_from_flat(state.opt_dis, trainer, "opt_dis")
    state.iteration = int(trainer["iteration"])
    keys = [f"{RANK_RNG_STATE}/{rank}"] + (["rng_state"] if rank == 0 else [])
    return next((torch.from_numpy(trainer[k]) for k in keys if k in trainer), None)


def scan_auto_resume(auto_resume_dir: str, names: List[str]) -> Optional[str]:
    """Newest tag for which every model file and the trainer snapshot exist
    (``train_rgbd.py:417-446``)."""
    if not os.path.isdir(auto_resume_dir):
        return None
    candidates = []
    for fname in os.listdir(auto_resume_dir):
        m = re.fullmatch(r"Generator_(\d+)\.npz", fname)
        if not m:
            continue
        tag = m.group(1)
        if all(
            os.path.exists(os.path.join(auto_resume_dir, f"{n}_{tag}.npz")) for n in names
        ) and os.path.exists(os.path.join(auto_resume_dir, f"snapshot_iter_{tag}.npz")):
            candidates.append(tag)
    return max(candidates, key=int) if candidates else None
