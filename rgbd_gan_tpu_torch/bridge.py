"""Weight bridge between the JAX package's flat parameter keys and PyTorch.

The JAX package flattens a flax tree to ``/``-joined keys
(``train/checkpoint.py:_flatten``): ``gen/block1/c0/kernel`` with conv
kernels HWIO and linear kernels (in, out). The port names its modules like
the flax tree, so the same parameter is ``gen.block1.c0.weight`` with the
PyTorch layouts (out, in, kh, kw) and (out, in); a 3D conv kernel DHWIO is
(out, in, kd, kh, kw). Every other leaf (biases, ``const``, noise gains,
AdaIN vectors, BatchNorm ``scale``/``bias``/``mean``/``var``) keeps its name
and layout.

A flax model with BatchNorm keeps two collections: ``params/...`` and
``batch_stats/.../{mean,var}``. The port keeps the statistics as buffers of
the same modules, so :func:`module_to_jax` and :func:`load_jax_variables`
split and merge the two by asking the module which leaves are buffers.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _kernel_to_weight(a: np.ndarray) -> np.ndarray:
    if a.ndim == 5:  # DHWIO -> OIDHW
        return a.transpose(4, 3, 0, 1, 2)
    if a.ndim == 4:  # HWIO -> OIHW
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 2:  # (in, out) -> (out, in)
        return a.T
    raise ValueError(f"unexpected kernel rank {a.ndim}")


def _weight_to_kernel(a: np.ndarray) -> np.ndarray:
    if a.ndim == 5:  # OIDHW -> DHWIO
        return a.transpose(2, 3, 4, 1, 0)
    if a.ndim == 4:  # OIHW -> HWIO
        return a.transpose(2, 3, 1, 0)
    if a.ndim == 2:
        return a.T
    raise ValueError(f"unexpected weight rank {a.ndim}")


def jax_to_torch(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat JAX keys (numpy arrays) -> a PyTorch ``state_dict``."""
    out = {}
    for key, arr in flat.items():
        parts = key.split("/")
        a = np.asarray(arr)
        if parts[-1] == "kernel":
            parts[-1] = "weight"
            a = _kernel_to_weight(a)
        out[".".join(parts)] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def torch_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A PyTorch ``state_dict`` -> flat JAX keys (numpy arrays)."""
    out = {}
    for key, t in state_dict.items():
        parts = key.split(".")
        a = t.detach().cpu().numpy()
        if parts[-1] == "weight":
            parts[-1] = "kernel"
            a = _weight_to_kernel(a)
        out["/".join(parts)] = np.ascontiguousarray(a)
    return out


def strip_prefix(flat: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """Keep the keys under ``prefix`` (e.g. ``params/``), without it."""
    return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}


@torch.no_grad()
def load_jax_params(
    module: nn.Module, flat: Mapping[str, np.ndarray], prefix: str = "", params_only: bool = False
) -> None:
    """Copy flat JAX parameters (under ``prefix``) into ``module``, strictly:
    every leaf of the module must be present, and nothing else. With
    ``params_only`` the module's buffers (BatchNorm statistics) are left as
    they are and must be absent from ``flat``."""
    sd = jax_to_torch(strip_prefix(flat, prefix) if prefix else flat)
    if params_only:
        sd = {**{k: v for k, v in module.state_dict().items() if k not in dict(module.named_parameters())}, **sd}
    module.load_state_dict(sd, strict=True)


def has_batch_stats(module: nn.Module) -> bool:
    """Whether the module keeps BatchNorm statistics (persistent buffers)."""
    return len(module.state_dict()) > sum(1 for _ in module.parameters())


def params_to_jax(module: nn.Module) -> Dict[str, np.ndarray]:
    """The module's parameters, without its buffers, as flat JAX keys."""
    return torch_to_jax(dict(module.named_parameters()))


def module_to_jax(module: nn.Module) -> Dict[str, np.ndarray]:
    """The module's parameters as flat JAX keys; when it keeps BatchNorm
    statistics, parameters under ``params/`` and statistics under
    ``batch_stats/``, as the JAX package writes such a generator."""
    flat = torch_to_jax(module.state_dict())
    if not has_batch_stats(module):
        return flat
    params = {name.replace(".", "/") for name, _ in module.named_parameters()}
    params |= {k[: -len("weight")] + "kernel" for k in params if k.endswith("/weight")}
    return {("params/" if k in params else "batch_stats/") + k: v for k, v in flat.items()}


def load_jax_variables(module: nn.Module, flat: Mapping[str, np.ndarray]) -> None:
    """Inverse of :func:`module_to_jax`, strict like :func:`load_jax_params`."""
    if has_batch_stats(module):
        flat = {**strip_prefix(flat, "params/"), **strip_prefix(flat, "batch_stats/")}
    load_jax_params(module, flat)
