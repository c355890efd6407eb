"""Data parallelism over ``torch.distributed`` — port of
:mod:`rgbd_gan_tpu.parallel.mesh`.

The JAX package runs the per-device step under ``shard_map`` over a 1-D
mesh whose one axis is :data:`DATA_AXIS`: each device draws its own latents
and poses, ``pmean``s the gradients before the optimizer, ``pmean``s the
metrics (the NaN flag is a ``pmax``) and, on DeepVoxels, ``pmean``s the
BatchNorm running statistics after the step. The reference does the same
with ChainerMN (``train_rgbd.py:103-161``).

Here each rank is one process on one device, as ``torchrun`` starts them,
and the data axis spans the whole world: the default process group. The
steps take their gradients with ``torch.autograd.grad`` over explicit
parameter lists (R1 and the feature penalty are double backwards), so the
averaging is done by hand, as plain functions, where the JAX step calls
``_pmean``; ``DistributedDataParallel``'s reducer hooks serve neither. Each
collective flattens its tensors into one buffer per dtype and runs once.
The step's all-reduces (:func:`all_mean`, :func:`mean_metrics`) run in a
``parallel.all_reduce`` span and count the bytes handed to
``dist.all_reduce`` as ``parallel.bytes`` (:mod:`..utils.trace`).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..nn.layers import BatchNorm
from ..utils import trace

DATA_AXIS = "data"


def maybe_initialize_distributed(backend: str = "nccl") -> None:
    """Initialise the default process group from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) with ``backend``: ``"nccl"`` on the card, ``"gloo"`` on
    the CPU. With NCCL the rank's current device becomes ``cuda:LOCAL_RANK``
    (which raises if there is no such card). With ``WORLD_SIZE`` unset or 1
    it does nothing, as the JAX one does on a single host; nor when a group
    is already up."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(backend, init_method="env://")


def world_size() -> int:
    """The number of ranks on the data axis (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's index on the data axis (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_master() -> bool:
    """Master-process predicate for I/O (``train_rgbd.py:121``)."""
    return rank() == 0


def make_mesh(device_type: str):
    """The 1-D data-parallel ``DeviceMesh`` over every rank, its one
    dimension named :data:`DATA_AXIS`."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (world_size(),), mesh_dim_names=(DATA_AXIS,))


def rank_seed(seed: int, rank_index: int, world: int) -> int:
    """The seed of a rank's stream of draws: ``seed`` itself in a run of one
    rank, else one drawn from ``(seed, rank)`` by numpy's ``SeedSequence``,
    so that no two ranks draw the same latents and poses (the JAX step folds
    the axis index into its key)."""
    if world <= 1:
        return seed
    return int(np.random.SeedSequence([seed, rank_index]).generate_state(1, np.uint64)[0])


def shard_batch(batch, rank_index: Optional[int] = None, world: Optional[int] = None, batch_axis: int = 0):
    """This rank's shard of a global batch: the ``rank``-th of ``world``
    contiguous slices along ``batch_axis``, as the JAX mesh lays a batch out
    over its devices."""
    rank_index = rank() if rank_index is None else rank_index
    world = world_size() if world is None else world
    n = batch.shape[batch_axis]
    if n % world:
        raise ValueError(f"a batch of {n} does not split over {world} ranks")
    index = [slice(None)] * batch_axis + [slice(rank_index * n // world, (rank_index + 1) * n // world)]
    return batch[tuple(index)]


def _flat_collective(tensors: Sequence[torch.Tensor], collective) -> List[torch.Tensor]:
    """``collective(buffer)`` run on one flat buffer per dtype holding
    ``tensors``; returns the results as views of those buffers, in order."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        collective(flat)
        for i, piece in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = piece.view_as(tensors[i])
    return out


def all_mean(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor's mean over the ranks (``lax.pmean``: the sum divided by
    the world size), by one ``all_reduce`` per dtype."""
    n = world_size()

    def mean(flat):
        trace.count("parallel.bytes", flat.numel() * flat.element_size())
        dist.all_reduce(flat)
        flat.div_(n)

    with trace.span("parallel.all_reduce"):
        return _flat_collective(tensors, mean)


def mean_grads(grads: Sequence[Optional[torch.Tensor]], params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The gradients averaged over the ranks, before the clip and Adam (the
    JAX step's ``_pmean`` of its gradient tree). A ``None`` gradient, a
    parameter the loss does not reach, counts as zero, as ``ClippedAdam``
    counts it, so every rank sends a buffer of the same layout."""
    return all_mean([torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)])


def mean_metrics(metrics: Dict[str, torch.Tensor], nan: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The 0-dim metrics averaged over the ranks in one stacked
    ``all_reduce``, and ``nan`` (this rank's NaN flag) true on every rank if
    it is true on any (the JAX step's ``_pany``, a ``pmax``)."""
    stacked = torch.stack([v.to(torch.float32) for v in metrics.values()])
    flag = nan.to(torch.float32).reshape(1)
    with trace.span("parallel.all_reduce"):
        trace.count("parallel.bytes", flag.numel() * flag.element_size())
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    out = dict(zip(metrics, all_mean([stacked])[0].unbind()))
    out["nan"] = flag[0] > 0
    return out


@torch.no_grad()
def mean_batch_stats(module: nn.Module) -> None:
    """Replace every BatchNorm's running ``mean`` and ``var`` in ``module``
    by their mean over the ranks (the JAX DeepVoxels step ``pmean``s its
    ``batch_stats`` after the step). This is not a synchronised BatchNorm:
    the forwards normalise with each rank's own batch statistics."""
    stats = [s for m in module.modules() if isinstance(m, BatchNorm) for s in (m.mean, m.var)]
    if stats:
        for s, mean in zip(stats, all_mean(stats)):
            s.copy_(mean)


@torch.no_grad()
def replicate(modules: Iterable[Optional[nn.Module]]) -> None:
    """Broadcast rank 0's parameters and buffers (BatchNorm statistics,
    spectral-norm vectors) of each module into every other rank's, in
    place: the twin of placing the JAX state replicated on the mesh."""
    tensors = [t for m in modules if m is not None for t in m.state_dict().values()]
    for t, mine in zip(tensors, _flat_collective(tensors, lambda flat: dist.broadcast(flat, 0))):
        t.copy_(mine)


def all_gather_bytes(blob: torch.Tensor, device: torch.device) -> List[torch.Tensor]:
    """Every rank's ``blob`` (a uint8 tensor of the same size on each rank,
    such as a ``torch.Generator``'s state), in rank order, on the CPU;
    ``device`` is where the backend exchanges it (a card for NCCL)."""
    mine = blob.to(device)
    every = [torch.empty_like(mine) for _ in range(world_size())]
    dist.all_gather(every, mine)
    return [t.cpu() for t in every]
