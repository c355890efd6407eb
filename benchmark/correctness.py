"""What decides ``correct``: the program's first three training steps held to
the reference's.

Set-up drives the program's training state through three steps of the
window's own call and feed, each with latents and poses injected from the
seed, and keeps what they produced: the fed batches, each step's reported
losses, the first moments of every Adam leaf after step 1 (with
``beta1 = 0`` they are the clipped gradient itself) and every parameter
after step 3. The same state then runs the window. Once the window has
closed and the program's state is freed, the reference rebuilds the
weights from the seed and follows the same three steps on the fed batches
and the same draws. The numbers a cell's limits file can name:

- ``loss1_gap`` (``loss1_gen_gap``, ``loss1_gp_gap``): the largest
  ``|program - reference| / max(|reference|, LOSS_FLOOR)`` over the four
  reported losses of step 1 (the G phase's two; R1's ``dis/loss_gp``);
  ``loss_gap`` the same over the three steps
- ``grad_gap`` (``grad_gap_gen``: G's leaves): over the Adam leaves, the
  largest gap between the norms of the program's and the reference's
  step-1 gradient, over the larger of the reference leaf's norm and the
  median leaf's
- ``grad_gap_kept``: the same over the leaves the nought rule keeps
- ``change_gap`` (``change_gap_median``: the median leaf's): the same for
  each parameter's change over the three steps, over the leaves the
  nought rule keeps

The nought rule leaves out the leaves whose step-1 gradient in the
reference computed in float32 is below a thousandth of the median leaf's:
their true gradient is nought (a bias or a constant that an instance norm
cancels), so what they get is round-off, and under Adam they move by it
alone. In a bf16 cell that round-off is large enough to pass the rule at
bf16, so the rule reads a float32 step of the reference, from the same
weights, batch and draws. And ``feed_bad_rows``: rows of a fed batch that
are not rows of the benchmark's image set, or repeat within the batch
(limit 0).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

import numpy as np
import torch

from . import inputs
from .cell import Cell
from .reference import step as ref
from .reference.layers import rounded_operands

GEN_LOSS_KEYS = ("gen/loss_adv", "gen/loss_rotate")
LOSS_KEYS = GEN_LOSS_KEYS + ("dis/loss_adv", "dis/loss_gp")
LOSS_FLOOR = 1e-3
NOUGHT_SHARE = 1e-3  # of the median leaf's gradient norm


def _norm(t: torch.Tensor) -> float:
    return math.sqrt(float(torch.sum(t.double() ** 2)))


class Capture:
    """What the program's checked steps produced, kept on the host."""

    def __init__(self) -> None:
        self.batches: List[torch.Tensor] = []  # uint8 (b, S, S, 3) as fed
        self.losses: List[Dict[str, float]] = []
        self.grad_norms: Dict[str, float] = {}  # "opt/leaf" -> norm of the step-1 gradient
        self.params: Dict[str, torch.Tensor] = {}  # "gen.x" / "dis.x" after step 3
        self.rule_grad_norms: Dict[str, float] = {}  # the reference's step-1 gradient in float32 (the nought rule)
        self.prefixes: Dict[str, str] = {}  # the reference's: optimizer -> the prefix of its leaves' parameter names


def reference_weights(cell: Cell, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The benchmark's initial weights (``gen`` and ``dis`` state dicts)."""
    models = ref.build(cell.config, inputs.weights_generator(seed, device), device)
    return {k: m.state_dict() for k, m in models.items()}


def grad_norms_of(opts: Dict[str, object], beta1: float) -> Dict[str, float]:
    """Norms of the step-1 gradients from each optimizer's first moments;
    ``opts`` maps a label to an object with ``state_dict()["mu"]`` or
    ``first_moments()``."""
    out = {}
    for label, opt in opts.items():
        mu = opt.first_moments() if hasattr(opt, "first_moments") else opt.state_dict()["mu"]
        for name, m in mu.items():
            out[f"{label}/{name}"] = _norm(m) / (1.0 - beta1)
    return out


def params_of(models: Dict[str, torch.nn.Module]) -> Dict[str, torch.Tensor]:
    return {f"{k}.{n}": p.detach().to("cpu", copy=True) for k, m in models.items() for n, p in m.named_parameters()}


def run_reference(cell: Cell, seed: int, batches: List[List[torch.Tensor]], device, *,
                  rounding: Optional[str] = None, fault: Optional[str] = None) -> Capture:
    """The reference's three steps from the seed's weights. ``batches[r][i]``
    is rank r's fed batch of step i. ``rounding`` computes every product in
    a lower precision (the control); ``fault`` plants one: ``"half_batch"``
    (half of each shard's pairs left out, the mean over the rest) or
    ``"no_exchange"`` (each rank's own gradients, not their mean: rank 0's
    shard alone). The unplanted reference also keeps the float32 step-1
    gradient that the nought rule reads."""
    cap = _reference_steps(cell, cell.config, seed, batches, device, inputs.CHECKED_STEPS, rounding, fault)
    if rounding is None and fault is None:
        if cell.precision == "f32":
            cap.rule_grad_norms = cap.grad_norms
        else:
            f32 = dict(cell.config, mixed16=False)
            cap.rule_grad_norms = _reference_steps(cell, f32, seed, batches, device, 1, None, None).grad_norms
    return cap


def _reference_steps(cell: Cell, cfg: dict, seed: int, batches, device, steps: int, rounding, fault) -> Capture:
    models = ref.build(cfg, inputs.weights_generator(seed, device), device)
    opts = ref.optimizers(cfg, models)
    draws = [inputs.draws(cell, seed, r, device) for r in range(cell.ranks)]
    init = params_of(models)
    cap = Capture()
    cap.prefixes = {k: opt.prefix for k, opt in opts.items()}
    step = ref.architecture(cfg).step
    tf32 = rounding == "tf32" and torch.device(device).type == "cuda"
    for i in range(steps):
        shards = []
        for r in range(cell.ranks):
            shard = dict(draws[r][i], x=batches[r][i].to(device))
            if fault == "half_batch":
                shard = _half(shard)
            shards.append(shard)
        if fault == "no_exchange":
            shards = shards[:1]
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            with rounded_operands(None if tf32 else rounding):
                losses = step(cfg, models, opts, shards, i)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        cap.losses.append({k: float(v) for k, v in losses.items()})
        if i == 0:
            cap.grad_norms = grad_norms_of(opts, cfg["adam_beta1"])
    cap.params = {k: v - init[k] for k, v in params_of(models).items()}
    del models, opts
    return cap


def _half(shard: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The first half of each half of the batch: the pairs stay pairs."""
    b = shard["x"].shape[0]
    q = b // 4
    idx = torch.cat([torch.arange(q), torch.arange(b // 2, b // 2 + q)])
    return {k: v[idx.to(v.device)] if v.shape[0] == b else v for k, v in shard.items()}


def feed_bad_rows(batches: List[torch.Tensor], images: np.ndarray) -> int:
    """Fed rows that are no row of the image set, or repeat within their batch."""
    known = {bytes(row) for row in np.ascontiguousarray(images.transpose(0, 2, 3, 1))}
    bad = 0
    for batch in batches:
        rows = [bytes(np.ascontiguousarray(r)) for r in batch.numpy()]
        bad += sum(r not in known for r in rows) + (len(rows) - len(set(rows)))
    return bad


def _gap(program: Dict[str, float], reference: Dict[str, float], keys, pick=max) -> float:
    """The worst leaf's gap (``pick=statistics.median``: the median leaf's),
    each over the larger of its own norm and the median leaf's."""
    keys = list(keys)
    if not keys:
        return 0.0
    median = statistics.median(reference[k] for k in keys)
    return pick(abs(program[k] - reference[k]) / max(reference[k], median, 1e-30) for k in keys)


def nought_rule(reference: Capture) -> List[str]:
    """The Adam leaves (``opt/leaf``) that the nought rule keeps."""
    rule = reference.rule_grad_norms or reference.grad_norms
    median = statistics.median(rule.values())
    return [k for k, g in rule.items() if g >= NOUGHT_SHARE * median]


def change_norms(program: Capture, reference: Capture):
    """Norms of each kept parameter's change over the three steps, the
    program's and the reference's (the leaf ``opt/name`` is the parameter
    of the reference optimizer's prefix and ``name``)."""
    kept_leaves = {reference.prefixes[k.split("/", 1)[0]] + k.split("/", 1)[1] for k in nought_rule(reference)}
    kept = [k for k in reference.params if k in kept_leaves]
    c_ref = {k: _norm(reference.params[k]) for k in kept}
    c_prog = {k: _norm(program.params[k]) for k in kept}
    return c_prog, c_ref


def readings(program: Capture, reference: Capture, bad_rows: int = 0) -> Dict[str, float]:
    """The numbers compared, and how many parameters the nought rule left
    out of the change."""
    def loss_gap(steps, keys):
        return max(abs(p[k] - r[k]) / max(abs(r[k]), LOSS_FLOOR) for p, r in steps for k in keys)

    first = [(program.losses[0], reference.losses[0])]
    g_prog, g_ref = program.grad_norms, reference.grad_norms
    c_prog, c_ref = change_norms(program, reference)
    gen_leaves, kept = [k for k in g_ref if not k.startswith("dis/")], nought_rule(reference)
    return {"loss_gap": loss_gap(zip(program.losses, reference.losses), LOSS_KEYS),
            "loss1_gap": loss_gap(first, LOSS_KEYS), "loss1_gen_gap": loss_gap(first, GEN_LOSS_KEYS),
            "loss1_gp_gap": loss_gap(first, ("dis/loss_gp",)), "grad_gap": _gap(g_prog, g_ref, g_ref),
            "grad_gap_gen": _gap(g_prog, g_ref, gen_leaves), "grad_gap_kept": _gap(g_prog, g_ref, kept),
            "change_gap": _gap(c_prog, c_ref, c_ref),
            "change_gap_median": _gap(c_prog, c_ref, c_ref, statistics.median), "feed_bad_rows": float(bad_rows),
            "leaves_left_out": float(len(reference.params) - len(c_ref))}


def worst_leaves(program: Dict[str, float], reference: Dict[str, float], n: int = 4) -> List[list]:
    """The leaves whose norms differ most, each over the larger of its own
    norm and the median leaf's: ``[name, gap, reference norm]`` (for a look
    at a cause; not compared)."""
    median = statistics.median(reference.values())
    gaps = sorted(((abs(program[k] - reference[k]) / max(reference[k], median, 1e-30), k) for k in reference),
                  reverse=True)
    return [[k, g, reference[k]] for g, k in gaps[:n]]


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number the cell's limits name within its limit; a cell with no
    limits is not correct."""
    return bool(limits) and all(values[k] <= limit for k, limit in limits.items())


def compared_lines(values: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    return [f"{k} {values[k]!r} limit {limit!r}" for k, limit in limits.items()]
