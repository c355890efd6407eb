"""The port's bf16 trunk (``mixed16``) and lazy R1 (``r1_interval``) against
the JAX package's, on the CPU.

Weights come from the port's init, perturbed by a seeded numpy generator so
that no parameter sits at its (often zero or one) initial value, and reach
the JAX modules through the bridge; inputs are numpy draws from a seed. The
JAX side runs ``compute_dtype=jnp.bfloat16`` on the same weights, jitted, as
its trainer runs it.

Distance: the largest absolute difference over the largest magnitude of the
JAX float32 output, per output tensor, the worst of the tensors a case
returns. Each case holds the port-vs-JAX bf16 distance to a tolerance stated
below (at most twice the distance measured on the CPU) and below the JAX
package's own bf16-vs-float32 distance on the same weights and inputs (the
largest difference and the mean one both). A bf16 trunk rounds every
activation to 8 bits of mantissa, so two correct implementations still
differ where a sum's order flips one rounding: the port's convolutions
(oneDNN) and XLA's sum in other orders, and XLA fuses elementwise chains
with float32 excess precision.

The step: ch 16, batch 4, stage 6, rotate + occlusion on, R1 every 2 steps,
EMA on; one JAX step jitted once and run for two iterations (R1 at weight
``lambda_gp * 2``, then none) against the port's two steps on the JAX
step's own draws. Adam's first step (beta1 = 0) moves each element by alpha
times the sign of its gradient, and bf16 rounding flips the sign of the
gradients that all but cancel; so the updated parameters are held by the
share of elements that ended more than one step (alpha) apart
(``MAX_SHARE_APART``), which must also be smaller than the share between
the JAX bf16 steps and the port's float32 steps on the same draws; the
losses are held to ``STEP_ATOL`` (the second step's see the updated
weights).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_gan_tpu.core import Config as JaxConfig
from rgbd_gan_tpu.geometry.camera import camera_matrices as jax_camera_matrices
from rgbd_gan_tpu.geometry.prior import CameraParamPrior as JaxPrior
from rgbd_gan_tpu.models import deepvoxels as jdv
from rgbd_gan_tpu.models.discriminator import Discriminator as JaxDiscriminator
from rgbd_gan_tpu.models.generators import StyleGANGenerator as JaxStyleGANGenerator
from rgbd_gan_tpu.models.generators import stylegan_make_hidden as jax_make_hidden
from rgbd_gan_tpu.train import checkpoint as jax_ckpt
from rgbd_gan_tpu.train.optim import make_optimizer as jax_make_optimizer
from rgbd_gan_tpu.train.optim import make_stylegan_gen_optimizer as jax_make_gen_optimizer
from rgbd_gan_tpu.train.state import TrainState as JaxTrainState
from rgbd_gan_tpu.train.steps import StepSpec as JaxStepSpec
from rgbd_gan_tpu.train.steps import make_rgbd_train_step as jax_make_step
from rgbd_gan_tpu_torch.bridge import load_jax_params, load_jax_variables, module_to_jax, torch_to_jax
from rgbd_gan_tpu_torch.cli import train as cli
from rgbd_gan_tpu_torch.core.config import Config
from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
from rgbd_gan_tpu_torch.geometry.camera import camera_matrices
from rgbd_gan_tpu_torch.models import deepvoxels as tdv
from rgbd_gan_tpu_torch.models.discriminator import Discriminator
from rgbd_gan_tpu_torch.models.generators import StyleGANGenerator
from rgbd_gan_tpu_torch.train import checkpoint as ckpt
from rgbd_gan_tpu_torch.train.trainer import Trainer

# the suite runs several worker processes at once: leave them the other cores
torch.set_num_threads(2)

BF16 = torch.bfloat16
CH, ALPHA = 16, 0.3
# port-vs-JAX bf16 distance per case, measured on the CPU: G stage 6 1.94e-3,
# stage 7 2.01e-3; D stage 6 3.13e-3, stage 7 2.34e-3; DeepVoxels 1.62e-2
TOL = {("gen", 6): 3.5e-3, ("gen", 7): 3.5e-3, ("dis", 6): 6e-3, ("dis", 7): 4e-3, "deepvoxels": 3e-2}
# the two steps, measured on the CPU: losses within 3.45e-3 (dis/loss_adv of
# the second step; the first step's within 1.04e-3); elements more than one
# Adam step (alpha) apart: 3.8 % of the generator's, 0.95 % of the
# discriminator's, 3.9 % of the EMA's (the port's float32 steps on the same
# draws: 9.5 %, 2.2 %, 9.9 %)
STEP_ATOL = 5e-3
MAX_SHARE_APART = {"gen": 0.07, "dis": 0.015, "ema": 0.07}
STEP_CFG = dict(
    generator_architecture="stylegan", ch=CH, batchsize=4, res_dis=True, sn=False,
    adam_alpha_g=0.001, adam_alpha_d=0.003, adam_beta1=0.0, adam_beta2=0.999,
    lambda_gp=1.0, lambda_depth=10, depth_min=1.0, keep_smoothed_gen=True, smoothing=0.999,
    stage_interval="0,0,0,0,0,0,0", max_stage=7, start_rotation=-1, start_occlusion_aware=0,
    x_rotate=0.3054, y_rotate=1.0472, z_rotate=0, x_translate=0, y_translate=0, z_translate=0,
    iteration=2, display_interval=1, snapshot_interval=2, mixed16=True, r1_interval=2,
)
STAGE = 6
METRICS = ["gen/loss_adv", "gen/loss_rotate", "dis/loss_adv", "dis/loss_gp"]


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)
    return tree


def _perturbed(flat, seed):
    rng = np.random.RandomState(seed)
    return {k: (v + 0.05 * rng.randn(*v.shape)).astype(v.dtype) for k, v in flat.items()}


def _distances(got, want16, want32):
    """(port vs JAX bf16, JAX bf16 vs float32): (largest, mean) absolute
    difference over the largest magnitude of the float32 output."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want16, want32 = np.asarray(want16), np.asarray(want32)
    assert got.shape == want16.shape and got.dtype == want16.dtype == np.float32
    scale = float(np.abs(want32).max())
    d = lambda a, b: (float(np.abs(a - b).max()) / scale, float(np.abs(a - b).mean()) / scale)
    return d(got, want16), d(want16, want32)


def _hold(case, pairs):
    """Every output of ``case``: within its tolerance, and closer to JAX bf16
    than JAX bf16 is to JAX float32."""
    worst = max(port[0] for port, _ in pairs)
    for port, own in pairs:
        assert port[0] < own[0] and port[1] < own[1], (case, port, own)
    assert worst <= TOL[case], (case, worst)


@pytest.fixture(scope="module")
def stylegan_models():
    g = torch.Generator().manual_seed(0)
    gen = StyleGANGenerator(CH, rgbd=True, compute_dtype=BF16, generator=g)
    dis = Discriminator(ch=CH, res=True, compute_dtype=BF16, generator=g)
    gflat = _perturbed(torch_to_jax(gen.state_dict()), 0)
    dflat = _perturbed(torch_to_jax(dis.state_dict()), 1)
    load_jax_params(gen, gflat)
    load_jax_params(dis, dflat)
    gen.requires_grad_(False)
    dis.requires_grad_(False)
    return gen, {"params": _unflatten(gflat)}, dis, {"params": _unflatten(dflat)}


@pytest.mark.parametrize("stage", [6, 7])
def test_generator_bf16_matches_jax(stylegan_models, stage):
    gen, gvars, _, _ = stylegan_models
    rng = np.random.RandomState(stage)
    z, theta = rng.randn(2, 2 * CH).astype("f"), (0.3 * rng.randn(2, 9)).astype("f")
    outs = {}
    for name, dtype in (("bf16", jnp.bfloat16), ("f32", None)):
        jgen = JaxStyleGANGenerator(CH, rgbd=True, compute_dtype=dtype)
        fwd = jax.jit(lambda v, z, a, t: jgen.apply(v, z, stage, a, t, return_feature=True))
        outs[name] = fwd(gvars, jnp.asarray(z), jnp.float32(ALPHA), jnp.asarray(theta))
    got = gen(torch.tensor(z), stage, ALPHA, torch.tensor(theta), return_feature=True)
    assert got[0].shape == (2, 16 * 2 ** (stage - 5), 16 * 2 ** (stage - 5), 4)
    _hold(("gen", stage), [_distances(got[i], outs["bf16"][i], outs["f32"][i]) for i in range(2)])


@pytest.mark.parametrize("stage", [6, 7])
def test_discriminator_bf16_matches_jax(stylegan_models, stage):
    """At the odd stage the JAX trainer's float32 ``alpha`` promotes the
    fade-in blend, and every block after it runs in float32: the port's too."""
    _, _, dis, dvars = stylegan_models
    size = 32 if stage == 6 else 64
    x = np.random.RandomState(10 + stage).uniform(-1, 1, (4, size, size, 3)).astype("f")
    outs = {}
    for name, dtype in (("bf16", jnp.bfloat16), ("f32", None)):
        jdis = JaxDiscriminator(ch=CH, res=True, compute_dtype=dtype)
        fwd = jax.jit(lambda v, x, a: jdis.apply(v, x, stage, a, return_hidden=True))
        outs[name] = fwd(dvars, jnp.asarray(x), jnp.float32(ALPHA))
    seen = {}

    def hook(i):
        return lambda module, args: seen.update({i: args[0].dtype})

    hooks = [getattr(dis, f"block{i}").register_forward_pre_hook(hook(i)) for i in (1, 3, 4)]
    try:
        got = dis(torch.tensor(x), stage, ALPHA, return_hidden=True)
    finally:
        for h in hooks:
            h.remove()
    # at stage 7 block 4 is the fade-in block (bf16); blocks 3 .. 0 run after the blend
    assert seen == ({1: BF16, 3: BF16} if stage == 6 else {1: torch.float32, 3: torch.float32, 4: BF16})
    _hold(("dis", stage), [_distances(got[i], outs["bf16"][i], outs["f32"][i]) for i in range(2)])


def test_deepvoxels_generator_bf16_matches_jax():
    """ch 16, batch 1, the accumulative occlusion net, the dense lift."""
    gen = tdv.DeepVoxelsGenerator(CH, occlusion_type="accumulative", compute_dtype=BF16,
                                  generator=torch.Generator().manual_seed(0))
    gen.requires_grad_(False)
    flat = _perturbed(module_to_jax(gen), 9)  # no BatchNorm: parameters only
    load_jax_variables(gen, flat)
    variables = {"params": _unflatten(flat)}
    rng = np.random.RandomState(13)
    z, z2 = rng.randn(1, CH).astype("f"), rng.randn(1, CH).astype("f")
    theta = np.array([[0.2, 2.2, 0, 0, 0, 0]], "f")
    outs = {}
    for name, dtype in (("bf16", jnp.bfloat16), ("f32", None)):
        jgen = jdv.DeepVoxelsGenerator(CH, occlusion_type="accumulative", lift_mode="gather", compute_dtype=dtype)
        fwd = jax.jit(lambda v, z, t, z2: jgen.apply(v, z, jax_camera_matrices(t), z2))
        outs[name] = np.asarray(fwd(variables, jnp.asarray(z), jnp.asarray(theta), jnp.asarray(z2)))
    got = gen(torch.tensor(z), camera_matrices(torch.tensor(theta)), torch.tensor(z2)).numpy()
    _hold("deepvoxels", [_distances(got[..., c], outs["bf16"][..., c], outs["f32"][..., c])
                         for c in (slice(0, 3), slice(3, 4))])


# ---------------------------------------------------------------------------
# the bf16 step with lazy R1, two iterations
# ---------------------------------------------------------------------------


def _jax_step_and_state(gflat, dflat):
    cfg = JaxConfig(STEP_CFG)
    gen = JaxStyleGANGenerator(CH, rgbd=True, compute_dtype=jnp.bfloat16)
    dis = JaxDiscriminator(ch=CH, res=True, compute_dtype=jnp.bfloat16)
    params_gen, params_dis = _unflatten(gflat), _unflatten(dflat)
    opt_map = jax_make_optimizer(cfg.adam_alpha_g / 100, 0.0, 0.999)
    opt_gen = jax_make_gen_optimizer(cfg.adam_alpha_g, 0.0, 0.999, rgbd=True)
    opt_dis = jax_make_optimizer(cfg.adam_alpha_d, 0.0, 0.999)
    state = JaxTrainState(
        params_gen=params_gen, params_dis=params_dis,
        opt_map=opt_map.init(params_gen["mapping"]), opt_gen=opt_gen.init(params_gen["gen"]),
        opt_dis=opt_dis.init(params_dis),
        ema_gen=jax.tree_util.tree_map(jnp.copy, params_gen), sn_state=None, iteration=jnp.int32(0),
    )
    spec = JaxStepSpec(
        architecture="stylegan", stage_floor=STAGE, batch_size=4, use_rotate=True,
        occlusion_aware=True, keep_smoothed_gen=True, lambda_gp=1.0, lambda_depth=10.0,
        depth_min=1.0, gather_mode="xla", max_stage=7, r1_interval=2,
    )
    prior = JaxPrior(cfg)
    step = jax_make_step(gen, dis, lambda k, n: jax_make_hidden(k, n, CH), prior, opt_map, opt_gen, opt_dis, spec)
    return jax.jit(step), state, prior


def _record_grad_dtypes(opt, seen):
    step = opt.step

    def recording(grads):
        seen.update(g.dtype for g in grads if g is not None)
        step(grads)

    opt.step = recording


def _trainer(gflat, dflat, data, **options):
    trainer = Trainer(Config(dict(STEP_CFG, **options)), dataset=data, seed=0, device="cpu")
    state = trainer.state
    for module, flat in ((state.gen, gflat), (state.ema_gen, gflat), (state.dis, dflat)):
        load_jax_params(module, flat)
    return trainer


@pytest.fixture(scope="module")
def two_steps():
    data = synthetic_dataset(4, 32, seed=5)
    init = Trainer(Config(STEP_CFG), dataset=data, seed=0, device="cpu").state
    gflat = _perturbed(torch_to_jax(init.gen.state_dict()), 2)
    dflat = _perturbed(torch_to_jax(init.dis.state_dict()), 3)
    trainer, f32 = _trainer(gflat, dflat, data), _trainer(gflat, dflat, data, mixed16=False)
    state = trainer.state
    assert state.gen.gen.compute_dtype == state.dis.compute_dtype == BF16
    jstep, jstate, jprior = _jax_step_and_state(gflat, dflat)
    grad_dtypes = set()
    for opt in (state.opt_map, state.opt_gen, state.opt_dis):
        _record_grad_dtypes(opt, grad_dtypes)

    x = data.transpose(0, 2, 3, 1)  # uint8 NHWC
    metrics, jmetrics = [], []
    for it in range(2):
        # the JAX step's own draws (steps.py:145-149), injected into the port
        key = jax.random.PRNGKey(10 + it)
        kz, ktheta, _ = jax.random.split(key, 3)
        z = jnp.concatenate([jax_make_hidden(kz, 2, CH)] * 2, axis=0)
        thetas6 = jprior.sample(ktheta, 4)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.float32(0.0), key)
        spec = trainer._spec_for(it, STAGE)
        assert spec.r1_interval == 2
        draws = dict(z=torch.tensor(np.asarray(z)), thetas6=torch.tensor(np.asarray(thetas6)))
        _, m = trainer._step(spec)(state, torch.from_numpy(x.copy()), 0.0, **draws)
        f32._step(spec)(f32.state, torch.from_numpy(x.copy()), 0.0, **draws)
        metrics.append({k: float(v) for k, v in m.items()})
        jmetrics.append({k: float(v) for k, v in jm.items()})
    return trainer, f32, jstate, metrics, jmetrics, grad_dtypes


@pytest.mark.parametrize("iteration", [0, 1])
def test_two_lazy_steps_losses_match_jax(two_steps, iteration):
    """R1 at weight ``lambda_gp * 2`` on the first step, none on the second."""
    _, _, _, metrics, jmetrics, _ = two_steps
    got, want = metrics[iteration], jmetrics[iteration]
    for k in METRICS:
        np.testing.assert_allclose(got[k], want[k], atol=STEP_ATOL, err_msg=k)
    if iteration == 0:
        assert got["dis/loss_gp"] > 0
    else:
        assert got["dis/loss_gp"] == want["dis/loss_gp"] == 0.0


@pytest.mark.parametrize("tree", ["gen", "dis", "ema"])
def test_two_lazy_steps_params_match_jax(two_steps, tree):
    trainer, f32, jstate, *_ = two_steps
    pick = {"gen": lambda s: s.gen, "dis": lambda s: s.dis, "ema": lambda s: s.ema_gen}[tree]
    want = jax_ckpt._flatten({"gen": jstate.params_gen, "dis": jstate.params_dis, "ema": jstate.ema_gen}[tree])
    alpha = {"gen": STEP_CFG["adam_alpha_g"], "dis": STEP_CFG["adam_alpha_d"]}.get(tree, STEP_CFG["adam_alpha_g"] * 1e-3)
    n = sum(v.size for v in want.values())

    def share_apart(module):
        got = torch_to_jax(module.state_dict())
        assert got.keys() == want.keys()
        return sum(int((np.abs(got[k] - want[k]) > alpha).sum()) for k in want) / n

    bf16, own = share_apart(pick(trainer.state)), share_apart(pick(f32.state))
    assert bf16 <= MAX_SHARE_APART[tree] and bf16 < own, (bf16, own)


def test_bf16_steps_keep_float32_state(two_steps):
    """Parameters, gradients, Adam moments and the EMA stay float32."""
    trainer, *_, grad_dtypes = two_steps
    state = trainer.state
    assert grad_dtypes == {torch.float32}
    tensors = [*state.gen.parameters(), *state.dis.parameters(), *state.ema_gen.parameters()]
    for opt in (state.opt_map, state.opt_gen, state.opt_dis):
        tensors += opt.mu + opt.nu
        assert opt.count == 2
    assert {t.dtype for t in tensors} == {torch.float32}


def test_bf16_checkpoints_interchange_with_jax(two_steps, tmp_path):
    """The port's mixed16 snapshot loads into the JAX package's float32
    trees and the JAX package's into the port, exactly."""
    trainer, _, jstate, *_ = two_steps
    state = trainer.state
    ckpt.save_snapshot(str(tmp_path), state, trainer.rng.get_state(), "2", trainer.config)
    gen_tree = jax_ckpt.load_tree(str(tmp_path / "Generator_2.npz"), jstate.params_gen, strict=True)
    dis_tree = jax_ckpt.load_tree(str(tmp_path / "Discriminator_2.npz"), {"params": jstate.params_dis}, strict=True)
    for module, tree in ((state.gen, gen_tree), (state.dis, dis_tree["params"])):
        got, want = torch_to_jax(module.state_dict()), jax_ckpt._flatten(tree)
        assert got.keys() == want.keys() and all(v.dtype == np.float32 for v in want.values())
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    jax_ckpt.save_snapshot(str(tmp_path / "jax"), jstate, jax.random.PRNGKey(0), "2", JaxConfig(STEP_CFG))
    fresh = Trainer(Config(STEP_CFG), dataset=synthetic_dataset(4, 32), seed=1, device="cpu")
    ckpt.load_snapshot(str(tmp_path / "jax"), fresh.state, "2", fresh.config)
    assert fresh.state.iteration == 2
    for module, tree in ((fresh.state.gen, jstate.params_gen), (fresh.state.dis, jstate.params_dis),
                         (fresh.state.ema_gen, jstate.ema_gen)):
        got, want = torch_to_jax(module.state_dict()), jax_ckpt._flatten(tree)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)




# ---------------------------------------------------------------------------
# lazy R1 in float32, the trainer and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("iteration", [0, 1])
def test_lazy_r1_step_equals_its_every_step_twin(iteration):
    """float32, ch 8: the lazy step (every 4th) at iteration 0 is the
    every-step R1 step at ``lambda_gp * 4``; at iteration 1 it is the step
    without a penalty. Same weights, draws and reals: the same numbers."""
    data = synthetic_dataset(4, 32, seed=6)
    x = torch.from_numpy(data.transpose(0, 2, 3, 1).copy())
    g = torch.Generator().manual_seed(7)
    draws = dict(z=torch.cat([torch.randn(2, 16, generator=g)] * 2), thetas6=0.3 * torch.randn(4, 6, generator=g))
    twin = dict(r1_interval=1, lambda_gp=4.0) if iteration == 0 else dict(r1_interval=1, lambda_gp=0.0)
    results = []
    for options in (dict(r1_interval=4), twin):
        trainer = Trainer(Config(dict(STEP_CFG, ch=8, mixed16=False, **options)), dataset=data, seed=0, device="cpu")
        trainer.state.iteration = iteration
        _, metrics = trainer._step(trainer._spec_for(iteration, STAGE))(trainer.state, x, 0.0, **draws)
        params = {f"{name}.{k}": v for name, module in (("gen", trainer.state.gen), ("dis", trainer.state.dis))
                  for k, v in module.state_dict().items()}
        results.append((metrics, params))
    (lazy, lazy_params), (every, every_params) = results
    assert float(lazy["dis/loss_gp"]) == (float(every["dis/loss_gp"]) if iteration == 0 else 0.0)
    if iteration == 0:
        assert float(lazy["dis/loss_gp"]) > 0
    for k in ("gen/loss_adv", "gen/loss_rotate", "dis/loss_adv"):
        assert float(lazy[k]) == float(every[k]), k
    for k, v in every_params.items():
        torch.testing.assert_close(lazy_params[k], v, rtol=0, atol=0, msg=k)


def test_cli_trains_mixed16_with_lazy_r1_on_the_cpu(tmp_path):
    """``mixed16`` and ``r1_interval`` come from the yml: two iterations at
    ch 8, the penalty on the first only."""
    yaml = pytest.importorskip("yaml")
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    np.save(data_dir / "images.npy", synthetic_dataset(8, 32))
    cfg = dict(STEP_CFG, ch=8, dataset_path=str(data_dir), image_path="unused/*.png", out=str(tmp_path / "out"))
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(cfg))
    rows = []
    trainer = cli.run(cli.load_config(str(path)), on_row=rows.append, device="cpu")
    assert trainer.state.gen.gen.compute_dtype == trainer.state.dis.compute_dtype == BF16
    assert [r["iteration"] for r in rows] == [1, 2]
    assert all(np.isfinite(r[k]) for r in rows for k in METRICS)
    assert rows[0]["dis/loss_gp"] > 0 and rows[1]["dis/loss_gp"] == 0.0
    assert {"Generator_2.npz", "Discriminator_2.npz", "snapshot_iter_2.npz"} <= set(os.listdir(tmp_path / "out"))


def test_deepvoxels_trainer_takes_mixed16_and_refuses_lazy_r1():
    cfg = dict(STEP_CFG, generator_architecture="deepvoxels", ch=8, batchsize=2, occlusion_type="accumulative",
               r1_interval=1)
    trainer = Trainer(Config(cfg), dataset=synthetic_dataset(2, 64), device="cpu")
    assert trainer.state.gen.compute_dtype == trainer.state.dis.compute_dtype == BF16
    assert {p.dtype for p in trainer.state.gen.parameters()} == {torch.float32}
    with pytest.raises(ValueError, match="r1_interval"):
        Trainer(Config(dict(cfg, r1_interval=16)), dataset=synthetic_dataset(2, 64), device="cpu")
