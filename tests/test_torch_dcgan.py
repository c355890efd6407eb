"""The port's DCGAN generator and DCGAN RGBD train step against the JAX
package's, on the CPU; DCGAN checkpoints both ways; ``step_window`` runs as
plain steps.

Weights come from the port's init, perturbed by a seeded numpy generator
(so that no parameter sits at its zero or one initial value) and reach the
JAX modules through the bridge; inputs and draws are numpy or the JAX
step's own, injected into the port. The width is cut to in_ch 16 and a
hidden width of 32 (the trainer's quirk keeps the hidden width at 512,
which the step would not need to be checked).

- The forward: stages 6 and 7 (alpha 0.5), float32 within ``FWD_ATOL``;
  bf16 (``compute_dtype``) held to the JAX bf16 forward by the largest
  absolute difference over the largest magnitude of the JAX float32 output,
  within ``BF16_TOL`` and below the JAX package's own bf16-vs-float32
  distance.
- The step: batch 4, stage 6 (32 px), rotate and occlusion on, EMA on, R1
  every step (one step; ``test_torch_dcgan_lazy_r1.py`` holds two steps
  with ``r1_interval=2``). Losses and every updated parameter within
  atol 1e-4 (a step moves each parameter by about alpha = 1e-3). One kind
  of parameter has a vanishing gradient at any weights: the noise gains
  ``n0``/``n1``, since noise is forced off; both packages leave them as
  they were.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_gan_tpu.core import Config as JaxConfig
from rgbd_gan_tpu.geometry.prior import CameraParamPrior as JaxPrior
from rgbd_gan_tpu.models.discriminator import Discriminator as JaxDiscriminator
from rgbd_gan_tpu.models.generators import DCGANGenerator as JaxDCGANGenerator
from rgbd_gan_tpu.models.generators import dcgan_make_hidden as jax_make_hidden
from rgbd_gan_tpu.train import checkpoint as jax_ckpt
from rgbd_gan_tpu.train.optim import make_optimizer as jax_make_optimizer
from rgbd_gan_tpu.train.state import TrainState as JaxTrainState
from rgbd_gan_tpu.train.steps import StepSpec as JaxStepSpec
from rgbd_gan_tpu.train.steps import make_rgbd_train_step as jax_make_step
from rgbd_gan_tpu_torch.bridge import load_jax_params, torch_to_jax
from rgbd_gan_tpu_torch.core.config import Config
from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
from rgbd_gan_tpu_torch.geometry.prior import CameraParamPrior
from rgbd_gan_tpu_torch.models.discriminator import Discriminator
from rgbd_gan_tpu_torch.models.generators import DCGANGenerator
from rgbd_gan_tpu_torch.train import checkpoint as ckpt
from rgbd_gan_tpu_torch.train.ema import copy_params
from rgbd_gan_tpu_torch.train.optim import make_optimizer
from rgbd_gan_tpu_torch.train.state import TrainState
from rgbd_gan_tpu_torch.train.steps import StepSpec, make_rgbd_train_step
from rgbd_gan_tpu_torch.train.trainer import Trainer

# the suite runs several worker processes at once: leave them the other cores
torch.set_num_threads(2)

IN_CH, HIDDEN, BATCH, STAGE = 16, 32, 4, 6
FWD_ATOL, STEP_ATOL = 1e-5, 1e-4
# port-vs-JAX bf16 distance, measured on the CPU: stage 6 1.5e-3, stage 7 1.5e-3
BF16_TOL = 4e-3
CFG = dict(
    generator_architecture="dcgan", ch=IN_CH, batchsize=BATCH, res_dis=True, sn=False,
    adam_alpha_g=0.001, adam_alpha_d=0.003, adam_beta1=0.0, adam_beta2=0.999,
    lambda_gp=1.0, lambda_depth=10, depth_min=0.6, keep_smoothed_gen=True, smoothing=0.999,
    stage_interval="0,0,0,0,0,0,0", max_stage=7, start_rotation=-1, start_occlusion_aware=0,
    x_rotate=0.3054, y_rotate=3.1415, z_rotate=0, x_translate=0, y_translate=0, z_translate=0,
)
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


def _generator(dtype=None):
    return DCGANGenerator(in_ch=IN_CH, ch=HIDDEN, rgbd=True, compute_dtype=dtype,
                          generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def weights():
    gflat = _perturbed(torch_to_jax(_generator().state_dict()), 0)
    dis = Discriminator(ch=IN_CH, res=True, generator=torch.Generator().manual_seed(1))
    return gflat, _perturbed(torch_to_jax(dis.state_dict()), 1)


def test_parameter_tree_matches_jax_init(weights):
    """The port owns every leaf of the JAX package's ``init_all`` tree, the
    unused noise gains included, with its shape."""
    jgen = JaxDCGANGenerator(in_ch=IN_CH, ch=HIDDEN, rgbd=True)
    z, theta = jnp.zeros((2, IN_CH)), jnp.zeros((2, 9))
    tree = jax.eval_shape(lambda: jgen.init(jax.random.PRNGKey(0), z, theta, method=jgen.init_all))["params"]
    want = {k: v.shape for k, v in jax_ckpt._flatten(jax.tree_util.tree_map(lambda s: np.zeros(s.shape), tree)).items()}
    got = {k: v.shape for k, v in weights[0].items()}
    assert got == want and "block4/n1/gain" in got


@pytest.fixture(scope="module", params=[6, 7], ids=lambda stage: f"stage{stage}")
def forwards(request, weights):
    """(stage, inputs, JAX outputs in float32 and in bf16) at alpha 0.5."""
    stage = request.param
    rng = np.random.RandomState(stage)
    z, theta = rng.randn(2, IN_CH).astype("f"), (0.3 * rng.randn(2, 9)).astype("f")
    outs = {}
    for name, dtype in (("f32", None), ("bf16", jnp.bfloat16)):
        jgen = JaxDCGANGenerator(in_ch=IN_CH, ch=HIDDEN, rgbd=True, compute_dtype=dtype)
        fwd = jax.jit(lambda v, z, a, t: jgen.apply(v, z, stage, a, t))
        outs[name] = np.asarray(fwd({"params": _unflatten(weights[0])}, jnp.asarray(z), jnp.float32(0.5),
                                    jnp.asarray(theta)))
    return stage, (torch.tensor(z), 0.5, torch.tensor(theta)), outs


def test_forward_matches_jax(weights, forwards):
    stage, inputs, outs = forwards
    gen = _generator()
    load_jax_params(gen, weights[0])
    with torch.no_grad():
        got = gen(inputs[0], stage, *inputs[1:]).numpy()
    assert got.shape == (2, 16 * 2 ** (stage - 5), 16 * 2 ** (stage - 5), 4)
    np.testing.assert_allclose(got, outs["f32"], atol=FWD_ATOL, rtol=1e-5)


def test_bf16_forward_matches_jax(weights, forwards):
    """The stem and the blocks in bf16, the heads and the blend in float32."""
    stage, inputs, outs = forwards
    gen = _generator(torch.bfloat16)
    load_jax_params(gen, weights[0])
    seen = {}
    for name in ("block1.c1", "out2"):
        gen.get_submodule(name).register_forward_pre_hook(lambda m, args, name=name: seen.update({name: args[0].dtype}))
    with torch.no_grad():
        got = gen(inputs[0], stage, *inputs[1:]).numpy()
    assert seen == {"block1.c1": torch.bfloat16, "out2": torch.float32}
    scale = float(np.abs(outs["f32"]).max())
    port, own = np.abs(got - outs["bf16"]) / scale, np.abs(outs["bf16"] - outs["f32"]) / scale
    assert port.max() < own.max() and port.mean() < own.mean(), (port.max(), own.max())
    assert port.max() <= BF16_TOL, port.max()


def test_low_stage_raises_and_eval_upsamples(weights):
    gen = _generator()
    load_jax_params(gen, weights[0])
    z, theta = torch.zeros(1, IN_CH), torch.zeros(1, 9)
    with pytest.raises(ValueError, match="stage >= 2"):
        gen(z, 1, 0.0, theta)
    with torch.no_grad():
        small = gen(z, 4, 0.0, theta)
        big = gen(z, 4, 0.0, theta, train=False)
    assert small.shape == (1, 16, 16, 4) and big.shape == (1, 64, 64, 4)
    assert torch.equal(big[:, ::4, ::4], small) and torch.equal(big[:, 3::4, 3::4], small)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _jax_step(r1_interval):
    cfg = JaxConfig(CFG)
    gen = JaxDCGANGenerator(in_ch=IN_CH, ch=HIDDEN, rgbd=True)
    dis = JaxDiscriminator(ch=IN_CH, res=True)
    opt_gen = jax_make_optimizer(cfg.adam_alpha_g, 0.0, 0.999)
    opt_dis = jax_make_optimizer(cfg.adam_alpha_d, 0.0, 0.999)
    spec = JaxStepSpec(
        architecture="dcgan", stage_floor=STAGE, batch_size=BATCH, use_rotate=True, occlusion_aware=True,
        keep_smoothed_gen=True, lambda_gp=1.0, lambda_depth=10.0, depth_min=0.6, gather_mode="xla",
        max_stage=7, r1_interval=r1_interval,
    )
    prior = JaxPrior(cfg)
    step = jax_make_step(gen, dis, lambda k, n: jax_make_hidden(k, n, IN_CH), prior, None, opt_gen, opt_dis, spec)
    return jax.jit(step), opt_gen, opt_dis, prior


def _port_state(gflat, dflat):
    gen = _generator()
    dis = Discriminator(ch=IN_CH, res=True)
    load_jax_params(gen, gflat)
    load_jax_params(dis, dflat)
    gen.requires_grad_(False)
    dis.requires_grad_(False)
    return TrainState(
        gen=gen, dis=dis, opt_map=None, opt_gen=make_optimizer(gen.named_parameters(), CFG["adam_alpha_g"], 0.0, 0.999),
        opt_dis=make_optimizer(dis.named_parameters(), CFG["adam_alpha_d"], 0.0, 0.999), ema_gen=copy_params(gen),
    )


def _run(weights, r1_interval, n_steps):
    gflat, dflat = weights
    jstep, opt_gen, opt_dis, jprior = _jax_step(r1_interval)
    params_gen, params_dis = _unflatten(gflat), _unflatten(dflat)
    jstate = JaxTrainState(
        params_gen=params_gen, params_dis=params_dis, opt_map=None, opt_gen=opt_gen.init(params_gen),
        opt_dis=opt_dis.init(params_dis), ema_gen=jax.tree_util.tree_map(jnp.copy, params_gen), sn_state=None,
        iteration=jnp.int32(0),
    )
    state = _port_state(gflat, dflat)
    spec = StepSpec(
        stage_floor=STAGE, batch_size=BATCH, architecture="dcgan", use_rotate=True, occlusion_aware=True,
        keep_smoothed_gen=True, lambda_depth=10, depth_min=0.6, max_stage=7, r1_interval=r1_interval,
    )
    step = make_rgbd_train_step(None, CameraParamPrior(Config(CFG)), spec)
    data = synthetic_dataset(BATCH, 32, seed=5).transpose(0, 2, 3, 1)  # uint8 NHWC
    metrics, jmetrics = [], []
    for it in range(n_steps):
        # the JAX step's own draws (steps.py:145-149), injected into the port
        key = jax.random.PRNGKey(20 + it)
        kz, ktheta, _ = jax.random.split(key, 3)
        z = jnp.concatenate([jax_make_hidden(kz, BATCH // 2, IN_CH)] * 2, axis=0)
        thetas6 = jprior.sample(ktheta, BATCH)
        jstate, jm = jstep(jstate, jnp.asarray(data), jnp.float32(0.0), key)
        _, m = step(state, torch.from_numpy(data.copy()), 0.0, z=torch.tensor(np.asarray(z)),
                    thetas6=torch.tensor(np.asarray(thetas6)))
        metrics.append({k: float(v) for k, v in m.items()})
        jmetrics.append({k: float(v) for k, v in jm.items()})
    return state, jstate, metrics, jmetrics


@pytest.fixture(scope="module")
def r1_every_step(weights):
    return _run(weights, 1, 1)


def _check_losses(metrics, jmetrics):
    for got, want in zip(metrics, jmetrics):
        for k in METRICS:
            np.testing.assert_allclose(got[k], want[k], atol=STEP_ATOL, err_msg=k)
        assert not got["nan"] and not want["nan"]


def _check_params(state, jstate, before):
    for module, tree in ((state.gen, jstate.params_gen), (state.dis, jstate.params_dis),
                         (state.ema_gen, jstate.ema_gen)):
        got, want = torch_to_jax(module.state_dict()), jax_ckpt._flatten(tree)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=STEP_ATOL, err_msg=k)
    noise = [k for k in before if "/n0/" in k or "/n1/" in k]
    assert noise and all(np.array_equal(torch_to_jax(state.gen.state_dict())[k], before[k]) for k in noise)


def test_step_matches_jax(r1_every_step, weights):
    state, jstate, metrics, jmetrics = r1_every_step
    _check_losses(metrics, jmetrics)
    assert metrics[0]["dis/loss_gp"] > 0 and metrics[0]["image_size"] == 32.0
    _check_params(state, jstate, weights[0])
    assert state.iteration == int(jstate.iteration) == 1 and state.opt_gen.count == state.opt_dis.count == 1


def test_checkpoints_interchange_exactly(r1_every_step, tmp_path):
    """A DCGAN snapshot has no mapping optimizer: neither package writes an
    ``opt_map`` key, and each reads the other's files bit for bit."""
    state, jstate, _, _ = r1_every_step
    config = Config(CFG)
    ckpt.save_snapshot(str(tmp_path), state, torch.Generator().get_state(), "1", config)
    trainer_flat = ckpt.load_tree(str(tmp_path / "snapshot_iter_1.npz"))
    assert not any(k.startswith("opt_map") for k in trainer_flat)
    gen_tree = jax_ckpt.load_tree(str(tmp_path / "Generator_1.npz"), jstate.params_gen, strict=True)
    ema_tree = jax_ckpt.load_tree(str(tmp_path / "SmoothedGenerator_1.npz"), jstate.ema_gen, strict=True)
    dis_tree = jax_ckpt.load_tree(str(tmp_path / "Discriminator_1.npz"), {"params": jstate.params_dis}, strict=True)
    opt_tree = jax_ckpt.load_tree(
        str(tmp_path / "snapshot_iter_1.npz"),
        {"opt_map": None, "opt_gen": jstate.opt_gen, "opt_dis": jstate.opt_dis, "iteration": jstate.iteration},
        strict=True,
    )
    for module, tree in ((state.gen, gen_tree), (state.ema_gen, ema_tree), (state.dis, dis_tree["params"])):
        got, want = torch_to_jax(module.state_dict()), jax_ckpt._flatten(tree)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    mu = jax_ckpt._flatten(opt_tree["opt_gen"])
    i = state.opt_gen.names.index("block0.c0.weight")
    np.testing.assert_array_equal(mu["1/0/mu/block0/c0/kernel"], torch_to_jax({"w.weight": state.opt_gen.mu[i]})["w/kernel"])
    assert int(opt_tree["iteration"]) == 1

    # and the port reads the JAX package's files, exactly
    jax_ckpt.save_snapshot(str(tmp_path / "jax"), jstate, jax.random.PRNGKey(0), "1", JaxConfig(CFG))
    fresh = _port_state(*[_perturbed(torch_to_jax(m.state_dict()), 7) for m in (state.gen, state.dis)])
    assert ckpt.load_snapshot(str(tmp_path / "jax"), fresh, "1", config) is None
    for module, tree in ((fresh.gen, jstate.params_gen), (fresh.dis, jstate.params_dis),
                         (fresh.ema_gen, jstate.ema_gen)):
        got, want = torch_to_jax(module.state_dict()), jax_ckpt._flatten(tree)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    i = fresh.opt_gen.names.index("linear.weight")
    nu = jax_ckpt._flatten(jstate.opt_gen)["1/0/nu/linear/kernel"]
    np.testing.assert_array_equal(torch_to_jax({"w.weight": fresh.opt_gen.nu[i]})["w/kernel"], nu)
    assert fresh.iteration == 1 and fresh.opt_gen.count == 1 and fresh.opt_map is None


# ---------------------------------------------------------------------------
# the trainer: DCGAN builds from the shipped ymls, step_window runs plain steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["dcgan_shapenet_car", "structured_spheres_dcgan", "structured_spheres_stylegan"])
def test_shipped_yml_builds_a_trainer(name):
    yaml = pytest.importorskip("yaml")
    with open(f"configs/{name}.yml") as f:
        config = Config(yaml.safe_load(f))
    config.ch = 8  # the hidden width of DCGAN stays 512
    trainer = Trainer(config, dataset=synthetic_dataset(4, 32), device="cpu")
    if config.generator_architecture == "dcgan":
        assert trainer.state.opt_map is None and trainer.state.gen.linear.weight.shape == (512 * 16, 8 + 9)
        assert trainer._spec_for(0, 6).architecture == "dcgan"


def test_step_window_runs_plain_steps(tmp_path):
    """``structured_spheres_stylegan.yml`` cut to ch 8 and 16 px: its
    ``step_window: 10`` and ``step_window: 1`` log the same losses over 12
    iterations (one row each)."""
    yaml = pytest.importorskip("yaml")
    with open("configs/structured_spheres_stylegan.yml") as f:
        values = yaml.safe_load(f)
    assert values["step_window"] == 10
    values.update(ch=8, batchsize=4, stage_interval="0,0,0,0,0", max_stage=5, start_rotation=5,
                  start_occlusion_aware=8, display_interval=1, snapshot_interval=100, auto_resume=False)
    rows = {}
    for window in (10, 1):
        out = tmp_path / f"window_{window}"
        trainer = Trainer(Config(dict(values, step_window=window, out=str(out))),
                          dataset=synthetic_dataset(8, 16), device="cpu")
        trainer.run(iterations=12)
        rows[window] = [json.loads(line) for line in (out / "log.jsonl").read_text().splitlines()]
    assert [r["iteration"] for r in rows[10]] == list(range(1, 13))
    for a, b in zip(rows[10], rows[1]):
        assert {k: v for k, v in a.items() if k != "elapsed_time"} == {k: v for k, v in b.items() if k != "elapsed_time"}
    assert "gen/loss_rotate" in rows[10][-1] and "gen/loss_rotate" not in rows[10][0]
