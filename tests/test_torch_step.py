"""One StyleGAN RGBD train step of the port against the JAX package's, from
the same (bridged) state and with the JAX step's own random draws injected;
plus checkpoint interchange and a tiny CPU run of the port's CLI.

Both sides: ch 16, batch 4, stage 6 (32 px), rotate + occlusion on, R1
every step, EMA on; the JAX side gathers with ``gather_mode="xla"``. The
initial weights are perturbed by seeded noise: at the plain init the
constant 4x4 input makes many gradients vanish in exact arithmetic, and
Adam's first step (beta1 = 0) turns their float32 noise into steps of
+-alpha in either package. One parameter keeps a vanishing gradient at any
weights: ``gen/block0/b0`` shifts the positive 4x4 constant uniformly before
the leaky ReLU (linear there) and the instance norm removes the shift, so
for it the test checks only that each package moves it by at most alpha.
Tolerance: atol 1e-4 on the losses and on every other updated parameter (a
step moves each parameter by about alpha = 1e-3).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_gan_tpu.core import Config as JaxConfig
from rgbd_gan_tpu.geometry.prior import CameraParamPrior as JaxPrior
from rgbd_gan_tpu.models.discriminator import Discriminator as JaxDiscriminator
from rgbd_gan_tpu.models.generators import StyleGANGenerator as JaxStyleGANGenerator
from rgbd_gan_tpu.models.generators import stylegan_make_hidden as jax_make_hidden
from rgbd_gan_tpu.train import checkpoint as jax_ckpt
from rgbd_gan_tpu.train.optim import make_optimizer as jax_make_optimizer
from rgbd_gan_tpu.train.optim import make_stylegan_gen_optimizer as jax_make_gen_optimizer
from rgbd_gan_tpu.train.state import TrainState as JaxTrainState
from rgbd_gan_tpu.train.steps import StepSpec as JaxStepSpec
from rgbd_gan_tpu.train.steps import make_rgbd_train_step as jax_make_step
from rgbd_gan_tpu_torch.bridge import load_jax_params, torch_to_jax
from rgbd_gan_tpu_torch.cli import train as cli
from rgbd_gan_tpu_torch.core.config import Config
from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
from rgbd_gan_tpu_torch.train import checkpoint as ckpt
from rgbd_gan_tpu_torch.train.steps import StepSpec, make_rgbd_train_step
from rgbd_gan_tpu_torch.train.trainer import Trainer

CH, BATCH, STAGE, ALPHA = 16, 4, 6, 0.0
ATOL = 1e-4
CFG = dict(
    generator_architecture="stylegan", ch=CH, batchsize=BATCH, res_dis=True, sn=False,
    adam_alpha_g=0.001, adam_alpha_d=0.003, adam_beta1=0.0, adam_beta2=0.999,
    lambda_gp=1.0, lambda_depth=10, depth_min=1.0, keep_smoothed_gen=True, smoothing=0.999,
    stage_interval="0,0,0,0,0,0,0", max_stage=7, start_rotation=-1, start_occlusion_aware=0,
    x_rotate=0.3054, y_rotate=1.0472, z_rotate=0, x_translate=0, y_translate=0, z_translate=0,
    iteration=2, display_interval=1, snapshot_interval=2,
)
METRICS = ["gen/loss_adv", "gen/loss_rotate", "dis/loss_adv", "dis/loss_gp"]
ZERO_GRAD = "gen/block0/b0"  # gradient identically zero (see above)


def _perturbed(flat, rng):
    return {k: (v + 0.05 * rng.randn(*v.shape)).astype(v.dtype) for k, v in flat.items()}


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)
    return tree


def _jax_step_and_state(gflat, dflat):
    cfg = JaxConfig(CFG)
    gen = JaxStyleGANGenerator(CH, rgbd=True)
    dis = JaxDiscriminator(ch=CH, res=True)
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
        architecture="stylegan", stage_floor=STAGE, batch_size=BATCH, use_rotate=True,
        occlusion_aware=True, keep_smoothed_gen=True, lambda_gp=1.0, lambda_depth=10.0,
        depth_min=1.0, gather_mode="xla", max_stage=7,
    )
    prior = JaxPrior(cfg)
    step = jax_make_step(
        gen, dis, lambda k, n: jax_make_hidden(k, n, CH), prior, opt_map, opt_gen, opt_dis, spec
    )
    return step, state, prior


@pytest.fixture(scope="module")
def one_step():
    data = synthetic_dataset(BATCH, 32, seed=5)
    trainer = Trainer(Config(CFG), dataset=data, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    gflat = _perturbed(torch_to_jax(trainer.state.gen.state_dict()), rng)
    dflat = _perturbed(torch_to_jax(trainer.state.dis.state_dict()), rng)
    load_jax_params(trainer.state.gen, gflat)
    load_jax_params(trainer.state.ema_gen, gflat)
    load_jax_params(trainer.state.dis, dflat)
    jstep, jstate, jprior = _jax_step_and_state(gflat, dflat)

    # the JAX step's own draws (steps.py:145-149), injected into the port
    key = jax.random.PRNGKey(4)
    kz, ktheta, _ = jax.random.split(key, 3)
    z = jnp.concatenate([jax_make_hidden(kz, BATCH // 2, CH)] * 2, axis=0)
    thetas6 = jprior.sample(ktheta, BATCH)
    x = data.transpose(0, 2, 3, 1)  # uint8 NHWC
    new_jstate, jmetrics = jax.jit(jstep)(jstate, jnp.asarray(x), jnp.float32(ALPHA), key)

    spec = trainer._spec_for(0, STAGE)
    assert spec == StepSpec(
        stage_floor=STAGE, batch_size=BATCH, use_rotate=True,
        occlusion_aware=True, keep_smoothed_gen=True, lambda_gp=1.0, lambda_depth=10,
        depth_min=1.0, max_stage=7,
    )
    state, metrics = trainer._step(spec)(
        trainer.state, torch.from_numpy(x.copy()), ALPHA,
        z=torch.tensor(np.asarray(z)), thetas6=torch.tensor(np.asarray(thetas6)),
    )
    return trainer, state, metrics, new_jstate, jmetrics, gflat


@pytest.mark.parametrize("name", METRICS)
def test_step_metrics_match(one_step, name):
    _, _, metrics, _, jmetrics, _ = one_step
    np.testing.assert_allclose(float(metrics[name]), float(jmetrics[name]), atol=ATOL)


@pytest.mark.parametrize("tree", ["gen", "dis", "ema"])
def test_step_updated_params_match(one_step, tree):
    _, state, _, jstate, _, before = one_step
    module, jtree = {
        "gen": (state.gen, jstate.params_gen),
        "dis": (state.dis, jstate.params_dis),
        "ema": (state.ema_gen, jstate.ema_gen),
    }[tree]
    want = jax_ckpt._flatten(jtree)
    got = torch_to_jax(module.state_dict())
    assert got.keys() == want.keys()
    for k in want:
        if tree == "gen" and k == ZERO_GRAD:
            alpha = CFG["adam_alpha_g"] * (1 + 1e-5)
            assert np.abs(got[k] - before[k]).max() <= alpha
            assert np.abs(want[k] - before[k]).max() <= alpha
            continue
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, err_msg=k)


def test_step_counts_and_flags(one_step):
    _, state, metrics, jstate, jmetrics, _ = one_step
    assert state.iteration == int(jstate.iteration) == 1
    assert not bool(metrics["nan"]) and not bool(jmetrics["nan"])
    assert float(metrics["image_size"]) == float(jmetrics["image_size"]) == 32.0
    assert state.opt_gen.count == state.opt_map.count == state.opt_dis.count == 1


def test_checkpoints_interchange_exactly(one_step, tmp_path):
    trainer, state, _, jstate, _, _ = one_step
    ckpt.save_snapshot(str(tmp_path), state, trainer.rng.get_state(), "1", trainer.config)
    # the JAX package reads the port's files into its own trees, exactly
    gen_tree = jax_ckpt.load_tree(str(tmp_path / "Generator_1.npz"), jstate.params_gen, strict=True)
    dis_tree = jax_ckpt.load_tree(str(tmp_path / "Discriminator_1.npz"), {"params": jstate.params_dis},
                                  strict=True)
    trainer_tree = jax_ckpt.load_tree(
        str(tmp_path / "snapshot_iter_1.npz"),
        {"opt_map": jstate.opt_map, "opt_gen": jstate.opt_gen, "opt_dis": jstate.opt_dis,
         "iteration": jstate.iteration},
        strict=True,
    )
    for module, tree in ((state.gen, gen_tree), (state.dis, dis_tree["params"])):
        got, want = torch_to_jax(module.state_dict()), jax_ckpt._flatten(tree)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    mu = jax_ckpt._flatten(trainer_tree["opt_dis"])
    np.testing.assert_array_equal(
        mu["1/0/mu/block1/c0/kernel"], torch_to_jax({"w.weight": state.opt_dis.mu[
            state.opt_dis.names.index("block1.c0.weight")]})["w/kernel"]
    )
    assert int(trainer_tree["iteration"]) == 1

    # and the port reads the JAX package's files, exactly
    jax_ckpt.save_snapshot(str(tmp_path / "jax"), jstate, jax.random.PRNGKey(0), "1", JaxConfig(CFG))
    fresh = Trainer(Config(CFG), dataset=synthetic_dataset(BATCH, 32), seed=1, device="cpu")
    assert ckpt.load_snapshot(str(tmp_path / "jax"), fresh.state, "1", fresh.config) is None
    for module, tree in ((fresh.state.gen, jstate.params_gen), (fresh.state.dis, jstate.params_dis),
                         (fresh.state.ema_gen, jstate.ema_gen)):
        got, want = torch_to_jax(module.state_dict()), jax_ckpt._flatten(tree)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert fresh.state.iteration == 1 and fresh.state.opt_gen.count == 1


def test_cli_runs_snapshots_and_resumes(tmp_path):
    yaml = pytest.importorskip("yaml")
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    np.save(data_dir / "images.npy", synthetic_dataset(8, 32))
    cfg = dict(CFG, ch=8, dataset_path=str(data_dir), image_path="unused/*.png",
               out=str(tmp_path / "out"), auto_resume=True)
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(cfg))
    rows = []
    trainer = cli.run(cli.load_config(str(path)), on_row=rows.append, device="cpu")
    assert trainer.state.iteration == 2 and [r["iteration"] for r in rows] == [1, 2]
    for r in rows:
        assert all(np.isfinite(r[k]) for k in METRICS)
    files = set(os.listdir(tmp_path / "out"))
    assert {"Generator_2.npz", "Discriminator_2.npz", "SmoothedGenerator_2.npz",
            "snapshot_iter_2.npz", "Generator_latest.npz", "log.jsonl"} <= files

    resumed = cli.main(["--config_path", str(path), "--iterations", "3", "--device", "cpu"])
    assert resumed.state.iteration == 3
    assert len((tmp_path / "out" / "log.jsonl").read_text().splitlines()) == 3


@pytest.mark.parametrize("option", [
    dict(r1_interval=16), dict(rotate_feature=True), dict(use_occupancy=True), dict(sn=True),
    dict(axis_name="data"),
])
def test_step_refuses_unported_options(option):
    with pytest.raises(NotImplementedError):
        make_rgbd_train_step(None, None, StepSpec(stage_floor=STAGE, batch_size=BATCH, **option))


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        Trainer(Config(dict(CFG, sn=True)), dataset=synthetic_dataset(4, 32), device="cpu")
    with pytest.raises(NotImplementedError):
        Trainer(Config(dict(CFG, step_window=4)), dataset=synthetic_dataset(4, 32), device="cpu")


def test_trainer_without_a_device_needs_a_card():
    """The card is the default device: without one the Trainer raises and
    does not move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(Config(CFG), dataset=synthetic_dataset(4, 32))


def test_cli_without_device_cpu_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(SystemExit) as info:
        cli.main(["--config_path", "configs/ffhq_stylegan_occlusion.yml"])
    assert info.value.code not in (0, None) and "--device cpu" in str(info.value.code)
