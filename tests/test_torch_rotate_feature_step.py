"""One StyleGAN RGBD train step of the port against the JAX package's with
spectral norm, the feature 3D-consistency loss (``rotate_feature``), the
occupancy loss and ``rotate_conv_input`` all on, from the same (bridged)
state and with the JAX step's own random draws injected (the occupancy
loss's depth jitter too); plus the SN vectors after the step and
checkpoints with the ``sn`` collection both ways.

Both sides: ch 16, batch 4, stage 6 (32 px; D's feature tap is 32x32, so
the feature gather sees C = 17), rotate + occlusion on, EMA on; the JAX side
gathers with ``gather_mode="xla"``. The initial weights are perturbed by
seeded noise, as in ``tests/test_torch_step.py``; the SN vectors ``u`` are
the port's init. With ``sn`` the step takes no R1 penalty and D advances
each ``u`` three times: the G phase's forward and the D phase's forwards
on the fakes and on the reals.

Tolerance: the losses (all taken before any update: the D phase scores the
pre-update fakes) within 1e-4 + 1e-3 relative; the SN vectors after the
step within 1e-5; the updated parameters within atol 1e-4 (a step moves
each parameter by about alpha = 1e-3). Adam's first step moves an element
by ``alpha * g / (|g| + 1e-8)``, so an element whose gradient is within
ten times Adam's eps (``NOISE_ABS``) moves by a share of alpha that float32
noise decides: such elements (measured: one of 256 in
``gen/block2/s1/b/kernel``, gradient -2.0e-9, moved 1.67e-4 by the port and
3.9e-5 by JAX) and ``gen/block0/b0``, whose gradient vanishes in exact
arithmetic (see ``tests/test_torch_step.py``), are held only to moving by
at most alpha in each package. The gradient is the port's: Adam's first
moment after one step with beta1 = 0.
"""

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
from rgbd_gan_tpu_torch.core.config import Config
from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
from rgbd_gan_tpu_torch.ops import bilinear
from rgbd_gan_tpu_torch.train import checkpoint as ckpt
from rgbd_gan_tpu_torch.train.steps import StepSpec
from rgbd_gan_tpu_torch.train.trainer import Trainer

# the suite runs several worker processes at once: leave them the other cores
torch.set_num_threads(2)

CH, BATCH, STAGE, ALPHA = 16, 4, 6, 0.0
RTOL, ATOL = 1e-3, 1e-4
U_ATOL = 1e-5
NOISE_ABS = 1e-7
CFG = dict(
    generator_architecture="stylegan", ch=CH, batchsize=BATCH, res_dis=True, sn=True, rotate_feature=True,
    use_occupancy_net_loss=True, rotate_conv_input=True, lambda_occupancy=0.5,
    adam_alpha_g=0.001, adam_alpha_d=0.003, adam_beta1=0.0, adam_beta2=0.999,
    lambda_gp=1.0, lambda_depth=10, depth_min=1.0, keep_smoothed_gen=True, smoothing=0.999,
    stage_interval="0,0,0,0,0,0,0", max_stage=7, start_rotation=-1, start_occlusion_aware=0,
    x_rotate=0.3054, y_rotate=1.0472, z_rotate=0, x_translate=0, y_translate=0, z_translate=0,
    iteration=2, display_interval=1, snapshot_interval=2,
)
METRICS = ["gen/loss_adv", "gen/loss_rotate", "gen/loss_occupancy", "dis/loss_adv"]
ZERO_GRAD = "gen/block0/b0"


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)
    return tree


def _perturbed(flat, rng):
    """Seeded noise on every parameter; the SN vectors stay as they are."""
    return {k: v.copy() if k.endswith("/u") else (v + 0.05 * rng.randn(*v.shape)).astype(v.dtype)
            for k, v in flat.items()}


def _split_sn(flat):
    return ({k: v for k, v in flat.items() if not k.endswith("/u")},
            {k: v for k, v in flat.items() if k.endswith("/u")})


@pytest.fixture(scope="module")
def one_step():
    data = synthetic_dataset(BATCH, 32, seed=5)
    trainer = Trainer(Config(CFG), dataset=data, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    gflat = _perturbed(torch_to_jax(trainer.state.gen.state_dict()), rng)
    dflat = _perturbed(torch_to_jax(trainer.state.dis.state_dict()), rng)
    for module, flat in ((trainer.state.gen, gflat), (trainer.state.ema_gen, gflat), (trainer.state.dis, dflat)):
        load_jax_params(module, flat)
    dparams, sn = _split_sn(dflat)

    cfg = JaxConfig(CFG)
    gen = JaxStyleGANGenerator(CH, rgbd=True, rotate_conv_input=True, use_occupancy_net=True)
    dis = JaxDiscriminator(ch=CH, res=True, sn=True)
    params_gen, params_dis = _unflatten(gflat), _unflatten(dparams)
    opt_map = jax_make_optimizer(cfg.adam_alpha_g / 100, 0.0, 0.999)
    opt_gen = jax_make_gen_optimizer(cfg.adam_alpha_g, 0.0, 0.999, rgbd=True)
    opt_dis = jax_make_optimizer(cfg.adam_alpha_d, 0.0, 0.999)
    jstate = JaxTrainState(
        params_gen=params_gen, params_dis=params_dis,
        opt_map=opt_map.init(params_gen["mapping"]), opt_gen=opt_gen.init(params_gen["gen"]),
        opt_dis=opt_dis.init(params_dis), ema_gen=jax.tree_util.tree_map(jnp.copy, params_gen),
        sn_state=_unflatten(sn), iteration=jnp.int32(0),
    )
    spec = JaxStepSpec(
        architecture="stylegan", stage_floor=STAGE, batch_size=BATCH, use_rotate=True, occlusion_aware=True,
        rotate_feature=True, use_occupancy=True, sn=True, keep_smoothed_gen=True, lambda_gp=1.0,
        lambda_depth=10.0, depth_min=1.0, lambda_occupancy=0.5, gather_mode="xla", max_stage=7,
    )
    prior = JaxPrior(cfg)
    jstep = jax_make_step(gen, dis, lambda k, n: jax_make_hidden(k, n, CH), prior, opt_map, opt_gen, opt_dis, spec)

    # the JAX step's own draws (steps.py:145-149, warp.py:386), injected into the port
    key = jax.random.PRNGKey(4)
    kz, ktheta, kocc = jax.random.split(key, 3)
    draws = dict(
        z=jnp.concatenate([jax_make_hidden(kz, BATCH // 2, CH)] * 2, axis=0),
        thetas6=prior.sample(ktheta, BATCH),
        occupancy_eps=0.05 * jax.random.normal(kocc, (BATCH, 1, 32 * 32), dtype=jnp.float32),
    )
    x = data.transpose(0, 2, 3, 1)  # uint8 NHWC
    new_jstate, jmetrics = jax.jit(jstep)(jstate, jnp.asarray(x), jnp.float32(ALPHA), key)

    spec = trainer._spec_for(0, STAGE)
    assert spec == StepSpec(
        stage_floor=STAGE, batch_size=BATCH, use_rotate=True, occlusion_aware=True, keep_smoothed_gen=True,
        lambda_gp=1.0, lambda_depth=10, depth_min=1.0, max_stage=7, rotate_feature=True, use_occupancy=True,
        lambda_occupancy=0.5, sn=True,
    )
    bilinear.reset_launches()
    state, metrics = trainer._step(spec)(
        trainer.state, torch.from_numpy(x.copy()), ALPHA, **{k: torch.tensor(np.asarray(v)) for k, v in draws.items()}
    )
    assert not any(bilinear.launches.values())  # the CPU runs the plain versions
    # each element's gradient (beta1 = 0: Adam's first moment after one step)
    grads = {}
    for prefix, opt in (("mapping.", state.opt_map), ("gen.", state.opt_gen), ("dis.", state.opt_dis)):
        grads.update({prefix + n: g for n, g in zip(opt.names, opt.mu)})
    before = {"gen": gflat, "ema": gflat, "dis": dparams}
    return trainer, state, metrics, new_jstate, jmetrics, before, sn, torch_to_jax(grads)


@pytest.mark.parametrize("name", METRICS)
def test_step_metrics_match(one_step, name):
    _, _, metrics, _, jmetrics, _, _, _ = one_step
    a, b = float(metrics[name]), float(jmetrics[name])
    assert abs(a - b) <= ATOL + RTOL * abs(b), (name, a, b)


def test_no_r1_with_sn(one_step):
    _, _, metrics, _, jmetrics, _, _, _ = one_step
    assert "dis/loss_gp" not in metrics and "dis/loss_gp" not in jmetrics


def test_sn_vectors_after_the_step_match(one_step):
    """Three power iterations from the same start in either package, for
    the layers that stage 6 runs (``in3``, blocks 3 to 0); the others keep
    their vectors in both. (That each run advances three times is held in
    ``tests/test_torch_sn.py``.)"""
    _, state, _, jstate, _, _, before, _ = one_step
    got = {k: v for k, v in torch_to_jax(state.dis.state_dict()).items() if k.endswith("/u")}
    want = jax_ckpt._flatten(jstate.sn_state)
    assert got.keys() == want.keys() == before.keys() and len(want) == 24
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=U_ATOL, err_msg=k)
        if k.split("/")[0] not in ("in3", "block3", "block2", "block1", "block0"):
            np.testing.assert_array_equal(got[k], before[k], err_msg=k)
            np.testing.assert_array_equal(want[k], before[k], err_msg=k)


@pytest.mark.parametrize("tree", ["gen", "dis", "ema"])
def test_step_updated_params_match(one_step, tree):
    _, state, _, jstate, _, before, _, grads = one_step
    before = before[tree]
    module, jtree = {
        "gen": (state.gen, jstate.params_gen),
        "dis": (state.dis, jstate.params_dis),
        "ema": (state.ema_gen, jstate.ema_gen),
    }[tree]
    want = jax_ckpt._flatten(jtree)
    got = {k: v for k, v in torch_to_jax(module.state_dict()).items() if not k.endswith("/u")}
    assert got.keys() == want.keys()
    if tree == "gen":  # the occupancy net and the pose-only l1 (9 inputs) exist and moved
        assert want["gen/l1/kernel"].shape == (9, CH) and "gen/occupancy/l0/kernel" in want
        assert want["gen/occupancy/l0/kernel"].shape == (2 * CH + 3, 32)
    alpha = CFG["adam_alpha_d" if tree == "dis" else "adam_alpha_g"] * (1 + 1e-5)
    for k in want:
        g = np.abs(grads[("dis/" if tree == "dis" else "") + k])
        clear = (g > NOISE_ABS) & (k != ZERO_GRAD)
        np.testing.assert_allclose(got[k][clear], want[k][clear], atol=ATOL, err_msg=k)
        if tree != "ema":
            assert np.abs(got[k] - before[k])[~clear].max(initial=0) <= alpha, k
            assert np.abs(want[k] - before[k])[~clear].max(initial=0) <= alpha, k


def test_checkpoints_carry_the_sn_collection_both_ways(one_step, tmp_path):
    trainer, state, _, jstate, _, _, _, _ = one_step
    ckpt.save_snapshot(str(tmp_path), state, trainer.rng.get_state(), "1", trainer.config)
    saved = np.load(tmp_path / "Discriminator_1.npz")
    assert {k.split("/")[0] for k in saved.files} == {"params", "sn"} and "sn/block0/l2/u" in saved.files
    tree = jax_ckpt.load_tree(str(tmp_path / "Discriminator_1.npz"),
                              {"params": jstate.params_dis, "sn": jstate.sn_state}, strict=True)
    got = torch_to_jax(state.dis.state_dict())
    for k, v in jax_ckpt._flatten(tree["sn"]).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)

    jax_ckpt.save_snapshot(str(tmp_path / "jax"), jstate, jax.random.PRNGKey(0), "1", JaxConfig(CFG))
    fresh = Trainer(Config(CFG), dataset=synthetic_dataset(BATCH, 32), seed=1, device="cpu")
    ckpt.load_snapshot(str(tmp_path / "jax"), fresh.state, "1", fresh.config)
    got = torch_to_jax(fresh.state.dis.state_dict())
    want = {**jax_ckpt._flatten(jstate.params_dis), **jax_ckpt._flatten(jstate.sn_state)}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
