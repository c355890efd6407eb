"""The port's legacy RGB StyleGAN step, its auxiliary losses, the learning-rate
table and the legacy schedule against the JAX package's, on the CPU.

- ``get_lr_scale_factor`` over every row of the table (and an unknown
  device count) at integer and fractional stages 0-20, ``legacy_stage_at``,
  ``loss_func_dsgan`` and ``calc_distance`` on seeded numpy inputs: exactly,
  or to float32 rounding (rtol 1e-6).
- One legacy step (``make_legacy_train_step``), its JAX twin compiled once
  (without XLA's backend optimisations) in the module-scoped fixture: StyleGAN with an RGB head, ch 16, batch 4,
  stage 9 at alpha 0.5 with ``total_devices=8``, where the table's factor is
  1.5 (no stage below 9 has a factor other than 1, so the reals are 128 px),
  style mixing forced on (rate 1), R1, EMA on, the JAX step's own latents
  injected. The losses and every updated parameter within atol 1e-4, as in
  ``tests/test_torch_step.py``; the elements of ``gen/block0/b0`` and
  ``gen/block0/b1`` whose gradient vanishes in exact arithmetic (see
  ``tests/test_torch_rgb_step.py``) only within alpha of where they started.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_gan_tpu.core.stage import legacy_stage_at as jax_legacy_stage_at
from rgbd_gan_tpu.models.discriminator import Discriminator as JaxDiscriminator
from rgbd_gan_tpu.models.generators import StyleGANGenerator as JaxStyleGANGenerator
from rgbd_gan_tpu.models.generators import stylegan_make_hidden as jax_make_hidden
from rgbd_gan_tpu.train import checkpoint as jax_ckpt
from rgbd_gan_tpu.train.legacy import calc_distance as jax_calc_distance
from rgbd_gan_tpu.train.legacy import loss_func_dsgan as jax_loss_func_dsgan
from rgbd_gan_tpu.train.legacy import make_legacy_train_step as jax_make_legacy_step
from rgbd_gan_tpu.train.optim import LR_SCALE_TABLE as JAX_LR_SCALE_TABLE
from rgbd_gan_tpu.train.optim import get_lr_scale_factor as jax_get_lr_scale_factor
from rgbd_gan_tpu.train.optim import make_optimizer as jax_make_optimizer
from rgbd_gan_tpu.train.optim import make_stylegan_gen_optimizer as jax_make_gen_optimizer
from rgbd_gan_tpu.train.state import TrainState as JaxTrainState
from rgbd_gan_tpu.train.steps import StepSpec as JaxStepSpec
from rgbd_gan_tpu_torch.bridge import load_jax_params, torch_to_jax
from rgbd_gan_tpu_torch.core.stage import legacy_stage_at
from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
from rgbd_gan_tpu_torch.models.discriminator import Discriminator
from rgbd_gan_tpu_torch.models.generators import StyleGANGenerator, mapping_make_hidden
from rgbd_gan_tpu_torch.train.ema import copy_params
from rgbd_gan_tpu_torch.train.legacy import calc_distance, loss_func_dsgan, make_legacy_train_step
from rgbd_gan_tpu_torch.train.optim import (
    LR_SCALE_TABLE,
    get_lr_scale_factor,
    make_optimizer,
    make_stylegan_gen_optimizer,
)
from rgbd_gan_tpu_torch.train.state import TrainState
from rgbd_gan_tpu_torch.train.steps import StepSpec
from test_torch_rgb_step import _vanishing

# the suite runs several worker processes at once: leave them the other cores
torch.set_num_threads(2)

CH, BATCH, STAGE, ALPHA, DEVICES = 16, 4, 9, 0.5, 8
ATOL, RTOL = 1e-4, 1e-6
ALPHA_G, ALPHA_D = 0.001, 0.003


@pytest.mark.parametrize("devices", sorted(JAX_LR_SCALE_TABLE) + [5])
def test_lr_scale_factor_matches_jax_over_the_table(devices):
    assert LR_SCALE_TABLE == JAX_LR_SCALE_TABLE
    for stage in [s / 2 for s in range(41)]:
        assert get_lr_scale_factor(devices, stage) == jax_get_lr_scale_factor(devices, stage), stage
    assert get_lr_scale_factor(DEVICES, STAGE) == 1.5


def test_legacy_stage_and_mapping_latent():
    for it in (0, 50, 100, 250, 10**6):
        assert legacy_stage_at(it, 100, 11) == jax_legacy_stage_at(it, 100, 11)
    z = mapping_make_hidden(torch.Generator().manual_seed(0), 512, CH)
    assert z.shape == (512, CH) and z.dtype == torch.float32
    assert abs(float(z.mean())) < 0.05 and abs(float(z.std()) - 1.0) < 0.05  # plain N(0, 1), not normalised


@pytest.mark.parametrize("channels", [3, 4])
def test_loss_func_dsgan_matches_jax(channels):
    rng = np.random.RandomState(channels)
    x = rng.randn(6, 8, 8, channels).astype("f")
    z = rng.randn(6, 32).astype("f")
    theta = rng.randn(6, 9).astype("f")
    want = float(jax.jit(jax_loss_func_dsgan, static_argnames="tau")(x, z, theta, tau=2.0))
    got = float(loss_func_dsgan(torch.tensor(x), torch.tensor(z), torch.tensor(theta), tau=2.0))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_calc_distance_matches_jax():
    rng = np.random.RandomState(0)
    est, theta = rng.randn(5, 9).astype("f"), rng.randn(7, 9).astype("f")
    want = float(jax.jit(jax_calc_distance)(est, theta))
    np.testing.assert_allclose(float(calc_distance(torch.tensor(est), torch.tensor(theta))), want, rtol=RTOL)
    assert abs(float(calc_distance(torch.tensor(est), torch.tensor(est)))) < 1e-4


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)
    return tree


@pytest.fixture(scope="module")
def one_step():
    g = torch.Generator().manual_seed(0)
    gen, dis = StyleGANGenerator(CH, rgbd=False, generator=g), Discriminator(ch=CH, res=True, generator=g)
    rng = np.random.RandomState(3)
    gflat, dflat = ({k: (v + 0.05 * rng.randn(*v.shape)).astype(v.dtype) for k, v in torch_to_jax(m.state_dict()).items()}
                    for m in (gen, dis))
    load_jax_params(gen, gflat)
    load_jax_params(dis, dflat)
    state = TrainState(
        gen=gen.requires_grad_(False), dis=dis.requires_grad_(False),
        opt_map=make_optimizer(gen.mapping.named_parameters(), ALPHA_G / 100, 0.0, 0.999),
        opt_gen=make_stylegan_gen_optimizer(gen.gen.named_parameters(), ALPHA_G, 0.0, 0.999, rgbd=False),
        opt_dis=make_optimizer(dis.named_parameters(), ALPHA_D, 0.0, 0.999), ema_gen=copy_params(gen),
    )
    spec = StepSpec(stage_floor=STAGE, batch_size=BATCH, keep_smoothed_gen=True, style_mixing_rate=1.0)

    params_gen, params_dis = _unflatten(gflat), _unflatten(dflat)
    opt_map = jax_make_optimizer(ALPHA_G / 100, 0.0, 0.999)
    opt_gen = jax_make_gen_optimizer(ALPHA_G, 0.0, 0.999, rgbd=False)
    opt_dis = jax_make_optimizer(ALPHA_D, 0.0, 0.999)
    jstate = JaxTrainState(
        params_gen=params_gen, params_dis=params_dis, opt_map=jax.jit(opt_map.init)(params_gen["mapping"]),
        opt_gen=jax.jit(opt_gen.init)(params_gen["gen"]), opt_dis=jax.jit(opt_dis.init)(params_dis),
        ema_gen=params_gen, sn_state=None, iteration=jnp.int32(0),
    )
    jspec = JaxStepSpec(architecture="stylegan", stage_floor=STAGE, batch_size=BATCH, keep_smoothed_gen=True,
                        style_mixing_rate=1.0)
    jmake_hidden = lambda k, n: jax_make_hidden(k, n, CH)  # noqa: E731
    jstep = jax_make_legacy_step(JaxStyleGANGenerator(CH, rgbd=False), JaxDiscriminator(ch=CH, res=True),
                                 jmake_hidden, opt_map, opt_gen, opt_dis, jspec, total_devices=DEVICES)
    key = jax.random.PRNGKey(4)
    x = synthetic_dataset(BATCH, 128, seed=5).transpose(0, 2, 3, 1)
    args = (jstate, jnp.asarray(x), jnp.float32(ALPHA), key)
    # the same program, compiled without XLA's backend optimisations: 4.1-4.9 s instead of about 8
    compiled = jax.jit(jstep).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})
    new_jstate, jmetrics = compiled(*args)

    # the JAX step's own draws (legacy.py:78-84, :90): G phase from kg, D phase from kd
    def latents(key):
        kz, _, kz2 = jax.random.split(key, 3)
        return jmake_hidden(kz, BATCH), jmake_hidden(kz2, BATCH)

    draws = {}
    for phase, z, z2 in zip(("", "_d"), *jax.jit(jax.vmap(latents))(jax.random.split(key))):
        draws.update({"z" + phase: torch.tensor(np.asarray(z)), "z2" + phase: torch.tensor(np.asarray(z2)),
                      "mix" + phase: True})
    step = make_legacy_train_step(None, spec, total_devices=DEVICES)
    conv_out = []  # block0's c1 output in the G phase's forward (the first of the step's two)
    hook = gen.gen.block0.c1.register_forward_hook(lambda m, i, o: conv_out.append(o.detach().numpy().copy()))
    _, metrics = step(state, torch.from_numpy(x.copy()), ALPHA, **draws)
    hook.remove()
    return state, metrics, new_jstate, jmetrics, gflat, _vanishing(gflat, conv_out[0])


@pytest.mark.parametrize("name", ["gen/loss_adv", "dis/loss_adv", "dis/loss_gp", "stage", "image_size"])
def test_legacy_step_metrics_match(one_step, name):
    _, metrics, _, jmetrics, _, _ = one_step
    np.testing.assert_allclose(float(metrics[name]), float(jmetrics[name]), atol=ATOL)


@pytest.mark.parametrize("tree", ["gen", "dis", "ema"])
def test_legacy_step_updated_params_match(one_step, tree):
    state, _, jstate, _, before, vanishing = one_step
    module, jtree = {"gen": (state.gen, jstate.params_gen), "dis": (state.dis, jstate.params_dis),
                     "ema": (state.ema_gen, jstate.ema_gen)}[tree]
    want = jax_ckpt._flatten(jtree)
    got = torch_to_jax(module.state_dict())
    assert got.keys() == want.keys()
    for k in want:
        mask = vanishing.get(k) if tree == "gen" else None
        if mask is not None:
            alpha = ALPHA_G * (1 + 1e-5)
            assert np.abs(got[k] - before[k])[mask].max(initial=0) <= alpha
            assert np.abs(want[k] - before[k])[mask].max(initial=0) <= alpha
            np.testing.assert_allclose(got[k][~mask], want[k][~mask], atol=ATOL, err_msg=k)
            continue
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, err_msg=k)


def test_legacy_step_counts_and_refusals(one_step):
    state, metrics, jstate, _, _, _ = one_step
    assert state.iteration == int(jstate.iteration) == 1 and not bool(metrics["nan"])
    assert float(metrics["image_size"]) == 128.0
    # data parallelism builds a step (averaging held in tests/test_torch_parallel.py)
    assert callable(make_legacy_train_step(None, StepSpec(stage_floor=STAGE, batch_size=BATCH, axis_name="data")))
