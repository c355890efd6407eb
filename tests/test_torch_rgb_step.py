"""The port's RGB train step (``rgb: True``, the reference's ``RGBUpdater``)
against the JAX package's ``make_rgb_train_step`` on the CPU, from the same
(bridged) weights and with the JAX step's own latents injected.

Three runs, each JAX step jitted once in the module-scoped fixture (the
three in threads, so that XLA compiles them at once):

- StyleGAN, R1 every step, one step;
- DCGAN, ``r1_interval: 2`` (lazy R1), two steps: the penalty on the first,
  none on the second;
- DCGAN with spectral norm (no R1), one step; the SN vectors after it.

ch 16 (DCGAN: in_ch 16, hidden 32), batch 4, stage 6 (32 px), EMA on; the
weights are the port's init perturbed by seeded noise. Tolerance: atol 1e-4
on every loss and every updated parameter (a step moves each by about
alpha = 1e-3), 1e-5 on the SN vectors. A bias of the StyleGAN generator's
4x4 block in front of a leaky ReLU and an instance norm has a gradient that
vanishes in exact arithmetic in every channel whose pre-activations keep one
sign over each sample's 4x4 map (the ReLU is linear there and the norm
removes the shift): all of ``gen/block0/b0`` (the positive constant), and
the channels of ``gen/block0/b1`` found so in the step's forward. Adam
turns float32 noise into a step of up to alpha there in either package, so
for those elements the test checks only that each package moved them by at
most alpha.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_gan_tpu.models.discriminator import Discriminator as JaxDiscriminator
from rgbd_gan_tpu.models.generators import DCGANGenerator as JaxDCGANGenerator
from rgbd_gan_tpu.models.generators import StyleGANGenerator as JaxStyleGANGenerator
from rgbd_gan_tpu.models.generators import dcgan_make_hidden as jax_dcgan_hidden
from rgbd_gan_tpu.models.generators import stylegan_make_hidden as jax_stylegan_hidden
from rgbd_gan_tpu.train import checkpoint as jax_ckpt
from rgbd_gan_tpu.train.optim import make_optimizer as jax_make_optimizer
from rgbd_gan_tpu.train.optim import make_stylegan_gen_optimizer as jax_make_gen_optimizer
from rgbd_gan_tpu.train.state import TrainState as JaxTrainState
from rgbd_gan_tpu.train.steps import StepSpec as JaxStepSpec
from rgbd_gan_tpu.train.steps import make_rgb_train_step as jax_make_rgb_step
from rgbd_gan_tpu_torch.bridge import load_jax_params, torch_to_jax
from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
from rgbd_gan_tpu_torch.models.discriminator import Discriminator
from rgbd_gan_tpu_torch.models.generators import DCGANGenerator, StyleGANGenerator
from rgbd_gan_tpu_torch.train.ema import copy_params
from rgbd_gan_tpu_torch.train.optim import make_optimizer, make_stylegan_gen_optimizer
from rgbd_gan_tpu_torch.train.state import TrainState
from rgbd_gan_tpu_torch.train.steps import StepSpec, make_rgb_train_step

# the suite runs several worker processes at once: leave them the other cores
torch.set_num_threads(2)

CH, HIDDEN, BATCH, STAGE = 16, 32, 4, 6
ATOL, SN_ATOL = 1e-4, 1e-5
ALPHA_G, ALPHA_D = 0.001, 0.003
RUNS = {
    "stylegan_r1": dict(architecture="stylegan", r1_interval=1, sn=False, steps=1),
    "dcgan_lazy_r1": dict(architecture="dcgan", r1_interval=2, sn=False, steps=2),
    "dcgan_sn": dict(architecture="dcgan", r1_interval=1, sn=True, steps=1),
}


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
    """Seeded noise on every parameter; SN vectors stay unit vectors."""
    return {k: v.copy() if k.endswith("/u") else (v + 0.05 * rng.randn(*v.shape)).astype(v.dtype)
            for k, v in flat.items()}


def _models(architecture, sn):
    g = torch.Generator().manual_seed(0)
    if architecture == "stylegan":
        gen = StyleGANGenerator(CH, rgbd=False, generator=g)
        jgen = JaxStyleGANGenerator(CH, rgbd=False)
    else:
        gen = DCGANGenerator(in_ch=CH, ch=HIDDEN, rgbd=False, generator=g)
        jgen = JaxDCGANGenerator(in_ch=CH, ch=HIDDEN, rgbd=False)
    return gen, Discriminator(ch=CH, res=True, sn=sn, generator=g), jgen, JaxDiscriminator(ch=CH, res=True, sn=sn)


def _vanishing(gflat, conv_out):
    """The elements of block0's biases whose gradient vanishes in exact
    arithmetic (see above): pre-activations of one sign over each sample's
    map, for ``b0`` from the constant, for ``b1`` from ``conv_out``, the
    output of ``c1`` in the step's forward."""

    def one_sign(pre):  # (B, H, W, C) -> (C,)
        return np.all((pre >= 0).all(axis=(1, 2)) | (pre <= 0).all(axis=(1, 2)), axis=0)

    b0 = one_sign((gflat["gen/block0/const"] + gflat["gen/block0/b0"])[None])
    return {"gen/block0/b0": b0, "gen/block0/b1": one_sign(conv_out + gflat["gen/block0/b1"])}


def _run(name, architecture, r1_interval, sn, steps):
    gen, dis, jgen, jdis = _models(architecture, sn)
    rng = np.random.RandomState(len(name))
    gflat = _perturbed(torch_to_jax(gen.state_dict()), rng)
    dflat = _perturbed(torch_to_jax(dis.state_dict()), rng)
    load_jax_params(gen, gflat)
    load_jax_params(dis, dflat)
    stylegan = architecture == "stylegan"
    state = TrainState(
        gen=gen.requires_grad_(False), dis=dis.requires_grad_(False),
        opt_map=make_optimizer(gen.mapping.named_parameters(), ALPHA_G / 100, 0.0, 0.999) if stylegan else None,
        opt_gen=(make_stylegan_gen_optimizer(gen.gen.named_parameters(), ALPHA_G, 0.0, 0.999, rgbd=False)
                 if stylegan else make_optimizer(gen.named_parameters(), ALPHA_G, 0.0, 0.999)),
        opt_dis=make_optimizer(dis.named_parameters(), ALPHA_D, 0.0, 0.999), ema_gen=copy_params(gen),
    )
    spec = StepSpec(stage_floor=STAGE, batch_size=BATCH, architecture=architecture, keep_smoothed_gen=True,
                    r1_interval=r1_interval, sn=sn, max_stage=7)

    params_gen = _unflatten(gflat)
    params_dis = _unflatten({k: v for k, v in dflat.items() if not k.endswith("/u")})
    sn_state = _unflatten({k: v for k, v in dflat.items() if k.endswith("/u")}) if sn else None
    if stylegan:
        opt_map = jax_make_optimizer(ALPHA_G / 100, 0.0, 0.999)
        opt_gen = jax_make_gen_optimizer(ALPHA_G, 0.0, 0.999, rgbd=False)
        jmake_hidden = lambda k, n: jax_stylegan_hidden(k, n, CH)  # noqa: E731
        opt_states = dict(opt_map=jax.jit(opt_map.init)(params_gen["mapping"]),
                          opt_gen=jax.jit(opt_gen.init)(params_gen["gen"]))
    else:
        opt_map, opt_gen = None, jax_make_optimizer(ALPHA_G, 0.0, 0.999)
        jmake_hidden = lambda k, n: jax_dcgan_hidden(k, n, CH)  # noqa: E731
        opt_states = dict(opt_map=None, opt_gen=jax.jit(opt_gen.init)(params_gen))
    opt_dis = jax_make_optimizer(ALPHA_D, 0.0, 0.999)
    jstate = JaxTrainState(
        params_gen=params_gen, params_dis=params_dis, opt_dis=jax.jit(opt_dis.init)(params_dis),
        ema_gen=params_gen, sn_state=sn_state, iteration=jnp.int32(0),
        **opt_states,
    )
    jspec = JaxStepSpec(architecture=architecture, stage_floor=STAGE, batch_size=BATCH, keep_smoothed_gen=True,
                        r1_interval=r1_interval, sn=sn, max_stage=7)
    jstep = jax.jit(jax_make_rgb_step(jgen, jdis, jmake_hidden, opt_map, opt_gen, opt_dis, jspec))
    step = make_rgb_train_step(None, spec)
    conv_out = []
    if stylegan:  # block0's c1 output in the first step's G forward
        hook = gen.gen.block0.c1.register_forward_hook(lambda m, i, o: conv_out.append(o.detach().numpy().copy()))

    # the JAX step's own draw (steps.py:408-409), in one compiled call
    draw = jax.jit(lambda key: jnp.concatenate([jmake_hidden(jax.random.split(key, 1)[0], BATCH // 2)] * 2))
    metrics, jmetrics = [], []
    data = synthetic_dataset(BATCH * steps, 32, seed=5).transpose(0, 2, 3, 1)
    for i in range(steps):
        x = data[i * BATCH:(i + 1) * BATCH]
        key = jax.random.PRNGKey(10 + i)
        z = draw(key)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.float32(0.0), key)
        _, m = step(state, torch.from_numpy(x.copy()), 0.0, z=torch.tensor(np.asarray(z)))
        metrics.append({k: float(v) for k, v in m.items()})
        jmetrics.append({k: float(v) for k, v in jm.items()})
    vanishing = {}
    if stylegan:
        hook.remove()
        vanishing = _vanishing(gflat, conv_out[0])
    return dict(state=state, jstate=jstate, metrics=metrics, jmetrics=jmetrics, before=gflat, vanishing=vanishing)


@pytest.fixture(scope="module")
def runs():
    with ThreadPoolExecutor(len(RUNS)) as pool:
        futures = {name: pool.submit(_run, name, **run) for name, run in RUNS.items()}
        return {name: f.result() for name, f in futures.items()}


@pytest.mark.parametrize("name", list(RUNS))
def test_rgb_step_metrics_match(runs, name):
    r = runs[name]
    for i, (m, jm) in enumerate(zip(r["metrics"], r["jmetrics"])):
        assert m.keys() == jm.keys(), (i, sorted(m), sorted(jm))
        assert "gen/loss_rotate" not in m
        for k in m:
            np.testing.assert_allclose(m[k], jm[k], atol=ATOL, err_msg=f"step {i}: {k}")


@pytest.mark.parametrize("tree", ["gen", "dis", "ema"])
@pytest.mark.parametrize("name", list(RUNS))
def test_rgb_step_updated_params_match(runs, name, tree):
    r = runs[name]
    state, jstate = r["state"], r["jstate"]
    module, jtree = {"gen": (state.gen, jstate.params_gen), "dis": (state.dis, jstate.params_dis),
                     "ema": (state.ema_gen, jstate.ema_gen)}[tree]
    want = jax_ckpt._flatten(jtree)
    got = torch_to_jax(dict(module.named_parameters()))
    assert got.keys() == want.keys()
    for k in want:
        mask = r["vanishing"].get(k) if tree == "gen" else None
        if mask is not None:
            bound = ALPHA_G * RUNS[name]["steps"] * (1 + 1e-5)
            assert np.abs(got[k] - r["before"][k])[mask].max(initial=0) <= bound
            assert np.abs(want[k] - r["before"][k])[mask].max(initial=0) <= bound
            np.testing.assert_allclose(got[k][~mask], want[k][~mask], atol=ATOL, err_msg=k)
            continue
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, err_msg=k)


def test_lazy_r1_takes_the_penalty_on_the_first_step_only(runs):
    first, second = runs["dcgan_lazy_r1"]["metrics"]
    assert first["dis/loss_gp"] > 0 and second["dis/loss_gp"] == 0
    assert runs["dcgan_lazy_r1"]["state"].opt_map is None


def test_rgb_step_sn_vectors_match(runs):
    r = runs["dcgan_sn"]
    got = torch_to_jax(r["state"].dis.state_dict())
    want = jax_ckpt._flatten(r["jstate"].sn_state)
    assert want and all(k in got for k in want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=SN_ATOL, err_msg=k)
    assert "dis/loss_gp" not in r["metrics"][0]


@pytest.mark.parametrize("name", list(RUNS))
def test_rgb_step_counts(runs, name):
    r = runs[name]
    steps = RUNS[name]["steps"]
    assert r["state"].iteration == int(r["jstate"].iteration) == steps
    assert r["state"].opt_gen.count == r["state"].opt_dis.count == steps
    assert all(m["image_size"] == 32.0 and not m["nan"] for m in r["metrics"])


def test_rgb_generator_slows_no_parameter_by_name():
    """With ``rgbd=False`` no parameter is in the alpha/100 group, even one
    named ``l1`` or ``l2`` (the occupancy head's), and the empty group takes
    a step."""
    gen = StyleGANGenerator(8, rgbd=False, use_occupancy_net=True, generator=torch.Generator().manual_seed(0))
    opt = make_stylegan_gen_optimizer(gen.gen.named_parameters(), ALPHA_G, 0.0, 0.999, rgbd=False)
    (fast_start, fast_stop, _, _), (slow_start, slow_stop, _, slow_scale) = opt.group_slices
    assert fast_stop - fast_start == len(opt.params) and slow_start == slow_stop and slow_scale == 0.01
    assert any(n.split(".")[-2] in ("l1", "l2") for n in opt.names)
    before = [p.clone() for p in opt.params]
    opt.step([torch.ones_like(p) for p in opt.params])
    assert all(not torch.equal(a, b) for a, b in zip(before, opt.params))
    rgbd = make_stylegan_gen_optimizer(
        StyleGANGenerator(8, rgbd=True, generator=torch.Generator().manual_seed(0)).gen.named_parameters(),
        ALPHA_G, 0.0, 0.999, rgbd=True)
    assert {n.split(".")[0] for n in rgbd.names[rgbd.group_slices[1][0]:]} == {"l1", "l2"}
