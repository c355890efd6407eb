"""One DeepVoxels train step of the port against the JAX package's, from the
same (bridged) state and with the JAX step's own random draws injected; plus
checkpoint interchange. The tiny CPU runs of the port's CLI are in
``tests/test_torch_deepvoxels_cli.py``.

Both sides: ch 16, batch 2, accumulative occlusion net, rotate loss on, R1
on, focal gamma 2, EMA on, the dense gather lift (what either package
resolves to on the CPU). The initial weights are perturbed by seeded noise,
as in ``tests/test_torch_step.py``: Adam's first step (beta1 = 0) moves every
parameter element by alpha times the sign of its gradient, so an element
whose gradient vanishes in exact arithmetic moves by +-alpha on float32 noise
in either package.

Tolerance: atol 1e-4 on the losses and on the updated parameters (a step
moves each parameter by about alpha = 1e-3). The elements whose gradient is
below ``NOISE_REL`` times their tensor's largest or below ``NOISE_ABS``
(inputs of dead units, the tails of the refiner's multi-million-element
kernels), and the biases in front of a leaky ReLU and an instance norm
(``CANCELLING``: their gradient is a sum that cancels to almost nothing, and
to nothing where the ReLU is linear), are held only to the bound that each
package moves them by at most alpha: their sign is float32 noise.
Measured: 0.17 % of the generator's 25.3 M elements and 0.04 % of the
discriminator's differ by more than 1e-4, none with a gradient above 2.5e-3
of its tensor's largest; at least 99 % must agree. ``dis/loss_adv`` sees the
generator *after* that update (the D phase renders fresh latents through
it), so it carries those elements' noise: 7e-4 measured, atol 2e-3. The
discriminator's gradient carries it too, through the fakes: it is compared
itself, tensor by tensor, as the first moment that Adam with beta1 = 0 keeps
(the clipped gradient). Measured: relative L2 error at most 4.3e-3 and
largest difference at most 5.4e-3 of the tensor's largest element (2.4e-4 and
3.1e-4 in the blocks next to the image); both are held to 1e-2.
"""

import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_gan_tpu.core import Config as JaxConfig
from rgbd_gan_tpu.geometry.prior import CameraParamPrior as JaxPrior
from rgbd_gan_tpu.models.deepvoxels import DeepVoxelsGenerator as JaxDeepVoxelsGenerator
from rgbd_gan_tpu.models.deepvoxels import deepvoxels_make_hidden as jax_make_hidden
from rgbd_gan_tpu.models.discriminator import Discriminator as JaxDiscriminator
from rgbd_gan_tpu.train import checkpoint as jax_ckpt
from rgbd_gan_tpu.train.optim import make_optimizer as jax_make_optimizer
from rgbd_gan_tpu.train.state import TrainState as JaxTrainState
from rgbd_gan_tpu.train.steps import StepSpec as JaxStepSpec
from rgbd_gan_tpu.train.steps_deepvoxels import make_deepvoxels_train_step as jax_make_step
from rgbd_gan_tpu_torch.bridge import load_jax_params, module_to_jax, params_to_jax, torch_to_jax
from rgbd_gan_tpu_torch.core.config import Config
from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
from rgbd_gan_tpu_torch.train import checkpoint as ckpt
from rgbd_gan_tpu_torch.train.steps import StepSpec
from rgbd_gan_tpu_torch.train.trainer import Trainer

# the suite runs several worker processes at once: leave them the other cores
torch.set_num_threads(2)

CH, BATCH, ALPHA = 16, 2, 0.0
ATOL = 1e-4
ATOL_AFTER_UPDATE = 2e-3
DIS_GRAD_RTOL = 1e-2
NOISE_REL, NOISE_ABS = 3e-3, 3e-5
CANCELLING = re.compile(r"style_generator/c[01456]/bias|voxel_gen/block\d/b[01]")
CFG = dict(
    generator_architecture="deepvoxels", ch=CH, batchsize=BATCH, res_dis=True, sn=False,
    adam_alpha_g=0.001, adam_alpha_d=0.003, adam_beta1=0.0, adam_beta2=0.999,
    lambda_gp=1.0, lambda_depth=10, depth_min=0.6, keep_smoothed_gen=True, smoothing=0.999,
    focal_loss_gamma=2.0, occlusion_type="accumulative", uniform_distribution=True,
    stage_interval="0,0,0,0,0,0,0,0", max_stage=11, start_rotation=-1, start_occlusion_aware=0,
    x_rotate=0.3054, y_rotate=3.1415, z_rotate=0, x_translate=0, y_translate=0, z_translate=0,
    iteration=2, display_interval=1, snapshot_interval=2,
)
METRICS = ["gen/loss_adv", "gen/loss_rotate", "dis/loss_gp", "dis/loss_adv"]


@pytest.fixture
def scratch(tmp_path):
    """A directory emptied when the test ends: a DeepVoxels snapshot holds the
    refiner's 25 M parameters several times over (about 300 MB a tag)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


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
    gen = JaxDeepVoxelsGenerator(CH, occlusion_type="accumulative", lift_mode="gather")
    dis = JaxDiscriminator(ch=CH, res=True)
    params_gen, params_dis = _unflatten(gflat), _unflatten(dflat)
    opt_map = jax_make_optimizer(cfg.adam_alpha_g / 100, 0.0, 0.999)
    opt_gen = jax_make_optimizer(cfg.adam_alpha_g, 0.0, 0.999)
    opt_dis = jax_make_optimizer(cfg.adam_alpha_d, 0.0, 0.999)
    state = JaxTrainState(
        params_gen=params_gen, params_dis=params_dis,
        opt_map=opt_map.init(params_gen["mapping"]), opt_gen=opt_gen.init(params_gen),
        opt_dis=opt_dis.init(params_dis),
        ema_gen=jax.tree_util.tree_map(jnp.copy, params_gen), sn_state=None, iteration=jnp.int32(0),
        gen_state=None,
    )
    spec = JaxStepSpec(
        architecture="deepvoxels", stage_floor=8, batch_size=BATCH, use_rotate=True,
        occlusion_aware=True, keep_smoothed_gen=True, lambda_gp=1.0, lambda_depth=10.0,
        depth_min=0.6, gather_mode="xla", max_stage=11,
    )
    prior = JaxPrior(cfg)
    make_hidden = lambda k, n: jax_make_hidden(k, n, CH)  # noqa: E731
    step = jax_make_step(gen, dis, make_hidden, prior, opt_map, opt_gen, opt_dis, spec, focal_loss_gamma=2.0)
    return step, state, prior


@pytest.fixture(scope="module")
def one_step():
    data = synthetic_dataset(BATCH, 64, seed=5)
    trainer = Trainer(Config(CFG), dataset=data, seed=0, device="cpu")
    assert trainer.state.gen.lift_mode == "gather"
    rng = np.random.RandomState(0)
    gflat = _perturbed(torch_to_jax(trainer.state.gen.state_dict()), rng)
    dflat = _perturbed(torch_to_jax(trainer.state.dis.state_dict()), rng)
    load_jax_params(trainer.state.gen, gflat)
    load_jax_params(trainer.state.ema_gen, gflat)
    load_jax_params(trainer.state.dis, dflat)
    jstep, jstate, jprior = _jax_step_and_state(gflat, dflat)

    # the JAX step's own draws (steps_deepvoxels.py:94-99, 167-168), injected into the port
    key = jax.random.PRNGKey(4)
    kz, kz2, ktheta, _, kdz, kdz2, _ = jax.random.split(key, 7)
    half = BATCH // 2
    draws = dict(
        z=jnp.tile(jax_make_hidden(kz, half, CH), (2, 1)), z2=jnp.tile(jax_make_hidden(kz2, half, CH), (2, 1)),
        thetas6=jprior.sample(ktheta, BATCH),
        z_d=jax_make_hidden(kdz, BATCH, CH), z2_d=jax_make_hidden(kdz2, BATCH, CH),
    )
    x = data.transpose(0, 2, 3, 1)  # uint8 NHWC
    new_jstate, jmetrics = jax.jit(jstep)(jstate, jnp.asarray(x), jnp.float32(ALPHA), key)
    draws = {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}

    spec = trainer._spec_for(0, 0)
    assert spec == StepSpec(
        stage_floor=8, batch_size=BATCH, use_rotate=True, occlusion_aware=True, keep_smoothed_gen=True,
        lambda_gp=1.0, lambda_depth=10, depth_min=0.6, max_stage=11,
    )
    # the generator's gradients as the whole-generator optimizer receives them, for the noise mask
    opt_gen, seen = trainer.state.opt_gen, {}
    opt_step = opt_gen.step

    def recording_step(grads):
        seen.update({k: torch.zeros_like(p) if g is None else g.clone()
                     for k, p, g in zip(opt_gen.names, opt_gen.params, grads)})
        return opt_step(grads)

    opt_gen.step = recording_step
    state, metrics = trainer._step(spec)(trainer.state, torch.from_numpy(x.copy()), ALPHA, **draws)
    opt_gen.step = opt_step
    grads = torch_to_jax(seen)
    return trainer, state, metrics, new_jstate, jmetrics, gflat, grads


@pytest.mark.parametrize("name", METRICS)
def test_step_metrics_match(one_step, name):
    _, _, metrics, _, jmetrics, _, _ = one_step
    atol = ATOL_AFTER_UPDATE if name == "dis/loss_adv" else ATOL
    np.testing.assert_allclose(float(metrics[name]), float(jmetrics[name]), atol=atol)


def _assert_updated_like(got, want, before, grads, alpha):
    """Equal within ATOL where the gradient is above the noise; elsewhere each
    side moved by at most alpha. Returns the number of elements off by more
    than ATOL."""
    assert got.keys() == want.keys()
    off = 0
    for k in want:
        g = np.abs(grads[k])
        clear = (g > max(NOISE_REL * g.max(), NOISE_ABS)) & (CANCELLING.fullmatch(k) is None)
        np.testing.assert_allclose(got[k][clear], want[k][clear], atol=ATOL, err_msg=k)
        bound = alpha * (1 + 1e-4) + 1e-7
        assert np.abs(got[k] - before[k])[~clear].max(initial=0) <= bound, k
        assert np.abs(want[k] - before[k])[~clear].max(initial=0) <= bound, k
        off += int((np.abs(got[k] - want[k]) > ATOL).sum())
    return off


def test_step_updated_generator_matches_with_the_mapping_s_double_update(one_step):
    _, state, _, jstate, _, before, grads = one_step
    got, want = torch_to_jax(state.gen.state_dict()), jax_ckpt._flatten(jstate.params_gen)
    # the mapping took alpha/100 from its own optimizer and alpha from the whole-generator one
    total = sum(v.size for v in want.values())
    off = _assert_updated_like(got, want, before, grads, CFG["adam_alpha_g"] * 1.01)
    assert off < 0.01 * total, (off, total)
    moved = np.abs(got["mapping/l0/kernel"] - before["mapping/l0/kernel"])
    assert np.isclose(np.median(moved), CFG["adam_alpha_g"] * 1.01, rtol=1e-3)
    untouched = np.abs(got["camera_param_generator/l0/kernel"] - before["camera_param_generator/l0/kernel"])
    assert untouched.max() == 0  # no gradient: a zero update, but a counted one


def test_step_updated_discriminator_matches(one_step):
    """D's gradient comes through the fakes of the *updated* generator, so
    its elements' signs carry that noise too: the bulk must agree."""
    _, state, _, jstate, _, _, _ = one_step
    got, want = torch_to_jax(state.dis.state_dict()), jax_ckpt._flatten(jstate.params_dis)
    assert got.keys() == want.keys()
    close = sum(int((np.abs(got[k] - want[k]) <= ATOL).sum()) for k in want)
    total = sum(v.size for v in want.values())
    assert close >= 0.99 * total, (close, total)
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= 2 * CFG["adam_alpha_d"] * (1 + 1e-4), k


def test_step_discriminator_gradient_matches(one_step):
    """The updated parameters above are a sign test after Adam's first step;
    this holds the gradient's magnitude. With beta1 = 0 either optimizer's
    first moment is the clipped gradient of this step."""
    _, state, _, jstate, _, _, _ = one_step
    got = torch_to_jax(dict(zip(state.opt_dis.names, state.opt_dis.mu)))
    prefix = "1/0/mu/"
    want = {k[len(prefix):]: np.asarray(v) for k, v in jax_ckpt._flatten(jstate.opt_dis).items()
            if k.startswith(prefix)}
    assert got.keys() == want.keys()
    assert sum(float(np.abs(v).max()) > 0 for v in want.values()) >= 30
    for k, w in want.items():
        largest, norm = np.abs(w).max(), np.linalg.norm(w)
        assert np.abs(got[k] - w).max() <= DIS_GRAD_RTOL * largest, k
        assert np.linalg.norm(got[k] - w) <= DIS_GRAD_RTOL * norm, k


def test_step_ema_tracks_the_updated_generator(one_step):
    _, state, _, jstate, _, before, _ = one_step
    got, want = params_to_jax(state.ema_gen), jax_ckpt._flatten(jstate.ema_gen)
    assert got.keys() == want.keys()
    for k in want:  # tau = 0.001 of a step of at most 2 alpha
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)


def test_step_counts_and_flags(one_step):
    _, state, metrics, jstate, jmetrics, _, _ = one_step
    assert state.iteration == int(jstate.iteration) == 1
    assert not bool(metrics["nan"]) and not bool(jmetrics["nan"])
    assert float(metrics["image_size"]) == float(jmetrics["image_size"]) == 64.0
    assert float(metrics["stage"]) == float(jmetrics["stage"]) == 8.5
    assert state.opt_gen.count == state.opt_map.count == state.opt_dis.count == 1
    assert len(state.opt_gen.params) == len(list(state.gen.parameters()))


def test_checkpoints_interchange_exactly(one_step, scratch):
    trainer, state, _, jstate, _, _, _ = one_step
    ckpt.save_snapshot(str(scratch), state, trainer.rng.get_state(), "1", trainer.config)
    # the JAX package reads the port's files into its own trees, exactly
    gen_tree = jax_ckpt.load_tree(str(scratch / "Generator_1.npz"), jstate.params_gen, strict=True)
    map_tree = jax_ckpt.load_tree(str(scratch / "Map_1.npz"), jstate.params_gen["mapping"], strict=True)
    trainer_tree = jax_ckpt.load_tree(
        str(scratch / "snapshot_iter_1.npz"),
        {"opt_map": jstate.opt_map, "opt_gen": jstate.opt_gen, "opt_dis": jstate.opt_dis,
         "iteration": jstate.iteration},
        strict=True,
    )
    got = torch_to_jax(state.gen.state_dict())
    for k, v in jax_ckpt._flatten(gen_tree).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for k, v in jax_ckpt._flatten(map_tree).items():
        np.testing.assert_array_equal(got["mapping/" + k], v, err_msg=k)
    nu = jax_ckpt._flatten(trainer_tree["opt_gen"])
    names = state.opt_gen.names
    np.testing.assert_array_equal(
        nu["1/0/nu/voxel_gen/block1/c0/kernel"],
        torch_to_jax({"w.weight": state.opt_gen.nu[names.index("voxel_gen.block1.c0.weight")]})["w/kernel"],
    )
    assert "1/0/mu/mapping/l0/kernel" in nu and "1/0/mu/camera_param_generator/l2/bias" in nu
    assert int(trainer_tree["iteration"]) == 1

    # and the port reads the JAX package's files, exactly
    jax_ckpt.save_snapshot(str(scratch / "jax"), jstate, jax.random.PRNGKey(0), "1", JaxConfig(CFG))
    assert os.path.exists(scratch / "jax" / "Map_1.npz")
    fresh = Trainer(Config(CFG), dataset=synthetic_dataset(BATCH, 64), seed=1, device="cpu")
    assert ckpt.load_snapshot(str(scratch / "jax"), fresh.state, "1", fresh.config) is None
    for module, tree in ((fresh.state.gen, jstate.params_gen), (fresh.state.dis, jstate.params_dis),
                         (fresh.state.ema_gen, jstate.ema_gen)):
        got, want = torch_to_jax(module.state_dict()), jax_ckpt._flatten(tree)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert fresh.state.iteration == 1 and fresh.state.opt_gen.count == 1


def test_batch_stats_checkpoint_layout_interchanges(scratch):
    """The softmax occlusion net's generator file: ``params/`` and
    ``batch_stats/``, read by the JAX loader into a flax variable tree."""
    cfg = dict(CFG, occlusion_type="deepvoxels", keep_smoothed_gen=False, out=str(scratch))
    trainer = Trainer(Config(cfg), dataset=synthetic_dataset(BATCH, 64), seed=0, device="cpu")
    stats = {k: v for k, v in trainer.state.gen.state_dict().items() if k.endswith((".mean", ".var"))}
    assert len(stats) == 4
    for v in stats.values():
        v.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(3))
    trainer.save("7")
    flat = ckpt.load_tree(os.path.join(trainer.out, "Generator_7.npz"))
    assert flat.keys() == module_to_jax(trainer.state.gen).keys()
    assert {k.split("/")[0] for k in flat} == {"params", "batch_stats"}
    assert sorted(k for k in flat if k.startswith("batch_stats/")) == sorted(
        f"batch_stats/occlusion_net/{bn}/{s}" for bn in ("prep_bn", "net_bn") for s in ("mean", "var"))

    jgen = JaxDeepVoxelsGenerator(CH, occlusion_type="deepvoxels", lift_mode="gather")
    from rgbd_gan_tpu.geometry.camera import camera_matrices as jax_camera_matrices

    z = jnp.zeros((1, CH))
    template = jax.eval_shape(
        lambda: jgen.init(jax.random.PRNGKey(0), z, jax_camera_matrices(jnp.zeros((1, 6))), z, None,
                          method=jgen.init_all))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(template))
    tree = jax_ckpt.load_tree(os.path.join(trainer.out, "Generator_7.npz"), template, strict=True)
    want = jax_ckpt._flatten(tree)
    assert want.keys() == flat.keys()
    for k in want:
        np.testing.assert_array_equal(want[k], flat[k], err_msg=k)

    fresh = Trainer(Config(cfg), dataset=synthetic_dataset(BATCH, 64), seed=1, device="cpu")
    ckpt.load_snapshot(trainer.out, fresh.state, "7", fresh.config)
    for k, v in trainer.state.gen.state_dict().items():
        np.testing.assert_array_equal(fresh.state.gen.state_dict()[k].numpy(), v.numpy(), err_msg=k)
