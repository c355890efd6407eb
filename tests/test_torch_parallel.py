"""The port's data parallelism (``rgbd_gan_tpu_torch.parallel``) on two gloo
ranks on the CPU, against the JAX package's sharded step.

One spawn of two processes per module (a ``file://`` store under the
module's temporary directory) runs every leg; the JAX side runs in this
process meanwhile, on the first two devices of the virtual CPU mesh that
``conftest.py`` fakes.

- Parity: the two-rank port DCGAN RGBD step at ``tests/test_parallel.py``'s
  width (in_ch 16, hidden 32, 4 images a rank, 32 px, rotate on) against
  one JAX ``shard_train_step`` on ``make_mesh(jax.devices()[:2])``, from the
  same weights (the port's init perturbed by seeded noise, as in
  ``tests/test_torch_dcgan.py``, so that no gradient vanishes at a zero or
  one initial value), each rank given the draws of ``fold_in(key, rank)``
  and its shard of the batch. The averaged losses and every updated
  parameter within atol 1e-4 (a step moves a parameter by about alpha =
  1e-3); the noise gains, whose gradient is zero (noise is off), stay where
  they were in both packages. Both ranks end bit-identical.
- The NaN flag trips on every rank when only rank 0's shard is NaN.
- Each rank's stream of draws (``parallel.mesh.rank_seed``) differs; with
  one rank the seed is the run's own.
- Spectral norm: the SN vectors after a two-rank step are identical on both
  ranks.
- DeepVoxels with ``rendernet_projection`` (ch 8, 2 images a rank, R1): the
  running statistics after a two-rank step are identical on both ranks and
  equal the mean of each rank's single-process step on the same draws and
  images. The learning rates are 0 in this leg, so that both generator
  forwards of a rank see the same weights in the two steps (the second
  forward renders through the updated generator). Each rank's statistics
  differ from the other's, so the mean is not vacuous.
- A global batch that leaves an odd batch a rank (the DeepVoxels yml's 10
  over two ranks) is refused: every step draws its latents in pairs.
- Parity with the JAX step is up to one fault of the JAX package: its
  sharded step sums the devices' gradients where it means to average them
  (shown on a tiny ``shard_map`` below), so the port's mean is compared
  after scaling by the world size.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_gan_tpu.models.generators import dcgan_make_hidden as jax_make_hidden
from rgbd_gan_tpu.parallel import DATA_AXIS as JAX_DATA_AXIS
from rgbd_gan_tpu.parallel import make_mesh as jax_make_mesh
from rgbd_gan_tpu.parallel import shard_train_step
from rgbd_gan_tpu.parallel.mesh import replicate as jax_replicate
from rgbd_gan_tpu.parallel.mesh import shard_batch as jax_shard_batch
from rgbd_gan_tpu.train import checkpoint as jax_ckpt
from rgbd_gan_tpu_torch.bridge import torch_to_jax
from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
from rgbd_gan_tpu_torch.models.discriminator import Discriminator
from rgbd_gan_tpu_torch.models.generators import DCGANGenerator
from rgbd_gan_tpu_torch.parallel import DATA_AXIS, shard_batch
from rgbd_gan_tpu_torch.parallel.mesh import rank_seed
from test_parallel import CH, LOCAL_BATCH, _build, _prior

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, HIDDEN, KEY = 2, 32, 4
ATOL = 1e-4
# the port's and the JAX step's gradients, tensor by tensor (measured on the
# CPU: at most 1.1e-3), and the share of the elements whose two gradients
# are further apart than the JAX one is from zero (measured: 3.3e-4)
GRAD_RTOL_L2, MAX_SHARE_NEAR_ZERO = 1e-2, 1e-3
METRICS = ["gen/loss_adv", "gen/loss_rotate", "dis/loss_adv", "dis/loss_gp"]
STATS = tuple(f"occlusion_net/bn{i}/{s}" for i in (0, 1) for s in ("mean", "var"))
PRIOR = dict(x_rotate=0.3054, y_rotate=3.1415, z_rotate=0, x_translate=0, y_translate=0, z_translate=0,
             uniform_distribution=False)

# Each rank runs every leg and writes what the tests read to {out}/rank{r}.npz.
_WORKER = """
import dataclasses
import sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
CH, HIDDEN, LOCAL_BATCH, PRIOR, DV = @CONSTANTS@
rank, init_file, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=2)

from rgbd_gan_tpu_torch.bridge import load_jax_params, module_to_jax, torch_to_jax
from rgbd_gan_tpu_torch.core.config import Config
from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
from rgbd_gan_tpu_torch.geometry.prior import CameraParamPrior
from rgbd_gan_tpu_torch.models.discriminator import Discriminator
from rgbd_gan_tpu_torch.models.generators import DCGANGenerator, dcgan_make_hidden
from rgbd_gan_tpu_torch.parallel import DATA_AXIS, shard_batch
from rgbd_gan_tpu_torch.parallel.mesh import rank_seed
from rgbd_gan_tpu_torch.train.optim import make_optimizer
from rgbd_gan_tpu_torch.train.state import TrainState
from rgbd_gan_tpu_torch.train.steps import StepSpec, make_rgbd_train_step
from rgbd_gan_tpu_torch.train.checkpoint import _opt_to_flat
from rgbd_gan_tpu_torch.train.trainer import Trainer

inp = dict(np.load(f"{out}/inputs.npz"))
flat = lambda prefix: {k[len(prefix):]: v for k, v in inp.items() if k.startswith(prefix)}
prior = CameraParamPrior(Config(PRIOR))
results = {}


def state(sn=False):
    gen = DCGANGenerator(in_ch=CH, ch=HIDDEN, rgbd=True)
    dis = Discriminator(ch=CH, res=True, sn=sn, generator=torch.Generator().manual_seed(3))
    load_jax_params(gen, flat("gen/"))
    if not sn:
        load_jax_params(dis, flat("dis/"))
    gen.requires_grad_(False)
    dis.requires_grad_(False)
    return TrainState(gen=gen, dis=dis, opt_map=None, opt_gen=make_optimizer(gen.named_parameters(), 0.001, 0.0, 0.999),
                      opt_dis=make_optimizer(dis.named_parameters(), 0.003, 0.0, 0.999))


def step(sn=False):
    spec = StepSpec(stage_floor=6, batch_size=LOCAL_BATCH, architecture="dcgan", use_rotate=True,
                    lambda_geometric=1.0, sn=sn, axis_name=DATA_AXIS)
    return make_rgbd_train_step(None, prior, spec)


draws = dict(z=torch.from_numpy(inp[f"z{rank}"]), thetas6=torch.from_numpy(inp[f"thetas6_{rank}"]))
x = torch.from_numpy(shard_batch(inp["x"], rank, 2).copy())

# parity with the JAX sharded step
s = state()
_, m = step()(s, x, 0.0, **draws)
results.update({f"metric/{k}": v.numpy() for k, v in m.items()})
results.update({f"gen/{k}": v for k, v in torch_to_jax(s.gen.state_dict()).items()})
results.update({f"dis/{k}": v for k, v in torch_to_jax(s.dis.state_dict()).items()})
results.update({f"opt_gen/{k}": v for k, v in _opt_to_flat(s.opt_gen, "opt").items() if "/mu/" in k})
results.update({f"opt_dis/{k}": v for k, v in _opt_to_flat(s.opt_dis, "opt").items() if "/mu/" in k})

# the NaN flag: only rank 0's shard is NaN
xf = x.to(torch.float32) / 127.5 - 1.0
_, m = step()(state(), torch.full_like(xf, float("nan")) if rank == 0 else xf, 0.0, **draws)
results["nan"] = m["nan"].numpy()

# each rank's own stream
results["z_stream"] = dcgan_make_hidden(torch.Generator().manual_seed(rank_seed(0, rank, 2)), 2, CH).numpy()

# spectral norm: the power-iteration vectors after a step
s = state(sn=True)
step(sn=True)(s, x, 0.0, **draws)
results.update({f"sn/{k}": v.numpy() for k, v in s.dis.state_dict().items() if k.endswith(".u")})

# DeepVoxels with RenderNet: the two-rank step, and this rank's step alone
dv = DV
data = synthetic_dataset(4, 64, seed=7).transpose(0, 2, 3, 1)
xd = torch.from_numpy(shard_batch(data, rank, 2).copy())
g = torch.Generator().manual_seed(100 + rank)
b, ch = 2, dv["ch"]
dv_draws = dict(z=torch.randn(b, ch, generator=g), z2=torch.randn(b, ch, generator=g),
                z_d=torch.randn(b, ch, generator=g), z2_d=torch.randn(b, ch, generator=g))
dv_draws["thetas6"] = CameraParamPrior(Config(dv)).sample(g, b, "cpu")
both = Trainer(Config(dict(dv, use_mpi=True)), dataset=data.transpose(0, 3, 1, 2), device="cpu")
alone = Trainer(Config(dv), dataset=data.transpose(0, 3, 1, 2), device="cpu")
spec = both._spec_for(0, 8)
assert both.use_mesh and spec.batch_size == b and spec.axis_name == DATA_AXIS
both._step(spec)(both.state, xd, 0.0, **dv_draws)
alone._step(dataclasses.replace(spec, axis_name=None))(alone.state, xd, 0.0, **dv_draws)
for name, t in (("both", both), ("alone", alone)):
    results.update({f"dv_{name}/{k}": v for k, v in module_to_jax(t.state.gen).items() if k.startswith("batch_stats")})

# the yml's DeepVoxels batch of 10 gives 5 a rank: the paired latents need an even batch
try:
    Trainer(Config(dict(dv, batchsize=10, use_mpi=True)), dataset=data.transpose(0, 3, 1, 2), device="cpu")
except ValueError as e:
    results["odd_batch"] = str(e)

np.savez(f"{out}/rank{rank}.npz", **results)
dist.barrier()  # no rank tears the group down while another still runs: that can abort
dist.destroy_process_group()
"""

DV = dict(
    generator_architecture="deepvoxels", ch=8, batchsize=4, res_dis=True, sn=False, rendernet_projection=True,
    adam_alpha_g=0.0, adam_alpha_d=0.0, adam_beta1=0.0, adam_beta2=0.999, lambda_gp=1.0, lambda_depth=10,
    depth_min=0.6, keep_smoothed_gen=False, focal_loss_gamma=2.0, uniform_distribution=True,
    stage_interval="0,0,0,0,0,0,0,0", max_stage=11, start_rotation=-1, start_occlusion_aware=0,
    x_rotate=0.3054, y_rotate=3.1415, z_rotate=0, x_translate=0, y_translate=0, z_translate=0,
)


def _perturbed(flat, seed):
    rng = np.random.RandomState(seed)
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results; the JAX step's metrics, parameters and
    optimizer states; G's and D's weights before the step)."""
    out = tmp_path_factory.mktemp("parallel")
    gflat = _perturbed(torch_to_jax(DCGANGenerator(in_ch=CH, ch=HIDDEN, rgbd=True,
                                                   generator=torch.Generator().manual_seed(0)).state_dict()), 0)
    dflat = _perturbed(torch_to_jax(Discriminator(ch=CH, res=True,
                                                  generator=torch.Generator().manual_seed(1)).state_dict()), 1)
    jstate, jstep = _build(JAX_DATA_AXIS)
    x = synthetic_dataset(WORLD * LOCAL_BATCH, 32, seed=5).transpose(0, 2, 3, 1)  # uint8 NHWC
    key = jax.random.PRNGKey(KEY)
    draws = {}
    for r in range(WORLD):  # the JAX step's own draws on device r (steps.py:143-149)
        kz, ktheta, _ = jax.random.split(jax.random.fold_in(key, r), 3)
        draws[f"z{r}"] = np.asarray(jnp.concatenate([jax_make_hidden(kz, LOCAL_BATCH // 2, CH)] * 2))
        draws[f"thetas6_{r}"] = np.asarray(_prior().sample(ktheta, LOCAL_BATCH))
    np.savez(out / "inputs.npz", x=x, **draws, **{f"gen/{k}": v for k, v in gflat.items()},
             **{f"dis/{k}": v for k, v in dflat.items()})
    script = out / "worker.py"
    script.write_text(_WORKER.replace("@CONSTANTS@", repr((CH, HIDDEN, LOCAL_BATCH, PRIOR, DV))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(out / "store"), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
             for r in range(WORLD)]
    try:
        # meanwhile, the JAX step on a mesh of two devices
        mesh = jax_make_mesh(jax.devices()[:WORLD])
        jstate = jstate.replace(params_gen=_unflatten(gflat), params_dis=_unflatten(dflat))
        new, jm = shard_train_step(jstep, mesh)(jax_replicate(jstate, mesh), jax_shard_batch(jnp.asarray(x), mesh),
                                                jnp.float32(0.0), key)
        jax_result = ({k: float(v) for k, v in jm.items()}, jax_ckpt._flatten(new.params_gen),
                      jax_ckpt._flatten(new.params_dis), jax_ckpt._flatten(new.opt_gen),
                      jax_ckpt._flatten(new.opt_dis))
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return ranks, jax_result, gflat, dflat


def test_jax_sharded_step_sums_the_gradients_of_replicated_parameters():
    """The JAX package's fault that the parity test allows for: under
    ``shard_map``'s replication check, the gradient of a replicated input is
    already summed over the devices (the transpose of its implicit
    broadcast), and ``lax.pmean`` of that replicated sum returns it
    unchanged, so the JAX sharded step steps on the *sum* of the devices'
    gradients where it means their mean (``steps.py:231,336``). Here: the
    local gradients 1 and 3 come back as 4, not 2."""
    from jax.sharding import PartitionSpec as P

    def step(w, x):
        return jax.lax.pmean(jax.grad(lambda w: jnp.mean(w * x))(w), JAX_DATA_AXIS)

    mesh = jax_make_mesh(jax.devices()[:WORLD])
    fn = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(P(), P(JAX_DATA_AXIS)), out_specs=P()))
    assert float(fn(jnp.float32(1.0), jnp.array([1.0, 3.0], jnp.float32))) == 4.0


def test_two_rank_step_matches_the_jax_sharded_step(runs):
    """Losses within ``ATOL``. The gradients Adam took (its first moment
    after one step with beta1 = 0, unclipped on both sides here) are the
    mean over the ranks: world x the port's equals the JAX step's sum within
    ``GRAD_RTOL_L2`` of each tensor's L2 norm (the packages' float32 gaps in
    the gather's derivative). Every updated parameter within ``ATOL``,
    except where the two gradients are further apart than the JAX one is
    from zero (at most ``MAX_SHARE_NEAR_ZERO`` of the elements): there Adam's
    first step moves by alpha times a sign that the gap decides, and each
    package's move is held to alpha."""
    ranks, (jm, jgen, jdis, jopt_gen, jopt_dis), gflat, dflat = runs
    for k in METRICS:
        np.testing.assert_allclose(ranks[0][f"metric/{k}"], jm[k], atol=ATOL, err_msg=k)
    assert jm["dis/loss_gp"] > 0 and not jm["nan"] and not ranks[0]["metric/nan"]
    before = {**{f"gen/{k}": v for k, v in gflat.items()}, **{f"dis/{k}": v for k, v in dflat.items()}}
    counts = np.zeros(2, np.int64)  # elements near zero, elements
    for prefix, want, jopt, alpha in (("gen/", jgen, jopt_gen, 0.001), ("dis/", jdis, jopt_dis, 0.003)):
        got = {k[len(prefix):]: v for k, v in ranks[0].items() if k.startswith(prefix)}
        assert got.keys() == want.keys()
        for k in want:
            g_jax = jopt[f"1/0/mu/{k}"].astype(np.float64)
            g = WORLD * ranks[0][f"opt_{prefix[:3]}/opt/1/0/mu/{k}"].astype(np.float64)
            gap = np.abs(g - g_jax)
            assert np.linalg.norm(gap) <= GRAD_RTOL_L2 * np.linalg.norm(g_jax), prefix + k
            near_zero = np.abs(g_jax) < gap
            counts += (near_zero.sum(), near_zero.size)
            start = before[prefix + k]
            for moved in (got[k], want[k]):
                assert np.abs(moved - start)[near_zero].max(initial=0) <= alpha * (1 + 1e-5), prefix + k
            np.testing.assert_allclose(got[k][~near_zero], want[k][~near_zero], atol=ATOL, err_msg=prefix + k)
    assert counts[0] <= MAX_SHARE_NEAR_ZERO * counts[1], counts
    noise = [k for k in before if "/n0/" in k or "/n1/" in k]
    assert noise and all(np.array_equal(ranks[0][k], before[k]) for k in noise)


def test_ranks_end_bit_identical(runs):
    ranks = runs[0]
    shared = [k for k in ranks[0] if k.startswith(("metric/", "gen/", "dis/", "sn/", "dv_both/"))]
    assert len(shared) > 50
    for k in shared:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def test_nan_flag_trips_on_every_rank(runs):
    assert [bool(r["nan"]) for r in runs[0]] == [True, True]


def test_each_rank_draws_from_its_own_stream(runs):
    ranks = runs[0]
    assert not np.allclose(ranks[0]["z_stream"], ranks[1]["z_stream"])
    assert rank_seed(7, 0, 1) == 7 and rank_seed(7, 1, 2) != rank_seed(7, 0, 2) != 7


def test_spectral_norm_vectors_identical_across_ranks(runs):
    ranks = runs[0]
    u = [k for k in ranks[0] if k.startswith("sn/")]
    assert len(u) > 5
    for k in u:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def test_deepvoxels_batch_stats_are_the_mean_of_each_ranks_step(runs):
    ranks = runs[0]
    for s in STATS:
        k = f"batch_stats/{s}"
        alone = [r[f"dv_alone/{k}"] for r in ranks]
        assert not np.allclose(alone[0], alone[1]), k
        np.testing.assert_array_equal(ranks[0][f"dv_both/{k}"], ranks[1][f"dv_both/{k}"], err_msg=k)
        np.testing.assert_allclose(ranks[0][f"dv_both/{k}"], (alone[0] + alone[1]) / 2, rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_shard_batch_splits_like_the_jax_mesh():
    x = np.arange(8 * 3).reshape(8, 3)
    assert np.array_equal(np.concatenate([shard_batch(x, r, 4) for r in range(4)]), x)
    assert np.array_equal(shard_batch(x[None], 1, 2, batch_axis=1), x[None, 4:])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(x, 0, 3)
    assert DATA_AXIS == JAX_DATA_AXIS


def test_an_odd_batch_a_rank_is_refused(runs):
    """Each step draws its latents in pairs; 10 images over two ranks are 5
    a rank, which no step can pair (nor the JAX package's)."""
    assert all("even batch" in str(r["odd_batch"]) for r in runs[0])
