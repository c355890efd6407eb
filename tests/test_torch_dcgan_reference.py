"""The port's DCGAN generator and RGBD step against the benchmark's plain
PyTorch reference (``benchmark/reference/dcgan.py``, which imports nothing
of the port), and the port's ``gen.chnorm`` spans and ``chnorm.elems``
counter. CPU, no JAX.

The width is cut to in_ch 16 and a hidden width of 32 (the trainer's quirk
keeps the hidden width at 512, which the comparison does not need), batch
4, up to 32 px. The reference draws the weights; every parameter is then
moved by 0.05 N(0, 1), so that no bias sits at its zero start, and the
port gets them by name.

- The forward at stage 6 (32 px) and at the fade-in stage 7 (alpha 0.5):
  within ``FWD_TOL``. Both sides compute the same float32 operations (they
  agree bit for bit here); a conv algorithm that sums in another order
  moves outputs of order 1 by a few ulps.
- One training step (R1, the occlusion-aware 3D loss at
  ``lambda_geometric`` 1, one Adam over the generator) on the same batch
  and draws. The port's 3D loss gathers and scatters in another order
  than the reference's four plain gathers (measured here: 7e-8 of the
  rotate loss, 3e-7 of a gradient leaf's norm). Step-1 losses within
  ``LOSS_TOL`` (relative); Adam's first moments (with beta1 = 0 the
  clipped gradient) leaf by leaf within ``GRAD_TOL`` of the leaf's norm;
  each parameter's change within ``CHANGE_TOL`` of its norm (1.5e-4
  measured): Adam's first step moves an element by about the learning rate
  times the sign of its gradient, so an element whose gradient is within
  round-off of zero can move the other way on one side.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import dcgan as ref
from benchmark.reference import step as ref_step
from benchmark.reference.geometry import theta_to_9dof
from benchmark.reference.stylegan import Discriminator as RefDiscriminator
from rgbd_gan_tpu_torch.models.discriminator import Discriminator
from rgbd_gan_tpu_torch.models.generators import DCGANGenerator
from rgbd_gan_tpu_torch.train.optim import make_optimizer
from rgbd_gan_tpu_torch.train.state import TrainState
from rgbd_gan_tpu_torch.train.steps import StepSpec, make_rgbd_train_step
from rgbd_gan_tpu_torch.utils import trace

# the suite runs several worker processes at once: leave them the other cores
torch.set_num_threads(2)

IN_CH, HIDDEN, BATCH, STAGE = 16, 32, 4, 6
FWD_TOL = 1e-5
LOSS_TOL, GRAD_TOL, CHANGE_TOL = 1e-5, 1e-5, 1e-3
CFG = dict(
    generator_architecture="dcgan", ch=IN_CH, batchsize=BATCH, res_dis=True, max_stage=STAGE + 1,
    adam_alpha_g=0.001, adam_alpha_d=0.003, adam_beta1=0.0, adam_beta2=0.999, lambda_gp=1.0, r1_interval=1,
    lambda_depth=10, depth_min=0.6, lambda_geometric=1,
    x_rotate=0.3054, y_rotate=3.1415, z_rotate=0, x_translate=0, y_translate=0, z_translate=0,
)
LOSSES = ("gen/loss_adv", "gen/loss_rotate", "dis/loss_adv", "dis/loss_gp")
# the elements each published block normalises, twice a block, at batch 32: 8, 16, 32, 64, 128 px
PUBLISHED_ELEMS = 2 * 32 * (8**2 * 512 + 16**2 * 512 + 32**2 * 512 + 64**2 * 256 + 128**2 * 128)


def _perturbed(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return module


@pytest.fixture(scope="module")
def weights():
    g = torch.Generator().manual_seed(0)
    gen = _perturbed(ref.DCGANGenerator(IN_CH, HIDDEN, generator=g), 1)
    dis = _perturbed(RefDiscriminator(IN_CH, True, None, g), 2)
    return gen.state_dict(), dis.state_dict()


def _pair(weights):
    """The reference's models and the port's, on the same weights."""
    mine = ref.DCGANGenerator(IN_CH, HIDDEN), RefDiscriminator(IN_CH, True)
    port = DCGANGenerator(in_ch=IN_CH, ch=HIDDEN, rgbd=True), Discriminator(ch=IN_CH, res=True)
    for module, state in zip(mine + port, weights + weights):
        module.load_state_dict(state)  # strict: the port names every parameter as the reference does
        module.requires_grad_(False)
    return mine, port


def _draws(seed=3):
    g = torch.Generator().manual_seed(seed)
    d = ref.draws(CFG, g, BATCH, "cpu")
    x = torch.randint(0, 256, (BATCH, 4 * 2 ** (STAGE // 2), 4 * 2 ** (STAGE // 2), 3), generator=g,
                      dtype=torch.uint8)
    return d, x


@pytest.mark.parametrize("stage, alpha", [(6, 0.0), (7, 0.5)], ids=["stage6", "stage7_fade_in"])
def test_forward_matches_the_reference(weights, stage, alpha):
    (ref_gen, _), (gen, _) = _pair(weights)
    d, _ = _draws()
    theta = theta_to_9dof(d["thetas6"])
    with torch.no_grad():
        want = ref_gen(d["z"], stage, alpha, theta)
        got = gen(d["z"], stage, alpha, theta)
    px = 4 * 2 ** ((stage + 1) // 2)
    assert got.shape == want.shape == (BATCH, px, px, 4)
    torch.testing.assert_close(got, want, atol=FWD_TOL, rtol=FWD_TOL)


def test_step_matches_the_reference(weights):
    (ref_gen, ref_dis), (gen, dis) = _pair(weights)
    d, x = _draws()
    models = {"gen": ref_gen, "dis": ref_dis}
    opts = ref_step.optimizers(CFG, models)
    assert set(opts) == {"gen", "dis"}  # no mapping network, so no map domain
    before_ref = {n: p.clone() for n, p in ref_gen.named_parameters()}
    want = ref.step(CFG, models, opts, [dict(d, x=x)], 0)

    state = TrainState(
        gen=gen, dis=dis, opt_map=None,
        opt_gen=make_optimizer(gen.named_parameters(), CFG["adam_alpha_g"], 0.0, 0.999),
        opt_dis=make_optimizer(dis.named_parameters(), CFG["adam_alpha_d"], 0.0, 0.999),
    )
    spec = StepSpec(stage_floor=STAGE, batch_size=BATCH, architecture="dcgan", use_rotate=True,
                    occlusion_aware=True, lambda_depth=10, depth_min=0.6, lambda_geometric=1.0,
                    max_stage=STAGE + 1)
    before = {n: p.clone() for n, p in gen.named_parameters()}
    _, got = make_rgbd_train_step(None, None, spec)(state, x, 1.0 - 1e-8, z=d["z"], thetas6=d["thetas6"])

    for k in LOSSES:
        torch.testing.assert_close(got[k], want[k], atol=0.0, rtol=LOSS_TOL, msg=k)
    assert float(want["dis/loss_gp"]) > 0
    for label, opt in (("gen", state.opt_gen), ("dis", state.opt_dis)):
        ref_mu, mu = opts[label].first_moments(), opt.state_dict()["mu"]
        assert mu.keys() == ref_mu.keys()
        for name, m in mu.items():
            scale = max(float(ref_mu[name].norm()), 1e-12)
            assert float((m - ref_mu[name]).norm()) <= GRAD_TOL * scale, (label, name)
    moved = 0
    for name, p in gen.named_parameters():
        change, ref_change = p - before[name], dict(ref_gen.named_parameters())[name] - before_ref[name]
        moved += bool(ref_change.abs().max() > 0)
        assert float((change - ref_change).norm()) <= CHANGE_TOL * max(float(ref_change.norm()), 1e-12), name
    assert moved == 2 + 3 * 4 + 2  # the stem, blocks 0-2 but their noise gains, the 32 px head


def _chnorm_records(gen, z, theta, stage):
    trace.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
            gen(z, stage, 0.0, theta)
        return [r for r in trace.records() if r["name"] == "gen.chnorm"]
    finally:
        trace.reset()


def test_chnorm_spans_count_what_the_reference_normalises(weights):
    (ref_gen, _), (gen, _) = _pair(weights)
    d, _ = _draws()
    theta = theta_to_9dof(d["thetas6"])
    normalised = []
    for i in range(3):
        for conv in ("c0", "c1"):
            ref_gen.get_submodule(f"block{i}.{conv}").register_forward_hook(
                lambda m, args, out: normalised.append(out.numel()))
    with torch.no_grad():
        ref_gen(d["z"], STAGE, 0.0, theta)
    records = _chnorm_records(gen, d["z"], theta, STAGE)
    assert len(records) == 2 * 3 == len(normalised)  # two a block, three blocks to 32 px
    assert [r["counts"] for r in records] == [{"chnorm.elems": n} for n in normalised]
    assert all(r["device_ms"] is None for r in records)  # the CPU keeps no device times


def test_chnorm_elems_at_the_published_widths():
    """The published generator (in_ch 256, hidden 512, batch 32) at stage 10,
    128 px, on the meta device: only shapes flow."""
    with torch.device("meta"):
        gen = DCGANGenerator(in_ch=256, rgbd=True)
        z, theta = torch.empty(32, 256), torch.empty(32, 9)
    records = _chnorm_records(gen, z, theta, 10)
    assert len(records) == 10
    assert sum(r["counts"]["chnorm.elems"] for r in records) == PUBLISHED_ELEMS == 245_366_784


def test_no_span_without_a_profiler(weights):
    (_, _), (gen, _) = _pair(weights)
    d, _ = _draws()
    trace.reset()
    with torch.no_grad():
        gen(d["z"], STAGE, 0.0, theta_to_9dof(d["thetas6"]))
    assert trace.records() == []
