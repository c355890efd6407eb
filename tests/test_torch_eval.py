"""The port's preview, Inception-v3, FID/IS and evaluation CLI against the
JAX package's, on the CPU.

- Preview grids from bridged StyleGAN and DCGAN weights (ch 16 and a hidden
  width of 32, eval mode below 64 px): the images within ``PREVIEW_ATOL``
  times the largest magnitude of the JAX package's (as in
  ``test_torch_models.py``), the uint8 grid within one level (a float on a
  rounding edge may land on either side).
- Inception-v3 at 75x75 (every stride-2 stage divides exactly there, so no
  padding rule is hidden by the small size), 2 images, from variables of the
  JAX model's tree (He-normal kernels, seeded BatchNorm affine and
  statistics, drawn with numpy: the JAX init runs op by op for half a
  minute), saved with the JAX package's ``save_tree`` and read by the port's
  ``load_params``: features and softmax within ``INCEPTION_RTOL``.
- The resize to Inception's input against ``jax.image.resize``, up and down.
- FID, IS and the feature mean and covariance on fixed arrays, to 1e-6.
- The default second style latent of the DeepVoxels eval forward, equal to
  the JAX trainer's draw.

``test_torch_eval_cli.py`` runs the evaluation CLI.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_gan_tpu.core import Config as JaxConfig
from rgbd_gan_tpu.eval import fid as jax_fid
from rgbd_gan_tpu.eval import preview as jax_preview
from rgbd_gan_tpu.eval.inception import InceptionV3 as JaxInceptionV3
from rgbd_gan_tpu.models.generators import DCGANGenerator as JaxDCGANGenerator
from rgbd_gan_tpu.models.generators import StyleGANGenerator as JaxStyleGANGenerator
from rgbd_gan_tpu.train import checkpoint as jax_ckpt
from rgbd_gan_tpu.train.trainer import Trainer as JaxTrainer
from rgbd_gan_tpu_torch.bridge import load_jax_params, torch_to_jax
from rgbd_gan_tpu_torch.cli import evaluate
from rgbd_gan_tpu_torch.cli import train as cli
from rgbd_gan_tpu_torch.core.config import Config
from rgbd_gan_tpu_torch.data.dataset import synthetic_dataset
from rgbd_gan_tpu_torch.eval import fid
from rgbd_gan_tpu_torch.eval import preview
from rgbd_gan_tpu_torch.eval.inception import FEATURE_DIM, NUM_LOGITS, load_params
from rgbd_gan_tpu_torch.models.generators import DCGANGenerator, StyleGANGenerator
from rgbd_gan_tpu_torch.train.trainer import Trainer

# the suite runs several worker processes at once: leave them the other cores
torch.set_num_threads(2)

CH = 16
PREVIEW_ATOL = 1e-5
INCEPTION_RTOL = 1e-4
PREVIEW_CFG = dict(test_y_rotate=3.1415, max_stage=7, rgb=False)


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)
    return tree


def _make_hidden_np(arch, ch):
    """Each package's trainer's host sampler, bound to a stand-in trainer."""
    port = SimpleNamespace(arch=arch, config=Config(dict(ch=ch)))
    jax_side = SimpleNamespace(arch=arch, config=JaxConfig(dict(ch=ch)))
    return (lambda rng, n: Trainer.make_hidden_np(port, rng, n),
            lambda rng, n: JaxTrainer.make_hidden_np(jax_side, rng, n))


@pytest.mark.parametrize("arch,stage", [("stylegan", 5.5), ("dcgan", 6.0)])
def test_preview_grid_matches_jax(arch, stage):
    """32 px outputs, nearest-repeated to 64 px; the StyleGAN stage fades in."""
    g = torch.Generator().manual_seed(3)
    if arch == "stylegan":
        gen = StyleGANGenerator(CH, rgbd=True, generator=g)
        jgen = JaxStyleGANGenerator(CH, rgbd=True)
    else:
        gen = DCGANGenerator(in_ch=CH, ch=32, rgbd=True, generator=g)
        jgen = JaxDCGANGenerator(in_ch=CH, ch=32, rgbd=True)
    rng = np.random.RandomState(4)
    flat = {k: (v + 0.05 * rng.randn(*v.shape)).astype(v.dtype) for k, v in torch_to_jax(gen.state_dict()).items()}
    load_jax_params(gen, flat)
    params = {"params": _unflatten(flat)}
    port_hidden, jax_hidden = _make_hidden_np(arch, CH)
    np.testing.assert_array_equal(port_hidden(np.random.RandomState(0), 8), jax_hidden(np.random.RandomState(0), 8))

    def port_apply(z, floor, alpha, theta9, mats):
        with torch.no_grad():
            return gen(torch.as_tensor(z), floor, alpha, torch.as_tensor(theta9), train=False)

    jax_outs = []
    jfwd = jax.jit(lambda v, z, a, t, floor: jgen.apply(v, z, floor, a, t, train=False), static_argnums=4)

    def jax_apply(z, floor, alpha, theta9, mats=None):
        jax_outs.append(np.asarray(jfwd(params, z, alpha, theta9, floor)))
        return jax_outs[-1]

    got = preview.render_preview_float(port_apply, port_hidden, Config(PREVIEW_CFG), stage)
    want_grid = jax_preview.render_preview_grid(jax_apply, jax_hidden, JaxConfig(PREVIEW_CFG), stage)
    assert len(jax_outs) == 4 and got.shape == (64, 4, 64, 64)
    want = np.concatenate(jax_outs).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=PREVIEW_ATOL * max(1.0, float(np.abs(want).max())))
    grid = preview.convert_batch_images(got, 8, 8)
    assert grid.shape == want_grid.shape == (16 * 64, 8 * 64, 3) and grid.dtype == np.uint8
    assert np.abs(grid.astype(int) - want_grid.astype(int)).max() <= 1


@pytest.mark.parametrize("channels", [3, 4])
def test_convert_batch_images_matches_jax(channels):
    x = np.random.RandomState(channels).uniform(-1.2, 1.2, (6, channels, 5, 7)).astype("f")
    if channels == 4:
        x[:, 3] = np.abs(x[:, 3]) + 0.1  # inverse depth
    np.testing.assert_array_equal(preview.convert_batch_images(x, 2, 3), jax_preview.convert_batch_images(x, 2, 3))


# ---------------------------------------------------------------------------
# Inception-v3, the resize, FID and IS
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def inception_npz(tmp_path_factory):
    """Variables of the JAX model's tree, saved as the flat-key npz."""
    model = JaxInceptionV3()
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(1), jnp.zeros((1, 75, 75, 3)))
    rng = np.random.RandomState(5)

    def draw(path, s):
        name = "/".join(str(p.key) for p in path)
        if name.endswith("/kernel"):
            return rng.randn(*s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))
        if name.endswith("/var"):
            return 0.5 + rng.rand(*s.shape)
        if name.endswith("/scale"):
            return 1.0 + 0.1 * rng.randn(*s.shape)
        return 0.1 * rng.randn(*s.shape)  # bias, mean

    variables = jax.tree_util.tree_map_with_path(lambda p, s: np.asarray(draw(p, s), np.float32), shapes)
    path = str(tmp_path_factory.mktemp("inception") / "inception.npz")
    jax_ckpt.save_tree(path, variables)
    fwd = jax.jit(lambda v, x: (model.apply(v, x, get_feature=True), model.apply(v, x)))
    return path, fwd, jax_ckpt.load_tree(path, variables, strict=True)


def test_inception_matches_jax(inception_npz):
    path, jax_fwd, variables = inception_npz
    x = np.random.RandomState(6).uniform(0, 255, (2, 75, 75, 3)).astype("f")
    model = load_params(path)
    with torch.no_grad():
        feat = model(torch.tensor(x), get_feature=True).numpy()
        probs = model(torch.tensor(x)).numpy()
    want_feat, want_probs = (np.asarray(a) for a in jax_fwd(variables, jnp.asarray(x)))
    assert feat.shape == (2, FEATURE_DIM) and probs.shape == (2, NUM_LOGITS)
    assert float(np.abs(want_feat).max()) > 1e-2  # the activations keep their scale
    np.testing.assert_allclose(feat, want_feat, rtol=INCEPTION_RTOL, atol=INCEPTION_RTOL * np.abs(want_feat).max())
    np.testing.assert_allclose(probs, want_probs, rtol=INCEPTION_RTOL, atol=1e-7)


def test_inception_without_weights_warns_and_keeps_scale():
    with pytest.warns(UserWarning, match="random init"):
        model = load_params(None)
    assert not model.training and not any(p.requires_grad for p in model.parameters())
    with torch.no_grad():
        feat = model(torch.rand(1, 75, 75, 3) * 255, get_feature=True)
    assert float(feat.abs().max()) > 1e-2


@pytest.mark.parametrize("size_in,size_out", [(32, 48), (64, 40)])
def test_resize_matches_jax_image_resize(size_in, size_out):
    """Half-pixel centres when it grows; antialiased when it shrinks."""
    x = np.random.RandomState(size_in).uniform(0, 255, (2, size_in, size_in, 3)).astype("f")
    got = fid.resize_to_input(torch.tensor(x), size_out).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, size_out, size_out, 3), method="bilinear"))
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_fid_score_matches_jax():
    rng = np.random.RandomState(7)
    a, b = rng.randn(64, 16), rng.randn(64, 16) * 1.3 + 0.2
    args = (a.mean(0), np.cov(a.T), b.mean(0), np.cov(b.T))
    assert fid.fid_score(*args) == pytest.approx(jax_fid.fid_score(*args), abs=1e-6)
    assert fid.fid_score(*args[:2], *args[:2]) == pytest.approx(0.0, abs=1e-6)


def test_inception_score_and_mean_cov_match_jax(monkeypatch):
    """The algebra on fixed network outputs (each package's forward replaced)."""
    rng = np.random.RandomState(8)
    logits = rng.randn(30, NUM_LOGITS).astype("f") * 3
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    feats = rng.randn(30, FEATURE_DIM).astype("f")
    monkeypatch.setattr(fid, "inception_softmax", lambda *a, **k: probs)
    monkeypatch.setattr(jax_fid, "inception_softmax", lambda *a, **k: probs)
    monkeypatch.setattr(fid, "inception_features", lambda *a, **k: feats)
    monkeypatch.setattr(jax_fid, "inception_features", lambda *a, **k: feats)
    got, want = fid.inception_score(None, None), jax_fid.inception_score(None, None, None)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert got[0] > 1.0
    (m, c), (jm, jc) = fid.get_mean_cov(None, None), jax_fid.get_mean_cov(None, None, None)
    np.testing.assert_allclose(m, jm, atol=1e-6)
    np.testing.assert_allclose(c, jc, atol=1e-6)


def test_samplers_carry_their_generator():
    """Each call draws anew from the one generator, as the JAX key is split."""
    seen = []

    def gen_apply(z, floor, alpha, theta9, mats=None):
        seen.append((z, theta9))
        return torch.zeros(z.shape[0], 4, 4, 4)

    hidden = lambda g, n: torch.randn(n, 8, generator=g)
    theta9 = lambda g, n: torch.randn(n, 9, generator=g)
    gen = fid.rgbd_image_sampler(gen_apply, hidden, 6, 0.0, theta9)
    images = fid.gen_images(gen, n=5, batchsize=3)
    assert images.shape == (5, 4, 4, 3) and images.dtype == np.uint8 and (images == 127).all()
    assert not torch.equal(seen[0][0], seen[1][0]) and not torch.equal(seen[0][1], seen[1][1])


@pytest.mark.parametrize("n", [16, 10])
def test_deepvoxels_eval_z2_is_the_jax_draw(n):
    """16: a grid of 8 columns (the preview's chunks), tiled; 10: one draw per sample."""
    config = dict(ch=8)
    z = np.random.RandomState(9).randn(n, 8).astype("f")
    port = SimpleNamespace(arch="deepvoxels", config=Config(config), device=torch.device("cpu"),
                           state=SimpleNamespace(gen=lambda z, mats, z2, theta9, train: (z2, train)))
    port.make_hidden_np = lambda rng, k: Trainer.make_hidden_np(port, rng, k)
    jax_side = SimpleNamespace(arch="deepvoxels", config=JaxConfig(config),
                               state=SimpleNamespace(params_gen={}, gen_state=None),
                               gen=SimpleNamespace(apply=lambda v, z, mats, z2, theta9, train: z2))
    jax_side.make_hidden_np = lambda rng, k: JaxTrainer.make_hidden_np(jax_side, rng, k)
    got, train = Trainer.gen_apply_eval(port, z, 8, 0.0, np.zeros((n, 9), "f"), np.zeros((n, 4, 4), "f"))
    want = JaxTrainer.gen_apply_eval(jax_side, jnp.asarray(z), 8, 0.0, None, None)
    assert train is False
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    explicit = np.ones((n, 8), "f")
    got, _ = Trainer.gen_apply_eval(port, z, 8, 0.0, np.zeros((n, 9), "f"), np.zeros((n, 4, 4), "f"), z2=explicit)
    assert (got.numpy() == 1).all()
