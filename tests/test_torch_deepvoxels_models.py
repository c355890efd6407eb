"""The port's DeepVoxels modules against the JAX package's, on the same
(bridged) weights and numpy-seeded inputs, on the CPU.

Weights come from the port's init, perturbed by a seeded numpy generator so
that no parameter sits at its (often zero or one) initial value, and reach
the flax modules through the bridge. The occlusion nets run on a small
frustum (8 x 8 lateral), the refiner at a small ``hidden_ch``; one whole
generator forward runs at ch 16, batch 1. Tolerance: atol 1e-5 times the
largest magnitude of the tensor compared (float32 sums in another order),
3e-5 for the whole generator; ``AccumulativeOcclusionNet`` takes its prefix
sum as ``torch.cumsum`` against the JAX package's triangular matmul, the same
function up to summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_gan_tpu.geometry.camera import camera_matrices as jax_camera_matrices
from rgbd_gan_tpu.geometry.warp import intrinsics as jax_intrinsics
from rgbd_gan_tpu.geometry.warp import rotate_consistency_loss as jax_rotate_consistency_loss
from rgbd_gan_tpu.models import deepvoxels as jdv
from rgbd_gan_tpu.models.extras import CameraParamGenerator as JaxCameraParamGenerator
from rgbd_gan_tpu.nn import layers as jlayers
from rgbd_gan_tpu.train.losses import gen_adv_loss as jax_gen_adv_loss
from rgbd_gan_tpu_torch.bridge import load_jax_params, load_jax_variables, module_to_jax, torch_to_jax
from rgbd_gan_tpu_torch.geometry import warp as twarp
from rgbd_gan_tpu_torch.geometry.camera import camera_matrices
from rgbd_gan_tpu_torch.models import deepvoxels as tdv
from rgbd_gan_tpu_torch.models.extras import CameraParamGenerator
from rgbd_gan_tpu_torch.nn import layers as tlayers
from rgbd_gan_tpu_torch.train.losses import gen_adv_loss

# the suite runs several worker processes at once: leave them the other cores
torch.set_num_threads(2)

REL = 1e-5


def _close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1.0, float(np.abs(want).max())))


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)
    return tree


def _bridged(module, seed):
    """Perturb the module's weights in place; returns the flax variables
    (``params`` and, with BatchNorm, ``batch_stats``) holding the same values."""
    rng = np.random.RandomState(seed)
    flat = module_to_jax(module)
    flat = {k: (np.abs(v + 0.05 * rng.randn(*v.shape)) if k.endswith("/var") else v + 0.05 * rng.randn(*v.shape))
            .astype(v.dtype) for k, v in flat.items()}
    load_jax_variables(module, flat)
    tree = _unflatten(flat)
    return tree if "batch_stats" in tree else {"params": tree}


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype("f")


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("exact_lifting", [True, False])
def test_frustum_camera_coords_exact(exact_lifting):
    got, want = tdv.frustum_camera_coords(exact_lifting), jdv.frustum_camera_coords(exact_lifting)
    assert got.dtype == want.dtype and got.shape == (4, 56 * 64 * 64)
    np.testing.assert_array_equal(got, want)


def test_frustum_voxel_coords_and_depth_decode():
    """Coordinates within 1e-4 grid cells (a 4-term float32 dot product in
    another order); the mask equal wherever no coordinate lies that close to
    the grid's faces."""
    rng = np.random.RandomState(0)
    th = (rng.uniform(-1, 1, (3, 6)) * [0.3054, 3.1415, 0.2, 0.1, 0.1, 0.1]).astype("f")
    coords = tdv.frustum_camera_coords()
    want_vox, want_ib = jdv.frustum_voxel_coords(jax_camera_matrices(jnp.asarray(th)), jnp.asarray(coords))
    vox, ib = tdv.frustum_voxel_coords(camera_matrices(torch.tensor(th)), torch.tensor(coords))
    np.testing.assert_allclose(vox.numpy(), np.asarray(want_vox), rtol=0, atol=1e-4)
    want_vox = np.asarray(want_vox)
    near_face = (np.abs(want_vox) < 1e-3).any(axis=1) | (np.abs(want_vox - 32) < 1e-3).any(axis=1)
    np.testing.assert_array_equal(ib.numpy()[~near_face], np.asarray(want_ib)[~near_face])
    assert 0.2 < ib.float().mean() < 0.9
    d = _rand(1, 2, 8, 8, 1)
    _close(tdv.decode_depth(torch.tensor(d)), jdv.decode_depth(jnp.asarray(d)))
    np.testing.assert_array_equal(tdv._depth_coords(), jdv._depth_coords())


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_plain_3d_layers():
    x = _rand(2, 2, 3, 4, 5, 6)
    _close(tlayers.upscale2x_3d(torch.tensor(x)), jlayers.upscale2x_3d(jnp.asarray(x)), rel=0)
    _close(tlayers.l2_normalize_channels(torch.tensor(x)), jlayers.l2_normalize_channels(jnp.asarray(x)))
    scale, bias = _rand(3, 2, 6), _rand(4, 2, 6)
    _close(tlayers.adain(torch.tensor(x), torch.tensor(scale), torch.tensor(bias)),
           jlayers.adain(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))


@pytest.mark.parametrize("k,stride,padding,use_bias", [(3, 1, 1, False), (1, 1, 0, True), (4, 2, 0, True)])
def test_equalized_conv3d(k, stride, padding, use_bias):
    conv = tlayers.EqualizedConv3D(5, 7, k, stride, padding, use_bias=use_bias, generator=torch.Generator().manual_seed(0))
    assert conv.inv_c == np.sqrt(2.0) * np.sqrt(1.0 / (5 * k**2))  # k**2, not k**3
    variables = _bridged(conv, 1)
    assert variables["params"]["kernel"].shape == (k, k, k, 5, 7)
    x = _rand(2, 2, 6, 8, 6, 5)
    want = jlayers.EqualizedConv3D(7, k, stride, padding, use_bias=use_bias).apply(variables, jnp.asarray(x))
    _close(conv(torch.tensor(x)), want)


@pytest.mark.parametrize("k", [1, 3, 4])
def test_conv3d_same_reflect_padding(k):
    conv = tdv.Conv3dSame(3, 4, k, generator=torch.Generator().manual_seed(0))
    variables = _bridged(conv, 2)
    x = _rand(3, 1, 6, 5, 7, 3)
    _close(conv(torch.tensor(x)), jdv.Conv3dSame(4, k).apply(variables, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("upsample", [False, True])
def test_synthesis_block_3d(upsample):
    ch = 6 if upsample else 5  # the constant input has the block's own width
    block = tdv.SynthesisBlock3D(ch, 5, 8, upsample=upsample, generator=torch.Generator().manual_seed(0))
    variables = _bridged(block, 3)
    w, x = _rand(4, 2, 8), _rand(5, 2, 4, 4, 4, 5)
    want = jdv.SynthesisBlock3D(ch, 5, upsample=upsample).apply(
        variables, jnp.asarray(w), jnp.asarray(x) if upsample else None)
    _close(block(torch.tensor(w), torch.tensor(x) if upsample else None), want)


def test_voxel_generator():
    gen = tdv.VoxelGenerator(16, 5, generator=torch.Generator().manual_seed(0))
    variables = _bridged(gen, 4)
    w = _rand(6, 2, 16)
    want = jdv.VoxelGenerator(16, 5).apply(variables, jnp.asarray(w))
    got = gen(torch.tensor(w))
    assert got.shape == (2, 32, 32, 32, 5)
    _close(got, want)


def test_accumulative_occlusion_net():
    net = tdv.AccumulativeOcclusionNet(in_ch=6, accumulative_threshold=6.0, generator=torch.Generator().manual_seed(0))
    variables = _bridged(net, 5)
    frustum = _rand(7, 2, 56, 8, 8, 6)  # densities that saturate the clipped prefix sum for some rays
    want_w, want_d = jdv.AccumulativeOcclusionNet(accumulative_threshold=6.0).apply(variables, jnp.asarray(frustum))
    got_w, got_d = net(torch.tensor(frustum))
    assert 0.05 < float((np.asarray(want_w).sum(1) > 0.999).mean()) < 0.95
    _close(got_w, want_w)
    _close(got_d, want_d)


@pytest.mark.parametrize("train", [True, False])
def test_softmax_occlusion_net_and_its_batchnorm_statistics(train):
    net = tdv.OcclusionNetLight(in_ch=6, generator=torch.Generator().manual_seed(0))
    variables = _bridged(net, 6)
    frustum = _rand(8, 2, 56, 8, 8, 6)
    jnet = jdv.OcclusionNetLight()
    if train:
        (want_w, want_d), new_vars = jnet.apply(variables, jnp.asarray(frustum), train=True, mutable=["batch_stats"])
    else:
        want_w, want_d = jnet.apply(variables, jnp.asarray(frustum), train=False)
        new_vars = variables
    got_w, got_d = net(torch.tensor(frustum), train)
    _close(got_w, want_w)
    _close(got_d, want_d)
    np.testing.assert_allclose(got_w.sum(dim=1).detach().numpy(), 1.0, atol=1e-5)
    # running statistics: 0.99 * old + 0.01 * batch, the variance biased
    for bn in ("prep_bn", "net_bn"):
        for stat in ("mean", "var"):
            want = np.asarray(new_vars["batch_stats"][bn][stat])
            np.testing.assert_allclose(getattr(getattr(net, bn), stat).numpy(), want, rtol=0, atol=1e-6)
            assert (not train) == np.array_equal(want, np.asarray(variables["batch_stats"][bn][stat]))


def test_batchnorm_takes_the_biased_variance():
    bn = tdv.BatchNorm(3)
    x = torch.tensor(_rand(9, 4, 2, 2, 2, 3))
    bn(x)
    flat = x.reshape(-1, 3)
    np.testing.assert_allclose(bn.var.numpy(), 0.99 + 0.01 * flat.var(dim=0, unbiased=False).numpy(), atol=1e-6)
    np.testing.assert_allclose(bn.mean.numpy(), 0.01 * flat.mean(dim=0).numpy(), atol=1e-7)
    assert set(dict(bn.named_parameters())) == {"scale", "bias"} and set(dict(bn.named_buffers())) == {"mean", "var"}


def test_refiner_style_generator():
    refiner = tdv.RefinerStyleGenerator(8, in_ch=6, hidden_ch=4, generator=torch.Generator().manual_seed(0))
    assert refiner.c7.inv_c == 0.5 * np.sqrt(1.0 / (10 * 9))  # output conv gain 0.5
    variables = _bridged(refiner, 7)
    h, w = _rand(10, 2, 16, 16, 6), _rand(11, 2, 8)
    want = jdv.RefinerStyleGenerator(hidden_ch=4).apply(variables, jnp.asarray(h), jnp.asarray(w))
    got = refiner(torch.tensor(h), torch.tensor(w))
    assert got.shape == (2, 16, 16, 3)
    _close(got, want)


def test_camera_param_generator():
    head = CameraParamGenerator(generator=torch.Generator().manual_seed(0))
    variables = _bridged(head, 8)
    z = _rand(12, 3, 8)
    _close(head(torch.tensor(z)), JaxCameraParamGenerator().apply(variables, jnp.asarray(z)))


@pytest.fixture(scope="module")
def whole_generator():
    ch = 16
    gen = tdv.DeepVoxelsGenerator(ch, occlusion_type="accumulative", generator=torch.Generator().manual_seed(0))
    gen.requires_grad_(False)
    variables = _bridged(gen, 9)
    jgen = jdv.DeepVoxelsGenerator(ch, occlusion_type="accumulative", lift_mode="gather")
    return ch, gen, jgen, variables


def test_parameter_tree_matches_jax_init(whole_generator):
    ch, gen, jgen, variables = whole_generator
    z = jnp.zeros((1, ch))
    shapes = jax.eval_shape(lambda: jgen.init(
        jax.random.PRNGKey(0), z, jax_camera_matrices(jnp.zeros((1, 6))), z, None, method=jgen.init_all))
    want = {"/".join(str(p.key) for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    got = {k: tuple(v.shape) for k, v in torch_to_jax(gen.state_dict()).items()}
    assert got == want
    assert any(k.startswith("camera_param_generator/") for k in got) and "frustum_coords" not in got


def test_whole_generator_forward(whole_generator):
    ch, gen, jgen, variables = whole_generator
    z, z2 = _rand(13, 1, ch), _rand(14, 1, ch)
    th = np.array([[0.2, 2.2, 0, 0, 0, 0]], "f")
    want = jgen.apply(variables, jnp.asarray(z), jax_camera_matrices(jnp.asarray(th)), jnp.asarray(z2))
    got = gen(torch.tensor(z), camera_matrices(torch.tensor(th)), torch.tensor(z2))
    assert got.shape == (1, 64, 64, 4)
    _close(got, want, rel=3e-5)
    assert 0.4 < float(got[..., 3].min()) and float(got[..., 3].max()) < 1.4  # metric depth inside the frustum


def test_make_hidden_is_a_plain_normal_draw():
    z = tdv.deepvoxels_make_hidden(torch.Generator().manual_seed(0), 4096, 16)
    assert z.shape == (4096, 16) and abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1) < 0.02


def test_build_deepvoxels_generator_follows_the_config():
    from rgbd_gan_tpu_torch.core.config import Config

    gen, make_hidden = tdv.build_deepvoxels_generator(Config(dict(ch=8, occlusion_type="accumulative",
                                                                 accumulative_threshold=2.0, z_rotate=0)))
    assert isinstance(gen.occlusion_net, tdv.AccumulativeOcclusionNet) and gen.lift_mode == "gather"
    assert gen.occlusion_net.accumulative_threshold == 2.0 and make_hidden(None, 3).shape == (3, 8)
    gen, _ = tdv.build_deepvoxels_generator(Config(dict(ch=8, z_rotate=0)), on_cuda=True)
    assert isinstance(gen.occlusion_net, tdv.OcclusionNetLight) and gen.lift_mode == "pallas_win"
    gen, _ = tdv.build_deepvoxels_generator(Config(dict(ch=8, z_rotate=0.3)), on_cuda=True)
    assert gen.lift_mode == "pallas"


# ---------------------------------------------------------------------------
# what the DeepVoxels step adds to the losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gamma", [0.0, None, 1.0, 2.0])
def test_gen_adv_loss_focal_weighting(gamma):
    y = 2 * _rand(15, 6, 1)
    _close(gen_adv_loss(torch.tensor(y), gamma), jax_gen_adv_loss(jnp.asarray(y), gamma))


@pytest.mark.parametrize("options", [
    dict(base_k=True), dict(base_k=True, max_depth=1.0), dict(base_k=True, min_depth=1.0), dict(max_depth=1.1),
])
def test_rotate_consistency_loss_options(options):
    """``base_k``, ``max_depth`` and ``min_depth``; value and gradient, atol 1e-5."""
    rng = np.random.RandomState(16)
    img, img_rot = (np.concatenate([rng.randn(2, 16, 16, 3), 0.8 + 0.5 * rng.rand(2, 16, 16, 1)], -1).astype("f")
                    for _ in range(2))
    th = (rng.uniform(-1, 1, (4, 6)) * [0.3, 0.5, 0, 0, 0, 0]).astype("f")
    jopts = dict(options, base_k=jnp.asarray(jdv.PROJECTION_INTRINSIC)) if "base_k" in options else options
    topts = dict(options, base_k=tdv.PROJECTION_INTRINSIC) if "base_k" in options else options
    jm = jax_camera_matrices(jnp.asarray(th))

    def jloss(a, b):
        return jax_rotate_consistency_loss(a, jm[:2], b, jm[2:], **jopts)[0]

    want, (want_ga, want_gb) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(img_rot))
    tm = camera_matrices(torch.tensor(th))
    a, b = torch.tensor(img, requires_grad=True), torch.tensor(img_rot, requires_grad=True)
    got = twarp.rotate_consistency_loss(a, tm[:2], b, tm[2:], **topts)[0]
    got.backward()
    _close(got, want)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(want_ga), atol=1e-5)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(want_gb), atol=1e-5)
    _close(twarp.intrinsics(64, base_k=tdv.PROJECTION_INTRINSIC), jax_intrinsics(64, jnp.asarray(jdv.PROJECTION_INTRINSIC)))
