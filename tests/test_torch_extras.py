"""The port's auxiliary heads against the JAX package's, on the CPU: the
encoder (``Encoder``, its ``EncoderBlockBase`` and BatchNorm blocks), ``MLP``
(equalized and spectrally normalised), ``CameraParamDiscriminator``,
``BigBiGANDiscriminator`` (SN) and ``DisentangledDiscriminator``, and
``DiscriminatorBlock(bn=True)``; plus ``utils/image_processing``.

Weights: the port's init with seeded noise on every parameter and on the
BatchNorm running statistics, carried to the JAX modules by the bridge
(``variables_to_jax``: parameters under ``params/``, statistics under
``batch_stats/``, SN vectors under ``sn/``). Each case runs in training mode
(the batch's statistics, the running ones and the SN vectors updated) and,
where the module has BatchNorm or SN, in eval mode; it compares the outputs,
the input gradient of one scalar (the outputs weighted by fixed seeded
arrays) and the updated statistics and vectors. Tolerance: the largest
difference within ``REL`` = 1e-5 of the largest magnitude of the JAX value
(float32 sums taken in another order; BatchNorm over a batch of 4 divides
by small deviations). The JAX init's flat keys are a subset of the port's
with the same shapes (flax creates only the blocks a stage runs), and the
port's variables go to the JAX layout and back exactly.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_gan_tpu.models.discriminator import DiscriminatorBlock as JaxDiscriminatorBlock
from rgbd_gan_tpu.models.discriminator import DisentangledDiscriminator as JaxDisentangledDiscriminator
from rgbd_gan_tpu.models.extras import MLP as JaxMLP
from rgbd_gan_tpu.models.extras import BigBiGANDiscriminator as JaxBigBiGANDiscriminator
from rgbd_gan_tpu.models.extras import CameraParamDiscriminator as JaxCameraParamDiscriminator
from rgbd_gan_tpu.models.extras import Encoder as JaxEncoder
from rgbd_gan_tpu.train import checkpoint as jax_ckpt
from rgbd_gan_tpu.utils import image_processing as jax_image_processing
from rgbd_gan_tpu_torch.bridge import load_jax_variables, variables_to_jax
from rgbd_gan_tpu_torch.models.discriminator import DiscriminatorBlock, DisentangledDiscriminator
from rgbd_gan_tpu_torch.models.extras import MLP, BigBiGANDiscriminator, CameraParamDiscriminator, Encoder
from rgbd_gan_tpu_torch.utils import image_processing

# the suite runs several worker processes at once: leave them the other cores
torch.set_num_threads(2)

REL = 1e-5
CH, DIM_Z, BATCH = 16, 8, 4

# name: (port module from a torch.Generator, JAX module, variable collection, input shapes, static arguments)
CASES = {
    "encoder_even": (lambda g: Encoder(CH, DIM_Z, generator=g), lambda: JaxEncoder(ch=CH, dim_z=DIM_Z),
                     "batch_stats", [(BATCH, 32, 32, 3)], (6, 0.0)),
    "encoder_odd": (lambda g: Encoder(CH, DIM_Z, generator=g), lambda: JaxEncoder(ch=CH, dim_z=DIM_Z),
                    "batch_stats", [(BATCH, 32, 32, 3)], (5, 0.3)),
    "dis_block_bn": (lambda g: DiscriminatorBlock(CH // 2, CH, res=True, bn=True, generator=g),
                     lambda: JaxDiscriminatorBlock(CH // 2, CH, res=True, bn=True),
                     "batch_stats", [(BATCH, 8, 8, CH // 2)], ()),
    "mlp": (lambda g: MLP(DIM_Z, CH, 5, generator=g), lambda: JaxMLP(CH, 5), None, [(BATCH, DIM_Z)], ()),
    "mlp_sn": (lambda g: MLP(DIM_Z, CH, 5, sn=True, generator=g), lambda: JaxMLP(CH, 5, sn=True), "sn",
               [(BATCH, DIM_Z)], ()),
    "camera_param_dis": (lambda g: CameraParamDiscriminator(generator=g), JaxCameraParamDiscriminator, None,
                         [(BATCH, 9)], ()),
    "bigbigan_sn": (lambda g: BigBiGANDiscriminator(CH, DIM_Z, sn=True, res=True, generator=g),
                    lambda: JaxBigBiGANDiscriminator(CH, DIM_Z, sn=True, res=True), "sn",
                    [(BATCH, 32, 32, 3), (BATCH, DIM_Z), (BATCH, 9)], (6, 0.0)),
    "disentangled_odd": (lambda g: DisentangledDiscriminator(CH * 2, res=True, generator=g),
                         lambda: JaxDisentangledDiscriminator(CH * 2, res=True), None, [(BATCH, 32, 32, 3)],
                         (5, 0.3)),
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


def _perturb(flat, rng):
    """Noise on every parameter and running mean; running variances in
    [1, 1.2]; SN vectors as they are (unit vectors)."""
    out = {}
    for k, v in flat.items():
        if k.endswith("/u"):
            out[k] = v.copy()
        elif k.startswith("batch_stats/") and k.endswith("/var"):
            out[k] = (1.0 + 0.2 * rng.rand(*v.shape)).astype(v.dtype)
        else:
            out[k] = (v + 0.05 * rng.randn(*v.shape)).astype(v.dtype)
    return out


def _jax_variables(flat):
    cols = {}
    for k, v in flat.items():
        col, rest = k.split("/", 1)
        cols.setdefault(col, {})[rest] = v
    return {col: _unflatten(f) for col, f in cols.items()}


def _assert_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= REL * scale, (what, float(np.abs(got - want).max()), scale)


def _weighted_sum(outs, weights, lib):
    return sum(lib.sum(o * w) for o, w in zip(outs, weights))


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _port_run(module, flat, collection, inputs, static, train, weights):
    """Outputs, the scalar's input gradient and the variables after one
    forward in training or eval mode, from ``flat``."""
    load_jax_variables(module, flat, collection or "none")
    bn = collection == "batch_stats"
    module.train(train or bn)  # BatchNorm takes ``train`` as an argument; SN reads the module's mode
    x = [torch.tensor(a) for a in inputs]
    x[0].requires_grad_(True)
    outs = _as_tuple(module(*x, *static, **({"train": train} if bn else {})))
    _weighted_sum(outs, [torch.tensor(w) for w in weights], torch).backward()
    after = {k: v.copy() for k, v in variables_to_jax(module, collection or "none").items()}  # not views
    return [o.detach().numpy() for o in outs], x[0].grad.numpy(), after


def _jax_runs(jmod, variables, collection, inputs, static, weights):
    """The JAX twin of :func:`_port_run` in both modes, in one jitted call."""
    bn = collection == "batch_stats"

    def run(x0, train):
        mutable = [collection] if (train and collection) else False

        def scalar(x0):
            res = jmod.apply(variables, x0, *map(jnp.asarray, inputs[1:]), *static, mutable=mutable,
                             **({"train": train} if bn else {}))
            outs, new_vars = res if mutable else (res, {})
            outs = _as_tuple(outs)
            return _weighted_sum(outs, weights, jnp), (outs, new_vars)

        (_, (outs, new_vars)), grad = jax.value_and_grad(scalar, has_aux=True)(x0)
        return outs, grad, new_vars

    return jax.jit(lambda x0: (run(x0, True), run(x0, False)))(jnp.asarray(inputs[0]))


def _case(name):
    make, make_jax, collection, shapes, static = CASES[name]
    module = make(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(len(name))
    flat = _perturb(variables_to_jax(module, collection or "none"), rng)
    inputs = [rng.randn(*s).astype("f") for s in shapes]
    load_jax_variables(module, flat, collection or "none")
    with torch.no_grad():
        outs = _as_tuple(module(*[torch.tensor(a) for a in inputs], *static))
    weights = [np.random.RandomState(i).randn(*o.shape).astype("f") for i, o in enumerate(outs)]
    jmod = make_jax()
    results = {mode: _port_run(module, flat, collection, inputs, static, mode == "train", weights)
               for mode in ("train", "eval")}
    jresults = dict(zip(("train", "eval"), _jax_runs(jmod, _jax_variables(flat), collection, inputs, static, weights)))
    return dict(name=name, jmod=jmod, collection=collection, flat=flat, inputs=inputs, static=static,
                results=results, jresults=jresults)


@pytest.fixture(scope="module")
def cases():
    """Each case's variables and inputs, and both packages' results in
    training and in eval mode; the cases in threads, so that XLA compiles
    their JAX functions at once."""
    with ThreadPoolExecutor(4) as pool:
        futures = {name: pool.submit(_case, name) for name in CASES}
        return {name: f.result() for name, f in futures.items()}


@pytest.fixture(params=list(CASES))
def case(request, cases):
    return cases[request.param]


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_forward_and_input_gradient_match_jax(case, mode):
    name, flat = case["name"], case["flat"]
    outs, grad, got = case["results"][mode]
    jouts, jgrad, new_vars = case["jresults"][mode]
    assert len(outs) == len(jouts)
    for i, (o, jo) in enumerate(zip(outs, jouts)):
        _assert_close(o, jo, f"{name} output {i}")
    _assert_close(grad, jgrad, f"{name} input gradient")
    updated = jax_ckpt._flatten(new_vars)
    for k, v in updated.items():
        _assert_close(got[k], v, f"{name} {k} after the forward")
    if mode == "train" and case["collection"]:
        assert any(not np.array_equal(v, flat[k]) for k, v in updated.items()), f"{name}: nothing updated"
    if mode == "eval":  # eval mode leaves the statistics and the SN vectors as they were
        assert all(np.array_equal(got[k], flat[k]) for k in flat), name


def test_variables_load_from_the_jax_layout_and_save_back(case):
    """The JAX init's keys (of the blocks this stage runs) are the port's,
    with the same shapes; the port's variables go to the JAX layout and
    back unchanged."""
    name, jmod, collection, flat = case["name"], case["jmod"], case["collection"], case["flat"]
    inputs, static = case["inputs"], case["static"]
    bn = collection == "batch_stats"
    args = [jnp.asarray(a) for a in inputs] + list(static)
    init = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args, **({"train": True} if bn else {})))
    jshapes = {"/".join(str(p.key) for p in path): leaf.shape
               for path, leaf in jax.tree_util.tree_flatten_with_path(init)[0]}
    shapes = {k: v.shape for k, v in flat.items()}
    assert jshapes and all(shapes.get(k) == s for k, s in jshapes.items()), {
        k: (s, shapes.get(k)) for k, s in jshapes.items() if shapes.get(k) != s}
    fresh = CASES[name][0](torch.Generator().manual_seed(1))
    load_jax_variables(fresh, flat, collection or "none")
    back = variables_to_jax(fresh, collection or "none")
    assert back.keys() == flat.keys() and all(np.array_equal(back[k], flat[k]) for k in flat)


@pytest.mark.parametrize("as_tensor", [True, False], ids=["tensor", "array"])
def test_image_processing_matches_jax(as_tensor):
    x = np.random.RandomState(0).uniform(-1.3, 1.3, (2, 8, 8, 3)).astype("f")
    arg = torch.tensor(x) if as_tensor else x
    for fn in ("to_host", "postprocessing_tanh", "postprocessing_sigmoid"):
        got, want = getattr(image_processing, fn)(arg), getattr(jax_image_processing, fn)(jnp.asarray(x))
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=fn)
