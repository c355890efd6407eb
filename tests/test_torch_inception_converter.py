"""The port's Inception converter chain (``eval/tf_graphdef.py``,
``eval/graphdef_exec.py``, ``eval/inception_score_compat.py``,
``eval/inception.convert_tf_checkpoint``, ``tools/convert_inception.py``
and the synthetic graph of ``tools/inception_graph.py``) against the JAX
package's, on the CPU.

- The wire-format reader and writer: the cases of
  ``tests/test_inception_converter.py:17-60``, bytes equal and tensors equal.
- The synthetic graph: the port's ``wired_graphdef`` writes the bytes of
  ``build_wired_graphdef`` in ``tests/test_graphdef_exec.py`` (on small
  constants: that one grows its bytes by copies); the converter's template is the JAX
  model's, key for key.
- The converter: one fully wired 75 px GraphDef over random constants of
  the real shapes through both converters gives npz files equal key for
  key, bit for bit; the tool's ``.tgz`` route writes the same file and
  checks it with a forward; a graph without the logit head is refused and
  one with another BatchNorm epsilon warns.
- The executor's ops against ``rgbd_gan_tpu.eval.graphdef_exec`` on the
  small graphs of ``tests/test_graphdef_exec.py:46-157``, within
  ``OP_ATOL`` (the same float32 products summed in another order).
- The wired graph through the port's executor against the port's
  Inception-v3 loaded from the converted npz, with TF's
  count-exclude-padding average pool swapped in as that file swaps it into
  its numpy twin (the JAX package's numpy executor is not run on a full
  graph: it is slow); and the ``inception_score_compat`` API end to end.
"""

import tarfile

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax

from rgbd_gan_tpu.eval import graphdef_exec as jax_gx
from rgbd_gan_tpu.eval import inception as jax_inception
from rgbd_gan_tpu.eval import tf_graphdef as jax_gd
from rgbd_gan_tpu_torch.eval import graphdef_exec as gx
from rgbd_gan_tpu_torch.eval import inception
from rgbd_gan_tpu_torch.eval import inception_score_compat as compat
from rgbd_gan_tpu_torch.eval import tf_graphdef as gd
from rgbd_gan_tpu_torch.tools import convert_inception
from rgbd_gan_tpu_torch.tools.inception_graph import synthetic_consts, wired_graphdef
from test_graphdef_exec import build_wired_graphdef

torch.set_num_threads(2)

OP_ATOL = 1e-5
# the wired graph's pool_3 features, executor vs model, over the largest
# feature (float32 in both, the convs summed in other orders)
FEATURE_REL = 1e-4


# ---------------------------------------------------------------------------
# the wire format
# ---------------------------------------------------------------------------

ARRAYS = [np.arange(24, dtype=np.float32).reshape(2, 3, 4), np.array(7, np.int32),
          np.random.RandomState(0).normal(size=(3, 3, 2, 5)).astype(np.float32), np.array([4, 4], np.int32)]


@pytest.mark.parametrize("arr", ARRAYS, ids=lambda a: f"{a.dtype}{list(a.shape)}")
def test_const_node_bytes_and_tensor_match_jax(arr):
    blob = gd.encode_const_node("x", arr)
    assert blob == jax_gd.encode_const_node("x", arr)
    got, want = gd.GraphDef(blob).const_tensor("x"), jax_gd.GraphDef(blob).const_tensor("x")
    assert got.dtype == want.dtype and np.array_equal(got, want) and np.array_equal(got, arr)


def test_float_val_broadcast_matches_jax():
    shape = gd._len_field(2, gd._varint_field(1, 3))
    tensor = gd._varint_field(1, gd.DT_FLOAT) + gd._len_field(2, shape) + gd._f32_field(5, 2.5)
    attr_entry = gd._len_field(1, b"value") + gd._len_field(2, gd._len_field(8, tensor))
    blob = gd._len_field(1, gd._len_field(1, b"c") + gd._len_field(2, b"Const") + gd._len_field(5, attr_entry))
    assert blob == jax_gd._len_field(1, jax_gd._len_field(1, b"c") + jax_gd._len_field(2, b"Const")
                                     + jax_gd._len_field(5, attr_entry))
    np.testing.assert_array_equal(gd.GraphDef(blob).const_tensor("c"), np.full((3,), 2.5, np.float32))
    np.testing.assert_array_equal(gd.GraphDef(blob).const_tensor("c"), jax_gd.GraphDef(blob).const_tensor("c"))


def test_node_inputs_and_attrs_match_jax():
    kwargs = dict(inputs=["a:0", "^w"], float_attrs={"variance_epsilon": 1e-3}, str_attrs={"padding": "SAME"},
                  int_attrs={"n": 300}, bool_attrs={"transpose_b": True}, int_list_attrs={"strides": [1, 2, 2, 1]})
    blob = gd.encode_node("op", "Conv2D", **kwargs)
    assert blob == jax_gd.encode_node("op", "Conv2D", **kwargs)
    mine, theirs = gd.GraphDef(blob), jax_gd.GraphDef(blob)
    assert mine.nodes["op"]["inputs"] == theirs.nodes["op"]["inputs"] == ["a:0", "^w"]
    assert mine.node_input("op", 0) == "a" and mine.node_input("op", 1) == "w"
    assert mine.float_attr("op", "variance_epsilon") == theirs.float_attr("op", "variance_epsilon") \
        == pytest.approx(1e-3)
    assert mine.str_attr("op", "padding") == "SAME" and mine.int_attr("op", "n") == 300
    assert mine.bool_attr("op", "transpose_b") and mine.int_list_attr("op", "strides") == [1, 2, 2, 1]
    assert not mine.has_attr("op", "nonesuch") and not mine.has_attr("nonesuch", "padding")


# ---------------------------------------------------------------------------
# the synthetic graph, the converter and the tool
# ---------------------------------------------------------------------------

SIZE = 75  # every stride-2 stage divides exactly, as at 299


@pytest.fixture(scope="module")
def wired(tmp_path_factory):
    """The wired graph over random constants, its softmax weights scaled so
    that the probabilities stay positive (the reference's IS takes a log
    without an epsilon), as ``test_graphdef_exec.py``'s ``compat_pb``
    does: (its pb, the port's npz of it, the JAX package's, the
    constants)."""
    out = tmp_path_factory.mktemp("wired")
    rng = np.random.RandomState(13)
    consts = synthetic_consts(rng)
    probe = rng.uniform(0, 255, size=(1, SIZE, SIZE, 3)).astype(np.float32)
    feats = gx.GraphExecutor(gd.GraphDef(wired_graphdef(consts, SIZE))).run(
        "pool_3:0", {"ExpandDims:0": probe}).reshape(1, -1).numpy()
    scale = 8.0 / (np.linalg.norm(feats) * np.sqrt(feats.shape[1]))
    consts["softmax/weights"] = (rng.normal(size=consts["softmax/weights"].shape) * scale).astype(np.float32)
    pb = out / "classify_image_graph_def.pb"
    pb.write_bytes(wired_graphdef(consts, SIZE))
    inception.convert_tf_checkpoint(str(pb), str(out / "port.npz"))
    jax_inception.convert_tf_checkpoint(str(pb), str(out / "jax.npz"))
    return pb, out / "port.npz", out / "jax.npz", consts


def _npz_equal(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert x.files == y.files
        for k in x.files:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


def test_wired_graphdef_writes_the_jax_tests_bytes():
    consts = {k: np.full((1,) * min(v.ndim, 1), 0.5, np.float32) for k, v in synthetic_consts(
        np.random.RandomState(0)).items() if k != "softmax/weights"}
    consts["softmax/weights"] = np.zeros((inception.FEATURE_DIM, 2), np.float32)
    for size, eps in ((SIZE, inception.BN_EPS), (299, 1e-5)):
        assert wired_graphdef(consts, size, eps) == build_wired_graphdef(consts, size, eps)


def test_mapping_and_template_match_jax():
    """The scope mapping is the JAX package's and reaches every conv of the
    port's model; the converter's template (keys and flat shapes) is the JAX
    model's."""
    assert list(inception.iter_conv_mappings()) == list(jax_inception.iter_conv_mappings())
    with torch.device("meta"):
        convs = {name.replace(".", "/")[: -len(".conv")] for name, m in inception.InceptionV3().named_modules()
                 if isinstance(m, torch.nn.Conv2d)}
    assert {path for _, path in inception.iter_conv_mappings()} == convs
    variables = jax.eval_shape(lambda: jax_inception.init_inception(jax.random.PRNGKey(0))[1])
    want = {"/".join(str(p.key) for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]}
    assert inception.template_shapes() == want


def test_converter_writes_the_jax_npz(wired):
    _, port_npz, jax_npz, consts = wired
    _npz_equal(port_npz, jax_npz)
    model = inception.load_params(str(port_npz))
    np.testing.assert_array_equal(model.logit.weight.numpy(), consts["softmax/weights"].T)
    np.testing.assert_array_equal(model.mixed_4.b7x7dbl_3.conv.weight.numpy(),
                                  consts["mixed_4/tower_1/conv_2/conv2d_params"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(model.mixed_10.bpool.bn.var.numpy(),
                                  consts["mixed_10/tower_2/conv/batchnorm/moving_variance"])


def test_converter_refuses_a_graph_without_the_head_and_warns_on_eps(wired, tmp_path):
    consts = wired[3]
    blob = b"".join(gd.encode_const_node(k, v) for k, v in consts.items() if not k.startswith("softmax"))
    (tmp_path / "g.pb").write_bytes(blob)
    with pytest.raises(KeyError):
        inception.convert_tf_checkpoint(str(tmp_path / "g.pb"), str(tmp_path / "o.npz"))
    (tmp_path / "e.pb").write_bytes(wired_graphdef(consts, SIZE, eps=1e-5))
    with pytest.warns(UserWarning, match="variance_epsilon"):
        inception.convert_tf_checkpoint(str(tmp_path / "e.pb"), str(tmp_path / "o.npz"))


def test_tool_converts_the_tarball(wired, tmp_path, capsys):
    pb, _, jax_npz, _ = wired
    tgz = tmp_path / "inception-2015-12-05.tgz"
    with tarfile.open(tgz, "w:gz") as tar:
        tar.add(pb, arcname=convert_inception.PB_NAME)
    convert_inception.main([str(tgz), "--out", str(tmp_path / "tool.npz"), "--device", "cpu"])
    _npz_equal(tmp_path / "tool.npz", jax_npz)
    assert "OK: use it via" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the executor's ops against the JAX package's (tests/test_graphdef_exec.py:46-157)
# ---------------------------------------------------------------------------


def _both(blob, fetch, feeds=None):
    got = gx.GraphExecutor(gd.GraphDef(blob)).run(fetch, feeds)
    want = jax_gx.GraphExecutor(jax_gd.GraphDef(blob)).run(fetch, feeds)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == np.shape(want)
    return got, want


@pytest.mark.parametrize("size,stride,padding", [(4, 2, "SAME"), (5, 2, "SAME"), (5, 1, "SAME"), (6, 2, "VALID")])
def test_conv2d_matches_jax(size, stride, padding):
    rng = np.random.RandomState(size + stride)
    x = rng.normal(size=(2, size, size, 2)).astype(np.float32)
    blob = gd.encode_const_node("w", rng.normal(size=(3, 3, 2, 5)).astype(np.float32))
    blob += gd.encode_node("y", "Conv2D", inputs=["x", "w"], str_attrs={"padding": padding},
                           int_list_attrs={"strides": [1, stride, stride, 1]})
    got, want = _both(blob, "y", {"x": x})
    np.testing.assert_allclose(got, want, atol=OP_ATOL)


@pytest.mark.parametrize("kind,k,stride,padding", [
    ("AvgPool", 3, 1, "SAME"), ("AvgPool", 3, 2, "SAME"), ("AvgPool", 2, 2, "VALID"),
    ("MaxPool", 3, 2, "VALID"), ("MaxPool", 3, 1, "SAME"),
])
def test_pools_match_jax(kind, k, stride, padding):
    x = np.random.RandomState(k).normal(size=(1, 6, 5, 3)).astype(np.float32)
    blob = gd.encode_node("y", kind, inputs=["x"], str_attrs={"padding": padding},
                          int_list_attrs={"ksize": [1, k, k, 1], "strides": [1, stride, stride, 1]})
    got, want = _both(blob, "y", {"x": x})
    np.testing.assert_allclose(got, want, atol=OP_ATOL)


def test_avgpool_same_excludes_padding():
    blob = gd.encode_node("y", "AvgPool", inputs=["x"], str_attrs={"padding": "SAME"},
                          int_list_attrs={"ksize": [1, 3, 3, 1], "strides": [1, 1, 1, 1]})
    got, want = _both(blob, "y", {"x": np.ones((1, 3, 3, 1), np.float32)})
    np.testing.assert_array_equal(got, np.ones((1, 3, 3, 1)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size,align", [((4, 4), False), ((2, 3), False), ((5, 3), True), ((3, 7), False)])
def test_resize_bilinear_matches_jax(size, align):
    x = np.random.RandomState(3).normal(size=(2, 2, 3, 2)).astype(np.float32)
    blob = gd.encode_const_node("size", np.array(size, np.int32))
    blob += gd.encode_node("y", "ResizeBilinear", inputs=["x", "size"], bool_attrs={"align_corners": align})
    got, want = _both(blob, "y", {"x": x})
    np.testing.assert_allclose(got, want, atol=1e-6)
    if size == x.shape[1:3]:
        np.testing.assert_array_equal(got, x)  # the identity resize is exact


def test_concat_and_concat_v2_arg_orders():
    a, b = np.ones((1, 2), np.float32), np.zeros((1, 3), np.float32)
    blob = gd.encode_const_node("dim", np.array(1, np.int32))
    blob += gd.encode_node("c1", "Concat", inputs=["dim", "a", "b"])
    blob += gd.encode_node("c2", "ConcatV2", inputs=["a", "b", "dim"])
    for fetch in ("c1", "c2"):
        got, want = _both(blob, fetch, {"a": a, "b": b})
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.concatenate([a, b], axis=1))


@pytest.mark.parametrize("scale_after", [True, False])
def test_matmul_bn_reshape_squeeze_match_jax(scale_after):
    rng = np.random.RandomState(1)
    a, b = rng.normal(size=(2, 3)).astype(np.float32), rng.normal(size=(4, 3)).astype(np.float32)
    blob = gd.encode_node("mm", "MatMul", inputs=["a", "b"], bool_attrs={"transpose_b": True})
    got, want = _both(blob, "mm", {"a": a, "b": b})
    np.testing.assert_allclose(got, want, atol=1e-6)

    x = rng.normal(size=(1, 2, 2, 3)).astype(np.float32)
    stats = dict(m=rng.normal(size=3), v=rng.uniform(0.5, 2, 3), beta=rng.normal(size=3), gamma=rng.normal(size=3))
    feeds = dict(x=x, **{k: v.astype(np.float32) for k, v in stats.items()})
    blob = gd.encode_node("bn", "BatchNormWithGlobalNormalization", inputs=["x", "m", "v", "beta", "gamma"],
                          float_attrs={"variance_epsilon": 1e-3},
                          bool_attrs={"scale_after_normalization": scale_after})
    got, want = _both(blob, "bn", feeds)
    np.testing.assert_allclose(got, want, atol=OP_ATOL)

    blob = gd.encode_const_node("shape", np.array([-1, 4], np.int32))
    blob += gd.encode_node("r", "Reshape", inputs=["x", "shape"])
    blob += gd.encode_node("s", "Squeeze", inputs=["p"], int_list_attrs={"squeeze_dims": [1, 2]})
    got, want = _both(blob, "r", {"x": x})
    np.testing.assert_array_equal(got, want)
    p = rng.normal(size=(2, 1, 1, 5)).astype(np.float32)
    got, want = _both(blob, "s", {"p": p})
    assert got.shape == (2, 5)
    np.testing.assert_array_equal(got, want)


def test_unfed_decode_jpeg_raises():
    blob = gd.encode_node("DecodeJpeg", "DecodeJpeg") + gd.encode_node("Cast", "Cast", inputs=["DecodeJpeg"])
    with pytest.raises(KeyError, match="must be fed"):
        gx.GraphExecutor(gd.GraphDef(blob)).run("Cast")


# ---------------------------------------------------------------------------
# the wired graph: executor vs the converted model, and the compat API
# ---------------------------------------------------------------------------


def test_wired_graph_matches_the_converted_model(wired, monkeypatch):
    pb, npz, _, _ = wired
    x = np.random.RandomState(5).uniform(0, 255, size=(2, SIZE, SIZE, 3)).astype(np.float32)
    ex = gx.GraphExecutor(gd.GraphDef(pb.read_bytes()))
    pool3 = ex.run("pool_3:0", {"ExpandDims:0": x})
    assert tuple(pool3.shape) == (2, 1, 1, inception.FEATURE_DIM)
    model = inception.load_params(str(npz))
    with torch.no_grad():
        own = model(torch.from_numpy(x), get_feature=True)
        monkeypatch.setattr(inception, "_avg_pool_3x3", lambda h: F.avg_pool2d(h, 3, 1, 1, count_include_pad=False))
        tf_pool = model(torch.from_numpy(x), get_feature=True)
        logits = [ex.run("softmax/logits:0", {"ExpandDims:0": x[i:i + 1]}) for i in range(2)]
        want_logits = model.logit(tf_pool)
    feat, scale = pool3.reshape(2, -1), float(tf_pool.abs().max())
    assert float((feat - tf_pool).abs().max()) <= FEATURE_REL * scale
    # the model's own padded average pools count the padding: the graph's do not
    assert float((feat - own).abs().max()) > 10 * FEATURE_REL * scale
    np.testing.assert_allclose(torch.cat(logits).numpy(), want_logits.numpy(),
                               atol=FEATURE_REL * float(want_logits.abs().max()))


def test_compat_api_end_to_end(wired, monkeypatch):
    pb, _, _, consts = wired
    for name in ("_executor", "_logit_w", "softmax", "last_layer"):  # this test owns the module's state
        monkeypatch.setattr(compat, name, None)
    compat._init_inception(str(pb), device="cpu")
    ims = np.random.RandomState(9).uniform(0, 255, size=(6, 3, SIZE, SIZE)).astype(np.float32)  # NCHW
    feats = compat.inception_forward(ims, "last_layer")
    assert feats.shape == (6, inception.FEATURE_DIM)
    probs = compat.inception_forward(ims, "softmax")
    assert np.all(probs > 0), "softmax saturated: the wired fixture's calibration broke"
    logits = feats @ consts["softmax/weights"]  # no bias (inception_score_tf.py:150-153)
    want = np.exp(logits - logits.max(axis=-1, keepdims=True))
    np.testing.assert_allclose(probs, want / want.sum(axis=-1, keepdims=True), atol=1e-5)
    m, cov = compat.get_mean_and_cov(ims)
    np.testing.assert_allclose(m, feats.mean(0), atol=1e-6)
    np.testing.assert_allclose(cov, np.cov(feats, rowvar=False), atol=1e-6)
    is_mean, is_std = compat.get_inception_score(ims, splits=2)
    scores = []
    for i in range(2):
        part = probs[i * 3:(i + 1) * 3]
        scores.append(np.exp((part * (np.log(part) - np.log(part.mean(0, keepdims=True)))).sum(1).mean()))
    assert is_mean == pytest.approx(np.mean(scores), rel=1e-5) and is_std == pytest.approx(np.std(scores), rel=1e-5)
    labels = np.argmax(probs[:, 1:1001], axis=1)
    assert compat.get_inception_accuracy(ims, labels) == 1.0
    assert compat.get_inception_accuracy([ims, ims], labels) == 1.0
    with pytest.raises(AssertionError):  # [0, 1] images break the reference's max > 10 assert (:32)
        compat.inception_forward(ims / 255.0, "last_layer")
