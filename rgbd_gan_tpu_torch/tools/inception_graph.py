"""A synthetic ``classify_image_graph_def.pb``: the ``inception-2015-12-05``
topology, with every node name and attr that the converter and the GraphDef
executor read, over random constants of the real shapes.

The repository cannot download the real artifact, so the converter chain
(``eval/tf_graphdef.py``, ``eval/graphdef_exec.py``,
``eval.inception.convert_tf_checkpoint``) is checked on this graph: the
tests and ``chip_smoke.py`` convert it, load the npz into
:class:`..eval.inception.InceptionV3` and run the graph itself through the
executor. The wiring follows the real pb (and ``build_wired_graphdef`` of
``tests/test_graphdef_exec.py``): ``{scope}/Conv2D`` ->
``{scope}/batchnorm`` -> the ReLU node ``{scope}``; the pools ``pool``,
``pool_1``, ``{block}/pool`` and ``{block}/tower_2/pool``; ``{block}/join``
Concat nodes (axis first); the input chain ``DecodeJpeg -> Cast ->
ExpandDims -> ResizeBilinear -> Sub -> Mul``, fed at ``ExpandDims:0``;
``pool_3``, an average pool over the whole remaining extent (8x8 at 299
px); and the biased head ``softmax/logits`` -> ``softmax`` behind the real
pb's batch-1 reshape.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..eval import tf_graphdef as gd
from ..eval.inception import BN_EPS, FEATURE_DIM, INPUT_SIZE, NUM_LOGITS, iter_conv_mappings, template_shapes


def synthetic_consts(rng: np.random.RandomState) -> Dict[str, np.ndarray]:
    """Random constants under every TF name the converter reads, shaped as
    the model's: conv kernels He-scaled (so that about 96 layers neither
    explode nor collapse), BatchNorm scales near 1 and variances in
    [0.5, 1.5], as the JAX package's tests draw them."""
    shapes = template_shapes()
    consts = {}
    for tf_scope, path in iter_conv_mappings():
        k = shapes[f"params/{path}/conv/kernel"]
        consts[f"{tf_scope}/conv2d_params"] = (rng.normal(size=k) * np.sqrt(2.0 / np.prod(k[:3]))).astype(np.float32)
        bn, c = f"{tf_scope}/batchnorm", k[-1]
        consts[f"{bn}/gamma"] = rng.uniform(0.8, 1.2, size=(c,)).astype(np.float32)
        consts[f"{bn}/beta"] = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
        consts[f"{bn}/moving_mean"] = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
        consts[f"{bn}/moving_variance"] = rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32)
    consts["softmax/weights"] = rng.normal(size=(FEATURE_DIM, NUM_LOGITS)).astype(np.float32)
    consts["softmax/biases"] = rng.normal(size=(NUM_LOGITS,)).astype(np.float32)
    return consts


def wired_graphdef(consts: Dict[str, np.ndarray], size: int = INPUT_SIZE, eps: float = BN_EPS) -> bytes:
    """Serialise the inception-2015 topology over ``consts`` for ``size`` px
    inputs (299, or 75: every stride-2 stage divides exactly at both)."""
    parts: List[bytes] = [gd.encode_const_node(name, arr) for name, arr in consts.items()]

    def conv_bn_relu(scope, inp, stride=1, padding="SAME"):
        bn = f"{scope}/batchnorm"
        parts.append(gd.encode_node(f"{scope}/Conv2D", "Conv2D", inputs=[inp, f"{scope}/conv2d_params"],
                                    str_attrs={"padding": padding},
                                    int_list_attrs={"strides": [1, stride, stride, 1]}))
        parts.append(gd.encode_node(bn, "BatchNormWithGlobalNormalization",
                                    inputs=[f"{scope}/Conv2D", f"{bn}/moving_mean", f"{bn}/moving_variance",
                                            f"{bn}/beta", f"{bn}/gamma"],
                                    float_attrs={"variance_epsilon": eps},
                                    bool_attrs={"scale_after_normalization": True}))
        parts.append(gd.encode_node(scope, "Relu", inputs=[bn]))
        return scope

    def pool(name, inp, kind, k=3, stride=1, padding="SAME"):
        parts.append(gd.encode_node(name, {"max": "MaxPool", "avg": "AvgPool"}[kind], inputs=[inp],
                                    str_attrs={"padding": padding},
                                    int_list_attrs={"ksize": [1, k, k, 1], "strides": [1, stride, stride, 1]}))
        return name

    def join(name, branches):
        parts.append(gd.encode_const_node(f"{name}/dim", np.array(3, np.int32)))
        parts.append(gd.encode_node(name, "Concat", inputs=[f"{name}/dim"] + branches))
        return name

    # the input chain (DecodeJpeg is never evaluated: the graph is fed at ExpandDims:0)
    parts += [
        gd.encode_node("DecodeJpeg", "DecodeJpeg"),
        gd.encode_node("Cast", "Cast", inputs=["DecodeJpeg"]),
        gd.encode_const_node("ExpandDims/dim", np.array(0, np.int32)),
        gd.encode_node("ExpandDims", "ExpandDims", inputs=["Cast", "ExpandDims/dim"]),
        gd.encode_const_node("ResizeBilinear/size", np.array([size, size], np.int32)),
        gd.encode_node("ResizeBilinear", "ResizeBilinear", inputs=["ExpandDims", "ResizeBilinear/size"],
                       bool_attrs={"align_corners": False}),
        gd.encode_const_node("Sub/y", np.array(128.0, np.float32)),
        gd.encode_node("Sub", "Sub", inputs=["ResizeBilinear", "Sub/y"]),
        gd.encode_const_node("Mul/y", np.array(0.0078125, np.float32)),
        gd.encode_node("Mul", "Mul", inputs=["Sub", "Mul/y"]),
    ]

    # the stem (VALID or SAME by kernel, as inception_score.py:581-605)
    h = conv_bn_relu("conv", "Mul", stride=2, padding="VALID")
    h = conv_bn_relu("conv_1", h, padding="VALID")
    h = conv_bn_relu("conv_2", h, padding="SAME")
    h = pool("pool", h, "max", stride=2, padding="VALID")
    h = conv_bn_relu("conv_3", h, padding="VALID")
    h = conv_bn_relu("conv_4", h, padding="VALID")
    h = pool("pool_1", h, "max", stride=2, padding="VALID")
    spatial = ((size - 3) // 2 + 1) - 2  # conv (s2 VALID), conv_1 (VALID; conv_2 is SAME)
    spatial = (spatial - 3) // 2 + 1 - 2  # pool, conv_4 (conv_3 is 1x1)
    spatial = (spatial - 3) // 2 + 1  # pool_1

    def mixed_a(b, inp):
        return join(f"{b}/join", [
            conv_bn_relu(f"{b}/conv", inp),
            conv_bn_relu(f"{b}/tower/conv_1", conv_bn_relu(f"{b}/tower/conv", inp)),
            conv_bn_relu(f"{b}/tower_1/conv_2", conv_bn_relu(
                f"{b}/tower_1/conv_1", conv_bn_relu(f"{b}/tower_1/conv", inp))),
            conv_bn_relu(f"{b}/tower_2/conv", pool(f"{b}/tower_2/pool", inp, "avg")),
        ])

    def mixed_b(b, inp):
        return join(f"{b}/join", [
            conv_bn_relu(f"{b}/conv", inp, stride=2, padding="VALID"),
            conv_bn_relu(f"{b}/tower/conv_2", conv_bn_relu(f"{b}/tower/conv_1", conv_bn_relu(f"{b}/tower/conv", inp)),
                         stride=2, padding="VALID"),
            pool(f"{b}/pool", inp, "max", stride=2, padding="VALID"),
        ])

    def mixed_c(b, inp):
        t = conv_bn_relu(f"{b}/tower/conv", inp)
        t = conv_bn_relu(f"{b}/tower/conv_2", conv_bn_relu(f"{b}/tower/conv_1", t))
        t1 = conv_bn_relu(f"{b}/tower_1/conv", inp)
        for i in range(1, 5):
            t1 = conv_bn_relu(f"{b}/tower_1/conv_{i}", t1)
        return join(f"{b}/join", [
            conv_bn_relu(f"{b}/conv", inp), t, t1,
            conv_bn_relu(f"{b}/tower_2/conv", pool(f"{b}/tower_2/pool", inp, "avg")),
        ])

    def mixed_d(b, inp):
        t = conv_bn_relu(f"{b}/tower/conv_1", conv_bn_relu(f"{b}/tower/conv", inp), stride=2, padding="VALID")
        t1 = conv_bn_relu(f"{b}/tower_1/conv", inp)
        t1 = conv_bn_relu(f"{b}/tower_1/conv_2", conv_bn_relu(f"{b}/tower_1/conv_1", t1))
        t1 = conv_bn_relu(f"{b}/tower_1/conv_3", t1, stride=2, padding="VALID")
        return join(f"{b}/join", [t, t1, pool(f"{b}/pool", inp, "max", stride=2, padding="VALID")])

    def mixed_e(b, inp, pool_kind):
        t = conv_bn_relu(f"{b}/tower/conv", inp)
        t = join(f"{b}/tower/join", [conv_bn_relu(f"{b}/tower/mixed/conv", t),
                                     conv_bn_relu(f"{b}/tower/mixed/conv_1", t)])
        t1 = conv_bn_relu(f"{b}/tower_1/conv_1", conv_bn_relu(f"{b}/tower_1/conv", inp))
        t1 = join(f"{b}/tower_1/join", [conv_bn_relu(f"{b}/tower_1/mixed/conv", t1),
                                        conv_bn_relu(f"{b}/tower_1/mixed/conv_1", t1)])
        return join(f"{b}/join", [
            conv_bn_relu(f"{b}/conv", inp), t, t1,
            conv_bn_relu(f"{b}/tower_2/conv", pool(f"{b}/tower_2/pool", inp, pool_kind)),
        ])

    for b in ("mixed", "mixed_1", "mixed_2"):
        h = mixed_a(b, h)
    h = mixed_b("mixed_3", h)
    spatial = (spatial - 3) // 2 + 1
    for b in ("mixed_4", "mixed_5", "mixed_6", "mixed_7"):
        h = mixed_c(b, h)
    h = mixed_d("mixed_8", h)
    spatial = (spatial - 3) // 2 + 1
    h = mixed_e("mixed_9", h, "avg")
    h = mixed_e("mixed_10", h, "max")
    # the real graph's pool_3 kernel is the whole remaining extent
    h = pool("pool_3", h, "avg", k=spatial, padding="VALID")

    # the biased in-graph head behind the real pb's batch-1 reshape
    fdim = consts["softmax/weights"].shape[0]
    parts += [
        gd.encode_const_node("pool_3/reshape/shape", np.array([1, fdim], np.int32)),
        gd.encode_node("pool_3/reshape", "Reshape", inputs=["pool_3", "pool_3/reshape/shape"]),
        gd.encode_node("softmax/logits/MatMul", "MatMul", inputs=["pool_3/reshape:0", "softmax/weights:0"]),
        gd.encode_node("softmax/logits", "BiasAdd", inputs=["softmax/logits/MatMul", "softmax/biases"]),
        gd.encode_node("softmax", "Softmax", inputs=["softmax/logits"]),
    ]
    return b"".join(parts)
