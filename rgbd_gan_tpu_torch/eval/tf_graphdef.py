"""Minimal, dependency-free TensorFlow GraphDef reader (+ writer for tests).

Copy of :mod:`rgbd_gan_tpu.eval.tf_graphdef` (numpy only), so that the
port converts the OpenAI ``inception-2015-12-05`` GraphDef without the JAX
package. The reference converts it with TensorFlow
(``source/inception/download.py:35-246``); neither package needs TF: the
GraphDef protobuf wire format is parsed directly. Only what the converter
and the executor need is implemented: walking ``node`` messages, reading
``Const`` nodes' ``value`` TensorProtos (dtype / shape / tensor_content /
float_val) and scalar, string, bool and int-list attrs, and listing a
node's inputs.

Wire-format refresher (all we use): a message is a sequence of
``(field_number << 3 | wire_type)`` varint keys; wire type 0 = varint,
1 = 64-bit, 2 = length-delimited (nested messages, strings, bytes, packed
repeated scalars), 5 = 32-bit.

The writer mirrors the reader so that the converter's name->parameter
mapping and the executor's ops can be tested on synthetic GraphDefs
without TF installed.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# tensorflow DataType enum values we care about
DT_FLOAT = 1
DT_INT32 = 3

_WT_VARINT = 0
_WT_64BIT = 1
_WT_LEN = 2
_WT_32BIT = 5


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _iter_fields(buf: bytes, start: int, end: int) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value); LEN fields yield (start, end) spans."""
    pos = start
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == _WT_VARINT:
            val, pos = _read_varint(buf, pos)
            yield field, wt, val
        elif wt == _WT_64BIT:
            yield field, wt, buf[pos : pos + 8]
            pos += 8
        elif wt == _WT_LEN:
            ln, pos = _read_varint(buf, pos)
            yield field, wt, (pos, pos + ln)
            pos += ln
        elif wt == _WT_32BIT:
            yield field, wt, buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} at {pos}")


def _span_bytes(buf: bytes, span: Tuple[int, int]) -> bytes:
    return buf[span[0] : span[1]]


def _parse_tensor_shape(buf: bytes, span: Tuple[int, int]) -> List[int]:
    dims = []
    for field, wt, val in _iter_fields(buf, *span):
        if field == 2 and wt == _WT_LEN:  # dim
            size = 0
            for f2, w2, v2 in _iter_fields(buf, *val):
                if f2 == 1 and w2 == _WT_VARINT:  # size
                    # int64 two's complement; sizes are non-negative here
                    size = v2
            dims.append(size)
    return dims


def parse_tensor(buf: bytes, span: Tuple[int, int]) -> np.ndarray:
    """Parse a TensorProto span into a numpy array (float32/int32 consts)."""
    dtype = DT_FLOAT
    shape: List[int] = []
    content: Optional[bytes] = None
    float_vals: List[float] = []
    int_vals: List[int] = []
    for field, wt, val in _iter_fields(buf, *span):
        if field == 1 and wt == _WT_VARINT:  # dtype
            dtype = val
        elif field == 2 and wt == _WT_LEN:  # tensor_shape
            shape = _parse_tensor_shape(buf, val)
        elif field == 4 and wt == _WT_LEN:  # tensor_content
            content = _span_bytes(buf, val)
        elif field == 5:  # float_val (packed or unpacked)
            if wt == _WT_LEN:
                raw = _span_bytes(buf, val)
                float_vals.extend(struct.unpack(f"<{len(raw) // 4}f", raw))
            elif wt == _WT_32BIT:
                float_vals.append(struct.unpack("<f", val)[0])
        elif field == 7:  # int_val
            if wt == _WT_LEN:
                p = val[0]
                while p < val[1]:
                    v, p = _read_varint(buf, p)
                    int_vals.append(v)
            elif wt == _WT_VARINT:
                int_vals.append(val)

    if dtype == DT_FLOAT:
        np_dtype = np.float32
    elif dtype == DT_INT32:
        np_dtype = np.int32
    else:
        raise ValueError(f"unsupported TensorProto dtype {dtype}")

    n = int(np.prod(shape)) if shape else 1
    if content is not None:
        arr = np.frombuffer(content, dtype=np_dtype).copy()
    elif dtype == DT_FLOAT and float_vals:
        arr = np.asarray(float_vals, dtype=np.float32)
    elif dtype == DT_INT32 and int_vals:
        arr = np.asarray(int_vals, dtype=np.int32)
    else:
        arr = np.zeros((0,), dtype=np_dtype)
    if arr.size == 1 and n > 1:
        arr = np.full((n,), arr[0], dtype=np_dtype)  # repeated-value broadcast
    return arr.reshape(shape)


class GraphDef:
    """Parsed view of a GraphDef: node name -> (op, inputs, attr spans)."""

    def __init__(self, data: bytes):
        self._buf = data
        self.nodes: Dict[str, dict] = {}
        for field, wt, span in _iter_fields(data, 0, len(data)):
            if field == 1 and wt == _WT_LEN:  # node: NodeDef
                self._add_node(span)

    def _add_node(self, span: Tuple[int, int]) -> None:
        buf = self._buf
        name = ""
        op = ""
        inputs: List[str] = []
        attrs: Dict[str, Tuple[int, int]] = {}
        for field, wt, val in _iter_fields(buf, *span):
            if field == 1 and wt == _WT_LEN:  # name
                name = _span_bytes(buf, val).decode("utf-8")
            elif field == 2 and wt == _WT_LEN:  # op
                op = _span_bytes(buf, val).decode("utf-8")
            elif field == 3 and wt == _WT_LEN:  # input
                inputs.append(_span_bytes(buf, val).decode("utf-8"))
            elif field == 5 and wt == _WT_LEN:  # attr map entry
                k = None
                v_span = None
                for f2, w2, v2 in _iter_fields(buf, *val):
                    if f2 == 1 and w2 == _WT_LEN:
                        k = _span_bytes(buf, v2).decode("utf-8")
                    elif f2 == 2 and w2 == _WT_LEN:
                        v_span = v2
                if k is not None and v_span is not None:
                    attrs[k] = v_span
        if name:
            self.nodes[name] = {"op": op, "inputs": inputs, "attrs": attrs}

    # -- accessors ----------------------------------------------------------

    def const_tensor(self, name: str) -> np.ndarray:
        """The value of a Const node (its ``value`` attr TensorProto)."""
        node = self.nodes.get(name)
        if node is None:
            raise KeyError(f"no node named {name!r} in graph")
        attr_span = node["attrs"].get("value")
        if attr_span is None:
            raise KeyError(f"node {name!r} (op {node['op']}) has no 'value' attr")
        for field, wt, val in _iter_fields(self._buf, *attr_span):
            if field == 8 and wt == _WT_LEN:  # AttrValue.tensor
                return parse_tensor(self._buf, val)
        raise KeyError(f"node {name!r} 'value' attr carries no tensor")

    def _attr_span(self, name: str, attr: str) -> Tuple[int, int]:
        node = self.nodes.get(name)
        if node is None:
            raise KeyError(f"no node named {name!r} in graph")
        span = node["attrs"].get(attr)
        if span is None:
            raise KeyError(f"node {name!r} has no attr {attr!r}")
        return span

    def has_attr(self, name: str, attr: str) -> bool:
        node = self.nodes.get(name)
        return node is not None and attr in node["attrs"]

    def float_attr(self, name: str, attr: str) -> float:
        span = self._attr_span(name, attr)
        for field, wt, val in _iter_fields(self._buf, *span):
            if field == 4 and wt == _WT_32BIT:  # AttrValue.f
                return struct.unpack("<f", val)[0]
        raise KeyError(f"attr {attr!r} of {name!r} is not a float")

    def str_attr(self, name: str, attr: str) -> str:
        """AttrValue.s (e.g. a Conv2D's ``padding``)."""
        span = self._attr_span(name, attr)
        for field, wt, val in _iter_fields(self._buf, *span):
            if field == 2 and wt == _WT_LEN:  # AttrValue.s
                return _span_bytes(self._buf, val).decode("utf-8")
        raise KeyError(f"attr {attr!r} of {name!r} is not a string")

    def int_attr(self, name: str, attr: str) -> int:
        span = self._attr_span(name, attr)
        for field, wt, val in _iter_fields(self._buf, *span):
            if field == 3 and wt == _WT_VARINT:  # AttrValue.i
                return val
        raise KeyError(f"attr {attr!r} of {name!r} is not an int")

    def bool_attr(self, name: str, attr: str) -> bool:
        span = self._attr_span(name, attr)
        for field, wt, val in _iter_fields(self._buf, *span):
            if field == 5 and wt == _WT_VARINT:  # AttrValue.b
                return bool(val)
        raise KeyError(f"attr {attr!r} of {name!r} is not a bool")

    def int_list_attr(self, name: str, attr: str) -> List[int]:
        """AttrValue.list.i (e.g. ``strides`` / ``ksize``); packed or not."""
        span = self._attr_span(name, attr)
        for field, wt, val in _iter_fields(self._buf, *span):
            if field == 1 and wt == _WT_LEN:  # AttrValue.list
                out: List[int] = []
                for f2, w2, v2 in _iter_fields(self._buf, *val):
                    if f2 == 3:  # ListValue.i
                        if w2 == _WT_VARINT:
                            out.append(v2)
                        elif w2 == _WT_LEN:  # packed
                            p = v2[0]
                            while p < v2[1]:
                                x, p = _read_varint(self._buf, p)
                                out.append(x)
                return out
        raise KeyError(f"attr {attr!r} of {name!r} is not an int list")

    def node_input(self, name: str, index: int) -> str:
        """The producer node name of a node's i-th input (tensor suffix stripped)."""
        node = self.nodes.get(name)
        if node is None:
            raise KeyError(f"no node named {name!r} in graph")
        src = node["inputs"][index]
        return src.split(":")[0].lstrip("^")


# ---------------------------------------------------------------------------
# writing (tests only)
# ---------------------------------------------------------------------------


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_field(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | _WT_LEN) + _varint(len(payload)) + payload


def _varint_field(field: int, v: int) -> bytes:
    return _varint(field << 3 | _WT_VARINT) + _varint(v)


def _f32_field(field: int, v: float) -> bytes:
    return _varint(field << 3 | _WT_32BIT) + struct.pack("<f", v)


def encode_tensor(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    if arr.dtype == np.float32:
        dt = DT_FLOAT
    elif arr.dtype == np.int32:
        dt = DT_INT32
    else:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    shape = b"".join(
        _len_field(2, _varint_field(1, int(d))) for d in arr.shape
    )
    out = _varint_field(1, dt) + _len_field(2, shape)
    out += _len_field(4, arr.tobytes())  # tensor_content
    return out


def encode_const_node(name: str, arr: np.ndarray) -> bytes:
    attr_value = _len_field(8, encode_tensor(arr))  # AttrValue.tensor
    attr_entry = _len_field(1, b"value") + _len_field(2, attr_value)
    node = (
        _len_field(1, name.encode())
        + _len_field(2, b"Const")
        + _len_field(5, attr_entry)
    )
    return _len_field(1, node)  # GraphDef.node


def encode_node(name: str, op: str, inputs: List[str] = (),
                float_attrs: Dict[str, float] = None,
                str_attrs: Dict[str, str] = None,
                int_attrs: Dict[str, int] = None,
                bool_attrs: Dict[str, bool] = None,
                int_list_attrs: Dict[str, List[int]] = None) -> bytes:
    node = _len_field(1, name.encode()) + _len_field(2, op.encode())
    for i in inputs:
        node += _len_field(3, i.encode())

    def _attr(k: str, payload: bytes) -> bytes:
        return _len_field(5, _len_field(1, k.encode()) + _len_field(2, payload))

    for k, v in (float_attrs or {}).items():
        node += _attr(k, _f32_field(4, v))
    for k, v in (str_attrs or {}).items():
        node += _attr(k, _len_field(2, v.encode()))
    for k, v in (int_attrs or {}).items():
        node += _attr(k, _varint_field(3, v))
    for k, v in (bool_attrs or {}).items():
        node += _attr(k, _varint_field(5, int(v)))
    for k, vs in (int_list_attrs or {}).items():
        lst = b"".join(_varint_field(3, int(v)) for v in vs)
        node += _attr(k, _len_field(1, lst))  # AttrValue.list
    return _len_field(1, node)
