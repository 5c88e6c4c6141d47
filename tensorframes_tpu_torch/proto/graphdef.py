"""GraphDef message layer: parse / build TensorFlow GraphDef protos.

The PyTorch port keeps its own copy of `tensorframes_tpu/proto/graphdef.py`;
the wire bytes are the interchange with the JAX package.

Wire-compatible with `tensorflow/core/framework/{graph,node_def,attr_value,
tensor,tensor_shape,types}.proto` — the same contract the reference vendors
(26 proto files under `src/main/protobuf/tensorflow/core/framework/`) and
keeps as its interchange format. Keeping GraphDef as the interchange format
preserves compatibility with the reference's serialized test graphs and
with frozen model exports (e.g. Inception-v3), per SURVEY.md §7.2.

Field numbers below are the public wire contract of those protos; messages
are hand-modelled on top of the `wire` codec rather than protoc-generated
(see `wire.py` for why).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np

from ..schema import ScalarType, Shape, UnsupportedTypeError
from . import wire

__all__ = [
    "TensorShapeProto",
    "TensorProto",
    "AttrValue",
    "AttrListValue",
    "NodeDef",
    "GraphDef",
]


# ---------------------------------------------------------------------------
# TensorShapeProto
# ---------------------------------------------------------------------------

@dataclass
class TensorShapeProto:
    dims: List[int] = field(default_factory=list)  # -1 = unknown dim
    unknown_rank: bool = False

    @classmethod
    def from_bytes(cls, data: bytes) -> "TensorShapeProto":
        dims: List[int] = []
        unknown_rank = False
        for f, _, v in wire.iter_fields(data):
            if f == 2:  # dim
                size = 0
                for f2, _, v2 in wire.iter_fields(v):
                    if f2 == 1:
                        size = wire.to_signed64(v2)
                dims.append(size)
            elif f == 3:
                unknown_rank = bool(v)
        return cls(dims, unknown_rank)

    def to_bytes(self) -> bytes:
        out = bytearray()
        for d in self.dims:
            dim = bytearray()
            if d != 0:
                wire.write_varint_field(dim, 1, d)
            wire.write_len_field(out, 2, bytes(dim))
        if self.unknown_rank:
            wire.write_varint_field(out, 3, 1)
        return bytes(out)

    @classmethod
    def from_shape(cls, shape: Optional[Shape]) -> "TensorShapeProto":
        if shape is None:
            return cls(unknown_rank=True)
        return cls([-1 if d is None else d for d in shape.dims])

    def to_shape(self) -> Optional[Shape]:
        """None means unknown rank."""
        if self.unknown_rank:
            return None
        return Shape(self.dims)


# ---------------------------------------------------------------------------
# TensorProto
# ---------------------------------------------------------------------------

# (field number, struct char or None) per dtype for the repeated *_val fields.
_VAL_FIELD = {
    ScalarType.float32: 5,
    ScalarType.float64: 6,
    ScalarType.int32: 7,
    ScalarType.int64: 10,
    ScalarType.bool_: 11,
    ScalarType.uint32: 16,
    ScalarType.uint64: 17,
    ScalarType.int16: 7,   # int16/int8/uint8 ride the int_val field
    ScalarType.int8: 7,
    ScalarType.uint8: 7,
    ScalarType.float16: 13,  # half_val (bit patterns in int32)
    ScalarType.bfloat16: 13,
}


@dataclass
class TensorProto:
    dtype: ScalarType
    shape: Shape
    tensor_content: bytes = b""
    values: List = field(default_factory=list)  # typed *_val fallback
    string_values: List[bytes] = field(default_factory=list)

    @classmethod
    def from_bytes(cls, data: bytes) -> "TensorProto":
        dtype = ScalarType.float32
        shape = Shape(())
        content = b""
        values: List = []
        string_values: List[bytes] = []
        for f, wt, v in wire.iter_fields(data):
            if f == 1:
                dtype = ScalarType.from_tf_datatype(v)
            elif f == 2:
                sp = TensorShapeProto.from_bytes(v).to_shape()
                shape = sp if sp is not None else Shape(())
            elif f == 4:
                content = v
            elif f == 5:  # float_val
                values.extend(
                    wire.unpack_floats(v) if wt == wire.WIRETYPE_LEN
                    else [struct.unpack("<f", v)[0]]
                )
            elif f == 6:  # double_val
                values.extend(
                    wire.unpack_doubles(v) if wt == wire.WIRETYPE_LEN
                    else [struct.unpack("<d", v)[0]]
                )
            elif f in (7, 10, 11, 13, 16, 17):  # int/int64/bool/half/uint
                if wt == wire.WIRETYPE_LEN:
                    values.extend(wire.unpack_varints(v))
                else:
                    values.append(wire.to_signed64(v))
            elif f == 8:  # string_val
                string_values.append(v)
        return cls(dtype, shape, content, values, string_values)

    def to_numpy(self) -> np.ndarray:
        """Materialize, following TF's MakeNdarray semantics: prefer
        tensor_content; else the typed val list, broadcasting a single value
        (TF repeats the last given value to fill the shape)."""
        if self.dtype is ScalarType.string:
            arr = np.array(
                [s.decode("utf-8", "surrogateescape") for s in self.string_values],
                dtype=object,
            )
            n = self.shape.num_elements
            if n is not None and arr.size == 1 and n > 1:
                arr = np.repeat(arr, n)
            if n is not None and arr.size == 0 and n > 0:
                # proto3 elides default values for strings too: absent
                # string_val means every element is "" (TF MakeNdarray
                # pads with the empty string)
                arr = np.array([""] * n, dtype=object)
            return arr.reshape(self.shape.assert_concrete())
        np_dt = self.dtype.np_dtype
        n = self.shape.num_elements
        if n is None:
            raise ValueError("TensorProto with unknown shape")
        if self.tensor_content:
            arr = np.frombuffer(self.tensor_content, dtype=np_dt.newbyteorder("<"))
            arr = arr.astype(np_dt)
        elif self.dtype in (ScalarType.float16, ScalarType.bfloat16):
            # half_val carries raw bit patterns in int32s.
            bits = np.asarray(self.values, dtype=np.uint16)
            arr = bits.view(np_dt)
        else:
            arr = np.asarray(self.values, dtype=np_dt)
        if arr.size < n:
            if arr.size == 0:
                # proto3 elides default values entirely: no content and
                # no typed values means every element is zero (TF's
                # MakeNdarray semantics — EfficientNet's frozen graphs
                # carry e.g. a scalar 0.0 Cast operand this way)
                arr = np.zeros(n, np_dt)
            else:
                # TF fills by repeating the last value.
                arr = np.concatenate(
                    [arr, np.full(n - arr.size, arr[-1], np_dt)]
                )
        return arr[:n].reshape(self.shape.assert_concrete())

    @classmethod
    def from_numpy(cls, arr: np.ndarray) -> "TensorProto":
        # NB: np.ascontiguousarray would promote 0-d arrays to 1-d.
        arr = np.asarray(arr, order="C")
        dtype = ScalarType.from_np_dtype(arr.dtype)
        if dtype is ScalarType.string:
            flat = [
                (s if isinstance(s, bytes) else str(s).encode("utf-8"))
                for s in arr.ravel()
            ]
            return cls(dtype, Shape(arr.shape), string_values=flat)
        le = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
        return cls(dtype, Shape(arr.shape), tensor_content=le.tobytes())

    def to_bytes(self) -> bytes:
        out = bytearray()
        wire.write_varint_field(out, 1, self.dtype.tf_datatype)
        wire.write_len_field(
            out, 2, TensorShapeProto.from_shape(self.shape).to_bytes()
        )
        if self.dtype is ScalarType.string:
            for s in self.string_values:
                wire.write_len_field(out, 8, s)
        elif self.tensor_content:
            wire.write_len_field(out, 4, self.tensor_content)
        elif self.values:
            fnum = _VAL_FIELD[self.dtype]
            if fnum == 5:
                for v in self.values:
                    wire.write_float_field(out, 5, float(v))
            elif fnum == 6:
                for v in self.values:
                    wire.write_tag(out, 6, wire.WIRETYPE_FIXED64)
                    out.extend(struct.pack("<d", float(v)))
            else:
                for v in self.values:
                    wire.write_varint_field(out, fnum, int(v))
        return bytes(out)


# ---------------------------------------------------------------------------
# AttrValue
# ---------------------------------------------------------------------------

@dataclass
class AttrListValue:
    s: List[bytes] = field(default_factory=list)
    i: List[int] = field(default_factory=list)
    f: List[float] = field(default_factory=list)
    b: List[bool] = field(default_factory=list)
    type: List[ScalarType] = field(default_factory=list)
    shape: List[Optional[Shape]] = field(default_factory=list)

    @classmethod
    def from_bytes(cls, data: bytes) -> "AttrListValue":
        lv = cls()
        for f, wt, v in wire.iter_fields(data):
            if f == 2:
                lv.s.append(v)
            elif f == 3:
                lv.i.extend(
                    wire.unpack_varints(v) if wt == wire.WIRETYPE_LEN
                    else [wire.to_signed64(v)]
                )
            elif f == 4:
                lv.f.extend(
                    wire.unpack_floats(v) if wt == wire.WIRETYPE_LEN
                    else [struct.unpack("<f", v)[0]]
                )
            elif f == 5:
                lv.b.extend(
                    [bool(x) for x in wire.unpack_varints(v)]
                    if wt == wire.WIRETYPE_LEN else [bool(v)]
                )
            elif f == 6:
                raw = (
                    wire.unpack_varints(v, signed=False)
                    if wt == wire.WIRETYPE_LEN else [v]
                )
                for t in raw:
                    try:
                        lv.type.append(ScalarType.from_tf_datatype(t))
                    except UnsupportedTypeError:
                        pass
            elif f == 7:
                lv.shape.append(TensorShapeProto.from_bytes(v).to_shape())
        return lv

    def to_bytes(self) -> bytes:
        out = bytearray()
        for v in self.s:
            wire.write_len_field(out, 2, v)
        for v in self.i:
            wire.write_varint_field(out, 3, v)
        for v in self.f:
            wire.write_float_field(out, 4, v)
        for v in self.b:
            wire.write_varint_field(out, 5, int(v))
        for v in self.type:
            wire.write_varint_field(out, 6, v.tf_datatype)
        for v in self.shape:
            wire.write_len_field(out, 7, TensorShapeProto.from_shape(v).to_bytes())
        return bytes(out)


@dataclass
class NameAttrList:
    """A function reference in an attr (`func` one-of, AttrValue field
    10): name + instantiation attrs. Carried raw-bytes-stable so nodes
    holding func attrs (If/While/PartitionedCall) round-trip exactly."""

    name: str
    raw: bytes = b""

    @classmethod
    def from_bytes(cls, data: bytes) -> "NameAttrList":
        name = ""
        for f, _, v in wire.iter_fields(data):
            if f == 1:
                name = v.decode("utf-8")
        return cls(name, data)

    def to_bytes(self) -> bytes:
        if self.raw:
            return self.raw
        out = bytearray()
        wire.write_string_field(out, 1, self.name)
        return bytes(out)


AttrPayload = Union[
    bytes, int, float, bool, ScalarType, Shape, None, TensorProto, AttrListValue, str
]


@dataclass
class AttrValue:
    """One-of: kind in {s,i,f,b,type,shape,tensor,list,placeholder}."""

    kind: str
    value: AttrPayload

    @classmethod
    def from_bytes(cls, data: bytes) -> "AttrValue":
        kind, value = "none", None
        for f, _, v in wire.iter_fields(data):
            if f == 1:
                kind, value = "list", AttrListValue.from_bytes(v)
            elif f == 2:
                kind, value = "s", v
            elif f == 3:
                kind, value = "i", wire.to_signed64(v)
            elif f == 4:
                kind, value = "f", struct.unpack("<f", v)[0]
            elif f == 5:
                kind, value = "b", bool(v)
            elif f == 6:
                try:
                    kind, value = "type", ScalarType.from_tf_datatype(v)
                except UnsupportedTypeError:
                    kind, value = "type_raw", v
            elif f == 7:
                kind, value = "shape", TensorShapeProto.from_bytes(v).to_shape()
            elif f == 8:
                kind, value = "tensor", TensorProto.from_bytes(v)
            elif f == 9:
                kind, value = "placeholder", v.decode("utf-8")
            elif f == 10:  # NameAttrList: a function reference (If/While)
                kind, value = "func", NameAttrList.from_bytes(v)
        return cls(kind, value)

    def to_bytes(self) -> bytes:
        out = bytearray()
        k, v = self.kind, self.value
        if k == "list":
            wire.write_len_field(out, 1, v.to_bytes())
        elif k == "s":
            wire.write_len_field(out, 2, v if isinstance(v, bytes) else str(v).encode())
        elif k == "i":
            wire.write_varint_field(out, 3, int(v))
        elif k == "f":
            wire.write_float_field(out, 4, float(v))
        elif k == "b":
            wire.write_varint_field(out, 5, int(bool(v)))
        elif k == "type":
            wire.write_varint_field(out, 6, v.tf_datatype)
        elif k == "shape":
            wire.write_len_field(out, 7, TensorShapeProto.from_shape(v).to_bytes())
        elif k == "tensor":
            wire.write_len_field(out, 8, v.to_bytes())
        elif k == "placeholder":
            wire.write_string_field(out, 9, v)
        elif k == "func":
            wire.write_len_field(out, 10, v.to_bytes())
        return bytes(out)

    # convenience constructors
    @classmethod
    def of_type(cls, t: ScalarType) -> "AttrValue":
        return cls("type", t)

    @classmethod
    def of_shape(cls, s: Optional[Shape]) -> "AttrValue":
        return cls("shape", s)

    @classmethod
    def of_tensor(cls, t: TensorProto) -> "AttrValue":
        return cls("tensor", t)

    @classmethod
    def of_int(cls, i: int) -> "AttrValue":
        return cls("i", i)

    @classmethod
    def of_bool(cls, b: bool) -> "AttrValue":
        return cls("b", b)

    @classmethod
    def of_ints(cls, ints: List[int]) -> "AttrValue":
        return cls("list", AttrListValue(i=list(ints)))

    @classmethod
    def of_string(cls, s: str) -> "AttrValue":
        return cls("s", s.encode("utf-8"))


# ---------------------------------------------------------------------------
# NodeDef / GraphDef
# ---------------------------------------------------------------------------

@dataclass
class NodeDef:
    name: str
    op: str
    inputs: List[str] = field(default_factory=list)
    attrs: Dict[str, AttrValue] = field(default_factory=dict)
    device: str = ""

    @classmethod
    def from_bytes(cls, data: bytes) -> "NodeDef":
        name = op = device = ""
        inputs: List[str] = []
        attrs: Dict[str, AttrValue] = {}
        for f, _, v in wire.iter_fields(data):
            if f == 1:
                name = v.decode("utf-8")
            elif f == 2:
                op = v.decode("utf-8")
            elif f == 3:
                inputs.append(v.decode("utf-8"))
            elif f == 4:
                device = v.decode("utf-8")
            elif f == 5:  # map<string, AttrValue> entry
                k = ""
                av = None
                for f2, _, v2 in wire.iter_fields(v):
                    if f2 == 1:
                        k = v2.decode("utf-8")
                    elif f2 == 2:
                        av = AttrValue.from_bytes(v2)
                if av is not None:
                    attrs[k] = av
        return cls(name, op, inputs, attrs, device)

    def to_bytes(self) -> bytes:
        out = bytearray()
        wire.write_string_field(out, 1, self.name)
        wire.write_string_field(out, 2, self.op)
        for i in self.inputs:
            wire.write_string_field(out, 3, i)
        if self.device:
            wire.write_string_field(out, 4, self.device)
        for k in sorted(self.attrs):
            entry = bytearray()
            wire.write_string_field(entry, 1, k)
            wire.write_len_field(entry, 2, self.attrs[k].to_bytes())
            wire.write_len_field(out, 5, bytes(entry))
        return bytes(out)


@dataclass
class ArgDef:
    """One input/output arg of a function signature (OpDef.ArgDef)."""

    name: str = ""
    type: Optional[ScalarType] = None
    type_attr: str = ""

    @classmethod
    def from_bytes(cls, data: bytes) -> "ArgDef":
        name, typ, type_attr = "", None, ""
        for f, _, v in wire.iter_fields(data):
            if f == 1:
                name = v.decode("utf-8")
            elif f == 3:
                try:
                    typ = ScalarType.from_tf_datatype(v)
                except UnsupportedTypeError:
                    typ = None
            elif f == 4:
                type_attr = v.decode("utf-8")
        return cls(name, typ, type_attr)

    def to_bytes(self) -> bytes:
        out = bytearray()
        wire.write_string_field(out, 1, self.name)
        if self.type is not None:
            wire.write_varint_field(out, 3, self.type.tf_datatype)
        if self.type_attr:
            wire.write_string_field(out, 4, self.type_attr)
        return bytes(out)


@dataclass
class FunctionDef:
    """A library function: signature args, body nodes, and the ret map
    (output arg name -> body edge in `node:out_arg:index` syntax).
    Parsed for `If`/`While` branch lowering and `PartitionedCall`
    inlining (`graph/control_flow.py`); the raw bytes are kept so the
    enclosing library re-serializes byte-stably."""

    name: str = ""
    input_args: List[ArgDef] = field(default_factory=list)
    output_args: List[ArgDef] = field(default_factory=list)
    nodes: List[NodeDef] = field(default_factory=list)
    ret: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_bytes(cls, data: bytes) -> "FunctionDef":
        fd = cls()
        for f, _, v in wire.iter_fields(data):
            if f == 1:  # OpDef signature
                for f2, _, v2 in wire.iter_fields(v):
                    if f2 == 1:
                        fd.name = v2.decode("utf-8")
                    elif f2 == 2:
                        fd.input_args.append(ArgDef.from_bytes(v2))
                    elif f2 == 3:
                        fd.output_args.append(ArgDef.from_bytes(v2))
            elif f == 3:
                fd.nodes.append(NodeDef.from_bytes(v))
            elif f == 4:  # map<string,string> ret entry
                k = rv = ""
                for f2, _, v2 in wire.iter_fields(v):
                    if f2 == 1:
                        k = v2.decode("utf-8")
                    elif f2 == 2:
                        rv = v2.decode("utf-8")
                fd.ret[k] = rv
        return fd

    def to_bytes(self) -> bytes:
        """Serialize a programmatically built FunctionDef (signature +
        body + ret map). Attrs outside this model (e.g. per-function
        attr maps) are not emitted — parsed functions re-serialize
        byte-stably through the enclosing library's ``raw`` instead."""
        sig = bytearray()
        wire.write_string_field(sig, 1, self.name)
        for a in self.input_args:
            wire.write_len_field(sig, 2, a.to_bytes())
        for a in self.output_args:
            wire.write_len_field(sig, 3, a.to_bytes())
        out = bytearray()
        wire.write_len_field(out, 1, bytes(sig))
        for n in self.nodes:
            wire.write_len_field(out, 3, n.to_bytes())
        for k in sorted(self.ret):
            entry = bytearray()
            wire.write_string_field(entry, 1, k)
            wire.write_string_field(entry, 2, self.ret[k])
            wire.write_len_field(out, 4, bytes(entry))
        return bytes(out)


@dataclass
class FunctionDefLibrary:
    functions: List[FunctionDef] = field(default_factory=list)
    raw: bytes = b""  # byte-stable re-serialization

    @classmethod
    def from_bytes(cls, data: bytes) -> "FunctionDefLibrary":
        fns = []
        for f, _, v in wire.iter_fields(data):
            if f == 1:
                fns.append(FunctionDef.from_bytes(v))
        return cls(fns, data)

    def to_bytes(self) -> bytes:
        """Parsed libraries re-serialize byte-stably from ``raw``;
        programmatically built ones (raw empty, e.g. the merged library
        of a fused graph) serialize from ``functions`` — previously they
        silently dropped every function on the wire."""
        if self.raw:
            return self.raw
        out = bytearray()
        for f in self.functions:
            wire.write_len_field(out, 1, f.to_bytes())
        return bytes(out)

    def by_name(self) -> Dict[str, FunctionDef]:
        return {f.name: f for f in self.functions}


@dataclass
class GraphDef:
    nodes: List[NodeDef] = field(default_factory=list)
    producer: int = 26  # TF 1.6-era graph version, matching the reference
    library: Optional[FunctionDefLibrary] = None

    @classmethod
    def from_bytes(cls, data: bytes) -> "GraphDef":
        nodes: List[NodeDef] = []
        producer = 0
        library = None
        for f, _, v in wire.iter_fields(data):
            if f == 1:
                nodes.append(NodeDef.from_bytes(v))
            elif f == 2:  # FunctionDefLibrary
                library = FunctionDefLibrary.from_bytes(v)
            elif f == 4:  # VersionDef
                for f2, _, v2 in wire.iter_fields(v):
                    if f2 == 1:
                        producer = v2
        return cls(nodes, producer, library)

    @classmethod
    def from_file(cls, path: str) -> "GraphDef":
        with open(path, "rb") as fh:
            return cls.from_bytes(fh.read())

    def to_bytes(self) -> bytes:
        out = bytearray()
        for n in self.nodes:
            wire.write_len_field(out, 1, n.to_bytes())
        if self.library is not None and self.library.to_bytes():
            wire.write_len_field(out, 2, self.library.to_bytes())
        versions = bytearray()
        wire.write_varint_field(versions, 1, self.producer)
        wire.write_len_field(out, 4, bytes(versions))
        return bytes(out)

    def node_map(self) -> Dict[str, NodeDef]:
        return {n.name: n for n in self.nodes}
