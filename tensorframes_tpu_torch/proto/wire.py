"""Minimal protobuf wire-format codec (proto3 subset).

The PyTorch port keeps its own copy of `tensorframes_tpu/proto/wire.py`
(the port imports nothing of the JAX package).

Self-contained encoder/decoder for the protobuf wire format, used by the
GraphDef message layer (`graphdef.py`). This replaces the reference's
vendored protoc-generated classes (89k LoC of generated Java under
`src/main/java/org/tensorflow/framework/`) with ~150 lines: we only need
the handful of messages that describe a graph, and implementing the wire
format directly avoids any protoc/runtime version coupling.

Wire format reference: https://protobuf.dev/programming-guides/encoding/
(varint = 0, 64-bit = 1, length-delimited = 2, 32-bit = 5).
"""

from __future__ import annotations

import struct
from typing import Iterator, Tuple

WIRETYPE_VARINT = 0
WIRETYPE_FIXED64 = 1
WIRETYPE_LEN = 2
WIRETYPE_FIXED32 = 5


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """Decode a varint at ``pos``; returns (value, new_pos)."""
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def to_signed64(value: int) -> int:
    """Reinterpret an unsigned varint as a two's-complement int64."""
    if value >= 1 << 63:
        value -= 1 << 64
    return value


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a serialized message.

    LEN fields yield ``bytes``; VARINT yields unsigned int; FIXED32/64 yield
    the raw little-endian bytes (callers struct-unpack as needed).
    """
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = read_varint(buf, pos)
        field, wtype = tag >> 3, tag & 7
        if wtype == WIRETYPE_VARINT:
            value, pos = read_varint(buf, pos)
        elif wtype == WIRETYPE_LEN:
            length, pos = read_varint(buf, pos)
            if pos + length > n:
                raise ValueError("truncated length-delimited field")
            value = buf[pos : pos + length]
            pos += length
        elif wtype == WIRETYPE_FIXED64:
            value = buf[pos : pos + 8]
            pos += 8
        elif wtype == WIRETYPE_FIXED32:
            value = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype} (field {field})")
        yield field, wtype, value


def unpack_floats(data: bytes) -> list:
    """Packed repeated float (fixed32 each)."""
    return list(struct.unpack(f"<{len(data) // 4}f", data))


def unpack_doubles(data: bytes) -> list:
    return list(struct.unpack(f"<{len(data) // 8}d", data))


def unpack_varints(data: bytes, signed: bool = True) -> list:
    out = []
    pos = 0
    while pos < len(data):
        v, pos = read_varint(data, pos)
        out.append(to_signed64(v) if signed else v)
    return out


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------

def write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value += 1 << 64  # two's complement int64
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def write_tag(out: bytearray, field: int, wtype: int) -> None:
    write_varint(out, (field << 3) | wtype)


def write_len_field(out: bytearray, field: int, data: bytes) -> None:
    write_tag(out, field, WIRETYPE_LEN)
    write_varint(out, len(data))
    out.extend(data)


def write_varint_field(out: bytearray, field: int, value: int) -> None:
    write_tag(out, field, WIRETYPE_VARINT)
    write_varint(out, value)


def write_float_field(out: bytearray, field: int, value: float) -> None:
    write_tag(out, field, WIRETYPE_FIXED32)
    out.extend(struct.pack("<f", value))


def write_string_field(out: bytearray, field: int, value: str) -> None:
    write_len_field(out, field, value.encode("utf-8"))
