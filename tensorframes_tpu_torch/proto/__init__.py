"""Proto layer: GraphDef wire format (see `wire.py`, `graphdef.py`)."""

from .graphdef import (
    AttrListValue,
    AttrValue,
    GraphDef,
    NodeDef,
    TensorProto,
    TensorShapeProto,
)

__all__ = [
    "AttrListValue",
    "AttrValue",
    "GraphDef",
    "NodeDef",
    "TensorProto",
    "TensorShapeProto",
]
