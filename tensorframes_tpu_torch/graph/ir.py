"""Graph IR: the framework's internal representation of a computation graph.

A `Graph` is a list of `GraphNode`s in definition order, each holding an op
name, typed attrs, and input edges. This is the layer the reference kept in
protoc-generated `GraphDef` Java objects and fed to libtensorflow
(`TensorFlowOps.scala:64-74`); here it is a first-class IR that can be

- imported from / exported to TF `GraphDef` wire bytes (compat path),
- built by the tracer / builder DSL front-ends, and
- lowered to a torch callable by `ops.lowering`.

The PyTorch port keeps its own copy of `tensorframes_tpu/graph/ir.py`; the
only change is that GraphDef bytes always parse through the Python codec.

Edges use TF's input syntax: ``name``, ``name:k`` (k-th output), and
``^name`` (control edge — order-only; this IR is purely functional, so
control edges are parsed and dropped at lowering).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..proto.graphdef import AttrValue, FunctionDef, GraphDef, NodeDef
from ..schema import ScalarType, Shape

__all__ = ["GraphNode", "Graph", "Subgraph", "parse_edge"]


@dataclass
class Subgraph:
    """An extracted control-flow body: a Graph plus its feed (placeholder
    name) order and fetch edges. `_Cond`/`_While` lowering rules build a
    callable from this exactly like a top-level graph."""

    graph: "Graph"
    feeds: List[str]
    fetches: List[str]


def parse_edge(edge: str) -> Tuple[str, int, bool]:
    """Split a TF input edge into (node_name, output_index, is_control)."""
    if edge.startswith("^"):
        return edge[1:], 0, True
    if ":" in edge:
        name, _, idx = edge.rpartition(":")
        if idx.isdigit():
            return name, int(idx), False
    return edge, 0, False


def base_name(edge: str) -> str:
    """Node name of an edge (strips ``:k`` / ``^``) — the shared `_base`
    helper every verb/planner module aliases."""
    return parse_edge(edge)[0]


@dataclass
class GraphNode:
    name: str
    op: str
    inputs: List[str] = field(default_factory=list)
    attrs: Dict[str, AttrValue] = field(default_factory=dict)

    # -- attr accessors --------------------------------------------------
    def attr(self, key: str, default=None):
        av = self.attrs.get(key)
        return default if av is None else av.value

    @property
    def dtype_attr(self) -> Optional[ScalarType]:
        for key in ("dtype", "T", "DstT"):
            av = self.attrs.get(key)
            if av is not None and av.kind == "type":
                return av.value
        return None

    @property
    def shape_attr(self) -> Optional[Shape]:
        av = self.attrs.get("shape")
        if av is not None and av.kind == "shape":
            return av.value
        return None

    def data_inputs(self) -> List[Tuple[str, int]]:
        out = []
        for e in self.inputs:
            name, idx, ctrl = parse_edge(e)
            if not ctrl:
                out.append((name, idx))
        return out

    def to_node_def(self) -> NodeDef:
        return NodeDef(self.name, self.op, list(self.inputs), dict(self.attrs))

    @classmethod
    def from_node_def(cls, nd: NodeDef) -> "GraphNode":
        return cls(nd.name, nd.op, list(nd.inputs), dict(nd.attrs))


class Graph:
    """An ordered, named DAG of `GraphNode`s.

    Two side tables ride along for control flow:

    - ``library``: FunctionDefs from the GraphDef's FunctionDefLibrary
      (name -> FunctionDef), consumed by `graph.control_flow` to inline
      `PartitionedCall` sites and lower `If`/`While` branches.
    - ``subgraphs``: extracted loop/branch bodies (key -> Subgraph),
      referenced by name from `_Cond`/`_While` pseudo-node attrs after
      functionalization. Keys embed a content hash, so the main graph's
      byte fingerprint still distinguishes different bodies.
    """

    def __init__(self, nodes: Optional[List[GraphNode]] = None):
        self.nodes: List[GraphNode] = []
        self._by_name: Dict[str, GraphNode] = {}
        self._fingerprint: Optional[str] = None
        self.library: Dict[str, "FunctionDef"] = {}
        self.subgraphs: Dict[str, "Subgraph"] = {}
        for n in nodes or []:
            self.add(n)

    def add(self, node: GraphNode) -> GraphNode:
        if node.name in self._by_name:
            raise ValueError(f"duplicate node name {node.name!r}")
        self.nodes.append(node)
        self._by_name[node.name] = node
        self._fingerprint = None
        return node

    def __getitem__(self, name: str) -> GraphNode:
        # Accept "name:0" fetch syntax like TF session fetches.
        base, _, _ = parse_edge(name)
        if base not in self._by_name:
            raise KeyError(
                f"no node {base!r} in graph; nodes: {[n.name for n in self.nodes]}"
            )
        return self._by_name[base]

    def __contains__(self, name: str) -> bool:
        base, _, _ = parse_edge(name)
        return base in self._by_name

    def __iter__(self):
        return iter(self.nodes)

    def __len__(self) -> int:
        return len(self.nodes)

    # -- structure -------------------------------------------------------
    def placeholders(self) -> List[GraphNode]:
        """Graph inputs: zero-input Placeholder ops (the same classification
        as `TensorFlowOps.analyzeGraphTF`, `TensorFlowOps.scala:106-108`)."""
        return [
            n
            for n in self.nodes
            if n.op in ("Placeholder", "PlaceholderV2") and not n.data_inputs()
        ]

    def toposort(self, fetches: Optional[List[str]] = None) -> List[GraphNode]:
        """Topological order of the transitive closure of ``fetches``
        (all nodes if None). Mirrors `DslImpl.getClosure`."""
        if fetches is None:
            wanted = [n.name for n in self.nodes]
        else:
            wanted = [parse_edge(f)[0] for f in fetches]
        order: List[GraphNode] = []
        seen: Dict[str, int] = {}  # 0 = visiting, 1 = done

        def visit(name: str, stack: List[str]):
            state = seen.get(name)
            if state == 1:
                return
            if state == 0:
                raise ValueError(f"cycle through {name!r}: {stack}")
            seen[name] = 0
            node = self[name]
            for dep, _, _ in map(parse_edge, node.inputs):
                visit(dep, stack + [name])
            seen[name] = 1
            order.append(node)

        for w in wanted:
            visit(w, [])
        return order

    # -- GraphDef interchange -------------------------------------------
    def to_graph_def(self) -> GraphDef:
        gd = GraphDef([n.to_node_def() for n in self.nodes])
        gd.library = self._library_proto
        return gd

    _library_proto = None  # raw FunctionDefLibrary for re-serialization

    @classmethod
    def from_graph_def(cls, gd: GraphDef) -> "Graph":
        g = cls([GraphNode.from_node_def(n) for n in gd.nodes])
        if gd.library is not None:
            g.library = gd.library.by_name()
            g._library_proto = gd.library
        return g

    @classmethod
    def from_bytes(cls, data: bytes) -> "Graph":
        """Parse GraphDef wire bytes with the pure-Python wire codec."""
        return cls.from_graph_def(GraphDef.from_bytes(data))

    @classmethod
    def from_file(cls, path: str) -> "Graph":
        return cls.from_graph_def(GraphDef.from_file(path))

    def to_bytes(self) -> bytes:
        return self.to_graph_def().to_bytes()

    def clone(self) -> "Graph":
        """Structural copy: fresh `GraphNode`s (input lists and attr
        dicts copied one level deep) sharing the library / subgraph side
        tables. The splice machinery (`graph.fuse`) builds fused graphs
        on top of a clone so the producer plan is never mutated —
        LazyFrames stay immutable and can branch like frames do."""
        g = Graph(
            [
                GraphNode(n.name, n.op, list(n.inputs), dict(n.attrs))
                for n in self.nodes
            ]
        )
        g.library = dict(self.library)
        g._library_proto = self._library_proto
        g.subgraphs = dict(self.subgraphs)
        return g

    def fingerprint(self) -> str:
        """Stable content hash; the compile-cache key component that replaces
        the reference's per-task graph re-import (`DebugRowOps.scala:790`).
        Cached after first use (serializing the graph dominated verb
        dispatch otherwise); `add` invalidates."""
        if self._fingerprint is None:
            self._fingerprint = hashlib.sha256(self.to_bytes()).hexdigest()[:16]
        return self._fingerprint

    def __repr__(self) -> str:
        return f"Graph({len(self.nodes)} nodes)"
