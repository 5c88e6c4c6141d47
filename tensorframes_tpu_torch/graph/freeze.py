"""Variable freezing: stateful imported graphs become constant graphs.

The PyTorch port keeps its own copy of `tensorframes_tpu/graph/freeze.py`.
Initializers are evaluated by the port's `build_callable` on the CPU: this
prepares the graph (it yields ``Const`` nodes before any device work) and
is not a fallback for device compute.

The reference ships only stateless graphs: its Python front-end calls
``tf.graph_util.convert_variables_to_constants`` on every user graph
before serialization (`core.py:42-56`), running a throwaway session to
read each variable's value. This framework has no session state at all,
so the equivalent transform evaluates each variable's *initializer
subgraph* through the normal lowering and splices the result in as a
``Const`` node. Two wire patterns are handled:

- **Reference-era ref variables** (TF 1.x protos, e.g. the frozen graphs
  the reference loads from disk, `PythonInterface.scala:115-118`):
  ``Variable``/``VariableV2`` nodes initialized by ``Assign(var, value)``.
- **Resource variables** (graphs exported by modern TF, which is what the
  conformance suite's TF emits): ``VarHandleOp`` handles, initialized by
  ``AssignVariableOp(handle, value)`` and read via ``ReadVariableOp``.

Initializers may depend on *other* variables (``b = Variable(f(a))``);
freezing iterates until a fixpoint, evaluating whichever initializers
have become computable. Initializer/bookkeeping machinery (assigns,
``VarIsInitializedOp``, the ``init`` NoOp from
``global_variables_initializer``) is pruned, and control edges into
pruned nodes are dropped from surviving nodes.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..proto.graphdef import AttrValue, TensorProto
from ..schema import ScalarType
from .ir import Graph, GraphNode, parse_edge

__all__ = ["freeze_variables", "has_variables"]

# Ops that *are* a variable's stored value.
_REF_VARIABLE_OPS = ("Variable", "VariableV2")
# Ops that only exist to initialize/inspect variables; never part of the
# frozen compute graph.
_BOOKKEEPING_OPS = (
    "Assign",
    "AssignAdd",
    "AssignSub",
    "AssignVariableOp",
    "AssignAddVariableOp",
    "AssignSubVariableOp",
    "VarIsInitializedOp",
    "IsVariableInitialized",
    "VarHandleOp",
)


def has_variables(graph: Graph) -> bool:
    return any(
        n.op in _REF_VARIABLE_OPS or n.op == "VarHandleOp" for n in graph
    )


def _const_node(name: str, arr: np.ndarray) -> GraphNode:
    st = ScalarType.from_np_dtype(arr.dtype)
    return GraphNode(
        name,
        "Const",
        [],
        {
            "dtype": AttrValue.of_type(st),
            "value": AttrValue.of_tensor(TensorProto.from_numpy(arr)),
        },
    )


def _find_initializers(graph: Graph) -> Dict[str, str]:
    """var/handle node name -> initial-value input edge.

    A graph may contain several assigns to the same variable (the
    startup initializer plus compute-time ``tf.assign`` updates). TF
    names the initializer assign ``<var>/Assign`` — prefer that node; for
    anything else, first in definition order wins. The value edge is the
    SECOND data input (control edges may precede data inputs in a legal
    GraphDef, so raw ``inputs[1]`` is not usable)."""
    inits: Dict[str, str] = {}
    preferred: Dict[str, bool] = {}
    for n in graph:
        if n.op in ("Assign", "AssignVariableOp"):
            data = n.data_inputs()
            if len(data) < 2:
                continue
            target, _ = data[0]
            name, idx = data[1]
            edge = f"{name}:{idx}" if idx else name
            is_init = n.name == f"{target}/Assign"
            if target not in inits or (is_init and not preferred[target]):
                inits[target] = edge
                preferred[target] = is_init
    return inits


def _reaches_unfrozen(graph: Graph, edge: str, unfrozen: set) -> bool:
    """Cheap reachability: does the subgraph under ``edge`` read a
    variable that has not been frozen yet? (Avoids attempting — and
    failing — a lowering per pending variable per round.)"""
    stack = [parse_edge(edge)[0]]
    seen: set = set()
    while stack:
        name = stack.pop()
        if name in seen:
            continue
        seen.add(name)
        node = graph[name]
        if node.op in _REF_VARIABLE_OPS or node.op == "VarHandleOp":
            if name in unfrozen:
                return True
        for dep, _, ctrl in map(parse_edge, node.inputs):
            if not ctrl:
                stack.append(dep)
    return False


def freeze_variables(graph: Graph) -> Graph:
    """Return an equivalent stateless graph with every variable replaced
    by a ``Const`` holding its initializer's value. No-op (same object)
    for graphs without variables."""
    if not has_variables(graph):
        return graph

    inits = _find_initializers(graph)
    ref_vars = [n.name for n in graph if n.op in _REF_VARIABLE_OPS]
    handles = [n.name for n in graph if n.op == "VarHandleOp"]
    missing = [v for v in ref_vars + handles if v not in inits]
    if missing:
        raise ValueError(
            f"cannot freeze graph: variables {missing!r} have no "
            "Assign/AssignVariableOp initializer (the reference requires "
            "initializable variables too: it session-runs the initializer "
            "before convert_variables_to_constants, core.py:42-56)"
        )

    # Working copy we rewrite round by round.
    work = Graph([GraphNode(n.name, n.op, list(n.inputs), dict(n.attrs))
                  for n in graph])
    import torch

    from ..frame import _to_numpy
    from ..ops.lowering import build_callable

    frozen: Dict[str, np.ndarray] = {}
    pending = set(ref_vars) | set(handles)
    while pending:
        # One batched evaluation per fixpoint round: every initializer
        # whose subgraph no longer reads an unfrozen variable is fetched
        # through a single lowering (rounds = dependency depth, not #vars).
        ready = [
            v for v in sorted(pending)
            if not _reaches_unfrozen(work, inits[v], pending)
        ]
        if not ready:
            raise ValueError(
                "cannot freeze graph: circular or non-constant variable "
                f"initializers for {sorted(pending)!r}"
            )
        values = build_callable(
            work, [inits[v] for v in ready], [], torch.device("cpu")
        )()
        for var, value in zip(ready, values):
            value = _to_numpy(value)
            frozen[var] = value
            # Splice the value in: ref variables become the Const
            # themselves (their readers use the node directly); resource
            # handles stay put while every ReadVariableOp on them becomes
            # the Const.
            for i, n in enumerate(work.nodes):
                if n.name == var and n.op in _REF_VARIABLE_OPS:
                    work.nodes[i] = _const_node(var, value)
                    work._by_name[var] = work.nodes[i]
                elif (
                    n.op == "ReadVariableOp"
                    and n.data_inputs()
                    and n.data_inputs()[0][0] == var
                ):
                    work.nodes[i] = _const_node(n.name, value)
                    work._by_name[n.name] = work.nodes[i]
            # direct node splices bypass Graph.add's cache invalidation
            work._fingerprint = None
        pending -= set(frozen)

    # Prune bookkeeping nodes and anything data-dependent on them.
    # GraphDef node order is NOT guaranteed topological, so propagate the
    # drop set to a fixpoint rather than in one forward pass.
    dropped: set = {n.name for n in work if n.op in _BOOKKEEPING_OPS}
    changed = True
    while changed:
        changed = False
        for n in work:
            if n.name in dropped:
                continue
            if any(
                dep in dropped
                for dep, _, ctrl in map(parse_edge, n.inputs)
                if not ctrl
            ):
                dropped.add(n.name)
                changed = True
    # NoOp init barriers whose only purpose was ordering the assigns.
    for n in work:
        if n.op == "NoOp" and n.inputs and all(
            parse_edge(e)[0] in dropped for e in n.inputs
        ):
            dropped.add(n.name)

    out = Graph()
    for n in work:
        if n.name in dropped:
            continue
        kept_inputs: List[str] = []
        for e in n.inputs:
            dep, _, ctrl = parse_edge(e)
            if ctrl and dep in dropped:
                continue  # ordering edge into pruned init machinery
            kept_inputs.append(e)
        out.add(GraphNode(n.name, n.op, kept_inputs, dict(n.attrs)))
    # control-flow side tables survive freezing
    out.library = graph.library
    out._library_proto = graph._library_proto
    out.subgraphs = dict(graph.subgraphs)
    return out
