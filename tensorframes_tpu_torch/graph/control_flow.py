"""TF control flow -> functional `_Cond`/`_While` pseudo-nodes.

The PyTorch port keeps its own copy of `tensorframes_tpu/graph/control_flow.py`
(framework-free: it rewrites the graph IR only). The one change is that
`GraphLoweringError` is the port's registry error, so a caller catches one
type for a graph the port cannot lower.

The reference executed ANY GraphDef because libtensorflow interpreted
dataflow control flow at runtime (`TensorFlowOps.scala:76-95`,
`Build.scala:56-57`). The lowering runs a graph as a fixed program of
rules, so imported control flow must be FUNCTIONALIZED before lowering:

- v2 functional ops (`If`/`StatelessIf`, `While`/`StatelessWhile`)
  map directly: their branch/loop FunctionDefs become `Subgraph`s and
  the node becomes a `_Cond`/`_While` pseudo-node, lowered by
  `ops.control` (one branch or a host-driven loop for a scalar
  predicate, `graph.vectorize`'s masked forms for a per-row one).
- v1 dataflow control flow is structurally recovered: while frames via
  their `Enter`/`Merge`/`Switch`/`NextIteration`/`Exit` rings (the
  shape TF 1.x sessions emitted — the graphs the reference ingested),
  cond diamonds via branch labeling from `Switch` ports to the joining
  `Merge`s.
- `PartitionedCall`/`StatefulPartitionedCall` (and direct
  function-name-as-op calls) are inlined at their call sites from the
  GraphDef's `FunctionDefLibrary`.

Documented bounds (the JAX package's, kept so both packages accept the
same graphs):

- loop carries must keep static shape/dtype across iterations (TF
  itself requires an invariant loop signature);
- both cond branches must produce matching output shapes;
- `Merge` value_index outputs (``:1``) and unstructured Switch/Merge
  patterns raise `GraphLoweringError` with the offending node named;
- FunctionDef edge syntax ``node:out_arg:index`` resolves named out_args
  to flat output offsets via the op's output-arg signature
  (`_OP_OUTPUT_ARGS`: TopK, Unique*, FusedBatchNorm*, ...); ops without
  a table entry are single-output-arg, where positional resolution is
  exact. A tabled op with an unknown out_arg raises `GraphLoweringError`
  instead of silently aliasing output 0;
- loop/cond interiors consumed from OUTSIDE the extracted construct
  (anything but an `Exit`/`Merge` output) raise `GraphLoweringError`
  naming the leaking node, instead of a bare `KeyError` later.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..ops.registry import GraphLoweringError
from ..proto.graphdef import AttrValue, FunctionDef
from .ir import Graph, GraphNode, Subgraph, parse_edge

__all__ = ["has_control_flow", "functionalize", "GraphLoweringError"]


_V1_OPS = {
    "Switch", "RefSwitch", "Merge", "RefMerge", "Enter", "RefEnter",
    "Exit", "RefExit", "NextIteration", "RefNextIteration", "LoopCond",
}
_V2_OPS = {"If", "StatelessIf", "While", "StatelessWhile"}
_CALL_OPS = {"PartitionedCall", "StatefulPartitionedCall"}


def has_control_flow(g: Graph) -> bool:
    return any(
        n.op in _V1_OPS or n.op in _V2_OPS or n.op in _CALL_OPS
        or n.op in g.library
        for n in g.nodes
    )


def functionalize(g: Graph, fetches: List[str]) -> Tuple[Graph, List[str]]:
    """Return an equivalent (graph, fetches) with all control flow in
    `_Cond`/`_While` pseudo-node form and all function calls inlined.
    No-op (same objects) when the graph has no control flow."""
    if not has_control_flow(g):
        return g, fetches
    g, fetches = _inline_calls(g, fetches)
    g = _convert_functional_ops(g)
    g, fetches = _functionalize_v1(g, fetches)
    g = _prune(g, fetches)
    return g, fetches


# ---------------------------------------------------------------------------
# shared plumbing
# ---------------------------------------------------------------------------


def _apply_repl(
    g: Graph, fetches: List[str], repl: Dict[Tuple[str, int], str]
) -> Tuple[Graph, List[str]]:
    """Rewrite every node input + fetch through ``repl`` (chains
    resolved). Control edges retarget to the replacement's base node."""

    def resolve(key: Tuple[str, int]) -> Optional[str]:
        tgt = repl.get(key)
        for _ in range(64):
            if tgt is None:
                return None
            name, idx, _ = parse_edge(tgt)
            nxt = repl.get((name, idx))
            if nxt is None:
                return tgt
            tgt = nxt
        raise GraphLoweringError("edge replacement chain did not converge")

    def rw(e: str) -> str:
        name, idx, ctrl = parse_edge(e)
        tgt = resolve((name, idx))
        if tgt is None:
            return e
        if ctrl:
            return "^" + parse_edge(tgt)[0]
        return tgt

    out = Graph()
    out.library = g.library
    out._library_proto = g._library_proto
    out.subgraphs = dict(g.subgraphs)
    for n in g.nodes:
        out.add(GraphNode(n.name, n.op, [rw(e) for e in n.inputs], n.attrs))
    return out, [rw(f) for f in fetches]


def _sub_key(kind: str, sub: Subgraph) -> str:
    """Content-hashed key: the owning graph's byte fingerprint (which
    includes this key string in the pseudo-node attrs) then
    distinguishes different bodies."""
    h = hashlib.sha256()
    h.update(sub.graph.to_bytes())
    h.update("|".join(sub.feeds).encode())
    h.update("|".join(sub.fetches).encode())
    return f"{kind}_{h.hexdigest()[:12]}"


def _attach_sub(g: Graph, kind: str, sub: Subgraph) -> str:
    sub.graph.library = g.library
    key = _sub_key(kind, sub)
    g.subgraphs[key] = sub
    return key


def _placeholder(name: str, dtype=None) -> GraphNode:
    attrs = {}
    # only attach dtypes this schema models: a DT_VARIANT Enter (a
    # TensorList carried through a Keras RNN loop) parses as raw bytes,
    # which must not be wrapped in a type attr (the subgraph would no
    # longer serialize for its content-hash key)
    if dtype is not None and hasattr(dtype, "tf_datatype"):
        attrs["dtype"] = AttrValue.of_type(dtype)
    return GraphNode(name, "Placeholder", [], attrs)


def _unique_name(g: Graph, base: str) -> str:
    if base not in g:
        return base
    i = 1
    while f"{base}_{i}" in g:
        i += 1
    return f"{base}_{i}"


def _prune(g: Graph, fetches: Sequence[str]) -> Graph:
    """Drop nodes unreachable from the fetches (the leftover interiors
    of extracted loops/conds), preserving definition order. Placeholders
    are kept when CONSUMED by any kept node (feed_dict may rename them)
    — but not when fully dangling: `convert_variables_to_constants`
    leaves zero-consumer `unused_control_flow_input*` placeholders
    behind in frozen RNN graphs, and shape analysis must not demand
    shapes for those."""
    keep: Set[str] = set()

    def visit(name: str):
        if name in keep:
            return
        keep.add(name)
        for e in g[name].inputs:
            visit(parse_edge(e)[0])

    for f in fetches:
        visit(parse_edge(f)[0])
    consumed = {
        parse_edge(e)[0]
        for n in g.nodes
        if n.name in keep
        for e in n.inputs
    }
    for n in g.nodes:
        if n.op in ("Placeholder", "PlaceholderV2") and n.name in consumed:
            visit(n.name)
    out = Graph()
    out.library = g.library
    out._library_proto = g._library_proto
    for n in g.nodes:
        if n.name in keep:
            out.add(n)
    # only the subgraphs still referenced
    for n in out.nodes:
        for akey in ("cond_then", "cond_else", "while_cond", "while_body"):
            key = n.attr(akey)
            if key is not None:
                key = key.decode() if isinstance(key, bytes) else key
                out.subgraphs[key] = g.subgraphs[key]
    return out


def _copy_nested_subgraphs(src: Graph, dst: Graph) -> None:
    """When cloning pseudo-nodes into a subgraph, bring the subgraph
    entries they reference along."""
    for n in dst.nodes:
        for akey in ("cond_then", "cond_else", "while_cond", "while_body"):
            key = n.attr(akey)
            if key is not None:
                key = key.decode() if isinstance(key, bytes) else key
                dst.subgraphs[key] = src.subgraphs[key]


def _clone_closure(
    g: Graph,
    src_edges: Sequence[str],
    edge_map: Dict[Tuple[str, int], str],
    forbidden: Optional[Dict[str, str]] = None,
    allowed: Optional[Set[str]] = None,
) -> Tuple[List[GraphNode], List[str], Set[str]]:
    """Clone the backward closure of ``src_edges`` up to the boundary
    ``edge_map`` (edge -> placeholder name). Control edges are dropped
    (this IR lowers them as ordering-only no-ops anyway). Returns
    (cloned nodes in original graph order, mapped fetch edges, visited
    source names).

    ``forbidden`` maps ring-node names to a reason; reaching one means
    the structure is not the canonical TF shape — raise, never
    mis-compile. ``allowed`` (if given) restricts which nodes may be
    entered (cond branch labeling)."""
    forbidden = forbidden or {}
    visited: Set[str] = set()
    order: Dict[str, int] = {n.name: i for i, n in enumerate(g.nodes)}

    def visit(name: str):
        if name in visited:
            return
        if name in forbidden:
            raise GraphLoweringError(
                f"unsupported control-flow structure: reached {name!r} "
                f"({forbidden[name]}) outside its canonical position"
            )
        if allowed is not None and name not in allowed:
            raise GraphLoweringError(
                f"unsupported control-flow structure: node {name!r} is "
                "referenced from a branch it does not belong to"
            )
        visited.add(name)
        for e in g[name].inputs:
            dep, idx, ctrl = parse_edge(e)
            if ctrl:
                continue
            if (dep, idx) in edge_map:
                continue
            visit(dep)

    fetch_edges: List[str] = []
    for e in src_edges:
        dep, idx, ctrl = parse_edge(e)
        if (dep, idx) in edge_map:
            fetch_edges.append(edge_map[(dep, idx)])
        else:
            visit(dep)
            fetch_edges.append(e)

    def rw_inputs(node: GraphNode) -> List[str]:
        out = []
        for e in node.inputs:
            dep, idx, ctrl = parse_edge(e)
            if ctrl:
                continue
            mapped = edge_map.get((dep, idx))
            out.append(mapped if mapped is not None else e)
        return out

    cloned = [
        GraphNode(n.name, n.op, rw_inputs(n), n.attrs)
        for n in g.nodes
        if n.name in visited
    ]
    cloned.sort(key=lambda n: order[n.name])
    return cloned, fetch_edges, visited


# ---------------------------------------------------------------------------
# function library: call inlining + FunctionDef -> Subgraph
# ---------------------------------------------------------------------------


# Flat output-arg layout of the multi-output ops this framework lowers.
# FunctionDef edges use ``node:out_arg:idx`` syntax where ``out_arg``
# NAMES an output arg of the node's op; the flat output offset is the
# arg's position in the op's output signature (every arg below is a
# single tensor, so position + idx is exact). Single-output ops need no
# entry: their one out_arg sits at offset 0 and ``idx`` is already flat.
_FBN_OUTS = (
    "y", "batch_mean", "batch_variance", "reserve_space_1", "reserve_space_2",
)
_OP_OUTPUT_ARGS: Dict[str, Tuple[str, ...]] = {
    "TopK": ("values", "indices"),
    "TopKV2": ("values", "indices"),
    "Unique": ("y", "idx"),
    "UniqueV2": ("y", "idx"),
    "UniqueWithCounts": ("y", "idx", "count"),
    "FusedBatchNorm": _FBN_OUTS,
    "FusedBatchNormV2": _FBN_OUTS,
    "FusedBatchNormV3": _FBN_OUTS + ("reserve_space_3",),
    "MaxPoolWithArgmax": ("output", "argmax"),
    "Switch": ("output_false", "output_true"),
    "RefSwitch": ("output_false", "output_true"),
    "Merge": ("output", "value_index"),
    "RefMerge": ("output", "value_index"),
}


def _flat_output_index(op: Optional[str], out_arg: str, idx: int, edge: str) -> int:
    """Resolve a named ``out_arg`` to its flat output offset via the
    op's output-arg signature. Ops without a table entry are treated as
    single-output-arg (offset == idx) — correct for every other op this
    framework lowers; a tabled op with an unrecognized out_arg raises
    rather than silently resolving to the wrong output."""
    sig = _OP_OUTPUT_ARGS.get(op or "")
    if sig is None:
        return idx
    if out_arg not in sig:
        raise GraphLoweringError(
            f"function body edge {edge!r}: op {op!r} has no output arg "
            f"{out_arg!r} (outputs: {list(sig)})"
        )
    if idx != 0:
        # every tabled output arg is a single tensor; a nonzero
        # within-arg index would need list-arg sizing we cannot do here
        raise GraphLoweringError(
            f"function body edge {edge!r}: output arg {out_arg!r} of "
            f"{op!r} is a single tensor but the edge indexes element {idx}"
        )
    return sig.index(out_arg)


def _fdef_edge(
    e: str,
    argmap: Dict[str, str],
    bodynames: Set[str],
    prefix: str = "",
    body_ops: Optional[Dict[str, str]] = None,
) -> str:
    """Translate FunctionDef edge syntax (``arg``, ``node:out_arg:idx``)
    into plain graph edge syntax: args splice to ``argmap`` targets,
    body nodes get ``prefix`` (the call-site name when inlining, empty
    when building a standalone Subgraph). Classification happens BEFORE
    prefixing, so a body node shadowing a caller node name cannot
    double-prefix. Named out_args resolve to flat output offsets via the
    op's output signature (``body_ops``: body node name -> op), so e.g.
    ``bn:batch_mean:0`` becomes output 1 of a FusedBatchNorm instead of
    silently aliasing output 0."""
    ctrl = e.startswith("^")
    if ctrl:
        e = e[1:]
    parts = e.split(":")
    base = parts[0]
    if base in argmap:
        tgt = argmap[base]
        return ("^" + parse_edge(tgt)[0]) if ctrl else tgt
    if base in bodynames:
        if ctrl:
            return f"^{prefix}{base}"
        op = (body_ops or {}).get(base)
        if len(parts) == 3:
            if not parts[2].isdigit():
                raise GraphLoweringError(
                    f"malformed function body edge {e!r}"
                )
            k = _flat_output_index(op, parts[1], int(parts[2]), e)
            return f"{prefix}{base}:{k}"
        if len(parts) == 2 and parts[1].isdigit():
            return f"{prefix}{base}:{parts[1]}"
        if len(parts) == 2:
            k = _flat_output_index(op, parts[1], 0, e)
            return f"{prefix}{base}:{k}"
        return f"{prefix}{base}"
    raise GraphLoweringError(
        f"function body edge {e!r} references neither an argument "
        f"({sorted(argmap)}) nor a body node"
    )


def _call_site_argmap(
    fdef: FunctionDef, call: GraphNode
) -> Dict[str, str]:
    data_in = [e for e in call.inputs if not e.startswith("^")]
    if len(data_in) != len(fdef.input_args):
        raise GraphLoweringError(
            f"call {call.name!r} feeds {len(data_in)} args but function "
            f"{fdef.name!r} declares {len(fdef.input_args)}"
        )
    return {a.name: data_in[i] for i, a in enumerate(fdef.input_args)}


def _inline_calls(g: Graph, fetches: List[str]) -> Tuple[Graph, List[str]]:
    lib = g.library
    if not lib:
        return g, fetches
    for _ in range(64):
        calls = [
            n for n in g.nodes if n.op in _CALL_OPS or n.op in lib
        ]
        if not calls:
            return g, fetches
        callset = {n.name for n in calls}
        out = Graph()
        out.library = g.library
        out._library_proto = g._library_proto
        out.subgraphs = dict(g.subgraphs)
        repl: Dict[Tuple[str, int], str] = {}
        for node in g.nodes:
            if node.name not in callset:
                out.add(node)
                continue
            if node.op in _CALL_OPS:
                fav = node.attrs.get("f")
                if fav is None or fav.kind != "func":
                    raise GraphLoweringError(
                        f"call node {node.name!r} has no function attr"
                    )
                fname = fav.value.name
                if fname not in lib:
                    raise GraphLoweringError(
                        f"call node {node.name!r} references unknown "
                        f"function {fname!r}"
                    )
                fdef = lib[fname]
            else:
                fdef = lib[node.op]
            argmap = _call_site_argmap(fdef, node)
            prefix = node.name + "/"
            bodynames = {bn.name for bn in fdef.nodes}
            body_ops = {bn.name: bn.op for bn in fdef.nodes}

            def tr(
                e: str,
                argmap=argmap,
                bodynames=bodynames,
                prefix=prefix,
                body_ops=body_ops,
            ):
                return _fdef_edge(e, argmap, bodynames, prefix, body_ops)

            for bn in fdef.nodes:
                out.add(
                    GraphNode(
                        prefix + bn.name, bn.op,
                        [tr(e) for e in bn.inputs], dict(bn.attrs),
                    )
                )
            for k, oarg in enumerate(fdef.output_args):
                ret_edge = fdef.ret.get(oarg.name)
                if ret_edge is None:
                    raise GraphLoweringError(
                        f"function {fdef.name!r} has no ret entry for "
                        f"output {oarg.name!r}"
                    )
                repl[(node.name, k)] = tr(ret_edge)
        g, fetches = _apply_repl(out, fetches, repl)
    raise GraphLoweringError(
        "function inlining did not converge after 64 rounds "
        "(recursive function library?)"
    )


def _fdef_to_subgraph(fdef: FunctionDef) -> Subgraph:
    sub = Graph()
    argmap = {a.name: a.name for a in fdef.input_args}
    bodynames = {bn.name for bn in fdef.nodes}
    body_ops = {bn.name: bn.op for bn in fdef.nodes}
    for a in fdef.input_args:
        sub.add(_placeholder(a.name, a.type))
    for bn in fdef.nodes:
        inputs = []
        for e in bn.inputs:
            te = _fdef_edge(e, argmap, bodynames, body_ops=body_ops)
            if not te.startswith("^"):
                inputs.append(te)
        sub.add(GraphNode(bn.name, bn.op, inputs, dict(bn.attrs)))
    fetches = []
    for oarg in fdef.output_args:
        ret_edge = fdef.ret.get(oarg.name)
        if ret_edge is None:
            raise GraphLoweringError(
                f"function {fdef.name!r} has no ret entry for output "
                f"{oarg.name!r}"
            )
        fetches.append(_fdef_edge(ret_edge, argmap, bodynames, body_ops=body_ops))
    return Subgraph(sub, [a.name for a in fdef.input_args], fetches)


def _convert_functional_ops(g: Graph) -> Graph:
    """`If`/`While` (v2 functional control flow) -> `_Cond`/`_While`."""
    if not any(n.op in _V2_OPS for n in g.nodes):
        return g
    out = Graph()
    out.library = g.library
    out._library_proto = g._library_proto
    out.subgraphs = dict(g.subgraphs)
    for node in g.nodes:
        if node.op in ("If", "StatelessIf"):
            tname = node.attrs["then_branch"].value.name
            ename = node.attrs["else_branch"].value.name
            tsub = _subgraph_from_lib(g, tname)
            esub = _subgraph_from_lib(g, ename)
            n_out = len(tsub.fetches)
            out.add(
                GraphNode(
                    node.name, "_Cond", list(node.inputs),
                    {
                        "cond_then": AttrValue.of_string(
                            _attach_sub(out, "cond_then", tsub)
                        ),
                        "cond_else": AttrValue.of_string(
                            _attach_sub(out, "cond_else", esub)
                        ),
                        "n_out": AttrValue.of_int(n_out),
                    },
                )
            )
        elif node.op in ("While", "StatelessWhile"):
            csub = _subgraph_from_lib(g, node.attrs["cond"].value.name)
            bsub = _subgraph_from_lib(g, node.attrs["body"].value.name)
            n_vars = len([e for e in node.inputs if not e.startswith("^")])
            out.add(
                GraphNode(
                    node.name, "_While", list(node.inputs),
                    {
                        "while_cond": AttrValue.of_string(
                            _attach_sub(out, "while_cond", csub)
                        ),
                        "while_body": AttrValue.of_string(
                            _attach_sub(out, "while_body", bsub)
                        ),
                        "n_vars": AttrValue.of_int(n_vars),
                    },
                )
            )
        else:
            out.add(node)
    return out


def _subgraph_from_lib(g: Graph, fname: str) -> Subgraph:
    if fname not in g.library:
        raise GraphLoweringError(f"unknown library function {fname!r}")
    sub = _fdef_to_subgraph(g.library[fname])
    sub.graph.library = g.library
    # the body may itself contain calls / functional ops / v1 rings
    sg, sf = functionalize(sub.graph, list(sub.fetches))
    return Subgraph(sg, sub.feeds, sf)


# ---------------------------------------------------------------------------
# v1 dataflow control flow
# ---------------------------------------------------------------------------


def _functionalize_v1(
    g: Graph, fetches: List[str]
) -> Tuple[Graph, List[str]]:
    for _ in range(64):
        frames = _frames(g)
        if frames:
            g, fetches = _extract_while(g, fetches, frames[0])
            # drop control-only satellites of the extracted construct
            # (e.g. an inner cond's pred Switch/switch_t identities that
            # only carried ^control edges) before the next pass trips
            # over their dangling inputs
            g = _prune(g, fetches)
            continue
        group = _next_cond_group(g)
        if group is not None:
            g, fetches = _extract_cond(g, fetches, *group)
            g = _prune(g, fetches)
            continue
        leftovers = [n for n in g.nodes if n.op in _V1_OPS]
        if leftovers:
            raise GraphLoweringError(
                "unstructured v1 control flow: leftover "
                f"{[(n.op, n.name) for n in leftovers[:4]]}"
            )
        return g, fetches
    raise GraphLoweringError("v1 functionalization did not converge")


def _frames(g: Graph) -> List[str]:
    seen: List[str] = []
    for n in g.nodes:
        if n.op in ("Enter", "RefEnter"):
            f = n.attr("frame_name")
            f = f.decode() if isinstance(f, bytes) else f
            if f not in seen:
                seen.append(f)
    return seen


def _extract_while(
    g: Graph, fetches: List[str], frame: str
) -> Tuple[Graph, List[str]]:
    """Recover one while frame into a `_While` pseudo-node.

    The canonical v1 ring per loop variable i (what `tf.while_loop`
    emitted): Merge_i(Enter_i, NextIteration_i) -> [cond] -> LoopCond ->
    Switch_i(Merge_i, LoopCond); Switch_i:1 -> [body] ->
    NextIteration_i; Switch_i:0 -> Exit_i. Loop invariants enter via
    Enter(is_constant=True) and become extra carries returned unchanged.
    """

    def fattr(n: GraphNode) -> Optional[str]:
        f = n.attr("frame_name")
        return f.decode() if isinstance(f, bytes) else f

    enters = [
        n for n in g.nodes if n.op in ("Enter", "RefEnter")
        and fattr(n) == frame
    ]
    loop_enters = [n for n in enters if not n.attr("is_constant")]
    const_enters = [n for n in enters if n.attr("is_constant")]
    enter_names = {n.name for n in loop_enters}

    merges = [
        n for n in g.nodes
        if n.op in ("Merge", "RefMerge")
        and any(parse_edge(e)[0] in enter_names for e in n.inputs)
    ]
    if not merges:
        raise GraphLoweringError(
            f"while frame {frame!r} has Enter nodes but no Merge ring"
        )

    class Var:
        __slots__ = ("enter", "merge", "next", "switch", "exit")

    nvars: List[Var] = []
    merge_names = {m.name for m in merges}
    switches = {
        parse_edge(n.inputs[0])[0]: n
        for n in g.nodes
        if n.op in ("Switch", "RefSwitch")
        and parse_edge(n.inputs[0])[0] in merge_names
    }
    exits = {}
    switch_names = {s.name for s in switches.values()}
    for n in g.nodes:
        if n.op in ("Exit", "RefExit"):
            b = parse_edge(n.inputs[0])[0]
            if b in switch_names:
                exits[b] = n

    lc_name = None
    for m in merges:
        v = Var()
        v.merge = m
        ins = [parse_edge(e)[0] for e in m.inputs]
        v.enter = next(g[i] for i in ins if i in enter_names)
        v.next = next(
            (g[i] for i in ins
             if g[i].op in ("NextIteration", "RefNextIteration")),
            None,
        )
        if v.next is None:
            raise GraphLoweringError(
                f"merge {m.name!r} in while frame {frame!r} has no "
                "NextIteration back edge"
            )
        v.switch = switches.get(m.name)
        v.exit = exits.get(v.switch.name) if v.switch is not None else None
        if v.switch is not None:
            cand = parse_edge(v.switch.inputs[1])[0]
            if g[cand].op != "LoopCond":
                raise GraphLoweringError(
                    f"switch {v.switch.name!r} predicate is "
                    f"{g[cand].op!r}, expected LoopCond"
                )
            if lc_name is None:
                lc_name = cand
            elif lc_name != cand:
                raise GraphLoweringError(
                    f"while frame {frame!r} has two LoopConds "
                    f"({lc_name!r}, {cand!r}) — nested frames sharing a "
                    "name are unsupported"
                )
        nvars.append(v)
    if lc_name is None:
        raise GraphLoweringError(
            f"while frame {frame!r} has no Switch/LoopCond"
        )
    lc = g[lc_name]

    edge_map: Dict[Tuple[str, int], str] = {}
    body_map: Dict[Tuple[str, int], str] = {}
    feeds: List[str] = []
    for i, v in enumerate(nvars):
        ph = f"__var{i}"
        feeds.append(ph)
        edge_map[(v.merge.name, 0)] = ph
        if v.switch is not None:
            body_map[(v.switch.name, 1)] = ph
    caps: List[str] = []
    for j, ce in enumerate(const_enters):
        ph = f"__cap{j}"
        feeds.append(ph)
        caps.append(ph)
        edge_map[(ce.name, 0)] = ph
        body_map[(ce.name, 0)] = ph

    ring_reason = {
        n.name: f"{n.op} of while frame {frame!r}"
        for n in (
            enters + merges + [lc]
            + [v.switch for v in nvars if v.switch is not None]
            + [v.next for v in nvars]
            + [v.exit for v in nvars if v.exit is not None]
        )
    }

    # cond: closure from the LoopCond input, stopping at merges/caps
    ring_for_cond = {
        k: r for k, r in ring_reason.items()
        if k not in {m.name for m in merges}
        and k not in {ce.name for ce in const_enters}
    }
    cond_nodes, cond_fetch, cond_visited = _clone_closure(
        g, [lc.inputs[0]], edge_map, forbidden=ring_for_cond
    )
    # body: closure from every NextIteration input, stopping at
    # switch:1 / caps; merges may be reached via nothing (forbidden)
    ring_for_body = {
        k: r for k, r in ring_reason.items()
        if k not in {v.switch.name for v in nvars if v.switch is not None}
        and k not in {ce.name for ce in const_enters}
    }
    # invariant captures return unchanged: fetch the const-Enter edges,
    # which the boundary map rewrites to the __cap placeholders
    body_srcs = [v.next.inputs[0] for v in nvars] + [
        ce.name for ce in const_enters
    ]
    body_nodes, body_fetch, body_visited = _clone_closure(
        g, body_srcs, body_map, forbidden=ring_for_body
    )

    def build_sub(nodes: List[GraphNode], fetch: List[str]) -> Subgraph:
        sub = Graph()
        for i, v in enumerate(nvars):
            sub.add(_placeholder(f"__var{i}", v.enter.attr("T")))
        for j, ce in enumerate(const_enters):
            sub.add(_placeholder(f"__cap{j}", ce.attr("T")))
        for n in nodes:
            sub.add(n)
        _copy_nested_subgraphs(g, sub)
        sub.library = g.library
        # the body may contain NESTED control flow (tf.cond inside the
        # loop body, an inner while frame): functionalize recursively
        sg, sf = functionalize(sub, list(fetch))
        return Subgraph(sg, list(feeds), sf)

    cond_sub = build_sub(cond_nodes, cond_fetch[:1])
    body_sub = build_sub(body_nodes, body_fetch)

    out = Graph()
    out.library = g.library
    out._library_proto = g._library_proto
    out.subgraphs = dict(g.subgraphs)
    wname = _unique_name(g, frame.split("/")[0] + "/_functional_while")
    interior = (
        set(ring_reason) | cond_visited | body_visited
        | {ce.name for ce in const_enters}
    )
    for n in g.nodes:
        if n.name in interior:
            continue
        out.add(n)
    out.add(
        GraphNode(
            wname, "_While",
            [v.enter.inputs[0] for v in nvars]
            + [ce.inputs[0] for ce in const_enters],
            {
                "while_cond": AttrValue.of_string(
                    _attach_sub(out, "while_cond", cond_sub)
                ),
                "while_body": AttrValue.of_string(
                    _attach_sub(out, "while_body", body_sub)
                ),
                "n_vars": AttrValue.of_int(len(nvars)),
            },
        )
    )
    repl = {
        (v.exit.name, 0): f"{wname}:{i}"
        for i, v in enumerate(nvars)
        if v.exit is not None
    }
    _check_interior_leaks(
        out, fetches, repl, interior, f"while frame {frame!r}"
    )
    return _apply_repl(out, fetches, repl)


def _check_interior_leaks(
    out: Graph,
    fetches: Sequence[str],
    repl: Dict[Tuple[str, int], str],
    dropped: Set[str],
    what: str,
) -> None:
    """Before an extracted construct's interior nodes vanish, verify no
    surviving node (or fetch) REACHABLE from the fetches consumes an
    interior output that is not re-exported through ``repl`` (Exit /
    Merge outputs). Raising here names the leaking edge and its
    consumer; without the check the dangling reference surfaces later as
    a bare `KeyError` deep in toposort. Unreachable consumers are
    ignored — `_prune` removes them right after extraction, exactly as
    before."""

    def leak(consumer: str, edge: str) -> None:
        dep, idx, _ = parse_edge(edge)
        raise GraphLoweringError(
            f"{consumer} consumes {dep}:{idx}, an interior node of the "
            f"extracted {what}; only its functional outputs are visible "
            "outside — unstructured control flow"
        )

    seen: Set[str] = set()

    def visit(name: str):
        if name in seen or name not in out:
            return
        seen.add(name)
        for e in out[name].inputs:
            dep, idx, _ = parse_edge(e)
            if dep in dropped and (dep, idx) not in repl:
                leak(f"node {out[name].name!r}", e)
            if dep not in dropped:
                visit(dep)

    for f in fetches:
        dep, idx, _ = parse_edge(f)
        if dep in dropped and (dep, idx) not in repl:
            leak(f"fetch {f!r}", f)
        visit(dep)


def _resolve_pred(g: Graph, edge: str) -> Tuple[str, int]:
    name, idx, _ = parse_edge(edge)
    for _ in range(64):
        node = g[name]
        if node.op == "Identity" and len(node.data_inputs()) == 1:
            name, idx = node.data_inputs()[0]
        else:
            return name, idx
    return name, idx


def _next_cond_group(g: Graph):
    """Pick one cond diamond: all Switches sharing a resolved predicate.
    Returns (pred_edge, switch list) or None."""
    groups: Dict[Tuple[str, int], List[GraphNode]] = {}
    first_edge: Dict[Tuple[str, int], str] = {}
    for n in g.nodes:
        if n.op in ("Switch", "RefSwitch"):
            origin = _resolve_pred(g, n.inputs[1])
            groups.setdefault(origin, []).append(n)
            first_edge.setdefault(origin, n.inputs[1])
    if not groups:
        return None
    origin = next(iter(groups))
    return first_edge[origin], groups[origin]


def _extract_cond(
    g: Graph, fetches: List[str], pred_edge: str, switches: List[GraphNode]
) -> Tuple[Graph, List[str]]:
    """Recover one cond diamond into a `_Cond` pseudo-node.

    Branch membership by label propagation from Switch ports (port 1 =
    true) through data AND control edges (v1 pins branch constants with
    a control edge to the switch identities) until the joining Merges.
    """
    switch_names = {s.name for s in switches}
    labels: Dict[str, str] = {}
    joins: List[GraphNode] = []
    join_set: Set[str] = set()

    changed = True
    while changed:
        changed = False
        for node in g.nodes:
            if node.name in switch_names or node.name in join_set:
                continue
            got: Set[str] = set()
            for e in node.inputs:
                dep, idx, _ = parse_edge(e)
                if dep in switch_names:
                    got.add("T" if idx == 1 else "F")
                elif dep in labels:
                    got.add(labels[dep])
            if len(got) == 2:
                if node.op in ("Merge", "RefMerge"):
                    joins.append(node)
                    join_set.add(node.name)
                    labels.pop(node.name, None)
                    changed = True
                    continue
                raise GraphLoweringError(
                    f"node {node.name!r} ({node.op}) consumes both cond "
                    "branches without a Merge — unstructured control flow"
                )
            if len(got) == 1 and node.name not in labels:
                labels[node.name] = got.pop()
                changed = True

    if not joins:
        raise GraphLoweringError(
            f"cond Switches {sorted(switch_names)[:3]} have no joining "
            "Merge — unstructured control flow"
        )

    # captures: external data edges consumed inside either branch.
    # Iterate the dict (insertion-ordered), NOT a set: cap order decides
    # the _Cond input order and the content-hashed subgraph keys, which
    # must be deterministic across processes (hash randomization).
    interior = set(labels)
    cap_edges: List[Tuple[str, int]] = []
    for name in labels:
        for e in g[name].inputs:
            dep, idx, ctrl = parse_edge(e)
            if ctrl or dep in interior or dep in switch_names:
                continue
            if (dep, idx) not in cap_edges:
                cap_edges.append((dep, idx))

    edge_map_t: Dict[Tuple[str, int], str] = {}
    edge_map_f: Dict[Tuple[str, int], str] = {}
    feeds: List[str] = []
    for k, s in enumerate(switches):
        ph = f"__sw{k}"
        feeds.append(ph)
        edge_map_t[(s.name, 1)] = ph
        edge_map_f[(s.name, 0)] = ph
        # a branch may read the "wrong" port only through its own
        # label; canonical graphs never do, and _clone_closure's
        # boundary check will surface it if one does
    for j, (dep, idx) in enumerate(cap_edges):
        ph = f"__cap{j}"
        feeds.append(ph)
        edge_map_t[(dep, idx)] = ph
        edge_map_f[(dep, idx)] = ph

    def branch(lab: str, emap) -> Tuple[Subgraph, Set[str]]:
        srcs = []
        for m in joins:
            side = None
            for e in m.inputs:
                dep, idx, _ = parse_edge(e)
                l = (
                    ("T" if idx == 1 else "F")
                    if dep in switch_names
                    else labels.get(dep)
                )
                if l == lab:
                    side = e
            if side is None:
                raise GraphLoweringError(
                    f"merge {m.name!r} has no {lab}-branch input"
                )
            srcs.append(side)
        allowed = {n for n, l in labels.items() if l == lab}
        nodes, fetch, visited = _clone_closure(
            g, srcs, emap, allowed=allowed | {parse_edge(s)[0] for s in srcs}
        )
        sub = Graph()
        for ph in feeds:
            sub.add(_placeholder(ph))
        for n in nodes:
            sub.add(n)
        _copy_nested_subgraphs(g, sub)
        sub.library = g.library
        # nested conds/loops inside the branch functionalize recursively
        sg, sf = functionalize(sub, list(fetch))
        return Subgraph(sg, list(feeds), sf), visited

    then_sub, _ = branch("T", edge_map_t)
    else_sub, _ = branch("F", edge_map_f)

    # Merge value_index (:1) consumers are unsupported
    join_names = {m.name for m in joins}
    for n in g.nodes:
        if n.name in interior or n.name in join_names:
            continue
        for e in n.inputs:
            dep, idx, _ = parse_edge(e)
            if dep in join_names and idx != 0:
                raise GraphLoweringError(
                    f"node {n.name!r} consumes Merge value_index "
                    f"({dep}:{idx}) — unsupported"
                )

    out = Graph()
    out.library = g.library
    out._library_proto = g._library_proto
    out.subgraphs = dict(g.subgraphs)
    cname = _unique_name(g, joins[0].name + "/_functional_cond")
    drop = interior | switch_names | join_names
    for n in g.nodes:
        if n.name in drop:
            continue
        out.add(n)
    out.add(
        GraphNode(
            cname, "_Cond",
            [pred_edge]
            + [s.inputs[0] for s in switches]
            + [dep if idx == 0 else f"{dep}:{idx}" for dep, idx in cap_edges],
            {
                "cond_then": AttrValue.of_string(
                    _attach_sub(out, "cond_then", then_sub)
                ),
                "cond_else": AttrValue.of_string(
                    _attach_sub(out, "cond_else", else_sub)
                ),
                "n_out": AttrValue.of_int(len(joins)),
            },
        )
    )
    repl = {(m.name, 0): f"{cname}:{j}" for j, m in enumerate(joins)}
    _check_interior_leaks(
        out, fetches, repl, drop,
        f"cond diamond at {joins[0].name!r}",
    )
    return _apply_repl(out, fetches, repl)
