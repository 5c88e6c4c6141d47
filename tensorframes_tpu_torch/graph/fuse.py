"""Graph splicing: fuse a consumer graph onto a producer graph.

A copy of `tensorframes_tpu/graph/fuse.py`, the mechanical core of lazy
verb fusion (`tensorframes_tpu_torch.lazy`). A chained ``map_blocks ->
map_blocks -> reduce_blocks`` pipeline is, at the graph level, a sequence
of graphs where each stage's placeholders read the previous stage's
outputs by column name. `splice` turns that chain into ONE graph: consumer
placeholders bound to a producer output are deleted and their consumers
rewired to the producer edge, every other consumer node is copied in with
its name uniquified against the producer's namespace, and the function
library / extracted control-flow subgraphs of both sides merge.

The result is an ordinary `Graph`, so everything downstream — analysis,
`build_callable` lowering, the executor cache keyed on
`Graph.fingerprint()` — works unchanged: the whole chain is one lowered
callable per block, so the per-stage Python dispatch and the whole-column
intermediates of the eager chain go away (the HiFrames observation,
arxiv 1704.02341: operator fusion is the dominant win for dataframe
pipelines). Eager PyTorch still launches the chain's ATen ops one by one.

Placeholder<->output *matching policy* (name conventions, dtype/shape
validation) lives with the caller (`lazy.LazyFrame`); this module only
performs the validated rewiring.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

from .ir import Graph, GraphNode, parse_edge

__all__ = ["splice", "chain_fingerprint"]


def chain_fingerprint(graph: Graph, feed_map: Dict[str, str],
                      outputs) -> str:
    """Canonical digest of one fused verb chain: the spliced graph's
    content fingerprint plus the placeholder->column bindings and the
    (sorted) output column set. This is the identity a fused chain
    contributes to a relational plan fingerprint (`graph.plan`) — two
    chains that fused to the same program over the same bindings key
    identically no matter how many verb calls produced them."""
    h = hashlib.sha256(graph.fingerprint().encode())
    for ph, colname in sorted(feed_map.items()):
        h.update(f"|{ph}={colname}".encode())
    for out in sorted(outputs):
        h.update(f"|>{out}".encode())
    return h.hexdigest()[:16]


def _rewired_edge(edge: str, target: str) -> str:
    """Rewire ``edge`` (which pointed at a bound placeholder) to the
    producer edge ``target``. Placeholders have exactly one output, so
    the consumer-side output index is always 0 and the target edge is
    used verbatim; control edges retarget to the target's base node."""
    _, _, ctrl = parse_edge(edge)
    if ctrl:
        return "^" + parse_edge(target)[0]
    return target


def splice(
    producer: Graph,
    consumer: Graph,
    bindings: Dict[str, str],
    fetches: List[str],
) -> Tuple[Graph, List[str], Dict[str, str]]:
    """Splice ``consumer`` onto ``producer``.

    ``bindings`` maps consumer placeholder names to producer edges
    (``node`` / ``node:k``): those placeholders are dropped and their
    consumers rewired to the producer edge. Every other consumer node is
    added to the fused graph, renamed only on collision with a producer
    node name (suffix ``__f<k>``), so single-stage plans keep their
    original names and fingerprints stay content-deterministic.

    Returns ``(fused graph, fetches rewritten into fused edges,
    rename map: consumer node name -> fused node name)``. The producer's
    own node names and edges are preserved verbatim, so any producer
    fetch edge remains valid in the fused graph.
    """
    fused = producer.clone()
    # side tables: extracted control-flow bodies merge freely (subgraph
    # keys are content-hashed, so a same-key collision means an
    # identical body); function libraries are keyed by NAME, and two
    # stages traced in different processes can carry the same function
    # name with different bodies (TF's name counter is per-process) —
    # silently letting one win would make call sites execute the wrong
    # body, so a same-name different-bytes collision refuses to fuse
    for fname, fdef in consumer.library.items():
        prev = producer.library.get(fname)
        if prev is not None and prev is not fdef and (
            prev.to_bytes() != fdef.to_bytes()
        ):
            raise ValueError(
                f"splice: function library collision on {fname!r} with "
                "different bodies between stages; force() between them"
            )
    fused.library = {**producer.library, **consumer.library}
    fused.subgraphs = {**producer.subgraphs, **consumer.subgraphs}
    if fused.library:
        from ..proto.graphdef import FunctionDefLibrary

        # rebuilt (raw=b"") library: serializes from .functions, so the
        # fused fingerprint still covers merged function bodies
        fused._library_proto = FunctionDefLibrary(list(fused.library.values()))

    dropped = {
        n.name
        for n in consumer.placeholders()
        if n.name in bindings
    }
    unknown = sorted(set(bindings) - dropped)
    if unknown:
        raise ValueError(
            f"splice: bindings {unknown} do not name consumer placeholders "
            f"(placeholders: {sorted(p.name for p in consumer.placeholders())})"
        )

    rename: Dict[str, str] = {}
    for n in consumer.nodes:
        if n.name in dropped:
            continue
        name = n.name
        if name in fused:
            k = 1
            while f"{name}__f{k}" in fused or f"{name}__f{k}" in rename.values():
                k += 1
            name = f"{name}__f{k}"
        rename[n.name] = name
        fused.add(GraphNode(name, n.op, [], dict(n.attrs)))  # inputs below

    def rw(edge: str) -> str:
        base, idx, ctrl = parse_edge(edge)
        if base in dropped:
            return _rewired_edge(edge, bindings[base])
        if base not in rename:
            raise ValueError(
                f"splice: consumer edge {edge!r} references {base!r}, "
                "which is neither a consumer node nor a bound placeholder"
            )
        new = rename[base]
        if ctrl:
            return "^" + new
        return f"{new}:{idx}" if idx else new

    for n in consumer.nodes:
        if n.name in dropped:
            continue
        fused[rename[n.name]].inputs.extend(rw(e) for e in n.inputs)

    return fused, [rw(f) for f in fetches], rename
