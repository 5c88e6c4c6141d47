"""Relational plan DAG: first-class filter/select/sort/join/groupby nodes.

A copy of `tensorframes_tpu/graph/plan.py` for the PyTorch port. The five
paper verbs are map/reduce-shaped linear chains (`lazy.py` fuses them into
ONE graph via `fuse.splice`); real traffic is filter/join/groupby-shaped.
This module generalizes the linear fused chain into a **plan DAG** whose
nodes are either relational verbs or opaque "map" nodes wrapping the
fused-chain machinery (the HiFrames observation, arxiv 1704.02341).

Three layers live here:

* `Col` / `Pred` — a tiny predicate expression tree (`col("x") > 0.5`,
  `&`/`|`/`~`) that evaluates as a numpy *or* torch mask, prunes parquet
  row groups from footer statistics (`may_match`), and fingerprints
  **canonically** (commutative `&`/`|` operands sort), so semantically
  equal predicates key the same plan.
* `PlanNode` — immutable DAG node (`source`/`scan`/`map`/`filter`/
  `select`/`sort`/`groupby`/`join`) with a structural fingerprint;
  `graph.optimizer` rewrites these.
* `execute` — lowers an (optimized) DAG onto the port's executors on one
  device: map nodes replay through `LazyFrame` (one fused callable per
  block), groupby-agg through the segment-aggregate plan, and filter, sort
  and join on the host as the JAX package's local path does (numpy mask
  and compaction, `np.lexsort`, `pandas.merge`): a device column crosses
  to the host once (`Column.host_values`), observed as ``d2h_bytes``.

`data_fingerprint` digests the DAG's leaves' data (a host frame's content,
a dataset's metadata identity): with `plan_fingerprint` it keys the
materialization cache of a relational force (`lazy.RelationalFrame.force`).

Over a `GlobalFrame` a filter runs on its shards
(`globalframe.filter_global`); what the shards cannot run crosses to the
local path, counted in ``plan_fallbacks{reason=}`` (``filter-ineligible``,
``sort-global``, ``join-global``).

Process-global accounting (rewrites / fallbacks / pushdown rows) lives
behind `_LOCK` with the standard `state()` / `reset_state()` pair.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Col",
    "Pred",
    "col",
    "PlanNode",
    "execute",
    "render",
    "plan_fingerprint",
    "data_fingerprint",
    "map_outputs",
    "map_feeds",
    "note_fallback",
    "note_rewrite",
    "note_pushdown_rows",
    "note_cache_hit",
    "state",
    "reset_state",
]

AGG_OPS = ("sum", "mean", "min", "max")

# ---------------------------------------------------------------------------
# accounting (module-global; lock-guarded; `reset_state` clears it)
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()


def _new_acct() -> Dict[str, Any]:
    return {
        "optimize_runs": 0,
        "rewrites": {},  # rule -> accepted count
        "rejected": {},  # rule -> cost-rejected count
        "fallbacks": {},  # reason -> count
        "pushdown_rows_skipped": 0,
        "executed_nodes": 0,
        "forces": 0,
        "cache_hits": 0,
    }


_ACCT = _new_acct()


def note_rewrite(rule: str, accepted: bool) -> None:
    """Record one optimizer decision; only ACCEPTED rewrites hit the
    `plan_rewrites{rule=}` counter (rejections stay visible in
    `state()["rejected"]` and in `explain`)."""
    with _LOCK:
        key = "rewrites" if accepted else "rejected"
        _ACCT[key][rule] = _ACCT[key].get(rule, 0) + 1
    if accepted:
        from ..utils import telemetry as _tele

        _tele.counter_inc("plan_rewrites", 1, rule=rule)


def note_fallback(reason: str) -> None:
    with _LOCK:
        _ACCT["fallbacks"][reason] = _ACCT["fallbacks"].get(reason, 0) + 1
    from ..utils import telemetry as _tele

    _tele.counter_inc("plan_fallbacks", 1, reason=reason)


def note_pushdown_rows(n: int) -> None:
    """Rows the scan pushdown PROVABLY skipped decoding (parquet
    row-group stats pruning) — the honest counter behind the "decode
    fewer rows, not mask more" claim."""
    if n <= 0:
        return
    with _LOCK:
        _ACCT["pushdown_rows_skipped"] += int(n)
    from ..utils import telemetry as _tele

    _tele.counter_inc("plan_pushdown_rows_skipped", int(n))


def note_cache_hit() -> None:
    with _LOCK:
        _ACCT["cache_hits"] += 1


def _note_optimize() -> None:
    with _LOCK:
        _ACCT["optimize_runs"] += 1


def _note_force() -> None:
    with _LOCK:
        _ACCT["forces"] += 1


def state() -> Dict[str, Any]:
    """Snapshot of the plan/optimizer ledger (diagnostics section)."""
    with _LOCK:
        return {
            "optimize_runs": _ACCT["optimize_runs"],
            "forces": _ACCT["forces"],
            "executed_nodes": _ACCT["executed_nodes"],
            "cache_hits": _ACCT["cache_hits"],
            "pushdown_rows_skipped": _ACCT["pushdown_rows_skipped"],
            "rewrites": dict(_ACCT["rewrites"]),
            "rejected": dict(_ACCT["rejected"]),
            "fallbacks": dict(_ACCT["fallbacks"]),
        }


def reset_state() -> None:
    global _ACCT
    with _LOCK:
        _ACCT = _new_acct()


# ---------------------------------------------------------------------------
# predicate expression tree
# ---------------------------------------------------------------------------


class Col:
    """A column reference inside a predicate: ``col("x") > 0.5``."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def _cmp(self, op: str, other) -> "Pred":
        return Pred("cmp", op=op, left=self, right=other)

    def __gt__(self, other):
        return self._cmp("gt", other)

    def __ge__(self, other):
        return self._cmp("ge", other)

    def __lt__(self, other):
        return self._cmp("lt", other)

    def __le__(self, other):
        return self._cmp("le", other)

    def __eq__(self, other):  # type: ignore[override]
        return self._cmp("eq", other)

    def __ne__(self, other):  # type: ignore[override]
        return self._cmp("ne", other)

    def __hash__(self):
        return hash(("Col", self.name))

    def __repr__(self):
        return f"col({self.name!r})"


def col(name: str) -> Col:
    """Predicate column reference (the relational DSL entry point)."""
    return Col(name)


_CMP_FNS: Dict[str, Callable] = {
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
}
_CMP_TEXT = {"gt": ">", "ge": ">=", "lt": "<", "le": "<=", "eq": "==", "ne": "!="}


class Pred:
    """Predicate tree node: comparison (`cmp`) or `and`/`or`/`not`.

    Evaluates against any column lookup (numpy arrays or torch tensors);
    `may_match` consults (min, max) column stats
    conservatively so parquet row groups can be skipped *before*
    decode; `fingerprint()` is canonical under commutativity (the
    operands of `&`, `|`, `==`, `!=` sort), which is what lets
    reordered-but-equal plans share one plan fingerprint.
    """

    __slots__ = ("kind", "op", "left", "right", "children")

    def __init__(self, kind, op=None, left=None, right=None, children=()):
        self.kind = kind
        self.op = op
        self.left = left
        self.right = right
        self.children = tuple(children)

    # -- combinators ----------------------------------------------------
    def __and__(self, other: "Pred") -> "Pred":
        return Pred("and", children=(self, other))

    def __or__(self, other: "Pred") -> "Pred":
        return Pred("or", children=(self, other))

    def __invert__(self) -> "Pred":
        return Pred("not", children=(self,))

    def __bool__(self):
        raise TypeError(
            "Pred is not a python boolean; combine predicates with "
            "`&` / `|` / `~`, not `and` / `or` / `not`"
        )

    # -- introspection --------------------------------------------------
    def columns(self) -> set:
        if self.kind == "cmp":
            cols = {self.left.name}
            if isinstance(self.right, Col):
                cols.add(self.right.name)
            return cols
        out: set = set()
        for c in self.children:
            out |= c.columns()
        return out

    def mask(self, getcol: Callable[[str], Any]):
        """Boolean mask over rows; works for numpy arrays and torch
        tensors."""
        if self.kind == "cmp":
            lhs = getcol(self.left.name)
            rhs = (
                getcol(self.right.name)
                if isinstance(self.right, Col)
                else self.right
            )
            return _CMP_FNS[self.op](lhs, rhs)
        masks = [c.mask(getcol) for c in self.children]
        if self.kind == "and":
            out = masks[0]
            for m in masks[1:]:
                out = out & m
            return out
        if self.kind == "or":
            out = masks[0]
            for m in masks[1:]:
                out = out | m
            return out
        return ~masks[0]  # not

    def may_match(self, stats: Dict[str, Tuple[Any, Any]]) -> bool:
        """Conservative row-group test from (min, max) column stats:
        False ONLY when the group provably contains no matching row —
        missing stats or inexpressible shapes always keep the group."""
        if self.kind == "cmp":
            if isinstance(self.right, Col):
                return True  # col-vs-col: stats cannot decide
            st = stats.get(self.left.name)
            if st is None:
                return True
            mn, mx = st
            if mn is None or mx is None:
                return True
            try:
                v = self.right
                if self.op == "gt":
                    return mx > v
                if self.op == "ge":
                    return mx >= v
                if self.op == "lt":
                    return mn < v
                if self.op == "le":
                    return mn <= v
                if self.op == "eq":
                    return mn <= v <= mx
                if self.op == "ne":
                    return not (mn == mx == v)
            except TypeError:
                return True
            return True
        if self.kind == "and":
            return all(c.may_match(stats) for c in self.children)
        if self.kind == "or":
            return any(c.may_match(stats) for c in self.children)
        return True  # not: negating range logic is not conservative

    # -- identity -------------------------------------------------------
    def fingerprint(self) -> str:
        return _short(self._canonical())

    def _canonical(self) -> str:
        if self.kind == "cmp":
            lhs = f"c:{self.left.name}"
            rhs = (
                f"c:{self.right.name}"
                if isinstance(self.right, Col)
                else f"v:{self.right!r}"
            )
            if self.op in ("eq", "ne") and rhs < lhs:
                lhs, rhs = rhs, lhs  # commutative comparison
            return f"({self.op} {lhs} {rhs})"
        parts = [c._canonical() for c in self.children]
        if self.kind in ("and", "or"):
            parts.sort()  # commutative + associative at this arity
        return f"({self.kind} {' '.join(parts)})"

    def describe(self) -> str:
        if self.kind == "cmp":
            rhs = (
                self.right.name if isinstance(self.right, Col) else repr(self.right)
            )
            return f"{self.left.name} {_CMP_TEXT[self.op]} {rhs}"
        if self.kind == "not":
            return f"~({self.children[0].describe()})"
        joiner = " & " if self.kind == "and" else " | "
        return "(" + joiner.join(c.describe() for c in self.children) + ")"

    def __repr__(self):
        return f"Pred<{self.describe()}>"


def _short(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# plan DAG nodes
# ---------------------------------------------------------------------------


class PlanNode:
    """One immutable relational plan node.

    ops: ``source`` (in-memory TensorFrame leaf), ``scan``
    (ingest Dataset leaf; payload carries the pushed-down column set +
    predicate), ``map`` (opaque fused-chain or expr stages), ``filter``,
    ``select``, ``sort``, ``groupby``, ``join``.
    """

    __slots__ = ("op", "inputs", "payload", "_plan_fp", "_data_fp")

    def __init__(self, op: str, inputs: Sequence["PlanNode"] = (),
                 payload: Optional[Dict[str, Any]] = None):
        self.op = op
        self.inputs = tuple(inputs)
        self.payload = dict(payload or {})
        self._plan_fp: Optional[str] = None
        # (computed, frame fingerprint or None) of a source leaf
        self._data_fp: Optional[Tuple[bool, Optional[str]]] = None

    # -- payload digests ------------------------------------------------
    def _payload_canonical(self) -> str:
        p = self.payload
        if self.op == "source":
            return "source"
        if self.op == "scan":
            cols = ",".join(p.get("columns") or ())
            pred = p.get("predicate")
            ptxt = pred._canonical() if pred is not None else ""
            return f"scan cols=[{cols}] pred={ptxt}"
        if self.op == "map":
            if p.get("kind") == "fused":
                from . import fuse as _fuse

                return "map fused " + _fuse.chain_fingerprint(
                    p["graph"], p["feed_map"], sorted(p["sources"])
                )
            parts = []
            for st in p["stages"]:
                fd = st.get("feed_dict") or {}
                parts.append(
                    st["graph"].fingerprint()
                    + "|"
                    + ",".join(f"{k}={v}" for k, v in sorted(fd.items()))
                    + "|"
                    + ",".join(st["fetch_list"])
                )
            return "map exprs " + ";".join(parts)
        if self.op == "filter":
            sel = p.get("selectivity")
            return f"filter {p['pred']._canonical()} sel={sel}"
        if self.op == "select":
            return "select " + ",".join(p["columns"])
        if self.op == "sort":
            return (
                "sort " + ",".join(p["keys"])
                + (" desc" if p.get("descending") else "")
            )
        if self.op == "groupby":
            specs = ",".join(
                f"{out}={op_}({c})"
                for out, (op_, c) in sorted(p["specs"].items())
            )
            return "groupby " + ",".join(p["keys"]) + " agg " + specs
        if self.op == "join":
            return f"join on={','.join(p['on'])} how={p.get('how', 'inner')}"
        raise ValueError(f"unknown plan op {self.op!r}")

    def describe(self) -> str:
        """One explain line (payload summary, no fingerprints)."""
        p = self.payload
        if self.op == "source":
            frame = p["frame"]
            kind = type(frame).__name__
            return f"source[{kind}] rows={_frame_rows(frame)}"
        if self.op == "scan":
            cols = p.get("columns")
            pred = p.get("predicate")
            bits = [f"columns={list(cols)}" if cols else "columns=*"]
            if pred is not None:
                bits.append(f"predicate=({pred.describe()})")
            return "scan " + " ".join(bits)
        if self.op == "map":
            kind = p.get("kind")
            outs = sorted(map_outputs(self.payload))
            if kind == "fused":
                return f"map[fused chain] -> {outs}"
            return f"map[{len(p['stages'])} stage(s)] -> {outs}"
        if self.op == "filter":
            sel = p.get("selectivity")
            hint = f" sel~{sel}" if sel is not None else ""
            return f"filter ({p['pred'].describe()}){hint}"
        if self.op == "select":
            return f"select {list(p['columns'])}"
        if self.op == "sort":
            d = " descending" if p.get("descending") else ""
            return f"sort_by {list(p['keys'])}{d}"
        if self.op == "groupby":
            specs = {
                out: f"{op_}({c})" for out, (op_, c) in sorted(p["specs"].items())
            }
            return f"group_by {list(p['keys'])} agg {specs}"
        if self.op == "join":
            return f"join on={list(p['on'])} how={p.get('how', 'inner')}"
        return self.op


def map_outputs(payload: Dict[str, Any]) -> set:
    """Column names a map node PRODUCES (shadowing passthroughs)."""
    if payload.get("kind") == "fused":
        return set(payload["sources"])
    out: set = set()
    for st in payload["stages"]:
        out |= {f.split(":")[0] for f in st["fetch_list"]}
    return out


def map_feeds(payload: Dict[str, Any]) -> set:
    """Column names a map node READS from its INPUT frame. For a
    multi-stage expression chain, later stages reading an earlier
    stage's output are internal — the reverse walk nets them out so
    column pruning never demands a column that only exists inside the
    chain."""
    if payload.get("kind") == "fused":
        return set(payload["feed_map"].values())
    need: set = set()
    for st in reversed(payload["stages"]):
        outs = {f.split(":")[0] for f in st["fetch_list"]}
        need = (need - outs) | set(st.get("feeds") or ())
    return need


def _frame_rows(frame) -> int:
    if hasattr(frame, "nrows"):
        return int(frame.nrows)
    names = frame.columns
    return len(frame.column(names[0])) if names else 0


# ---------------------------------------------------------------------------
# fingerprints (structural plan key)
# ---------------------------------------------------------------------------


def plan_fingerprint(root: PlanNode) -> str:
    """Canonical structural fingerprint of the DAG: payloads digest
    canonically (predicates sort commutative operands), leaves
    contribute only their ordinal — two semantically equal plans over
    the same-shaped inputs share this key regardless of how they were
    authored."""
    memo: Dict[int, str] = {}

    def rec(node: PlanNode) -> str:
        fp = memo.get(id(node))
        if fp is None:
            if node._plan_fp is not None:
                fp = node._plan_fp
            else:
                kids = ",".join(rec(i) for i in node.inputs)
                fp = _short(f"{node._payload_canonical()}[{kids}]")
                node._plan_fp = fp
            memo[id(node)] = fp
        return fp

    return rec(root)


def data_fingerprint(root: PlanNode) -> Optional[str]:
    """Digest of every leaf's DATA in DFS order (a source frame's content
    fingerprint, a scanned dataset's fingerprint), or None when a leaf
    cannot be fingerprinted (a frame with a column on the card, a dataset
    that cannot be read): the caller then skips the materialization cache."""
    h = hashlib.sha256()
    seen: Dict[int, bool] = {}

    def rec(node: PlanNode) -> bool:
        cached = seen.get(id(node))
        if cached is not None:
            return cached
        ok = True
        if node.op == "source":
            fp = _source_data_fp(node)
            if fp is None:
                ok = False
            else:
                h.update(fp.encode())
        elif node.op == "scan":
            try:
                h.update(node.payload["dataset"].fingerprint().encode())
            except Exception:
                ok = False
        else:
            ok = all(rec(i) for i in node.inputs)
        seen[id(node)] = ok
        return ok

    return h.hexdigest() if rec(root) else None


def _source_data_fp(node: PlanNode) -> Optional[str]:
    if node._data_fp is None:
        from ..runtime import materialize as _mat

        try:
            fp = _mat.frame_fingerprint(node.payload["frame"])
        except Exception:
            fp = None
        node._data_fp = (True, fp)
    return node._data_fp[1]


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------


def execute(root: PlanNode, executor=None, device=None):
    """Run the (optimized) DAG bottom-up on ``device`` (the verbs' device:
    map and groupby nodes compute there). Shared subplans execute once
    (the structural-dedup rewrite makes equal subplans the SAME node, so
    an id-keyed memo suffices)."""
    memo: Dict[int, Any] = {}

    def run(node: PlanNode):
        if id(node) in memo:
            return memo[id(node)]
        ins = [run(i) for i in node.inputs]
        out = _EXEC[node.op](node, ins, executor, device)
        memo[id(node)] = out
        with _LOCK:
            _ACCT["executed_nodes"] += 1
        return out

    return run(root)


def _host_values(frame, name: str) -> np.ndarray:
    """``frame``'s column as host numpy: a device column crosses once
    (`Column.host_values` caches the copy), and that copy is observed in
    the ``d2h_bytes`` histogram."""
    from ..utils import telemetry as _tele

    c = frame.column(name)
    fresh = c.device is not None and c._host is None
    values = c.host_values()
    if fresh and _tele.enabled():
        _tele.histogram_observe("d2h_bytes", float(values.nbytes))
    return values


def _is_global(frame) -> bool:
    from .. import globalframe as _gfm

    return isinstance(frame, _gfm.GlobalFrame)


def _localize(frame, reason: str):
    """A counted crossing from a `GlobalFrame` to the local block path,
    for the nodes its shards cannot run."""
    if _is_global(frame):
        note_fallback(reason)
        return frame.to_frame()
    return frame


def _exec_source(node, ins, executor, device):
    return node.payload["frame"]


def _exec_scan(node, ins, executor, device):
    from ..frame import TensorFrame
    from ..utils import telemetry as _tele

    ds = node.payload["dataset"]
    cols = node.payload.get("columns")
    pred = node.payload.get("predicate")
    with _tele.span(
        "plan.scan", kind="stage",
        predicate=pred.describe() if pred is not None else None,
        columns=",".join(cols) if cols else None,
    ):
        frames = [
            ds.decode(t, columns=list(cols) if cols else None, predicate=pred)
            for t in ds.tasks()
        ]
        if len(frames) == 1:
            return frames[0]
        names = list(cols) if cols else frames[0].columns
        data = {
            n: np.concatenate([np.asarray(f.host_values(n)) for f in frames])
            for n in names
        }
        total = len(next(iter(data.values()))) if names else 0
        nb = max(1, min(len(frames), total or 1))
        return TensorFrame.from_dict(data, num_blocks=nb)


def _exec_map(node, ins, executor, device):
    from ..lazy import LazyFrame

    frame = ins[0]
    p = node.payload
    if p.get("kind") == "fused":
        lf = LazyFrame(
            frame,
            graph=p["graph"],
            sources=dict(p["sources"]),
            feed_map=dict(p["feed_map"]),
            stages=list(p["stages"]),
        )
        return lf.force(executor=executor, device=device)
    lf = frame.lazy()
    for st in p["stages"]:
        lf = lf.map_blocks(
            st["graph"],
            feed_dict=dict(st["feed_dict"]) if st.get("feed_dict") else None,
            fetch_names=list(st["fetch_list"]),
        )
    return lf.force(executor=executor, device=device)


def _exec_filter(node, ins, executor, device):
    from ..frame import TensorFrame
    from ..utils import telemetry as _tele

    frame = ins[0]
    pred = node.payload["pred"]
    if _is_global(frame):
        from .. import globalframe as _gfm

        out = _gfm.filter_global(pred, frame, executor)
        if out is not None:
            return out
        frame = _localize(frame, "filter-ineligible")
    with _tele.span(
        "plan.filter", kind="stage", predicate=pred.describe(),
        rows=_frame_rows(frame),
    ):
        mask = np.asarray(
            pred.mask(lambda n: _host_values(frame, n)), dtype=bool
        )
        take = np.flatnonzero(mask)
        data = {n: _host_values(frame, n)[take] for n in frame.columns}
        nb = max(1, min(frame.num_blocks, len(take) or 1))
        return TensorFrame.from_dict(data, num_blocks=nb)


def _exec_select(node, ins, executor, device):
    return ins[0].select(list(node.payload["columns"]))


def _exec_sort(node, ins, executor, device):
    from ..frame import TensorFrame
    from ..utils import telemetry as _tele

    frame = _localize(ins[0], "sort-global")
    keys = node.payload["keys"]
    with _tele.span(
        "plan.sort", kind="stage", keys=",".join(keys),
        rows=_frame_rows(frame),
    ):
        arrays = [np.asarray(_host_values(frame, k)) for k in keys]
        order = np.lexsort(tuple(reversed(arrays)))
        if node.payload.get("descending"):
            order = order[::-1]
        data = {n: _host_values(frame, n)[order] for n in frame.columns}
        return TensorFrame.from_dict(
            data, num_blocks=max(1, frame.num_blocks)
        )


def _exec_groupby(node, ins, executor, device):
    from .. import api as _api
    from ..utils import telemetry as _tele

    frame = ins[0]
    keys = list(node.payload["keys"])
    specs = node.payload["specs"]
    with _tele.span(
        "plan.groupby", kind="stage", keys=",".join(keys),
        aggs=len(specs),
    ):
        # sum/mean/min/max all classify as segment combiners: the
        # segment-aggregate plan runs over the whole frame
        grouped = _api.GroupedFrame(frame, keys)
        fetches, feed = _api._agg_spec_exprs(grouped.frame, specs)
        return _api.aggregate(
            fetches, grouped, feed_dict=feed, executor=executor, device=device
        )


def _exec_join(node, ins, executor, device):
    from ..frame import TensorFrame
    from ..utils import telemetry as _tele

    left = _localize(ins[0], "join-global")
    right = _localize(ins[1], "join-global")
    on = list(node.payload["on"])
    with _tele.span(
        "plan.join", kind="stage", on=",".join(on),
        left_rows=_frame_rows(left), right_rows=_frame_rows(right),
    ):
        import pandas as pd

        ldf = pd.DataFrame({k: np.asarray(_host_values(left, k)) for k in on})
        ldf["__tfs_li"] = np.arange(len(ldf), dtype=np.int64)
        rdf = pd.DataFrame({k: np.asarray(_host_values(right, k)) for k in on})
        rdf["__tfs_ri"] = np.arange(len(rdf), dtype=np.int64)
        merged = pd.merge(ldf, rdf, on=on, how="inner")
        li = merged["__tfs_li"].to_numpy()
        ri = merged["__tfs_ri"].to_numpy()
        data: Dict[str, np.ndarray] = {}
        for n in left.columns:
            data[n] = np.asarray(_host_values(left, n))[li]
        for n in right.columns:
            if n in on:
                continue
            out_name = n if n not in data else f"{n}_right"
            data[out_name] = np.asarray(_host_values(right, n))[ri]
        return TensorFrame.from_dict(data, num_blocks=1)


_EXEC = {
    "source": _exec_source,
    "scan": _exec_scan,
    "map": _exec_map,
    "filter": _exec_filter,
    "select": _exec_select,
    "sort": _exec_sort,
    "groupby": _exec_groupby,
    "join": _exec_join,
}


# ---------------------------------------------------------------------------
# rendering (explain — never executes)
# ---------------------------------------------------------------------------


def render(root: PlanNode, annotate: Optional[Callable[[PlanNode], str]] = None) -> str:
    """Indented DAG text. Shared subplans print once and are referenced
    by their node number afterwards."""
    lines: List[str] = []
    numbered: Dict[int, int] = {}

    def rec(node: PlanNode, depth: int) -> None:
        pad = "  " * depth
        if id(node) in numbered:
            lines.append(f"{pad}#{numbered[id(node)]} (shared, see above)")
            return
        num = len(numbered) + 1
        numbered[id(node)] = num
        extra = f"  [{annotate(node)}]" if annotate is not None else ""
        lines.append(f"{pad}#{num} {node.describe()}{extra}")
        for i in node.inputs:
            rec(i, depth + 1)

    rec(root, 0)
    return "\n".join(lines)
