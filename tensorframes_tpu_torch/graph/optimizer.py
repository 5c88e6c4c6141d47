"""Cost-based rewrite optimizer for the relational plan DAG.

A copy of `tensorframes_tpu/graph/optimizer.py`. Five rewrite rules run to
a bounded fixpoint over `plan.PlanNode` DAGs — dedup (common subplans
collapse to one shared node), filter reordering below maps, predicate
pushdown into the ingest scan (decode fewer rows, not mask more), column
pruning end-to-end into the scan column set, and fusion of adjacent
expression-map stages (the merged node splices into ONE lowered callable
per block at execution, across the relational boundary the filter used to
sit on).

Every structural rewrite is **priced, not assumed**: the whole-plan cost
(modeled bytes over a per-op-class throughput, plus a fixed per-node
dispatch overhead) is computed for the old and the candidate root, and the
rewrite is kept only when the candidate is strictly cheaper. Rejected
rewrites are recorded too — `explain` shows the decision with both prices,
and `plan.state()["rejected"]` counts them — so a rewrite priced as a
regression (e.g. pushing a non-selective predicate into the scan) is
visibly declined rather than silently applied.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

from . import plan as _plan
from .plan import PlanNode, map_feeds, map_outputs

__all__ = ["optimize", "Estimator"]

# Fixed modeled cost per plan node: dispatch/bookkeeping overhead that
# makes "fewer nodes doing the same bytes" (dedup, map fusion) strictly
# cheaper. Dwarfed by any real data movement.
_NODE_OVERHEAD_S = 5e-4
# Throughput when the cost ledger has no calibrated figure yet (the JAX
# package's cold-start value): roughly host-memory bandwidth order,
# bytes/second.
_DEFAULT_BYTES_PER_S = 2.0e9
_COL_BYTES = 8.0  # double-precision column element (x64 default)
_UNKNOWN_ROWS = 1_000_000
_UNKNOWN_COLS = 8


class Estimator:
    """Whole-plan cost in modeled seconds.

    Rows propagate through the DAG (filter/scan predicates scale by the
    verb's selectivity hint or ``config.plan_selectivity_default``);
    bytes = rows x live columns x 8; seconds = bytes / the
    residuals-corrected throughput of the node's op class (`throughput`).
    """

    def __init__(self, executor=None):
        self._thr: Dict[str, float] = {}
        self._est: Dict[int, Tuple[float, float]] = {}
        from .. import config as _config

        self._default_sel = float(_config.get().plan_selectivity_default)

    # -- throughput -----------------------------------------------------
    def throughput(self, op_class: str) -> float:
        """Bytes/second for ``op_class``: the residuals-corrected figure
        of the cost ledger (`costmodel.planner_throughput`), else the
        cold-start default."""
        v = self._thr.get(op_class)
        if v is None:
            try:
                from ..runtime import costmodel as _cm

                v = _cm.planner_throughput(op_class)
            except Exception:
                v = None
            if not v or not math.isfinite(v) or v <= 0:
                v = _DEFAULT_BYTES_PER_S
            self._thr[op_class] = v
        return v

    # -- (rows, cols) propagation --------------------------------------
    def shape(self, node: PlanNode) -> Tuple[float, float]:
        got = self._est.get(id(node))
        if got is not None:
            return got
        rows, cols = self._shape(node)
        self._est[id(node)] = (rows, cols)
        return rows, cols

    def _sel(self, hint: Optional[float]) -> float:
        s = self._default_sel if hint is None else float(hint)
        return min(max(s, 0.0), 1.0)

    def _shape(self, node: PlanNode) -> Tuple[float, float]:
        p = node.payload
        if node.op == "source":
            frame = p["frame"]
            try:
                rows = float(_plan._frame_rows(frame))
                cols = float(len(frame.columns))
            except Exception:
                rows, cols = float(_UNKNOWN_ROWS), float(_UNKNOWN_COLS)
            return rows, cols
        if node.op == "scan":
            rows = self._scan_rows(node)
            cols = float(len(p["columns"])) if p.get("columns") else float(
                _UNKNOWN_COLS
            )
            pred = p.get("predicate")
            if pred is not None:
                rows *= self._sel(p.get("selectivity"))
            return rows, cols
        rows, cols = self.shape(node.inputs[0]) if node.inputs else (
            float(_UNKNOWN_ROWS), float(_UNKNOWN_COLS)
        )
        if node.op == "filter":
            return rows * self._sel(p.get("selectivity")), cols
        if node.op == "select":
            return rows, float(len(p["columns"]))
        if node.op == "map":
            return rows, cols + len(map_outputs(p))
        if node.op == "sort":
            return rows, cols
        if node.op == "groupby":
            return max(1.0, math.sqrt(rows)), float(
                len(p["keys"]) + len(p["specs"])
            )
        if node.op == "join":
            rrows, rcols = self.shape(node.inputs[1])
            return max(rows, rrows), cols + rcols - len(p["on"])
        return rows, cols

    def _scan_rows(self, node: PlanNode) -> float:
        cached = node.payload.get("_est_rows")
        if cached is not None:
            return float(cached)
        rows = 0
        known = False
        try:
            for t in node.payload["dataset"].tasks():
                if t.rows is not None and t.rows >= 0:
                    rows += int(t.rows)
                    known = True
        except Exception:
            known = False
        total = float(rows) if known else float(_UNKNOWN_ROWS)
        node.payload["_est_rows"] = total
        return total

    # -- per-node / whole-plan seconds ---------------------------------
    def node_cost(self, node: PlanNode) -> float:
        p = node.payload
        rows_out, cols_out = self.shape(node)
        if node.op == "source":
            return _NODE_OVERHEAD_S
        if node.op == "scan":
            base = self._scan_rows(node)
            pred = p.get("predicate")
            thr = self.throughput("relational")
            cost = base * cols_out * _COL_BYTES / thr  # decode
            if pred is not None:
                # decode-side predicate: evaluate over every candidate
                # row's predicate columns, then RE-materialize only the
                # survivors at the arrow boundary. Statically we do not
                # assume row-group stats will skip anything — so a
                # non-selective pushdown prices as a regression and is
                # rejected, while any sel<1 predicate wins by exactly
                # the avoided re-materialization + downstream rows.
                cost += base * len(pred.columns()) * _COL_BYTES / thr
                cost += rows_out * cols_out * _COL_BYTES / thr
                # the arrow-boundary mask+filter is one extra kernel
                # pass — billed the same fixed overhead as any plan
                # node, so absorbing a filter is never free: at sel=1
                # pushdown prices exactly even and is rejected
                cost += _NODE_OVERHEAD_S
            return cost + _NODE_OVERHEAD_S
        rows_in, cols_in = (
            self.shape(node.inputs[0]) if node.inputs else (0.0, 0.0)
        )
        if node.op == "filter":
            pred = p["pred"]
            thr = self.throughput("relational")
            return (
                rows_in * (len(pred.columns()) + cols_in) * _COL_BYTES / thr
                + _NODE_OVERHEAD_S
            )
        if node.op == "select":
            return _NODE_OVERHEAD_S
        if node.op == "map":
            touched = len(map_feeds(p)) + len(map_outputs(p))
            thr = self.throughput("map")
            return rows_in * touched * _COL_BYTES / thr + _NODE_OVERHEAD_S
        if node.op == "sort":
            thr = self.throughput("relational")
            lg = math.log2(max(rows_in, 2.0))
            return rows_in * lg * len(p["keys"]) * _COL_BYTES / thr + _NODE_OVERHEAD_S
        if node.op == "groupby":
            touched = len(p["keys"]) + len(p["specs"])
            thr = self.throughput("reduce")
            return rows_in * touched * _COL_BYTES / thr + _NODE_OVERHEAD_S
        if node.op == "join":
            rrows, rcols = self.shape(node.inputs[1])
            thr = self.throughput("relational")
            return (
                (rows_in * cols_in + rrows * rcols) * _COL_BYTES / thr
                + _NODE_OVERHEAD_S
            )
        return _NODE_OVERHEAD_S

    def plan_cost(self, root: PlanNode) -> float:
        """Sum of node costs over UNIQUE reachable nodes (a shared
        subplan executes — and is billed — once)."""
        seen: Dict[int, bool] = {}
        total = 0.0

        def rec(node: PlanNode) -> None:
            nonlocal total
            if id(node) in seen:
                return
            seen[id(node)] = True
            total += self.node_cost(node)
            for i in node.inputs:
                rec(i)

        rec(root)
        return total


# ---------------------------------------------------------------------------
# structural rewrites (cost gate applied by optimize())
# ---------------------------------------------------------------------------


def _rebuild(root: PlanNode, fn) -> Tuple[PlanNode, List[str]]:
    """Bottom-up rebuild: ``fn(node, new_inputs)`` returns a replacement
    node (pattern matched) or None (keep). Shared nodes rebuild once so
    DAG sharing survives."""
    memo: Dict[int, PlanNode] = {}
    notes: List[str] = []

    def rec(node: PlanNode) -> PlanNode:
        got = memo.get(id(node))
        if got is not None:
            return got
        new_inputs = tuple(rec(i) for i in node.inputs)
        cand = fn(node, new_inputs, notes)
        if cand is None:
            cand = (
                node
                if new_inputs == node.inputs
                else PlanNode(node.op, new_inputs, node.payload)
            )
        memo[id(node)] = cand
        return cand

    return rec(root), notes


def _rule_dedup(root: PlanNode) -> Tuple[PlanNode, List[str]]:
    """Common-subplan dedup: structurally equal nodes over the same
    leaves collapse to ONE shared node (executes once)."""
    canon: Dict[Any, PlanNode] = {}
    notes: List[str] = []
    memo: Dict[int, PlanNode] = {}

    def key(node: PlanNode, inputs: Tuple[PlanNode, ...]):
        leaf = None
        if node.op == "source":
            leaf = id(node.payload["frame"])
        elif node.op == "scan":
            leaf = id(node.payload["dataset"])
        return (node.op, node._payload_canonical(), leaf,
                tuple(id(i) for i in inputs))

    def rec(node: PlanNode) -> PlanNode:
        got = memo.get(id(node))
        if got is not None:
            return got
        new_inputs = tuple(rec(i) for i in node.inputs)
        cand = (
            node
            if new_inputs == node.inputs
            else PlanNode(node.op, new_inputs, node.payload)
        )
        k = key(cand, new_inputs)
        prior = canon.get(k)
        if prior is not None and prior is not cand:
            notes.append(f"dedup {cand.op}")
            cand = prior
        else:
            canon[k] = cand
        memo[id(node)] = cand
        return cand

    return rec(root), notes


def _rule_filter_below_map(root: PlanNode) -> Tuple[PlanNode, List[str]]:
    """filter(map(X)) -> map(filter(X)) when the predicate only reads
    columns that exist BELOW the map (not produced/shadowed by it):
    the map then touches only surviving rows."""

    def fn(node, ins, notes):
        if node.op != "filter" or not ins or ins[0].op != "map":
            return None
        m = ins[0]
        if len(m.inputs) != 1:
            return None
        pred = node.payload["pred"]
        if pred.columns() & map_outputs(m.payload):
            return None
        notes.append(f"filter ({pred.describe()}) below map")
        pushed = PlanNode("filter", (m.inputs[0],), node.payload)
        return PlanNode("map", (pushed,), m.payload)

    return _rebuild(root, fn)


def _rule_filter_into_scan(root: PlanNode) -> Tuple[PlanNode, List[str]]:
    """filter(scan(ds)) -> scan(ds, predicate): the decode pipeline
    skips whole row groups from footer stats and masks the rest at the
    arrow boundary — fewer rows DECODED, not more rows masked."""

    def fn(node, ins, notes):
        if node.op != "filter" or not ins or ins[0].op != "scan":
            return None
        s = ins[0]
        pred = node.payload["pred"]
        cols = s.payload.get("columns")
        if cols is not None and not pred.columns() <= set(cols):
            return None
        payload = dict(s.payload)
        prior = payload.get("predicate")
        payload["predicate"] = pred if prior is None else (prior & pred)
        sel = node.payload.get("selectivity")
        prior_sel = payload.get("selectivity")
        if sel is not None or prior_sel is not None:
            payload["selectivity"] = (
                (1.0 if sel is None else sel)
                * (1.0 if prior_sel is None else prior_sel)
            )
        notes.append(f"pushdown ({pred.describe()}) into scan")
        return PlanNode("scan", (), payload)

    return _rebuild(root, fn)


def _rule_prune_columns(root: PlanNode) -> Tuple[PlanNode, List[str]]:
    """Column pruning end-to-end into the scan column set. Demands
    propagate top-down (groupby demands exactly keys+agg inputs; select
    demands its list; map adds its feeds net of its outputs); a scan
    whose demanded set is narrower than what it decodes gets its
    ``columns`` payload narrowed."""
    # pass 1: accumulate per-node demand (None = all columns)
    demand: Dict[int, Optional[set]] = {}

    def merge(node: PlanNode, d: Optional[set]) -> None:
        if id(node) in demand:
            prior = demand[id(node)]
            demand[id(node)] = (
                None if prior is None or d is None else prior | d
            )
        else:
            demand[id(node)] = None if d is None else set(d)

    def walk(node: PlanNode, d: Optional[set]) -> None:
        merge(node, d)
        d = demand[id(node)]
        p = node.payload
        if node.op == "select":
            walk(node.inputs[0], set(p["columns"]))
        elif node.op == "filter":
            walk(
                node.inputs[0],
                None if d is None else d | p["pred"].columns(),
            )
        elif node.op == "sort":
            walk(node.inputs[0], None if d is None else d | set(p["keys"]))
        elif node.op == "map":
            if d is None:
                walk(node.inputs[0], None)
            else:
                walk(
                    node.inputs[0],
                    (d - map_outputs(p)) | map_feeds(p),
                )
        elif node.op == "groupby":
            need = set(p["keys"]) | {c for (_, c) in p["specs"].values()}
            walk(node.inputs[0], need)
        elif node.op == "join":
            # splitting demand per side needs schemas; stay safe
            for i in node.inputs:
                walk(i, None)
        else:
            for i in node.inputs:
                walk(i, None)

    walk(root, None)

    notes: List[str] = []

    def fn(node, ins, nts):
        if node.op != "scan":
            return None
        d = demand.get(id(node))
        if d is None:
            return None
        cur = node.payload.get("columns")
        want = tuple(sorted(d))
        if cur is not None and not (set(want) < set(cur)):
            return None  # nothing to narrow (or demand exceeds schema)
        payload = dict(node.payload)
        payload["columns"] = want
        nts.append(f"prune scan columns -> {list(want)}")
        return PlanNode("scan", (), payload)

    return _rebuild(root, fn)


def _rule_fuse_maps(root: PlanNode) -> Tuple[PlanNode, List[str]]:
    """map(map(X)) with expression stages merges into one node; at
    execution the merged stage list splices into ONE fused callable
    (fusion across the relational boundary the filter vacated)."""

    def fn(node, ins, notes):
        if node.op != "map" or node.payload.get("kind") == "fused":
            return None
        if not ins or ins[0].op != "map" or ins[0].payload.get("kind") == "fused":
            return None
        inner = ins[0]
        payload = {
            "kind": "exprs",
            "stages": list(inner.payload["stages"]) + list(node.payload["stages"]),
        }
        notes.append(
            f"fuse {len(inner.payload['stages'])}+{len(node.payload['stages'])}"
            " map stage(s)"
        )
        return PlanNode("map", inner.inputs, payload)

    return _rebuild(root, fn)


_RULES = (
    ("dedup", _rule_dedup),
    ("filter_below_map", _rule_filter_below_map),
    ("pushdown_into_scan", _rule_filter_into_scan),
    ("prune_columns", _rule_prune_columns),
    ("fuse_maps", _rule_fuse_maps),
)

_MAX_PASSES = 8


def optimize(root: PlanNode, executor=None) -> Tuple[PlanNode, List[Dict]]:
    """Rewrite ``root`` to a bounded fixpoint; every structural rewrite
    is kept only when the priced whole-plan cost strictly drops.
    Returns (new root, decision records) — decisions include rejected
    rewrites so `explain` can show why a plan was NOT changed. Runs
    under a ``plan.optimize`` stage span."""
    from ..utils import telemetry as _tele

    decisions: List[Dict] = []
    with _tele.span("plan.optimize", kind="stage"):
        _plan._note_optimize()
        est = Estimator(executor)
        cur = root
        for _ in range(_MAX_PASSES):
            changed = False
            for rule_name, rule in _RULES:
                cand, notes = rule(cur)
                if cand is cur or not notes:
                    continue
                before = est.plan_cost(cur)
                after = est.plan_cost(cand)
                accepted = after < before * (1.0 - 1e-9)
                decisions.append({
                    "rule": rule_name,
                    "accepted": accepted,
                    "cost_before_s": before,
                    "cost_after_s": after,
                    "detail": "; ".join(notes),
                })
                _plan.note_rewrite(rule_name, accepted)
                if accepted:
                    cur = cand
                    changed = True
            if not changed:
                break
    return cur, decisions
