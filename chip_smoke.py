#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`tensorframes_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, then
drives every ported path once at full width through the entry points a user
calls, and checks each result. It times nothing: the port's speed is the
benchmark's (`portbench/`), and each kernel is held against its plain
version by the ``card`` tests (README, "On the card").

1. the card's name and power limit, and the kernel build;
2. (each kernel against its plain version: the ``card`` tests);
3. the graph verbs at `bench.py`'s data size: `map_blocks` of x+3 exact and
   `reduce_blocks` sum / min over 200,000,000 float32 rows in 8 blocks
   against numpy; then `reduce_rows` over the same column through its
   monoid plan (sum, min), and a non-associative fold (0.5 x_1 + x_2,
   20,000 rows in 8 blocks) through its general plan against a float64
   fold in the same order;
4. `map_rows` of `models.MLP`'s 512-512-512-10 scoring graph over 1,000,000
   rows, and the same weights through the function front end (`map_rows`
   of a plain function with the weights bound), both against a float64
   forward and each other;
5. keyed `aggregate`: BASELINE config 4 (mean and variance of 100,000,000
   rows x 8 float32 values over 16 int64 keys) through the segment plan,
   one keyed-sums launch a call and the keys factorized on the card, the
   keyed-sums kernel against its plain version and float64 and the key
   factorization kernel bit for bit against ``torch.unique`` on the same
   tensors; a Div-rooted graph over 1,000,000 rows and 1,000 keys of
   uneven size through the exact plan; then a ``reduce_sum(x * 2)`` +
   ``reduce_max(x)`` graph over 1,000,000 x 8 float32 rows in 1,000 groups
   of all-distinct sizes with the segment plan off: the chunk plan (one
   vmapped call a power-of-two chunk size) and the exact plan (one a
   distinct size), the calls counted;
6. `models.kmeans` at the k-means demo's widths (dim 100, k 10, 10
   iterations) over 10,000,000 float32 rows in 8 blocks, one iteration
   held against a numpy float64 Lloyd step;
7. `TransformerLM` scoring through `map_blocks` with a plain function, its
   logits against the model on the plain attention;
8. BASELINE config 5: `models.InceptionLite` at Inception-v3's stem widths
   (299x299, 32/64 channels, 1000 classes) as GraphDef bytes, scoring 2,048
   random images in 8 blocks through `map_blocks`, the first 16 held
   against the port's CPU run of the same bytes;
9. imported TF control flow from the committed fixtures
   (`tests/fixtures/torch_port/`): the branchy per-row graph as v1 rings and
   v2 ``If``/``While`` and the cond + product loop through `map_rows`'
   lifted plan over 10,000,000 rows in 8 blocks, exact against numpy; then
   a block-level graph with a scalar cond and a scalar loop through
   `map_blocks`, with the host syncs counted; then two per-row v1 conds
   that do not lift (a `Sum` predicate over a float32[3] cell, and branches
   that call `Fill`), each with a bound placeholder, through `map_rows`'
   vmap plan (one call per block) over 10,000,000 rows, exact against
   numpy, and the first through the per-row plan over 2,000 rows; the
   same for a per-row v1 loop that does not lift (``v = 2 v + w`` while
   ``sum(v * v) < 10000`` over float32[3] cells, ``w`` bound: one batched
   loop a block, one host read a trip); and the exact `aggregate` plan over
   a per-group v1 cond (1,000,000 rows, 1,000 keys), one call a group size;
10. variable freezing: a ``VariableV2`` and a ``VarHandleOp`` graph as TF
    wrote them, through `map_blocks` over phase 3's column, exact;
11. frame breadth: ragged `map_rows` over 1,000,000 float32 rows of 1-64
    values (64 shape buckets), `pad_ragged` and a masked sum, a
    string-keyed aggregate at config 4's widths (10,000,000 x 8 float32,
    1,000 string ids; pandas' factorization and the dict pass giving the
    same codes), a bytes pass-through over 10,000,000 rows, and the
    function front end on all-empty frames;
12. out-of-core streaming: `reduce_blocks_stream` of the README vector
    `reduce_sum` (with a `reduce_min`) as GraphDef bytes over the north
    star's 1,000,000,000 float32 rows in chunks of 128,000,000
    (`examples/billion_row_reduce.py`) against float64, its peak device
    memory within (prefetch depth + 3) chunks, after one chunk through the
    transfer stage unchanged; the same stream over 256,000,000 rows with
    the ingest pipeline on and off; 16 Parquet and 16 Arrow IPC shards
    (4,000,000 rows of ``x`` float32 and ``v`` float32[8], uneven row
    groups, one empty shard) through `stream_dataset`; that stream made
    durable, cut by a deadline of half its uninterrupted time and resumed
    in a fresh process; and a slow stream's deadline, after which no
    pipeline thread may live;
13. lazy plans and the Spark bridge: `benchmarks/fusion_bench.py`'s three
    maps + `reduce_sum` over phase 3's 200,000,000 float32 rows in 8 blocks,
    fused (`df.lazy()`) equal to eager, with the lowered programs, the block
    calls and a second fused run's cache misses counted; the same maps over
    a host-resident base through `force()` with the plan-prep pipeline off
    and on, equal bit for bit; `benchmarks/relational_bench.py`'s plan
    (`scan -> filter(x > its 95th percentile) -> map_blocks(x*0.5+1) ->
    group_by(y).agg(sum, max)`) over 16 Parquet shards x 8 row groups x
    500,000 float64 rows with the optimizer on and off, the rows each way
    decoded; a `sort_by` of 10,000,000 device rows and an inner join of
    10,000,000 x 1,000 keys with their device-to-host bytes; and
    `spark.reduce_blocks` / `map_blocks` / `aggregate` over a duck-typed
    Spark DataFrame of 16 partitions x 2,000,000 rows (``k`` int64 of 16
    keys, ``x0``..``x7`` float64); and a second `force()` of the three maps
    over a 20,000,000-row host base served by the materialization cache
    (no block dispatch, equal to the first force);
14. training and the expert FFN: `TransformerLM` at phase 7's widths
    trained by SGD (lr 0.1, `benchmarks/train_bench.py`'s) on 8 x 2,048
    tokens through the plain attention `full_attention`, six steps, step
    1's loss and four gradients held against float64 on the card, the loss
    falling; `flash_attention` refusing a gradient; a `save_params` /
    `load_params` round trip that scores the same; the MLP (512-512-512-10)
    trained by Adam through `make_train_step` on 65,536 rows of a column
    `map_blocks` produced, eleven steps, step 1 against float64;
    `MoEFFN.apply` at Mixtral-8x7B's published widths (hidden 4096,
    intermediate 14336, 8 experts, top 2) over 4,096 float32 tokens, its
    first 256 tokens against float64 with the same routing;
15. the serving runtime, through `ServingClient` over loopback HTTP:
    (a) `benchmarks/serving_bench.py`'s elementwise endpoint at its sizes
    (48 requests of 2,041-2,047 rows, 8 clients, ``max_batch_rows``
    16,384), serially and concurrently, every response bit-identical to a
    direct `map_blocks`, the requests coalesced and no new lowering after
    `warm()`; (b) the 512-512-512-10 MLP endpoint (BASELINE config 3, not
    batchable, so inline) with 8 clients x 16 requests of 2,048 rows
    against a direct `map_blocks`; (c) a 429 with ``Retry-After`` and a 504
    under an injected hang, the /metrics, /healthz and /trace scrapes, and
    `drain()` freeing the port. No request may take over 5 s (a stalled
    connect);
16. runtime services: the autotuner over the live profile phase 15 left
    (the same recommendations twice; a knob pinned through `update()` that
    `apply` leaves alone); the cost ledger over phase 3's x+3 map (200M
    rows, 8 blocks) and phase 4's MLP ``map_rows`` (graph route), with
    every cached program's flops, bytes and footprint, and the MLP's flops
    and the map's bytes against their hand counts; ``/diagnostics`` and
    ``/profile``; a genuine ``torch.cuda.OutOfMemoryError`` under
    ``set_per_process_memory_fraction`` that `map_blocks` and
    `reduce_blocks` survive by splitting the block; and the numerics guard
    (one host sync a block, ``x / 0.0`` raising);
17. the mesh verbs on ``parallel.data_mesh()`` (every visible card):
    phase 3's x+3 `map_blocks`, `reduce_blocks` sum / min and the
    `reduce_rows` sum over 200,000,000 float32 rows, phase 4's MLP
    `map_rows` over 1,000,000 rows, a keyed sum over 100,000,000 x 8
    float32 rows and 16 keys and phase 5's mean / mean-of-squares graph,
    both through per-shard segment tables combined by monoid, each against the
    local verb on the same data, with the mesh's dispatch spans;
18. the block scheduler, failover and `GlobalFrame` on every visible
    card: phase 3's x+3 `map_blocks`, `reduce_blocks` sum / min and the
    `reduce_rows` sum over 200,000,000 float32 rows in 8 blocks, phase 4's
    MLP `map_rows` over 1,000,000 rows and an exact-plan keyed sum over
    1,000,000 rows and 1,000 keys, each with ``devices=[0, ...]`` under
    ``block_scheduler="on"`` against the local verb (every dispatch span
    labelled with its card, the per-card dispatch ledger summing to the
    items); a transient fault injected on cuda:0 (one card: retried in
    place, nothing evicted; several: the block moves, one eviction,
    /healthz ``degraded``, one ``eviction`` incident bundle); `to_global()`
    of the 200,000,000 rows, x+3 -> x*2 -> `reduce_sum` with the outputs
    left on their shards, the ``"global"`` auto-route, a `LazyFrame.force`
    and `filter_global` on the shards, and a stream of 4 x 128,000,000
    rows through the double-buffered accumulator; on two or more cards,
    after phase 7, a ``devices=`` `TransformerLM` scoring of 16 sequences,
    its kernel launches counted apart from the main path's;
19. the sequence, pipeline, expert and 3-D parallel paths, after the main
    path's launches are read (their launches counted apart), every mesh a
    set of slots on cuda:0 (and again over every card where there are
    two or more): the kernel's log-sum-exp entry against its plain version
    at the LM's shape (causal and not) and at head_dim 128, and equal to
    the entry without it; in bf16 and fp16 at the LM's shape on the
    tensor-core kernels, within one unit in the dtype's last place; phase 7's `TransformerLM` scoring 8 sequences
    through `apply(mesh=)` on a 4-slot ``data`` mesh (the ring: n_layers x
    10 launches of that entry) against `apply`;
    `ring_attention_reference`'s gradients on one head of the LM's shape
    against float64; `seq_all_to_all` of (2048, 8, 64) over 4 slots and
    back, exact; `pipeline_apply` of 4 linear + ReLU stages (d 2048, batch
    8,192, 8 microbatches); `MoEFFN.apply_ep` at phase 14's Mixtral widths
    over 8 ``model`` slots; the 512-512-512-10 MLP's sharded step on a 2 x 2
    mesh; and `TransformerLM.sharded_train_step_3d` at
    `benchmarks/train_bench.py`'s widths on a 2 x 2 x 2 mesh, every
    parameter against the single-card step;
20. multi-process execution (`parallel.multihost`), after phase 18: one
    rank a card (``torch.cuda.device_count()`` processes started with the
    torchrun environment, NCCL, never a gloo fallback), each owning 1/N of
    phase 17's 200,000,000 float32 rows (x+3 `map_blocks`, `reduce_blocks`
    sum and min over a `SpanningFrame`), of 100,000,000 x 8 float32 rows
    through `aggregate_global` (sum and mean) with 16 int64 keys and again
    with 16 string keys, and of 1,000,000 ragged rows through
    `analyze_global`; every rank's results held to numpy float64 and, at
    one rank, to the single-process ``mesh=data_mesh()`` verbs; any rank's
    failure or timeout (300 s) fails the run;
21. after phase 19, phase 7's scoring route and widths with 2, 1 and 16
    heads (head_dim 128, 256 and 15; d_model 240 for the last) and phase
    19's ``mesh=`` ring at head_dim 15 and 256, each against the plain
    attention, their launches counted apart from the main path's;
22. one JSON line listing every kernel with its source, its launches on
    the main path (phases 3-18 and 20) and their routes, the errors of
    phase 19's checks and the ring's launches, and phase 21's launches;
23. as the last line, ``{"ok": true, "device": {...}}``.

Phases 3-17 run with ``block_scheduler="off"``: they run on one card.
Phases 8-18 and 20 run after phase 6 and before phase 7. Phases 3-6, 8-18
and 20 run no attention kernel (their ops are ATen, cuBLAS and cuDNN
calls, the keyed-sums and key factorization kernels, host numpy, the
stream's copies and NCCL; phase 14 trains through the plain attention;
phases 15-18 run graphs of elementwise ops and products), so the script
checks that the attention kernel's count is still 0 after them (phase
20's ranks report their own counts) and counts its launches in phase 7
alone. Phase 15 needs pyarrow (the serving wire format is Arrow IPC).
Phase 12 imports pyarrow for its dataset and durable parts, and prints
them as skipped where pyarrow is missing; phase 13 needs pyarrow and
pandas and fails without them.

Every check raises on failure, so the script exits non-zero and prints no
result line. Without a CUDA device it exits non-zero at once. It imports
nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# Kernel vs plain version, both float32 with TF32 off: the kernel sums each
# row's scores tile by tile with an online softmax, the plain version in one
# softmax over the full row, so the two differ only by rounding order.
_ATTN_RTOL, _ATTN_ATOL = 1e-4, 1e-5
# float32 partial sums on the card against numpy's float64 sum
_SUM_RTOL = 1e-5
# float32 products of depth 512 (TF32 off) against a float64 numpy forward
_MLP_RTOL, _MLP_ATOL = 1e-4, 1e-6
# logits of the kernel's model against the plain version's model: the
# attention differences above carried through 4 layers
_LOGIT_RTOL, _LOGIT_ATOL = 1e-4, 1e-5
# reduce_rows' general plan folds 0.5 * carry + row in float32: one
# rounding per step, halved by every later step, so the float32 fold stays
# within a few ulps of a float64 fold of the same float32 inputs
_FOLD_RTOL = 1e-6
# k-means centres (coordinates of order 1-20): float32 sums of ~10^6
# points per centre against a float64 Lloyd step
_KMEANS_RTOL, _KMEANS_ATOL = 1e-4, 1e-3
# Inception probabilities on the card against the port's CPU run of the same
# bytes: float32 convolutions (TF32 off) summed in another order by cuDNN's
# and ATen's CPU algorithms, through 18 convolutions and a softmax
_INCEPTION_RTOL, _INCEPTION_ATOL = 1e-4, 1e-6

_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures", "torch_port")

SEED = 0


def _emit(phase: str, **numbers) -> None:
    print(json.dumps({"phase": phase, **numbers}), flush=True)


def _check_close(what: str, got: torch.Tensor, want: torch.Tensor, rtol, atol) -> float:
    """Max abs error; raises when any element is outside atol + rtol*|want|."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(
            f"{what}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}"
        )
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    diff = (got - want).abs()
    bad = diff > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements outside rtol={rtol} atol={atol}, "
            f"max abs err {float(diff.max()):.3e}"
        )
    return float(diff.max())


def _plan_ran(what: str, key: str, *also: str) -> None:
    """Raise unless the verb call since the last `reset_stats` took exactly
    the plan ``key``, and the steps ``also`` once each (the port's plan
    counters)."""
    from tensorframes_tpu_torch.utils.profiling import stats

    want = dict.fromkeys((key, *also), 1.0)
    if stats() != want:
        raise AssertionError(f"{what}: expected {want}, counters say {stats()}")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_card_and_build() -> None:
    """The card's name and power limit, then every kernel library built from
    this checkout's sources."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)

    from tensorframes_tpu_torch.ops import _cuda_build

    _emit("build", libraries=sorted(_cuda_build.build_all()))


def phase_graph_verbs(tft):
    n, blocks = 200_000_000, 8
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.rand(n, device="cuda", generator=gen)  # float32
    df = tft.TensorFrame([tft.Column("x", x)]).repartition(blocks)

    z = (tft.block(df, "x") + 3.0).named("z")
    out = tft.map_blocks(z, df)
    zt = out.column("z").values
    if zt.dtype != torch.float32 or not torch.equal(zt, x + 3.0):
        raise AssertionError("map_blocks x+3 disagrees with x + 3")
    del out, zt

    s = tft.dsl.reduce_sum(tft.block(df, "x", tf_name="x_input")).named("x")
    mn = tft.dsl.reduce_min(tft.block(df, "x", tf_name="x_input")).named("x")
    got_sum = tft.reduce_blocks(s, df)
    got_min = tft.reduce_blocks(mn, df)

    xh = x.cpu().numpy()
    want_sum, want_min = float(xh.sum(dtype=np.float64)), xh.min()
    if got_min.dtype != torch.float32 or got_min.item() != want_min:
        raise AssertionError(f"reduce_min {got_min.item()} != numpy {want_min}")
    sum_rel = abs(got_sum.item() - want_sum) / abs(want_sum)
    if got_sum.dtype != torch.float32 or sum_rel > _SUM_RTOL:
        raise AssertionError(f"reduce_sum rel err {sum_rel:.3e} > {_SUM_RTOL}")
    _emit("graph_verbs", rows=n, blocks=blocks, reduce_sum_rel_err=sum_rel, sum_rtol=_SUM_RTOL)
    phase_reduce_rows(tft, df, want_sum, want_min)
    return df


def _pair_graph(tft, combine):
    """``x = combine(x_1, x_2)`` over float32 scalars: a reduce_rows fold."""
    f32, scalar = tft.ScalarType.float32, tft.Shape(())
    x1 = tft.dsl.placeholder(f32, scalar, name="x_1")
    x2 = tft.dsl.placeholder(f32, scalar, name="x_2")
    return combine(x1, x2).named("x")


def phase_reduce_rows(tft, df, want_sum: float, want_min, fold_rows: int = 20_000,
                      fold_blocks: int = 8) -> None:
    """The monoid plan over phase 3's column (sum, min), then the general
    plan on a non-associative fold against a float64 fold in the same
    order: rows left to right in each block, then the block partials."""
    from tensorframes_tpu_torch.utils.profiling import reset_stats

    n = df.nrows
    out = {}
    for name, combine in (
        ("sum", tft.dsl.add),
        ("min", lambda a, b: tft.dsl._nary("Minimum", [a, b])),
    ):
        g = _pair_graph(tft, combine)
        tft.reduce_rows(g, df)  # lowers once
        reset_stats()
        out[name] = tft.reduce_rows(g, df)
        _plan_ran(f"reduce_rows {name}", "reduce_rows.plan.monoid")
    got_min = out["min"]
    if got_min.dtype != torch.float32 or got_min.item() != want_min:
        raise AssertionError(f"reduce_rows min {got_min.item()} != numpy {want_min}")
    got_sum = out["sum"]
    sum_rel = abs(got_sum.item() - want_sum) / abs(want_sum)
    if got_sum.dtype != torch.float32 or sum_rel > _SUM_RTOL:
        raise AssertionError(f"reduce_rows sum rel err {sum_rel:.3e} > {_SUM_RTOL}")

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    y = torch.rand(fold_rows, device="cuda", generator=gen)
    fdf = tft.TensorFrame([tft.Column("x", y)]).repartition(fold_blocks)
    g = _pair_graph(tft, lambda a, b: a * 0.5 + b)
    tft.reduce_rows(g, fdf)  # lowers once
    reset_stats()
    got_fold = tft.reduce_rows(g, fdf)
    _plan_ran("reduce_rows 0.5 x_1 + x_2", "reduce_rows.plan.general")

    yh = y.cpu().numpy().astype(np.float64).tolist()
    partials = []
    for lo, hi in zip(fdf.offsets, fdf.offsets[1:]):
        acc = yh[lo]
        for v in yh[lo + 1:hi]:
            acc = 0.5 * acc + v
        partials.append(acc)
    want_fold = partials[0]
    for p in partials[1:]:
        want_fold = 0.5 * want_fold + p
    fold_rel = abs(got_fold.item() - want_fold) / abs(want_fold)
    if got_fold.dtype != torch.float32 or fold_rel > _FOLD_RTOL:
        raise AssertionError(f"reduce_rows fold rel err {fold_rel:.3e} > {_FOLD_RTOL}")
    _emit(
        "reduce_rows", rows=n, blocks=df.num_blocks, monoid_sum_rel_err=sum_rel,
        sum_rtol=_SUM_RTOL, general_rows=fold_rows, general_blocks=fold_blocks,
        general_rel_err=fold_rel, general_rtol=_FOLD_RTOL,
    )


def phase_map_rows_mlp(tft) -> None:
    from tensorframes_tpu_torch.models import MLP

    rows, sizes = 1_000_000, [512, 512, 512, 10]
    rng = np.random.default_rng(SEED)
    params = [
        (
            (rng.standard_normal((a, b)) * math.sqrt(2.0 / a)).astype(np.float32),
            (rng.standard_normal(b) * 0.1).astype(np.float32),
        )
        for a, b in zip(sizes[:-1], sizes[1:])
    ]
    # the per-row scoring graph of BASELINE config 3
    probs = MLP.from_jax_params(params).scoring_graph("features", block=False)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    feats = torch.rand(rows, sizes[0], device="cuda", generator=gen)
    df = tft.TensorFrame([tft.Column("features", feats)])
    out = tft.map_rows(probs, df)
    got = out.column("probs").values
    if tuple(got.shape) != (rows, sizes[-1]) or not torch.isfinite(got).all():
        raise AssertionError(f"map_rows MLP: bad output {tuple(got.shape)}")

    # the same weights through the function front end, bound once per call
    bound = {f"{p}{i}": t for i, wb in enumerate(params) for p, t in zip("wb", wb)}

    def score(features, w0, b0, w1, b1, w2, b2):
        h = torch.relu(features @ w0 + b0)
        h = torch.relu(h @ w1 + b1)
        return {"probs": torch.softmax(h @ w2 + b2, dim=-1)}

    fn_out = tft.map_rows(score, df, bindings=bound)
    fn_got = fn_out.column("probs").values
    routes_err = _check_close("map_rows MLP graph vs function", fn_got, got, _MLP_RTOL, _MLP_ATOL)

    idx = np.concatenate([np.arange(1000), np.arange(rows - 1000, rows)])
    a = feats[torch.from_numpy(idx).cuda()].cpu().numpy().astype(np.float64)
    for i, (w, b) in enumerate(params):
        a = a @ w.astype(np.float64) + b
        if i < len(params) - 1:
            a = np.maximum(a, 0.0)
    a = np.exp(a - a.max(axis=1, keepdims=True))
    want = torch.from_numpy((a / a.sum(axis=1, keepdims=True)).astype(np.float32))
    sel = torch.from_numpy(idx).cuda()
    err = _check_close("map_rows MLP", got[sel].cpu(), want, _MLP_RTOL, _MLP_ATOL)
    fn_err = _check_close("map_rows MLP function", fn_got[sel].cpu(), want, _MLP_RTOL, _MLP_ATOL)
    _emit(
        "map_rows_mlp", rows=rows, sizes=sizes, checked_rows=len(idx), max_abs_err=err, function_max_abs_err=fn_err,
        graph_vs_function_max_abs_err=routes_err,
        tolerance={"rtol": _MLP_RTOL, "atol": _MLP_ATOL},
    )


def phase_aggregate(tft, rows: int = 100_000_000, dim: int = 8, nkeys: int = 16,
                    exact_rows: int = 1_000_000, exact_keys: int = 1000) -> dict:
    """BASELINE config 4 through the segment plan (one keyed-sums launch a
    call, on the column itself: the squares are taken as it loads), the
    keyed-sums kernel alone against its plain version and the
    key factorization kernel against ``torch.unique`` on the same card
    tensors, then a graph the segment plan refuses (its root is a Div)
    through the exact plan. Returns what the kernels line carries of the
    two kernels: ``(keyed sums, factorization)``."""
    from tensorframes_tpu_torch.ops import factorize_keys as fk
    from tensorframes_tpu_torch.ops import keyed_sums as ks
    from tensorframes_tpu_torch.utils.profiling import reset_stats

    dsl = tft.dsl
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    v = torch.rand(rows, dim, device="cuda", generator=gen)
    keys = torch.arange(rows, device="cuda") % nkeys
    df = tft.TensorFrame([tft.Column("k", keys), tft.Column("v", v)])
    m = dsl.reduce_mean(dsl.block(df, "v", tf_name="m_input"), axes=[0]).named("m")
    q = dsl.reduce_mean(dsl.square(dsl.block(df, "v", tf_name="q_input")), axes=[0]).named("q")
    feed = {"m_input": "v", "q_input": "v"}
    grouped = tft.group_by(df, "k")
    launched = ks.keyed_sums.launches
    tft.aggregate([m, q], grouped, feed_dict=feed)  # lowers once
    reset_stats()
    out = tft.aggregate([m, q], grouped, feed_dict=feed)
    _plan_ran("aggregate mean/variance", "aggregate.plan.segment", "aggregate.segment.fused",
              "factorize.kernel")
    segment_launches = ks.keyed_sums.launches - launched
    if segment_launches != 2:
        raise AssertionError(
            f"aggregate mean/variance: {segment_launches} keyed-sums launches in two "
            f"segment-plan calls, expected one a call")
    got_k = out.host_values("k")
    got_m, got_q = out.host_values("m"), out.host_values("q")
    if got_m.dtype != np.float32 or got_m.shape != (nkeys, dim):
        raise AssertionError(f"aggregate mean: {got_m.dtype} {got_m.shape}")
    if not np.array_equal(got_k, np.arange(nkeys)):
        raise AssertionError(f"aggregate keys {got_k}")
    del out

    # the keyed-sums kernel and its plain version on the same card tensors,
    # in the launch the segment plan makes (one source, its identity and its
    # square): the same counts, means within 1e-6 of each other
    loads = [(0, "identity"), (0, "square")]
    (ks_s, ks_q), ks_counts = ks.keyed_sums([v], keys, nkeys, loads)
    (pl_s, pl_q), pl_counts = ks.keyed_sums_reference([v], keys, nkeys, loads)
    if not torch.equal(ks_counts, pl_counts):
        raise AssertionError("keyed_sums: the kernel's counts differ from the plain version's")
    per = ks_counts.double()[:, None]
    ks_plain_gap = max(float((a.double() / b.double() - 1).abs().max())
                       for a, b in ((ks_s, pl_s), (ks_q, pl_q)))
    if ks_plain_gap > 1e-6:
        raise AssertionError(f"keyed_sums: means {ks_plain_gap:.3e} from the plain version's")
    ks_means = [(t.double() / per).cpu().numpy() for t in (ks_s, ks_q)]
    ks_counts = ks_counts.cpu().numpy()
    del ks_s, ks_q, pl_s, pl_q, pl_counts

    # the key factorization kernel on the same keys against torch.unique,
    # the route it replaces: equal bit for bit
    got_f, want_f = fk.factorize(keys), fk.factorize_reference(keys)
    if got_f is None or not all(a.dtype == b.dtype and torch.equal(a, b)
                                for a, b in zip(got_f, want_f)):
        raise AssertionError("factorize_keys: the kernel's keys or inverse differ from torch.unique's")
    del got_f, want_f

    kh = keys.cpu().numpy()
    vh = v.cpu().numpy()
    del df, grouped, v, keys
    counts = np.bincount(kh, minlength=nkeys).astype(np.float64)
    want_m = np.empty((nkeys, dim))
    want_q = np.empty((nkeys, dim))
    for j in range(dim):
        col = vh[:, j].astype(np.float64)
        want_m[:, j] = np.bincount(kh, weights=col, minlength=nkeys) / counts
        want_q[:, j] = np.bincount(kh, weights=col * col, minlength=nkeys) / counts
    del kh, vh, col
    if not np.array_equal(ks_counts, counts):
        raise AssertionError("keyed_sums: the kernel's counts differ from numpy's")
    ks_err = max(float(np.abs(got / want - 1).max())
                 for got, want in zip(ks_means, (want_m, want_q)))
    if ks_err > 1e-6:
        raise AssertionError(f"keyed_sums: means {ks_err:.3e} from float64")
    mean_err = _check_close(
        "aggregate mean", torch.from_numpy(got_m.astype(np.float64)),
        torch.from_numpy(want_m), _SUM_RTOL, 0.0,
    )
    sq_err = _check_close(
        "aggregate mean of squares", torch.from_numpy(got_q.astype(np.float64)),
        torch.from_numpy(want_q), _SUM_RTOL, 0.0,
    )
    # variance = q - m^2: within rtol of q and m, it is within
    # rtol * (q + 2 m^2) of the float64 variance
    got_var = got_q.astype(np.float64) - got_m.astype(np.float64) ** 2
    var_err = _check_close(
        "aggregate variance", torch.from_numpy(got_var),
        torch.from_numpy(want_q - want_m**2), 0.0,
        torch.from_numpy(_SUM_RTOL * (want_q + 2 * want_m**2)),
    )

    # exact plan: Sum / Max per key, 1,000 keys of uneven size (key k
    # drawn with density falling as 1/sqrt(k))
    u = torch.rand(exact_rows, device="cuda", generator=gen)
    ek = (u * u * exact_keys).to(torch.int64)
    ev = torch.rand(exact_rows, device="cuda", generator=gen) + 0.5
    edf = tft.TensorFrame([tft.Column("k", ek), tft.Column("x", ev)]).repartition(8)
    xi = dsl.block(edf, "x", tf_name="x_input")
    ratio = (dsl.reduce_sum(xi, axes=[0]) / dsl.reduce_max(xi, axes=[0])).named("x")
    egrouped = tft.group_by(edf, "k")
    tft.aggregate(ratio, egrouped)  # lowers once
    reset_stats()
    eout = tft.aggregate(ratio, egrouped)
    _plan_ran("aggregate Sum/Max", "aggregate.plan.exact", "factorize.kernel")
    ekh, exh = ek.cpu().numpy(), ev.cpu().numpy().astype(np.float64)
    sizes = np.bincount(ekh, minlength=exact_keys)
    present = np.nonzero(sizes)[0]
    maxes = np.full(exact_keys, -np.inf)
    np.maximum.at(maxes, ekh, exh)
    want_ratio = (np.bincount(ekh, weights=exh, minlength=exact_keys) / maxes)[present]
    if not np.array_equal(eout.host_values("k"), present):
        raise AssertionError("aggregate exact plan: keys differ from the distinct keys")
    exact_err = _check_close(
        "aggregate Sum/Max", torch.from_numpy(eout.host_values("x").astype(np.float64)),
        torch.from_numpy(want_ratio), _SUM_RTOL, 0.0,
    )
    _emit(
        "aggregate", rows=rows, dim=dim, keys=nkeys, mean_max_abs_err=mean_err,
        mean_of_squares_max_abs_err=sq_err, variance_max_abs_err=var_err,
        mean_rtol=_SUM_RTOL, exact_rows=exact_rows, exact_keys=len(present),
        exact_distinct_sizes=len(np.unique(sizes[present])), exact_max_abs_err=exact_err,
        exact_rtol=_SUM_RTOL,
    )
    del eout, edf, egrouped, ek, ev, u
    _chunk_and_exact(tft)
    return {
        "segment_plan_launches": segment_launches, "mean_max_rel_err": ks_err,
        "plain_max_rel_gap": ks_plain_gap, "shape": [rows, dim, nkeys],
        "sources": 1, "outputs": [op for _, op in loads],
    }, {"equal_to_plain": True, "shape": [rows, nkeys]}


def _dispatches(name: str) -> int:
    """Dispatch spans called ``name`` in the telemetry ring."""
    from tensorframes_tpu_torch.utils import telemetry

    return sum(1 for s in telemetry.spans() if s.kind == "dispatch" and s.name == name)


def _chunk_and_exact(tft, rows: int = 1_000_000, dim: int = 8, nkeys: int = 1000) -> None:
    """A ``reduce_sum(x * 2)`` + ``reduce_max(x)`` graph over ``rows`` x
    ``dim`` float32 rows in ``nkeys`` groups of all-distinct sizes, with
    the segment plan off: the chunk plan (one vmapped call a power-of-two
    chunk size), then the exact plan (one a distinct size, with
    ``aggregate_exact_size_limit`` raised above ``nkeys``). Sums rtol 1e-5
    against numpy float64, the max exact."""
    from tensorframes_tpu_torch.utils import telemetry
    from tensorframes_tpu_torch.utils.profiling import reset_stats

    dsl = tft.dsl
    # sizes base .. base + nkeys - 1, the last grown to make ``rows``
    base = (rows - nkeys * (nkeys - 1) // 2) // nkeys
    sizes = base + np.arange(nkeys)
    sizes[-1] += rows - int(sizes.sum())
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    keys = torch.repeat_interleave(
        torch.arange(nkeys, device="cuda"), torch.from_numpy(sizes).cuda()
    )[torch.randperm(rows, device="cuda", generator=gen)]
    # positive values: a group's float32 sum stays within rtol of float64
    v = torch.rand(rows, dim, device="cuda", generator=gen) + 0.5
    df = tft.TensorFrame([tft.Column("k", keys), tft.Column("v", v)]).repartition(8)
    s2 = dsl.reduce_sum(dsl.block(df, "v", tf_name="s_input") * 2.0, axes=[0]).named("s")
    mx = dsl.reduce_max(dsl.block(df, "v", tf_name="m_input"), axes=[0]).named("m")
    feed = {"s_input": "v", "m_input": "v"}
    grouped = tft.group_by(df, "k")

    kh, vh = keys.cpu().numpy(), v.cpu().numpy()
    want_s = np.stack([np.bincount(kh, weights=vh[:, j].astype(np.float64) * 2.0,
                                   minlength=nkeys) for j in range(dim)], 1)
    want_m = np.full((nkeys, dim), -np.inf, np.float32)
    np.maximum.at(want_m, kh, vh)
    out = {}
    for plan, knobs, span in (
        ("chunk", dict(aggregate_segment_fast=False), "aggregate.chunk"),
        ("exact", dict(aggregate_segment_fast=False, aggregate_exact_size_limit=nkeys + 1),
         "aggregate.size"),
    ):
        with tft.config.override(**knobs):
            tft.aggregate([s2, mx], grouped, feed_dict=feed)  # lowers once
            reset_stats()
            telemetry.reset()
            res = tft.aggregate([s2, mx], grouped, feed_dict=feed)
        _plan_ran(f"aggregate {plan} plan", f"aggregate.plan.{plan}", "factorize.kernel")
        calls = _dispatches(span)
        want_calls = int(sizes.max()).bit_length() if plan == "chunk" else len(np.unique(sizes))
        if calls != want_calls:
            raise AssertionError(f"aggregate {plan} plan: {calls} vmapped calls, want {want_calls}")
        if not np.array_equal(res.host_values("k"), np.arange(nkeys)):
            raise AssertionError(f"aggregate {plan} plan: keys differ")
        got_m = res.host_values("m")
        if got_m.dtype != np.float32 or not np.array_equal(got_m, want_m):
            raise AssertionError(f"aggregate {plan} plan: max differs from numpy")
        s_err = _check_close(
            f"aggregate {plan} plan sum", torch.from_numpy(res.host_values("s").astype(np.float64)),
            torch.from_numpy(want_s), _SUM_RTOL, 0.0,
        )
        out[plan] = dict(vmapped_calls=calls, sum_max_abs_err=s_err, max_exact=True)
        del res
    _emit(
        "aggregate_chunk_and_exact", rows=rows, dim=dim, keys=nkeys,
        distinct_sizes=len(np.unique(sizes)), largest_group=int(sizes.max()),
        sum_rtol=_SUM_RTOL, **out,
    )


def _lloyd_step_f64(points: torch.Tensor, centers: np.ndarray, chunk: int = 1_000_000):
    """One float64 Lloyd step on the host: (centres, counts, near_ties),
    where near_ties counts points whose two nearest squared distances lie
    within float32 rounding of each other (either assignment is right)."""
    k, dim = centers.shape
    c = centers.astype(np.float64)
    c2 = (c * c).sum(1)
    sums, counts, ties = np.zeros((k, dim)), np.zeros(k), 0
    for lo in range(0, len(points), chunk):
        p = points[lo:lo + chunk].cpu().numpy().astype(np.float64)
        p2 = (p * p).sum(1, keepdims=True)
        d = p2 - 2.0 * p @ c.T + c2
        two = np.partition(d, 1, axis=1)[:, :2]
        # float32 rounds each of |p|^2, 2 p.c and |c|^2 to ~2^-24 of its size
        ties += int((two[:, 1] - two[:, 0] <= 1e-5 * (p2[:, 0] + c2.max())).sum())
        a = d.argmin(1)
        counts += np.bincount(a, minlength=k)
        sums += np.eye(k)[a].T @ p
    new = c.copy()
    nz = counts > 0
    new[nz] = sums[nz] / counts[nz, None]
    return new, counts, ties


def phase_kmeans(tft, rows: int = 10_000_000, dim: int = 100, k: int = 10,
                 iters: int = 10, blocks: int = 8) -> None:
    from tensorframes_tpu_torch.models import kmeans

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    blobs = torch.randn(k, dim, device="cuda", generator=gen) * 5.0
    pick = torch.randint(0, k, (rows,), device="cuda", generator=gen)
    pts = blobs[pick] + torch.randn(rows, dim, device="cuda", generator=gen)
    del pick
    df = tft.TensorFrame([tft.Column("features", pts)]).repartition(blocks)

    one_c, one_n = kmeans(df, "features", k, num_iters=1, seed=SEED)
    init = pts[torch.from_numpy(
        np.random.RandomState(SEED).choice(rows, size=k, replace=False)
    ).cuda()].cpu().numpy()
    want_c, want_n, ties = _lloyd_step_f64(pts, init)
    moved = int(np.abs(one_n - want_n).sum())
    if moved > 2 * ties:
        raise AssertionError(
            f"kmeans counts differ by {moved} from the float64 step, more than "
            f"the {ties} near-tie points can explain"
        )
    centre_err = _check_close(
        "kmeans centres", torch.from_numpy(one_c.astype(np.float64)),
        torch.from_numpy(want_c), _KMEANS_RTOL, _KMEANS_ATOL,
    )

    cs, ns = kmeans(df, "features", k, num_iters=iters, seed=SEED)
    if cs.shape != (k, dim) or not np.isfinite(cs).all() or ns.sum() != rows:
        raise AssertionError(f"kmeans: bad result {cs.shape}, {ns.sum()} points counted")
    _emit(
        "kmeans", rows=rows, dim=dim, k=k, blocks=blocks, iterations=iters,
        centre_max_abs_err=centre_err,
        count_differences=moved, near_tie_points=ties,
        tolerance={"rtol": _KMEANS_RTOL, "atol": _KMEANS_ATOL},
    )


def _fixture(name: str) -> bytes:
    """A GraphDef written by TensorFlow (the card's machine has none) and
    committed by ``tests/fixtures/torch_port/make_fixtures.py``."""
    with open(os.path.join(_FIXTURES, name), "rb") as f:
        return f.read()


def phase_inception(tft, images: int = 2048, blocks: int = 8, image_size: int = 299,
                    width: int = 32, classes: int = 1000, checked: int = 16) -> None:
    """BASELINE config 5: a frozen Inception GraphDef scoring an image
    column. `InceptionLite` at Inception-v3's stem widths (32 and 64
    channels at 299x299, 1000 classes) goes to wire bytes, and
    `map_blocks` scores 2,048 random images in 8 blocks on the card. The
    first ``checked`` images' probabilities are held against the port's
    CPU run of the same bytes."""
    from tensorframes_tpu_torch.models import InceptionLite

    graph, _ = tft.dsl.build(
        InceptionLite(image_size=image_size, width=width, num_classes=classes,
                      seed=SEED).scoring_graph()
    )
    wire = graph.to_bytes()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    imgs = torch.rand(images, image_size, image_size, 3, device="cuda", generator=gen)
    df = tft.TensorFrame([tft.Column("images", imgs)]).repartition(blocks)

    out = tft.map_blocks(wire, df, fetch_names=["probs"], trim=True)
    probs = out.column("probs").values
    if tuple(probs.shape) != (images, classes) or not torch.isfinite(probs).all():
        raise AssertionError(f"Inception: bad probabilities {tuple(probs.shape)}")
    sum_err = float((probs.double().sum(1) - 1.0).abs().max())
    if sum_err > 1e-5:
        raise AssertionError(f"Inception: probabilities sum to 1 within {sum_err:.3e}")

    cpu = tft.map_blocks(
        wire, tft.TensorFrame.from_dict({"images": imgs[:checked].cpu().numpy()}),
        fetch_names=["probs"], trim=True, device="cpu",
    ).host_values("probs")
    card = probs[:checked].cpu()
    err = _check_close("Inception card vs CPU", card, torch.from_numpy(cpu),
                       _INCEPTION_RTOL, _INCEPTION_ATOL)
    top2 = np.sort(cpu, axis=1)[:, -2:]
    near_ties = int((top2[:, 1] - top2[:, 0] < 1e-5).sum())
    differ = card.numpy().argmax(1) != cpu.argmax(1)
    if (differ & (top2[:, 1] - top2[:, 0] >= 1e-5)).any():
        raise AssertionError("Inception: top-1 differs from the CPU's on a clear winner")
    _emit(
        "inception_scoring", images=images, blocks=blocks, image_size=image_size,
        width=width, classes=classes, graph_bytes=len(wire), checked_images=checked,
        max_abs_err=err,
        top1_differences=int(differ.sum()), top2_near_ties=near_ties,
        tolerance={"rtol": _INCEPTION_RTOL, "atol": _INCEPTION_ATOL},
    )


def _branchy_reference(x: np.ndarray):
    """The branchy per-row graph in numpy: ``(x > 0 ? 2x : x - 5) + v``,
    ``v`` = ``x`` halved until ``|v| <= 1``, looped by trip, not by row."""
    c = np.where(x > 0, x * np.float32(2.0), x - np.float32(5.0))
    v, k = x.copy(), np.zeros(len(x), np.int32)
    active = np.abs(v) > 1.0
    while active.any():
        v[active] *= np.float32(0.5)
        k[active] += 1
        active = np.abs(v) > 1.0
    return c + v, k


def phase_control_flow(tft, rows: int = 10_000_000, blocks: int = 8) -> None:
    """Imported TF control flow: the branchy per-row graph as v1 rings and
    as v2 ``If``/``While``, and the cond + 3-trip product loop, through
    `map_rows` (the lifted plan: one call per block); then a block-level
    graph with a scalar predicate (a reduction over the block) and a scalar
    loop carry through `map_blocks`. Every result is exact."""
    from tensorframes_tpu_torch.utils.profiling import reset_stats, stats

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    x = (torch.rand(rows, device="cuda", generator=gen) - 0.5) * 40.0
    df = tft.TensorFrame([tft.Column("x", x)]).repartition(blocks)
    xh = x.cpu().numpy()
    want_out, want_trips = _branchy_reference(xh)
    want_cw = np.where(xh > 0, xh * np.float32(2.0), xh - np.float32(5.0)) + (
        (xh + np.float32(1.0)) * (xh + np.float32(1.0)) * (xh + np.float32(1.0))
    )
    result = {}
    for name, fetches in (
        ("branchy_v1.pb", ["out", "trips"]), ("branchy_v2.pb", ["out", "trips"]),
        ("cond_while_v1.pb", ["out"]), ("cond_while_v2.pb", ["out"]),
    ):
        data = _fixture(name)
        tft.map_rows(data, df, fetch_names=fetches)  # lowers once
        reset_stats()
        out = tft.map_rows(data, df, fetch_names=fetches)
        counts = stats()
        if counts.get("map_rows.plan.lifted") != 1.0 or "map_rows.plan.per_row" in counts:
            raise AssertionError(f"map_rows {name}: expected the lifted plan, counters say {counts}")
        if name.startswith("branchy"):
            got_out, got_trips = out.host_values("out"), out.host_values("trips")
            if not (np.array_equal(got_out, want_out) and np.array_equal(got_trips, want_trips)):
                raise AssertionError(f"map_rows {name}: differs from the numpy per-row reference")
        elif not np.array_equal(out.host_values("out"), want_cw):
            raise AssertionError(f"map_rows {name}: differs from the numpy reference")
        result[name.replace(".pb", "")] = dict(
            dense_trips_all_blocks=counts.get(
                "vectorize.while.trips", counts.get("control.while.trips")
            ),
            host_syncs=counts.get("vectorize.while.host_syncs", 0)
            + counts.get("control.while.host_syncs", 0),
        )
        del out

    # block level: a scalar cond on the block's sum and a scalar loop; the
    # blocks alternate in sign so float32 rounding of the sum cannot flip
    # the predicate
    sign = torch.repeat_interleave(
        torch.tensor([1.0 if i % 2 == 0 else -1.0 for i in range(blocks)], device="cuda"),
        torch.tensor(np.diff(df.offsets), device="cuda"),
    )
    y = x + sign
    ydf = tft.TensorFrame([tft.Column("x", y)], df.offsets)
    data = _fixture("block_cond_while.pb")
    tft.map_blocks(data, ydf, fetch_names=["out"])  # lowers once
    reset_stats()
    out = tft.map_blocks(data, ydf, fetch_names=["out"])
    counts = stats()
    yh = y.cpu().numpy()
    want = []
    for lo, hi in zip(df.offsets, df.offsets[1:]):
        b = yh[lo:hi]
        s, top = np.float32(1.0), np.abs(b).max()
        while s * top < 1000.0:
            s *= np.float32(2.0)
        want.append((b * np.float32(2.0) if b.sum(dtype=np.float64) > 0 else -b) * s)
    if not np.array_equal(out.host_values("out"), np.concatenate(want)):
        raise AssertionError("map_blocks block_cond_while: differs from the numpy reference")
    del out, y, ydf
    one_call = _one_call_conds(tft, rows, blocks)
    one_call["sum_loop"] = _one_call_loop(tft, rows, blocks)
    group_cond = _group_cond_aggregate(tft)
    _emit(
        "control_flow", rows=rows, blocks=blocks, map_rows=result,
        map_rows_one_call=one_call, aggregate_group_cond=group_cond,
        block_level=dict(
            cond_host_syncs=counts.get("control.cond.host_syncs"),
            while_trips=counts.get("control.while.trips"),
            while_host_syncs=counts.get("control.while.host_syncs"),
        ),
    )


def _v1_cond_graph(tft, kind: str) -> bytes:
    """The GraphDef bytes of a per-row TF v1 cond diamond, written node by
    node as TensorFlow writes one (the card's machine has no TensorFlow),
    with a bound placeholder ``w``:

    - ``sum``: ``x`` float32[3]; ``y = sum(x) > 0 ? x * w : x - w``, ``w``
      float32[3];
    - ``fill``: ``x`` float32; ``y = x > 0 ? fill([3], x) * w : fill([3],
      x - w)``, ``w`` float32.

    Neither lifts to block level (a cell `Sum` reduces the row's axis; a
    `Fill` is not row-local), so `map_rows` runs them under `vmap`."""
    from tensorframes_tpu_torch.proto.graphdef import AttrValue
    from tensorframes_tpu_torch.schema import ScalarType, Shape

    dsl, f32 = tft.dsl, ScalarType.float32
    t_f32 = {"T": AttrValue.of_type(f32)}
    cell = (3,) if kind == "sum" else ()
    x = dsl.placeholder(f32, Shape(cell), name="x")
    w = dsl.placeholder(f32, Shape(cell), name="w")
    s = dsl.reduce_sum(x, axes=[0]) if kind == "sum" else x
    pred = dsl.Tensor("Greater", [s, dsl.constant(np.float32(0.0))], t_f32, ScalarType.bool_)

    def switch(v):
        sw = dsl.Tensor("Switch", [v, pred], t_f32, f32)
        return sw, dsl.Tensor("Switch", [], {}, f32, idx=1, source=sw)

    (xf, xt), (wf, wt) = switch(x), switch(w)
    if kind == "sum":
        then, other = xt * wt, xf - wf
    else:
        def fill(v):
            dims = dsl.constant(np.asarray([3], np.int32))
            return dsl._nary("Fill", [dims, v], f32, {"index_type": AttrValue.of_type(ScalarType.int32)})

        then, other = fill(xt) * wt, fill(xf - wf)
    merge = dsl.Tensor("Merge", [other, then], {**t_f32, "N": AttrValue.of_int(2)}, f32)
    graph, _ = dsl.build(dsl.identity(merge).named("y"))
    return graph.to_bytes()


def _one_call_conds(tft, rows: int, blocks: int, per_row_rows: int = 2000) -> dict:
    """The cond-only per-row graphs of `_v1_cond_graph` over ``rows`` rows
    in ``blocks`` blocks: `map_rows`' vmap plan (one call per block, no
    host sync), exact against numpy. Values are integers in float32, so
    every sum and product is exact in any order. The Sum graph also runs
    through the per-row plan (`row_vectorize` off) over its first
    ``per_row_rows`` rows, to show what the one-call plan replaces."""
    from tensorframes_tpu_torch.utils.profiling import reset_stats, stats

    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    w3 = np.array([1.5, -2.0, 0.5], np.float32)
    out = {}
    for kind, cell, w in (("sum", (3,), w3), ("fill", (), np.float32(3.0))):
        x = torch.randint(-8, 9, (rows,) + cell, device="cuda", generator=gen).float()
        df = tft.TensorFrame([tft.Column("x", x)]).repartition(blocks)
        graph, bound = _v1_cond_graph(tft, kind), {"w": w}
        tft.map_rows(graph, df, fetch_names=["y"], bindings=bound)  # lowers once
        reset_stats()
        res = tft.map_rows(graph, df, fetch_names=["y"], bindings=bound)
        counts = stats()
        if counts.get("map_rows.plan.vmap") != 1.0 or "map_rows.plan.per_row" in counts:
            raise AssertionError(f"map_rows {kind} cond: expected the vmap plan, counters say {counts}")
        syncs = sum(v for k, v in counts.items() if k.endswith("host_syncs")) + counts.get("host_sync", 0)
        xh = x.cpu().numpy()
        if kind == "sum":
            want = np.where((xh.sum(1) > 0)[:, None], xh * w3, xh - w3)
        else:
            want = np.repeat(np.where(xh > 0, xh * w, xh - w)[:, None], 3, 1)
        if not np.array_equal(res.host_values("y"), want.astype(np.float32)):
            raise AssertionError(f"map_rows {kind} cond: differs from numpy")
        out[kind] = dict(
            plan="vmap",
            selects=counts.get("vectorize.lowered.cond"), host_syncs_per_block=syncs / blocks,
        )
        if kind == "sum":
            head = tft.TensorFrame([tft.Column("x", x[:per_row_rows])])
            with tft.config.override(row_vectorize=False):
                reset_stats()
                pr = tft.map_rows(graph, head, fetch_names=["y"], bindings=bound)
                pr_counts = stats()
            if pr_counts.get("map_rows.plan.per_row") != 1.0:
                raise AssertionError(f"per-row plan did not run: {pr_counts}")
            if not np.array_equal(pr.host_values("y"), want[:per_row_rows].astype(np.float32)):
                raise AssertionError("map_rows sum cond, per-row plan: differs from numpy")
            out[kind].update(
                per_row_rows=per_row_rows,
                per_row_host_syncs_per_row=pr_counts.get("control.cond.host_syncs", 0) / per_row_rows,
            )
        del x, df, res
    return out


_W3 = np.array([1.5, -2.0, 0.5], np.float32)


def _cell_loop_reference(xh: np.ndarray):
    """`cell_while_v1.pb` over all rows in numpy: (y, trips). The values
    are integers and halves in float32, so every sum is exact."""
    v, trips = xh.copy(), np.zeros(len(xh), np.int32)
    active = (v * v).sum(1) < 10000.0
    while active.any():
        v[active] = v[active] * np.float32(2.0) + _W3
        trips[active] += 1
        active &= (v * v).sum(1) < 10000.0
    return v, trips


def _one_call_loop(tft, rows: int, blocks: int, per_row_rows: int = 2000) -> dict:
    """`cell_while_v1.pb` (TF's v1 loop: ``v = 2 v + w`` while ``sum(v *
    v) < 10000`` over float32[3] cells, ``w`` bound): the loop's predicate
    reduces the cell, so it does not lift; `map_rows`' vmap plan runs it as
    one batched loop a block (one host read a trip). Exact against numpy;
    beside it the per-row plan over ``per_row_rows`` rows."""
    from tensorframes_tpu_torch.utils.profiling import reset_stats, stats

    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    x = torch.randint(-8, 9, (rows, 3), device="cuda", generator=gen).float()
    df = tft.TensorFrame([tft.Column("x", x)]).repartition(blocks)
    graph, bound, fetches = _fixture("cell_while_v1.pb"), {"w": _W3}, ["trips", "y"]
    tft.map_rows(graph, df, fetch_names=fetches, bindings=bound)  # lowers once
    reset_stats()
    res = tft.map_rows(graph, df, fetch_names=fetches, bindings=bound)
    counts = stats()
    if counts.get("map_rows.plan.vmap") != 1.0 or counts.get("map_rows.plan.per_row", 0.0):
        raise AssertionError(f"map_rows sum loop: expected the vmap plan, counters say {counts}")
    want_y, want_trips = _cell_loop_reference(x.cpu().numpy())
    if not (np.array_equal(res.host_values("y"), want_y)
            and np.array_equal(res.host_values("trips"), want_trips)):
        raise AssertionError("map_rows sum loop: differs from numpy")
    head = tft.TensorFrame([tft.Column("x", x[:per_row_rows])])
    with tft.config.override(row_vectorize=False):
        reset_stats()
        pr = tft.map_rows(graph, head, fetch_names=fetches, bindings=bound)
        pr_counts = stats()
    if pr_counts.get("map_rows.plan.per_row") != 1.0:
        raise AssertionError(f"per-row plan did not run: {pr_counts}")
    if not np.array_equal(pr.host_values("y"), want_y[:per_row_rows]):
        raise AssertionError("map_rows sum loop, per-row plan: differs from numpy")
    del res, df, x
    return dict(
        plan="vmap",
        map_rows_plan_per_row=counts.get("map_rows.plan.per_row", 0.0),
        trips_per_block=counts.get("control.while.trips") / blocks,
        host_syncs_per_block=counts.get("control.while.host_syncs") / blocks,
        max_row_trips=int(want_trips.max()),
        per_row_rows=per_row_rows,
        per_row_host_syncs_per_row=pr_counts.get("control.while.host_syncs", 0) / per_row_rows,
    )


def _group_cond_aggregate(tft, rows: int = 1_000_000, nkeys: int = 1000) -> dict:
    """`group_cond_v1.pb` (``x = sum(x) > 0 ? sum(x) : max(x)`` a group)
    through the exact `aggregate` plan over ``rows`` float32 rows and
    ``nkeys`` keys of uneven size: one vmapped call a distinct size, the
    cond a select per group. Even keys hold positive values and odd keys
    negative ones, so float32 rounding cannot flip a predicate; sums rtol
    1e-5 against numpy float64, maxes exact."""
    from tensorframes_tpu_torch.utils import telemetry
    from tensorframes_tpu_torch.utils.profiling import reset_stats, stats

    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    u = torch.rand(rows, device="cuda", generator=gen)
    k = (u * u * nkeys).to(torch.int64)
    sign = 1.0 - 2.0 * (k % 2).float()
    x = (torch.rand(rows, device="cuda", generator=gen) + 0.5) * sign
    df = tft.TensorFrame([tft.Column("k", k), tft.Column("x", x)]).repartition(8)
    graph, grouped = _fixture("group_cond_v1.pb"), tft.group_by(df, "k")
    tft.aggregate(graph, grouped, fetch_names=["x"])  # lowers once
    reset_stats()
    telemetry.reset()
    out = tft.aggregate(graph, grouped, fetch_names=["x"])
    counts = stats()
    plans = {k: v for k, v in counts.items() if k.startswith("aggregate.plan.")}
    if plans != {"aggregate.plan.exact": 1.0}:
        raise AssertionError(f"aggregate group cond: expected the exact plan, counters say {counts}")
    kh, xh = k.cpu().numpy(), x.cpu().numpy()
    sizes = np.bincount(kh, minlength=nkeys)
    present = np.nonzero(sizes)[0]
    calls = _dispatches("aggregate.size")
    if calls != len(np.unique(sizes[present])):
        raise AssertionError(f"aggregate group cond: {calls} calls for "
                             f"{len(np.unique(sizes[present]))} distinct sizes")
    sums = np.bincount(kh, weights=xh.astype(np.float64), minlength=nkeys)
    maxes = np.full(nkeys, -np.inf, np.float32)
    np.maximum.at(maxes, kh, xh)
    got = out.host_values("x")
    if not np.array_equal(out.host_values("k"), present):
        raise AssertionError("aggregate group cond: keys differ")
    even = present % 2 == 0
    if not np.array_equal(got[~even], maxes[present][~even]):
        raise AssertionError("aggregate group cond: maxes differ from numpy")
    err = _check_close("aggregate group cond sums", torch.from_numpy(got[even].astype(np.float64)),
                       torch.from_numpy(sums[present][even]), _SUM_RTOL, 0.0)
    return dict(rows=rows, keys=len(present), distinct_sizes=calls, selects=counts.get("vectorize.lowered.cond"),
                sum_max_abs_err=err, sum_rtol=_SUM_RTOL)


def phase_freezing(tft, df) -> None:
    """Stateful graphs as TF wrote them, a ref variable (``VariableV2`` +
    ``Assign``: ``z = x + 3``) and resource variables (``VarHandleOp``:
    ``z = x * 2 + (-1)``), frozen at import and run by `map_blocks` over
    phase 3's column. Exact."""
    x = df.column("x").values
    for name, want in (
        ("var_ref.pb", lambda: x + 3.0),
        ("var_resource.pb", lambda: x * 2.0 + (-1.0)),
    ):
        out = tft.map_blocks(_fixture(name), df, fetch_names=["z"])
        z = out.column("z").values
        if z.dtype != torch.float32 or not torch.equal(z, want()):
            raise AssertionError(f"map_blocks {name}: differs from the variable's arithmetic")
        del out, z
    _emit("freezing", rows=df.nrows, blocks=df.num_blocks,
          graphs=["var_ref.pb", "var_resource.pb"], exact=True)


def _ragged_column(rows: int, max_len: int, seed: int):
    """``rows`` float32 cells of lengths uniform in 1..``max_len``: (cells,
    flat values, row starts, lengths)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len + 1, rows)
    flat = rng.random(int(lens.sum()), dtype=np.float32)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return np.split(flat, starts[1:]), flat, starts, lens


def phase_frame_breadth(tft, ragged_rows: int = 1_000_000, max_len: int = 64,
                        agg_rows: int = 10_000_000, dim: int = 8, nids: int = 1000,
                        blocks: int = 8) -> None:
    """Ragged `map_rows` (graph and function), `pad_ragged` with a masked
    sum, a string-keyed aggregate and a bytes pass-through, and the
    function front end over all-empty frames."""
    from tensorframes_tpu_torch.frame import factorize_keys
    from tensorframes_tpu_torch.utils.profiling import reset_stats, stats

    dev = torch.device("cuda")
    dsl = tft.dsl
    result = {}

    # (a) ragged map_rows: one call per length bucket
    cells, flat, starts, lens = _ragged_column(ragged_rows, max_len, SEED)
    df = tft.TensorFrame.from_dict({"v": cells}, num_blocks=blocks)
    del cells
    want_sum = np.add.reduceat(flat.astype(np.float64), starts)
    want_max = np.maximum.reduceat(flat, starts)
    buckets = len(np.unique(lens))
    v = tft.row(df, "v")
    s_graph = dsl.reduce_sum(v, axes=[0]).named("s")
    w_graph = (v * 2.0).named("w")

    def ragged_call(what, call):
        call()  # lowers once
        reset_stats()
        out = call()
        counts = stats()
        if counts.get("map_rows.plan.ragged") != 1.0 or counts.get("map_rows.ragged.buckets") != buckets:
            raise AssertionError(f"ragged map_rows {what}: counters say {counts}, "
                                 f"expected the ragged plan over {buckets} buckets")
        return out

    out = ragged_call("sum", lambda: tft.map_rows(s_graph, df))
    got_sum = out.column("s").values
    if not (got_sum.is_cuda and got_sum.dtype == torch.float32):
        raise AssertionError(f"ragged sum: {got_sum.device} {got_sum.dtype}, expected float32 on cuda")
    sum_err = _check_close("ragged map_rows sum", got_sum.cpu().double(),
                           torch.from_numpy(want_sum), _SUM_RTOL, 0.0)
    got_sum = got_sum.cpu().numpy()
    del out

    out = ragged_call("v * 2", lambda: tft.map_rows(w_graph, df))
    col = out.column("w")
    if col.is_dense or col.device is not None:
        raise AssertionError("ragged map_rows v * 2: expected ragged host cells")
    sample = np.random.default_rng(SEED + 1).choice(ragged_rows, 1000, replace=False)
    for i in sample:
        cell = col.row(int(i))
        if cell.dtype != np.float32 or not np.array_equal(cell, flat[starts[i]:starts[i] + lens[i]] * 2):
            raise AssertionError(f"ragged map_rows v * 2: row {i} differs")
    doubled = np.concatenate(col.ragged)
    if not np.array_equal(doubled, flat * 2):
        raise AssertionError("ragged map_rows v * 2: the rows in order differ from 2 v")
    checksum = float(doubled.sum(dtype=np.float64))
    del out, col, doubled

    out = ragged_call("max", lambda: tft.map_rows(lambda v: {"m": v.max()}, df))
    if not np.array_equal(out.host_values("m"), want_max):
        raise AssertionError("ragged map_rows(fn) max differs from numpy")
    del out

    result["ragged_map_rows"] = dict(
        rows=ragged_rows, values=int(lens.sum()), max_len=max_len, blocks=blocks,
        buckets=buckets, sum_max_abs_err=sum_err, sum_rtol=_SUM_RTOL,
        times_two_checksum=checksum,
    )

    # (b) pad_ragged, then a masked block sum on the card
    padded = df.pad_ragged("v").to_device()
    if tuple(padded.column("v").values.shape) != (ragged_rows, max_len):
        raise AssertionError(f"pad_ragged: shape {tuple(padded.column('v').values.shape)}")

    def masked_sum(v, v_len):
        keep = torch.arange(v.shape[1], device=v.device) < v_len[:, None]
        return {"t": torch.where(keep, v, 0.0).sum(1)}

    out = tft.map_blocks(masked_sum, padded)
    got_t = out.column("t").values
    masked_err = _check_close("masked sum over pad_ragged", got_t.cpu().double(),
                              torch.from_numpy(want_sum), _SUM_RTOL, 0.0)
    vs_ragged = float(np.abs(got_t.cpu().numpy() - got_sum).max())
    result["pad_ragged"] = dict(
        max_abs_err=masked_err, max_abs_diff_from_ragged_sum=vs_ragged, rtol=_SUM_RTOL,
    )
    del df, padded, out, got_t, flat

    # (c) string keys at config 4's widths: mean and variance per id
    ids = np.array([f"user_{i:06d}" for i in range(nids)], dtype=object)
    rng = np.random.default_rng(SEED)
    codes = rng.integers(0, nids, agg_rows)
    keys = ids[codes]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    vals = torch.rand(agg_rows, dim, device="cuda", generator=gen)
    kdf = tft.TensorFrame([tft.Column("k", keys), tft.Column("v", vals)])
    # the two host factorizations `factorize_keys` has: pandas' where it
    # imports (a first call imports it), and the dict pass that runs
    # without pandas, run with pandas hidden; they give the same codes
    factorize_keys(["k"], [keys[:10]], dev)
    pandas = sys.modules.get("pandas")
    _, codes_default = factorize_keys(["k"], [kdf.host_values("k")], dev)
    sys.modules["pandas"] = None
    try:
        _, codes_dict = factorize_keys(["k"], [kdf.host_values("k")], dev)
    finally:
        if pandas is None:
            del sys.modules["pandas"]
        else:
            sys.modules["pandas"] = pandas
    if not torch.equal(codes_default, codes_dict):
        raise AssertionError("string keys: the dict pass and pandas give different codes")
    del codes_default, codes_dict
    m = dsl.reduce_mean(dsl.block(kdf, "v", tf_name="m_input"), axes=[0]).named("m")
    q = dsl.reduce_mean(dsl.square(dsl.block(kdf, "v", tf_name="q_input")), axes=[0]).named("q")
    feed = {"m_input": "v", "q_input": "v"}
    grouped = tft.group_by(kdf, "k")
    tft.aggregate([m, q], grouped, feed_dict=feed)  # lowers once
    reset_stats()
    out = tft.aggregate([m, q], grouped, feed_dict=feed)
    # 1,000 ids x (8 + 8 + 1) accumulators: past the keyed-sums kernel's table
    _plan_ran("string-keyed aggregate", "aggregate.plan.segment", "aggregate.segment.torch")
    got_k = out.host_values("k")
    if out.column("k").device is not None or got_k.tolist() != sorted(ids.tolist()):
        raise AssertionError("string-keyed aggregate: the key column is not the sorted ids")
    got_m, got_q = out.host_values("m"), out.host_values("q")
    vh = vals.cpu().numpy()
    counts = np.bincount(codes, minlength=nids).astype(np.float64)
    want_m, want_q = np.empty((nids, dim)), np.empty((nids, dim))
    for j in range(dim):
        c = vh[:, j].astype(np.float64)
        want_m[:, j] = np.bincount(codes, weights=c, minlength=nids) / counts
        want_q[:, j] = np.bincount(codes, weights=c * c, minlength=nids) / counts
    del vh
    mean_err = _check_close("string-keyed mean", torch.from_numpy(got_m.astype(np.float64)),
                            torch.from_numpy(want_m), _SUM_RTOL, 0.0)
    sq_err = _check_close("string-keyed mean of squares",
                          torch.from_numpy(got_q.astype(np.float64)),
                          torch.from_numpy(want_q), _SUM_RTOL, 0.0)
    var_err = _check_close(
        "string-keyed variance",
        torch.from_numpy(got_q.astype(np.float64) - got_m.astype(np.float64) ** 2),
        torch.from_numpy(want_q - want_m**2), 0.0,
        torch.from_numpy(_SUM_RTOL * (want_q + 2 * want_m**2)),
    )
    result["string_keyed_aggregate"] = dict(
        rows=agg_rows, dim=dim, ids=nids, pandas_version=getattr(pandas, "__version__", None),
        mean_max_abs_err=mean_err,
        mean_of_squares_max_abs_err=sq_err, variance_max_abs_err=var_err, rtol=_SUM_RTOL,
    )
    del out, grouped, kdf

    # (d) a bytes column through map_blocks beside a computed fetch
    x = vals[:, 0].contiguous()
    del vals
    sdf = tft.TensorFrame([tft.Column("x", x), tft.Column("id", keys)]).repartition(blocks)
    tag = dsl.placeholder(tft.ScalarType.string, tft.Shape(()), name="id")
    fetches = [(tft.block(sdf, "x") + 3.0).named("z"), dsl.identity(tag).named("t")]
    out = tft.map_blocks(fetches, sdf)
    z, t = out.column("z"), out.column("t")
    if t.device is not None or t.dtype is not tft.ScalarType.string or not np.array_equal(
        t.host_values(), keys
    ):
        raise AssertionError("bytes pass-through: the ids did not come back unchanged on the host")
    if not (z.values.is_cuda and torch.equal(z.values, x + 3.0)):
        raise AssertionError("bytes pass-through: x + 3 is not x + 3 on the card")
    if out.columns != ["t", "z", "x", "id"]:
        raise AssertionError(f"bytes pass-through: columns {out.columns}")
    result["string_passthrough"] = dict(rows=agg_rows, blocks=blocks)
    del out, sdf, x, keys

    # (e) the function front end over all-empty frames, on the card: the
    # JAX package's names, shapes and dtypes (tests/test_torch_verbs.py)
    empty = tft.TensorFrame([tft.Column("x", torch.zeros(0, 3, device="cuda"))])
    cases = {
        "map_blocks": (tft.map_blocks(lambda x: {"y": x * 2.0 + 1.0}, empty), ["y", "x"]),
        "map_rows": (tft.map_rows(lambda x: {"y": x * 2.0 + 1.0}, empty), ["y", "x"]),
        "map_blocks_trim_keepdims": (
            tft.map_blocks(lambda x: {"s": x.sum(0, keepdim=True)}, empty, trim=True), ["s"]),
    }
    for name, (frame, names) in cases.items():
        if frame.columns != names:
            raise AssertionError(f"empty {name}: columns {frame.columns}, expected {names}")
        for c in names:
            val = frame.column(c).values
            if tuple(val.shape) != (0, 3) or val.dtype != torch.float32 or not val.is_cuda:
                raise AssertionError(f"empty {name}: {c} is {tuple(val.shape)} {val.dtype} "
                                     f"on {val.device}, expected (0, 3) float32 on cuda")
    result["empty_frame_functions"] = {n: f.columns for n, (f, _) in cases.items()}
    _emit("frame_breadth", **result)


# ---------------------------------------------------------------------------
# phase 12: out-of-core streaming
# ---------------------------------------------------------------------------

# the durable stream's resume runs in a fresh interpreter: it reads the
# committed checkpoint and prints the stream's results and its counters
_RESUME_CHILD = r"""
import json, sys
import numpy as np
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.utils import telemetry

root, ck, fetch_bytes, fetch_names, feed = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5]
out = tft.reduce_blocks_stream(
    open(fetch_bytes, "rb").read(), tft.stream_dataset(root), json.loads(feed),
    fetch_names=json.loads(fetch_names), checkpoint=ck,
)
flat = telemetry.flat_counters()
print("RESULT " + json.dumps({
    "values": {k: v.cpu().numpy().tolist() for k, v in out.items()},
    "checkpoint_chunks_skipped": flat.get("checkpoint_chunks_skipped", 0),
    "decoded_chunks": flat.get("ingest_chunks{stage=decode}", 0),
}))
"""


def _ingest_threads():
    import threading

    return [t.name for t in threading.enumerate() if t.is_alive() and t.name.startswith("tfs-ingest")]


def _stage_chunks():
    """The chunks each ingest stage passed (``ingest_chunks`` by stage)."""
    from tensorframes_tpu_torch.utils import telemetry

    return {dict(labels).get("stage", "?"): v
            for (name, labels), v in telemetry.labeled_counters().items()
            if name == "ingest_chunks"}


def _chunk_reference(arr: np.ndarray):
    """(float64 sum, min) of one chunk's float32 values."""
    return float(arr.sum(dtype=np.float64)), float(arr.min())


def _north_star_chunks(tft, rows: int, chunk_rows: int, refs: list, pool):
    """`examples/billion_row_reduce.py`'s chunks as host frames. The
    float64 reference of each chunk is computed on ``pool`` (numpy's
    reductions release the GIL), so the producer pays only the
    synthesis."""
    made = 0
    while made < rows:
        n = min(chunk_rows, rows - made)
        arr = np.arange(made, made + n, dtype=np.float64).astype(np.float32)
        refs.append(pool.submit(_chunk_reference, arr))
        yield tft.TensorFrame.from_dict({"x": arr})
        made += n


def _north_star(tft, rows: int, chunk_rows: int):
    """The README vector `reduce_sum` (and a `reduce_min` beside it) as
    GraphDef bytes over ``rows`` float32 rows in chunks of ``chunk_rows``."""
    from concurrent.futures import ThreadPoolExecutor

    from tensorframes_tpu_torch.utils.profiling import reset_stats, stats

    probe = tft.TensorFrame.from_dict({"x": np.zeros(4, np.float32)})
    s = tft.dsl.reduce_sum(tft.block(probe, "x", tf_name="x_input"), axes=[0]).named("x")
    mn = tft.dsl.reduce_min(tft.block(probe, "x", tf_name="m_input"), axes=[0]).named("m")
    g, fetches = tft.dsl.build([s, mn])
    wire, feed = g.to_bytes(), {"x_input": "x", "m_input": "x"}

    futures = []
    reset_stats()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with ThreadPoolExecutor(1) as pool:
        out = tft.reduce_blocks_stream(wire, _north_star_chunks(tft, rows, chunk_rows, futures, pool),
                                       feed, fetch_names=fetches)
        got_sum, got_min = out["x"].item(), out["m"].item()  # reads end in a sync
        refs = [f.result() for f in futures]
    peak = torch.cuda.max_memory_allocated() - base
    want_sum, want_min = sum(r[0] for r in refs), min(r[1] for r in refs)
    counts = stats()
    rel = abs(got_sum - want_sum) / abs(want_sum)
    if out["x"].dtype != torch.float32 or rel > _SUM_RTOL:
        raise AssertionError(f"stream sum {got_sum} vs float64 {want_sum}: rel err {rel:.3e}")
    if got_min != want_min:
        raise AssertionError(f"stream min {got_min} != numpy {want_min}")
    if counts.get("reduce_blocks_stream.transfer_fallback", 0):
        raise AssertionError(f"the transfer stage fell back: {counts}")
    return dict(
        sum_rel_err=rel, min=got_min,
        chunks=int(counts.get("reduce_blocks_stream.chunks", 0)),
        folds=int(counts.get("reduce_blocks_stream.fold", 0)),
        transfer_fallbacks=int(counts.get("reduce_blocks_stream.transfer_fallback", 0)),
        peak_device_bytes=peak,
    )


def _transfer_stage_probe(tft, chunk_rows: int) -> None:
    """One chunk through the transfer stage (both pinned slots and the copy
    stream warmed first) reaches the card unchanged."""
    from tensorframes_tpu_torch.streaming import _TransferStage

    arr = np.arange(0, chunk_rows, dtype=np.float64).astype(np.float32)
    frame = tft.TensorFrame.from_dict({"x": arr})
    stage = _TransferStage(torch.device("cuda"))
    for _ in range(2):  # warm: both pinned slots, the copy stream
        stage(frame)
    stage.close()
    staged = stage.receive(stage(frame))
    if not torch.equal(staged.column("x").values.cpu(), torch.from_numpy(arr)):
        raise AssertionError("the transfer stage changed the chunk's values")


def _write_dataset(tft, root: str, shards: int, rows: int, width: int):
    """``shards`` Parquet and ``shards`` Arrow IPC files of ``rows`` rows
    (``x`` float32, ``v`` float32[width], uniform in [0, 1)), each in 2-6
    row groups / record batches of uneven size; shard 0 of the Parquet
    files is empty. Returns the float64 reference and the row count."""
    from tensorframes_tpu_torch import io as tio

    ref = {"x_sum": 0.0, "x_min": math.inf, "x_max": -math.inf,
           "v_sum": np.zeros(width, np.float64)}
    total = 0
    for i in range(2 * shards):
        fmt = "parquet" if i < shards else "ipc"
        n = 0 if i == 0 else rows
        rng = np.random.default_rng(SEED + i)
        x = rng.random(n, dtype=np.float32)
        v = rng.random((n, width), dtype=np.float32)
        groups = 2 + i % 5
        cuts = np.sort(rng.choice(np.arange(1, max(n, 2)), size=groups - 1, replace=False)) if n else []
        offsets = [0, *map(int, cuts), n] if n else None
        frame = tft.TensorFrame([tft.Column("x", x), tft.Column("v", v)], offsets)
        path = os.path.join(root, f"shard-{i:03d}." + ("parquet" if fmt == "parquet" else "arrow"))
        (tio.write_parquet if fmt == "parquet" else tio.write_arrow_ipc)(frame, path)
        if n:
            ref["x_sum"] += float(x.sum(dtype=np.float64))
            ref["x_min"] = min(ref["x_min"], float(x.min()))
            ref["x_max"] = max(ref["x_max"], float(x.max()))
            ref["v_sum"] += v.sum(axis=0, dtype=np.float64)
        total += n
    return ref, total


def _dataset_fetches(tft, width: int):
    probe = tft.TensorFrame.from_dict(
        {"x": np.zeros(2, np.float32), "v": np.zeros((2, width), np.float32)}
    )
    d = tft.dsl
    fetches = [
        d.reduce_sum(tft.block(probe, "x", tf_name="x_sum_input"), axes=[0]).named("x_sum"),
        d.reduce_min(tft.block(probe, "x", tf_name="x_min_input"), axes=[0]).named("x_min"),
        d.reduce_max(tft.block(probe, "x", tf_name="x_max_input"), axes=[0]).named("x_max"),
        d.reduce_sum(tft.block(probe, "v", tf_name="v_sum_input"), axes=[0]).named("v_sum"),
    ]
    g, names = d.build(fetches)
    feed = {"x_sum_input": "x", "x_min_input": "x", "x_max_input": "x", "v_sum_input": "v"}
    return g.to_bytes(), names, feed


def _check_dataset(what: str, out: dict, ref: dict) -> float:
    """Max relative error of the sums (rtol 1e-5 vs float64); min and max
    exact."""
    got = {k: np.asarray(v.cpu().numpy() if isinstance(v, torch.Tensor) else v, np.float64)
           for k, v in out.items()}
    if got["x_min"] != ref["x_min"] or got["x_max"] != ref["x_max"]:
        raise AssertionError(f"{what}: min/max {got['x_min']}/{got['x_max']} vs "
                             f"{ref['x_min']}/{ref['x_max']}")
    rel = max(abs(got["x_sum"] - ref["x_sum"]) / ref["x_sum"],
              float(np.max(np.abs(got["v_sum"] - ref["v_sum"]) / ref["v_sum"])))
    if rel > _SUM_RTOL:
        raise AssertionError(f"{what}: sums rel err {rel:.3e} > {_SUM_RTOL}")
    return rel


def _dataset_phases(tft, shards: int, shard_rows: int, width: int = 8) -> None:
    """A multi-file dataset through `stream_dataset`, then the same stream
    made durable, cut by its deadline and resumed in a fresh interpreter."""
    import tempfile

    from tensorframes_tpu_torch.ingest.dataset import _auto_decode_workers
    from tensorframes_tpu_torch.utils import telemetry
    from tensorframes_tpu_torch.utils.profiling import reset_stats, stats

    with tempfile.TemporaryDirectory(prefix="tfs-stream-") as tmp:
        data = os.path.join(tmp, "data")
        os.mkdir(data)
        ref, rows = _write_dataset(tft, data, shards, shard_rows, width)
        wire, names, feed = _dataset_fetches(tft, width)

        telemetry.reset()
        reset_stats()
        # the uninterrupted stream's time sets the durable stream's deadline
        t0 = time.perf_counter()
        out = tft.reduce_blocks_stream(wire, tft.stream_dataset(data), feed, fetch_names=names)
        err = _check_dataset("dataset stream", out, ref)
        secs = time.perf_counter() - t0
        counts = stats()
        if counts.get("reduce_blocks_stream.transfer_fallback", 0):
            raise AssertionError(f"dataset stream: the transfer stage fell back: {counts}")
        _emit(
            "stream_dataset", shards=2 * shards, empty_shards=1, rows=rows, bytes_per_row=4 * (1 + width),
            chunks=int(counts.get("reduce_blocks_stream.chunks", 0)),
            folds=int(counts.get("reduce_blocks_stream.fold", 0)),
            decode_workers=_auto_decode_workers(), stage_chunks=_stage_chunks(),
            max_sum_rel_err=err, sum_rtol=_SUM_RTOL,
        )

        # durable: the same stream, cut by its deadline, resumed elsewhere
        ck = os.path.join(tmp, "stream.ckpt")
        budget = 0.5 * secs
        reset_stats()
        try:
            tft.reduce_blocks_stream(wire, tft.stream_dataset(data), feed, fetch_names=names,
                                     checkpoint=ck, timeout_s=budget)
        except tft.DeadlineExceeded as e:
            watermark = e.tfs_checkpoint_watermark
        else:
            raise AssertionError(f"durable stream finished inside its {budget:.2f} s budget")
        wire_path = os.path.join(tmp, "fetches.pb")
        with open(wire_path, "wb") as f:
            f.write(wire)
        repo = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.run(
            [sys.executable, "-c", _RESUME_CHILD, data, ck, wire_path, json.dumps(names),
             json.dumps(feed)],
            capture_output=True, text=True, timeout=600, env=env, cwd=repo,
        )
        if proc.returncode != 0:
            raise AssertionError(f"resume process failed:\n{proc.stderr[-3000:]}")
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
        child = json.loads(line[len("RESULT "):])
        resumed = child["values"]
        if not child["checkpoint_chunks_skipped"] > 0:
            raise AssertionError(f"the resume skipped no chunk: {child}")
        for k in ("x_min", "x_max"):
            if np.float32(resumed[k]) != out[k].item():
                raise AssertionError(f"resumed {k} {resumed[k]} != uninterrupted {out[k].item()}")
        rel = max(abs(resumed["x_sum"] - out["x_sum"].item()) / out["x_sum"].item(),
                  float(np.max(np.abs(np.asarray(resumed["v_sum"]) - out["v_sum"].cpu().numpy())
                               / out["v_sum"].cpu().numpy())))
        if rel > _SUM_RTOL:
            raise AssertionError(f"resumed sums rel err {rel:.3e} vs the uninterrupted stream")
        err = _check_dataset("resumed stream", resumed, ref)
        _emit(
            "stream_durable", watermark=watermark,
            chunks_before_cut=int(stats().get("reduce_blocks_stream.chunks", 0)),
            checkpoint_chunks_skipped=child["checkpoint_chunks_skipped"],
            resumed_decoded_chunks=child["decoded_chunks"],
            min_max_bit_equal=True, sum_rel_err_vs_uninterrupted=rel, max_sum_rel_err=err,
        )


def phase_streaming(tft, rows: int = 1_000_000_000, chunk_rows: int = 128_000_000,
                    overlap_rows: int = 256_000_000, shards: int = 16,
                    shard_rows: int = 4_000_000, slow_chunks: int = 40) -> None:
    """Phase 12: `reduce_blocks_stream` over the north star's 1B rows, the
    overlap with the pipeline on and off, a multi-file dataset, a durable
    stream resumed in a fresh interpreter, and a deadline's teardown."""
    from tensorframes_tpu_torch import config

    try:
        import pyarrow
        has_pyarrow = pyarrow.__version__
    except ImportError:
        has_pyarrow = None
    print(json.dumps({"pyarrow": has_pyarrow is not None, "version": has_pyarrow}), flush=True)

    _transfer_stage_probe(tft, chunk_rows)
    ns = _north_star(tft, rows, chunk_rows)
    depth = config.get().stream_prefetch_depth
    limit = (depth + 3) * chunk_rows * 4
    if ns["peak_device_bytes"] > limit:
        raise AssertionError(f"device memory peaked at {ns['peak_device_bytes']} bytes over the "
                             f"stream, above (depth + 3) chunks = {limit}")
    if ns["folds"] < 1:
        raise AssertionError(f"the stream never folded: {ns}")
    _emit(
        "stream_north_star", rows=rows, chunk_rows=chunk_rows, chunk_bytes=chunk_rows * 4,
        prefetch_depth=depth, **ns,
        peak_device_chunks=ns["peak_device_bytes"] / (chunk_rows * 4), peak_limit_chunks=depth + 3,
        sum_rtol=_SUM_RTOL,
    )

    errs = {}
    for on in (True, False):
        with config.override(ingest_pipeline=on):
            r = _north_star(tft, overlap_rows, chunk_rows)
        errs["pipeline_on" if on else "pipeline_off"] = r["sum_rel_err"]
    _emit("stream_pipeline_on_off", rows=overlap_rows, chunk_rows=chunk_rows, sum_rel_err=errs)

    if has_pyarrow is None:
        for name in ("stream_dataset", "stream_durable"):
            _emit(name, skipped="pyarrow not installed")
    else:
        _dataset_phases(tft, shards, shard_rows)

    # deadline: a slow generator under a 0.5 s budget
    def slow():
        for i in range(slow_chunks):
            time.sleep(0.1)
            yield tft.TensorFrame.from_dict({"x": np.full(1024, float(i), np.float32)})

    probe = tft.TensorFrame.from_dict({"x": np.zeros(4, np.float32)})
    s = tft.dsl.reduce_sum(tft.block(probe, "x", tf_name="x_input"), axes=[0]).named("x")
    try:
        tft.reduce_blocks_stream(s, slow(), timeout_s=0.5)
    except tft.DeadlineExceeded:
        pass
    else:
        raise AssertionError("the slow stream finished inside its 0.5 s budget")
    t1 = time.perf_counter()
    while _ingest_threads() and time.perf_counter() - t1 < 2.0:
        time.sleep(0.01)
    left = _ingest_threads()
    if left:
        raise AssertionError(f"pipeline threads alive 2 s after the deadline: {left}")
    _emit("stream_deadline", budget_s=0.5, raised=True, threads_left=0)


# ---------------------------------------------------------------------------
# phase 13: lazy plans and the Spark bridge
# ---------------------------------------------------------------------------


def _d2h_bytes() -> float:
    """Bytes the relational executors copied from the card to the host
    (the ``d2h_bytes`` histogram) since the last telemetry reset."""
    from tensorframes_tpu_torch.utils import telemetry

    return sum(v[2] for (name, _), v in telemetry.metrics_snapshot()[2].items()
               if name == "d2h_bytes")


def _counting_executor():
    """An `Executor` that counts the calls of its lowered callables by
    kind: the Python block dispatches a chain makes."""
    from collections import Counter

    from tensorframes_tpu_torch.runtime.executor import Executor

    class Counting(Executor):
        def __init__(self):
            super().__init__()
            self.calls = Counter()

        def cached(self, kind, graph, fetches, feed_names, device, make):
            fn = super().cached(kind, graph, fetches, feed_names, device, make)

            def counted(*feeds):
                self.calls[kind] += 1
                return fn(*feeds)

            return counted

    return Counting()


def _chain_maps(tft, lf_or_frame, stages: int, eager: bool, ex=None):
    """`benchmarks/fusion_bench.py`'s chain: ``stages`` maps of
    x * (1 + 2^-(k+3)) + 1, eager (one verb call per stage) or deferred."""
    cur, src = lf_or_frame, "x"
    for k in range(stages):
        dst = f"c{k}"
        t = (tft.block(cur, src) * (1.0 + 2.0 ** -(k + 3)) + 1.0).named(dst)
        cur = tft.map_blocks(t, cur, executor=ex) if eager else cur.map_blocks(t, executor=ex)
        src = dst
    return cur, src


def _chain_reduce(tft, df, stages: int, eager: bool, ex):
    cur, src = _chain_maps(tft, df if eager else df.lazy(), stages, eager, ex)
    s = tft.dsl.reduce_sum(tft.block(cur, src, tf_name=src + "_input"), axes=[0]).named(src)
    return tft.reduce_blocks(s, cur, executor=ex)


def _fused_chain(tft, rows: int, blocks: int, stages: int = 3) -> None:
    from collections import Counter

    from tensorframes_tpu_torch import config
    from tensorframes_tpu_torch.utils.profiling import reset_stats, stats

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    x = torch.rand(rows, device="cuda", generator=gen)
    df = tft.TensorFrame([tft.Column("x", x)]).repartition(blocks)

    # the first run of each way lowers its graphs: the executor counts
    ex_f, ex_e = _counting_executor(), _counting_executor()
    fused = _chain_reduce(tft, df, stages, False, ex_f)
    eager = _chain_reduce(tft, df, stages, True, ex_e)
    fused_programs = dict(Counter(k[0] for k in ex_f.cache_keys()))
    eager_programs = dict(Counter(k[0] for k in ex_e.cache_keys()))
    if fused_programs != {"block": 1, "reduce-combine": 1} or eager_programs != {"block": stages + 1}:
        raise AssertionError(f"lowered programs: fused {fused_programs}, eager {eager_programs}")
    fused_calls, eager_calls = dict(ex_f.calls), dict(ex_e.calls)
    if fused_calls != {"block": blocks, "reduce-combine": 1} or eager_calls != {
            "block": (stages + 1) * blocks + 1}:
        raise AssertionError(f"block calls: fused {fused_calls}, eager {eager_calls}")
    if not torch.equal(fused, eager):
        raise AssertionError(f"fused {fused.item()!r} != eager {eager.item()!r}")
    misses = ex_f.cache_misses
    again = _chain_reduce(tft, df, stages, False, ex_f)
    if ex_f.cache_misses != misses or not torch.equal(again, fused):
        raise AssertionError(f"second fused run: {ex_f.cache_misses - misses} new misses")

    for way, ex in (("eager", ex_e), ("fused", ex_f)):
        if not torch.equal(_chain_reduce(tft, df, stages, way == "eager", ex), fused):
            raise AssertionError(f"{way} run disagrees with the first fused run")
    want = float(x.double().mul(1.125).add(1).mul(1.0625).add(1).mul(1.03125).add(1).sum())
    rel = abs(fused.item() - want) / abs(want)
    if rel > _SUM_RTOL:
        raise AssertionError(f"fused chain sum rel err {rel:.3e} > {_SUM_RTOL} vs float64")
    _emit(
        "lazy_fused_chain", rows=rows, blocks=blocks, maps=stages,
        programs={"fused": fused_programs, "eager": eager_programs},
        block_calls={"fused": fused_calls, "eager": eager_calls},
        second_fused_run_misses=ex_f.cache_misses - misses,
        fused_equals_eager=True, sum_rel_err_vs_f64=rel,
    )

    # the same maps over a host-resident base: force() with the plan-prep
    # pipeline off and on
    x_host = x.cpu().numpy()
    device_c = _chain_maps(tft, df.lazy(), stages, False)[0].force()
    host_df = tft.TensorFrame([tft.Column("x", x_host)]).repartition(blocks)
    from tensorframes_tpu_torch.utils import telemetry

    ref = None
    reset_stats()
    for on in (False, True):
        telemetry.reset_counters()
        with config.override(plan_pipeline=on):
            out = _chain_maps(tft, host_df.lazy(), stages, False)[0].force()
        if on:
            stages_on = _stage_chunks()
        cols = [out.column(f"c{k}").values for k in range(stages)]
        if ref is None:
            ref = cols
            for c, d in zip(cols, (device_c.column(f"c{k}").values for k in range(stages))):
                if not torch.equal(c, d):
                    raise AssertionError("host-resident force disagrees with device-resident")
        elif not all(torch.equal(a, b) for a, b in zip(cols, ref)):
            raise AssertionError(f"plan_pipeline={on} disagrees bit for bit")
        del out, cols
    fallbacks = stats().get("lazy.force.transfer_fallback", 0.0)
    if fallbacks:
        raise AssertionError(f"{fallbacks} plan-prep transfers fell back to synchronous copies")
    _emit(
        "lazy_host_pipeline", rows=rows, blocks=blocks, maps=stages,
        h2d_bytes=rows * 4, transfer_fallbacks=fallbacks, on_equals_off=True,
        pipeline_stage_chunks_on=stages_on,
    )
    del ref, device_c, df, x
    torch.cuda.empty_cache()
    _force_cache(tft, rows // 10, blocks, stages)


def _force_cache(tft, rows: int, blocks: int, stages: int) -> None:
    """A second `force()` of the fused chain over a host-resident base,
    served by the materialization cache (``materialize_cache_bytes`` above
    the result's size): a hit, no block dispatch, `torch.equal` to the
    first force. The admission price first decides on its own (an
    elementwise chain recomputes faster than its result is written, so it
    is expected to refuse it); the hit path is then measured with the
    admission held open, as the JAX package's cache tests hold it."""
    from tensorframes_tpu_torch import config
    from tensorframes_tpu_torch.runtime import materialize as mat
    from tensorframes_tpu_torch.utils import telemetry

    gen = torch.Generator().manual_seed(SEED + 15)
    host_df = tft.TensorFrame([tft.Column("x", torch.rand(rows, generator=gen).numpy())])
    host_df = host_df.repartition(blocks)
    names = [f"c{k}" for k in range(stages)] + ["x"]

    def force():
        return _chain_maps(tft, host_df.lazy(), stages, False)[0].force()

    mat.reset_state()
    with config.override(materialize_cache_bytes=4 * rows * (stages + 1) * 2 + (1 << 20)):
        miss = force()
        policy = mat.state()
        if policy["stores"] == 0:
            priced_out = mat._priced_out
            mat._priced_out = lambda *a, **k: False
            try:
                miss = force()
            finally:
                mat._priced_out = priced_out
        stored = mat.state()
        if stored["stores"] != 1:
            raise AssertionError(f"force cache: the result was not stored: {stored}")
        sid = telemetry.allocate_span_id()
        hit = force()
        dispatched = sum(1 for s in telemetry.spans() if s.span_id > sid and s.kind == "dispatch")
        st = mat.state()
    if st["hits"] != 1 or dispatched:
        raise AssertionError(f"force cache: {st['hits']} hits, {dispatched} block dispatches")
    for c in names:
        if not torch.equal(_as_host(hit.column(c).values), _as_host(miss.column(c).values)):
            raise AssertionError(f"force cache: the hit's {c!r} differs from the first force")
    _emit(
        "lazy_force_cache", rows=rows, blocks=blocks, maps=stages,
        hit_block_dispatches=dispatched, hit_equals_miss=True,
        admission_policy_stored=policy["stores"], admission_policy_rejected=policy["rejected"],
        entry_bytes=st["last_hit"]["bytes"],
    )
    mat.reset_state()


def _as_host(t):
    return t.cpu() if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))


def _write_relational(tft, root: str, shards: int, groups: int, group_rows: int):
    """`benchmarks/relational_bench.py`'s dataset: ``x`` float64 ascending
    across the whole dataset, ``y`` float64 of 16 keys, ``w`` float64 dead
    weight; one row group per block. Returns (x, y) for the reference."""
    from tensorframes_tpu_torch import io as tio

    xs, ys = [], []
    for i in range(shards):
        rng = np.random.default_rng(SEED + 100 + i)
        lo = i * groups * group_rows
        x = np.arange(lo, lo + groups * group_rows, dtype=np.float64)
        y = np.floor(rng.random(len(x)) * 16.0)
        frame = tft.TensorFrame.from_dict({"x": x, "y": y, "w": rng.random(len(x))},
                                          num_blocks=groups)
        tio.write_parquet(frame, os.path.join(root, f"shard-{i:04d}.parquet"))
        xs.append(x)
        ys.append(y)
    return np.concatenate(xs), np.concatenate(ys)


def _relational(tft, shards: int, groups: int, group_rows: int, frac: float = 0.05) -> None:
    import tempfile

    from tensorframes_tpu_torch import config
    from tensorframes_tpu_torch.graph import plan as tplan
    from tensorframes_tpu_torch.utils import telemetry

    total = shards * groups * group_rows
    cutoff = float(total) * (1.0 - frac)
    ph = tft.dsl.placeholder(tft.ScalarType.float64, tft.Shape((None,)), name="x")
    z = (ph * 0.5 + 1.0).named("z")

    def build(root):
        return (
            tft.scan(root)
            .filter(tft.col("x") > cutoff, selectivity=frac)
            .map_blocks(z, feed_dict={"x": "x"})
            .group_by("y")
            .agg(z_sum=("sum", "z"), z_max=("max", "z"))
        )

    with tempfile.TemporaryDirectory(prefix="tfs-relational-") as root:
        x, y = _write_relational(tft, root, shards, groups, group_rows)
        parquet_bytes = sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root))
        keep = x > cutoff
        survivors = int(keep.sum())
        zs, ks = x[keep] * 0.5 + 1.0, y[keep]
        keys = np.unique(ks)
        want_sum = np.array([zs[ks == k].sum() for k in keys])
        want_max = np.array([zs[ks == k].max() for k in keys])
        del x, y, keep, zs, ks

        decisions, results, decoded = None, {}, {}
        for on in (True, False):
            tplan.reset_state()
            telemetry.reset_counters()
            with config.override(plan_optimizer=on):
                rel = build(root)
                out = rel.force()
                if on:
                    decisions = [d for d in rel.optimize()[1] if d["accepted"]]
            decoded["on" if on else "off"] = telemetry.flat_counters()["ingest_rows_decoded"]
            results[on] = out
            if on:
                pushed = tplan.state()["pushdown_rows_skipped"]
        if decoded["on"] > survivors + shards * group_rows or decoded["off"] != total:
            raise AssertionError(f"rows decoded {decoded} for {survivors} survivors of {total}")
        accepted = sorted({d["rule"] for d in decisions})
        if not {"pushdown_into_scan", "prune_columns"} <= set(accepted):
            raise AssertionError(f"accepted rewrites {accepted}")
        on_out, off_out = results[True], results[False]
        for c in ("y", "z_sum", "z_max"):
            a = torch.as_tensor(on_out.host_values(c))
            b = torch.as_tensor(off_out.host_values(c))
            if not torch.equal(a, b):
                raise AssertionError(f"optimizer on/off disagree on {c}")
        got_y = np.asarray(on_out.host_values("y"))
        got_sum = np.asarray(on_out.host_values("z_sum"))
        got_max = np.asarray(on_out.host_values("z_max"))
        if not np.array_equal(got_y, keys) or not np.array_equal(got_max, want_max):
            raise AssertionError("group keys or z_max disagree with the numpy groupby")
        rel_err = float(np.max(np.abs(got_sum - want_sum) / np.abs(want_sum)))
        if rel_err > 1e-12:
            raise AssertionError(f"z_sum rel err {rel_err:.3e} > 1e-12 vs the numpy groupby")
    _emit(
        "relational_scan", shards=shards, row_groups=groups, group_rows=group_rows, rows=total,
        parquet_bytes=parquet_bytes, survivors=survivors, rows_decoded=decoded, pushdown_rows_skipped=pushed, accepted_rewrites=accepted,
        on_equals_off=True, z_sum_rel_err_vs_numpy=rel_err,
    )


def _sort_and_join(tft, rows: int, keys: int) -> None:
    import pandas as pd

    from tensorframes_tpu_torch.utils import telemetry

    rng = np.random.default_rng(SEED + 200)
    k = rng.random(rows)
    v = np.arange(rows, dtype=np.float64)
    df = tft.TensorFrame.from_dict({"k": k, "v": v}).repartition(8).to_device()
    telemetry.reset()
    out = df.sort_by("k").force()
    sort_d2h = _d2h_bytes()
    order = np.argsort(k, kind="stable")
    if not (np.array_equal(out.host_values("k"), k[order])
            and np.array_equal(out.host_values("v"), v[order])):
        raise AssertionError("sort_by disagrees with numpy's stable argsort")
    del out, df

    ids = rng.integers(0, keys, rows).astype(np.int64)
    right_ids = rng.permutation(keys).astype(np.int64)
    label = rng.random(keys)
    left = tft.TensorFrame.from_dict({"id": ids, "v": v}).repartition(8).to_device()
    right = tft.TensorFrame.from_dict({"id": right_ids, "label": label})
    telemetry.reset()
    out = left.join(right, on="id").force()
    join_d2h = _d2h_bytes()
    want = pd.merge(pd.DataFrame({"id": ids, "v": v}), pd.DataFrame({"id": right_ids, "label": label}),
                    on="id", how="inner")
    got = out.to_pandas()
    if list(got.columns) != ["id", "v", "label"] or not all(
            np.array_equal(got[c].to_numpy(), want[c].to_numpy()) for c in got.columns):
        raise AssertionError("join disagrees with pandas.merge")
    by_id = np.empty(keys)
    by_id[right_ids] = label
    if out.nrows != rows or not np.array_equal(got["label"].to_numpy(), by_id[got["id"].to_numpy()]):
        raise AssertionError("join labels disagree with the key lookup")
    _emit("relational_sort_join", sort_rows=rows, sort_d2h_bytes=sort_d2h,
          join_rows=rows, join_keys=keys, join_d2h_bytes=join_d2h, join_out_rows=out.nrows)


class _ArrowPartitions:
    """A Spark DataFrame's surface that the bridge touches (``mapInArrow``
    per partition over pyarrow record batches, ``collect`` of attribute
    rows), the way `examples/spark_adapter_demo.py` stands in for one."""

    def __init__(self, parts):
        self._parts = parts

    def mapInArrow(self, fn, schema):  # noqa: N802
        return _ArrowPartitions([list(fn(iter(p))) for p in self._parts])

    def collect(self):
        import types

        return [types.SimpleNamespace(**r) for p in self._parts for b in p for r in b.to_pylist()]


def _spark_bridge(tft, partitions: int, part_rows: int, width: int = 8, nkeys: int = 16) -> None:
    import tempfile

    import pyarrow as pa

    import tensorframes_tpu_torch.spark as tspark
    from tensorframes_tpu_torch.utils.profiling import reset_stats, stats

    rng = np.random.default_rng(SEED + 300)
    parts, ks, xs = [], [], []
    for _ in range(partitions):
        cols = {"k": rng.integers(0, nkeys, part_rows).astype(np.int64)}
        for i in range(width):
            cols[f"x{i}"] = rng.random(part_rows)
        half = part_rows // 2  # two record batches: Arrow's write granularity
        parts.append([pa.RecordBatch.from_pydict({n: a[:half] for n, a in cols.items()}),
                      pa.RecordBatch.from_pydict({n: a[half:] for n, a in cols.items()})])
        ks.append(cols["k"])
        xs.append(np.stack([cols[f"x{i}"] for i in range(width)], axis=1))
    k_all, x_all = np.concatenate(ks), np.concatenate(xs)
    del ks, xs
    rows = partitions * part_rows
    sdf = _ArrowPartitions(parts)
    probe = tft.TensorFrame.from_dict({f"x{i}": np.zeros(2) for i in range(width)})
    d = tft.dsl

    with tempfile.TemporaryDirectory(prefix="tfs-spark-") as ingest_dir:
        reset_stats()
        s = d.reduce_sum(tft.block(probe, "x0", tf_name="x0_input"), axes=[0]).named("x0")
        total = tspark.reduce_blocks(s, sdf, ingest_dir=ingest_dir)
        if stats().get("reduce_blocks_stream.transfer_fallback", 0.0):
            raise AssertionError("spark.reduce_blocks: transfers fell back to the host")
        want = x_all[:, 0].sum()
        sum_err = abs(total.item() - want) / want
        if total.dtype != torch.float64 or sum_err > 1e-12:
            raise AssertionError(f"spark.reduce_blocks rel err {sum_err:.3e} > 1e-12")

        zt = (tft.block(probe, "x0") * 2.0 + 1.0).named("z")
        mapped = tspark.map_blocks(zt, sdf, ingest_dir=ingest_dir)
        zv = mapped.column("z").values
        if (mapped.num_blocks != partitions or zv.device.type != "cuda"
                or not np.array_equal(zv.cpu().numpy(), x_all[:, 0] * 2.0 + 1.0)):
            raise AssertionError("spark.map_blocks disagrees with numpy or lost the partitions")
        del mapped, zv

        fetches = [d.reduce_mean(tft.block(probe, f"x{i}", tf_name=f"m{i}_input"), axes=[0])
                   .named(f"m{i}") for i in range(width)]
        feed = {f"m{i}_input": f"x{i}" for i in range(width)}
        agg = tspark.aggregate(fetches, sdf, keys=["k"], feed_dict=feed, ingest_dir=ingest_dir)
        counts = np.bincount(k_all, minlength=nkeys)
        if not np.array_equal(np.asarray(agg.host_values("k")), np.arange(nkeys)):
            raise AssertionError("spark.aggregate keys disagree")
        mean_err = 0.0
        for i in range(width):
            want_m = np.bincount(k_all, weights=x_all[:, i], minlength=nkeys) / counts
            got_m = np.asarray(agg.host_values(f"m{i}"))
            mean_err = max(mean_err, float(np.max(np.abs(got_m - want_m) / np.abs(want_m))))
        if mean_err > 1e-12:
            raise AssertionError(f"spark.aggregate mean rel err {mean_err:.3e} > 1e-12")
        left = os.listdir(ingest_dir)
        if left:
            raise AssertionError(f"ingest files left behind: {left}")
    _emit(
        "spark_bridge", partitions=partitions, rows=rows, columns=width + 1,
        ipc_bytes_per_ingest=rows * (width + 1) * 8,
        reduce_sum_rel_err=sum_err, aggregate_mean_rel_err=mean_err, ingest_dir_removed=True,
    )


def phase_lazy_and_spark(tft, rows: int = 200_000_000, blocks: int = 8, rel_shards: int = 16,
                         rel_groups: int = 8, rel_group_rows: int = 500_000,
                         sort_rows: int = 10_000_000, join_keys: int = 1_000,
                         spark_partitions: int = 16, spark_part_rows: int = 2_000_000) -> None:
    """Phase 13: a fused map chain against the eager one, device- and
    host-resident; a relational plan over a Parquet dataset with the
    optimizer on and off, a sort and a join; and the Spark bridge."""
    import pandas
    import pyarrow

    print(json.dumps({"pyarrow": pyarrow.__version__, "pandas": pandas.__version__}), flush=True)
    _fused_chain(tft, rows, blocks)
    _relational(tft, rel_shards, rel_groups, rel_group_rows)
    _sort_and_join(tft, sort_rows, join_keys)
    _spark_bridge(tft, spark_partitions, spark_part_rows)


# ---------------------------------------------------------------------------
# phase 14: training and the expert FFN
# ---------------------------------------------------------------------------


def _attention_f64(q, k, v, *, causal=False, scale=None):
    """`full_attention` without its float32 cast: the float64 reference's
    attention."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        n = s.shape[-1]
        mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    return torch.matmul(torch.softmax(s, dim=-1), v)


def _grads_vs_f64(what: str, loss_fn, params, batch, names, loss_rtol, grad_rtol):
    """Step 1 in float32 against the same step in float64 on the card:
    the loss within ``loss_rtol``, and the gradient of each leaf ``names``
    (indices into `tree_leaves`) within ``grad_rtol`` of its float64 norm,
    ``||g - g64|| <= grad_rtol * ||g64||``. Returns (loss, loss64, the
    largest of those norm ratios)."""
    from tensorframes_tpu_torch.models.training import tree_leaves, value_and_grad

    leaves = tree_leaves(params)
    loss, grads = value_and_grad(loss_fn, params, *batch)
    params64 = [p.detach().double() for p in leaves]
    loss64, grads64 = value_and_grad(
        lambda ps, *b: loss_fn(_like(params, iter(ps)), *b, f64=True), params64, *batch
    )
    if abs(float(loss) - float(loss64)) > loss_rtol * abs(float(loss64)):
        raise AssertionError(f"{what}: step-1 loss {float(loss)} vs float64 {float(loss64)}")
    worst = 0.0
    for i in names:
        g, g64 = grads[i].double(), grads64[i]
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}: non-finite gradient of leaf {i}")
        ratio = float((g - g64).norm() / g64.norm())
        if not ratio <= grad_rtol:
            raise AssertionError(
                f"{what}: gradient of leaf {i} off its float64 value by {ratio:.3e} of "
                f"its norm (limit {grad_rtol})"
            )
        worst = max(worst, ratio)
    return float(loss), float(loss64), worst


def _like(params, leaves):
    """``params``' structure over ``leaves`` (dict keys sorted, as
    `tree_leaves` flattens them)."""
    if isinstance(params, (dict, torch.nn.ParameterDict)):
        return {k: _like(params[k], leaves) for k in sorted(params)}
    if isinstance(params, (list, tuple)):
        return type(params)(_like(p, leaves) for p in params)
    return next(leaves)


# float32 training step against float64 on the card: the loss within
# rtol 1e-4, and each checked gradient within 1e-3 of its norm. A gradient
# sums 16K tokens' or 65K rows' terms that largely cancel (random tokens
# and labels), so an element near zero carries float32 rounding of the
# much larger terms: the first MLP layer's is off by ~2e-4 of its norm in
# a CPU float64 comparison, 1e-6 absolute against a 2e-3 largest element.
_TRAIN_LOSS_RTOL, _TRAIN_GRAD_RTOL = 1e-4, 1e-3
# Mixtral-width expert FFN (sums of 4,096 and 14,336 products) against float64
_MOE_RTOL, _MOE_ATOL = 1e-4, 1e-5


def _lm_training(tft, cfg, batch: int, steps: int, lr: float) -> dict:
    from tensorframes_tpu_torch.models import TransformerLM
    from tensorframes_tpu_torch.ops.flash_attention import AttentionGradientError, flash_attention
    from tensorframes_tpu_torch.parallel.ring import full_attention
    from tensorframes_tpu_torch.utils.checkpoint import load_params, save_params

    model = TransformerLM(**cfg, seed=SEED, device="cuda")
    seq = cfg["max_seq"]
    tokens = torch.from_numpy(
        np.random.default_rng(SEED + 20).integers(0, cfg["vocab"], (batch, seq)).astype(np.int32)
    ).cuda()

    def lm_loss(params, toks, f64=False):
        return model.loss(params, toks, attention=_attention_f64 if f64 else full_attention)

    keys = sorted(model.params)
    checked = [keys.index(k) for k in ("embed", "l0_qkv", f"l{cfg['n_layers'] - 1}_mlp_down", "ln_f_g")]
    loss1, loss64, grad_err = _grads_vs_f64(
        "TransformerLM", lm_loss, model.params, (tokens,), checked, _TRAIN_LOSS_RTOL,
        _TRAIN_GRAD_RTOL,
    )
    _, first = model.train_step(model.params, tokens, lr=lr)  # step 1
    if abs(float(first) - loss1) > _TRAIN_LOSS_RTOL * abs(loss64):
        raise AssertionError(f"TransformerLM train_step loss {float(first)} vs {loss1}")
    losses = [model.train_step(model.params, tokens, lr=lr)[1] for _ in range(steps)]
    with torch.no_grad():
        after = float(model.loss(model.params, tokens))
    if not after < float(first):
        raise AssertionError(f"TransformerLM: loss {after} after {steps + 1} steps, first {float(first)}")

    # the kernel refuses a gradient on the card too, before any launch
    q = torch.randn(2, 64, 64, device="cuda", requires_grad=True)
    launches = flash_attention.launches
    try:
        flash_attention(q, q, q, causal=True)
    except AttentionGradientError:
        pass
    else:
        raise AssertionError("flash_attention returned an output autograd cannot differentiate")
    if flash_attention.launches != launches:
        raise AssertionError("flash_attention launched while refusing a gradient")

    # parameters round trip: the reloaded model scores as the trained one
    import tempfile

    with tempfile.TemporaryDirectory(prefix="tfs-params-") as tmp:
        path = os.path.join(tmp, "lm.npz")
        save_params(path, model.params)
        fresh = TransformerLM(**cfg, seed=SEED + 1, device="cuda")
        loaded = load_params(path, like=fresh.params)
    with torch.no_grad():
        for k, v in loaded.items():
            fresh.params[k].copy_(v)
        probe = tokens[:1]
        same = torch.equal(
            fresh(probe, attention=full_attention), model(probe, attention=full_attention)
        )
    if not same:
        raise AssertionError("TransformerLM: the reloaded parameters score differently")
    return dict(
        config=cfg, batch=batch, seq=seq, lr=lr, steps_after_step1=steps,
        loss_step1=float(first), loss_step1_f64=loss64, loss_after=after,
        losses=[float(x) for x in losses], grad_leaves_checked=[keys[i] for i in checked],
        max_grad_err_over_norm=grad_err, flash_attention_refuses_grad=True,
        params_round_trip="equal scores",
    )


def _mlp_training(tft, rows: int, steps: int) -> dict:
    import functools

    from tensorframes_tpu_torch.models import MLP, init_opt_state, make_train_step

    sizes = [512, 512, 512, 10]
    model = MLP(sizes, seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    raw = torch.rand(rows, sizes[0], device="cuda", generator=gen)
    labels = torch.randint(0, sizes[-1], (rows,), device="cuda", generator=gen)
    df = tft.TensorFrame([tft.Column("raw", raw)]).repartition(8)
    # the batch is a column a verb produced: autograd must accept it
    feats = tft.map_blocks((tft.block(df, "raw") * 2.0 - 1.0).named("x"), df)
    x = feats.column("x").values
    tx = functools.partial(torch.optim.Adam, lr=1e-3)
    step = make_train_step(model.loss, tx)
    state = init_opt_state(tx, model.params)

    def mlp_loss(params, xb, yb, f64=False):
        if not f64:
            return model.loss(params, xb, yb)
        logp = torch.log_softmax(model.apply(params, xb.double()), dim=-1)
        return -logp.gather(1, yb.long()[:, None]).mean()

    loss1, loss64, grad_err = _grads_vs_f64(
        "MLP", mlp_loss, model.params, (x, labels), list(range(6)), _TRAIN_LOSS_RTOL,
        _TRAIN_GRAD_RTOL,
    )
    _, state, first = step(model.params, state, x, labels)
    if abs(float(first) - loss1) > _TRAIN_LOSS_RTOL * abs(loss64):
        raise AssertionError(f"MLP step loss {float(first)} vs {loss1}")
    for _ in range(steps):
        _, state, _ = step(model.params, state, x, labels)
    with torch.no_grad():
        after = float(model.loss(model.params, x, labels))
    if not after < float(first):
        raise AssertionError(f"MLP: loss {after} after {steps + 1} steps, first {float(first)}")
    return dict(
        sizes=sizes, rows=rows, optimizer="Adam lr 1e-3", steps_after_step1=steps,
        batch_from="map_blocks output column", loss_step1=float(first), loss_step1_f64=loss64,
        loss_after=after, max_grad_err_over_norm=grad_err,
    )


def _moe_forward(tokens: int, checked: int) -> dict:
    """`MoEFFN.apply` at Mixtral-8x7B's published widths (hidden_size 4096,
    intermediate_size 14336, num_local_experts 8, num_experts_per_tok 2),
    the JAX package's gelu FFN, float32."""
    from tensorframes_tpu_torch.models import MoEFFN

    d, h, e, k = 4096, 14336, 8, 2
    model = MoEFFN(d, h, e, k, seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    x = torch.randn(tokens, d, device="cuda", generator=gen)
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    with torch.no_grad():
        out = model(x)
    if tuple(out.shape) != (tokens, d) or not torch.isfinite(out).all():
        raise AssertionError(f"MoEFFN: bad output {tuple(out.shape)}")
    # float64 on the first rows with the float32 run's routing
    p = model.params
    with torch.no_grad():
        xs = x[:checked]
        topi = torch.topk(xs @ p["gate"], k, dim=-1).indices
        x64 = xs.double()
        logits64 = x64 @ p["gate"].double()
        w64 = torch.zeros_like(logits64).scatter_add(
            -1, topi, torch.softmax(logits64.gather(-1, topi), dim=-1)
        )
        ref = torch.zeros(checked, d, dtype=torch.float64, device="cuda")
        for i in range(e):
            hid = torch.nn.functional.gelu(x64 @ p["w1"][i].double(), approximate="tanh")
            ref += w64[:, i:i + 1] * (hid @ p["w2"][i].double())
    err = _check_close("MoEFFN vs float64", out[:checked].double(), ref, _MOE_RTOL, _MOE_ATOL)
    return dict(
        widths=dict(hidden_size=d, intermediate_size=h, num_local_experts=e, num_experts_per_tok=k),
        tokens=tokens, weight_bytes=weight_bytes, checked_tokens=checked,
        max_abs_err=err, tolerance={"rtol": _MOE_RTOL, "atol": _MOE_ATOL},
    )


def phase_training_and_moe(tft, cfg, lm_batch: int = 8, lm_steps: int = 5, lm_lr: float = 0.1,
                           mlp_rows: int = 65_536, mlp_steps: int = 10, moe_tokens: int = 4096,
                           moe_checked: int = 256) -> None:
    """Phase 14: `TransformerLM` SGD steps at phase 7's widths through the
    plain attention (`full_attention`), the MLP trained by Adam through
    `make_train_step` on a column `map_blocks` produced, the expert FFN at
    Mixtral's widths, and a parameter checkpoint round trip. Every step 1
    is held against float64 on the card."""
    torch.cuda.empty_cache()
    lm = _lm_training(tft, cfg, lm_batch, lm_steps, lm_lr)
    torch.cuda.empty_cache()
    mlp = _mlp_training(tft, mlp_rows, mlp_steps)
    torch.cuda.empty_cache()
    moe = _moe_forward(moe_tokens, moe_checked)
    torch.cuda.empty_cache()
    _emit(
        "training_and_moe", lm_training=lm, mlp_training=mlp, moe_forward=moe,
        tolerance={"loss_rtol": _TRAIN_LOSS_RTOL, "grad_rtol_of_norm": _TRAIN_GRAD_RTOL},
    )


# ---------------------------------------------------------------------------
# phase 15: the serving runtime
# ---------------------------------------------------------------------------


#: the slowest a served request may be in phase 15: tens of ms is the norm,
#: and a dropped connect costs 1 s, then 3, 7, ... s of SYN retransmits
_SERVE_MAX_REQUEST_S = 5.0


def _check_latencies(what: str, lat) -> None:
    slowest = max(lat)
    if slowest > _SERVE_MAX_REQUEST_S:
        raise AssertionError(
            f"serving {what}: a request took {slowest:.2f} s (bound {_SERVE_MAX_REQUEST_S} s)"
        )


def _clients_round(n_clients: int, work, what: str):
    """Run ``work(client_index)`` on ``n_clients`` threads started
    together. Raises the first error a client met, and fails when a
    request outlasts ``_SERVE_MAX_REQUEST_S``."""
    import threading

    lat, errors = [], []
    barrier = threading.Barrier(n_clients + 1)

    def run(i):
        try:
            barrier.wait(timeout=60)
            lat.extend(work(i))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n_clients)]
    for t in threads:
        t.start()
    barrier.wait(timeout=60)
    for t in threads:
        t.join(timeout=300)
    if any(t.is_alive() for t in threads):
        raise AssertionError("serving: a client thread did not finish within 300 s")
    if errors:
        raise errors[0]
    _check_latencies(what, lat)


def _serving_batched(tft, url, clients: int, requests: int, rows: int, max_batch_rows: int):
    """(a) `benchmarks/serving_bench.py`'s endpoint at its sizes over HTTP."""
    from tensorframes_tpu_torch.runtime.executor import default_executor

    x = tft.dsl.placeholder(tft.ScalarType.float32, tft.Shape((None,)), name="x")
    two = tft.dsl.constant(np.float32(2.0))
    one = tft.dsl.constant(np.float32(1.0))
    fetch = ((((x * two) + one) * ((x * x) + two)) + one).named("score")
    ep = tft.serving.register(
        "bench", fetch, {"x": "float32"}, max_batch_rows=max_batch_rows, device="cuda"
    )
    ex = default_executor()
    compiles0 = ex.compile_count
    rng = np.random.RandomState(SEED)
    # off-rung sizes: the batcher's padding path is the one under test
    reqs = [rng.rand(rows - 1 - (i % 7)).astype(np.float32) for i in range(requests)]
    direct = [
        tft.map_blocks(fetch, tft.TensorFrame.from_dict({"x": r}), device="cuda")
        .column("score").host_values()
        for r in reqs
    ]
    client = tft.serving.ServingClient(url)

    def check(i, out):
        if not np.array_equal(out.column("score").host_values(), direct[i]):
            raise AssertionError(f"serving (a): request {i} is not bit-identical to map_blocks")

    # one request first, outside the latency bound: the client's first
    # call imports pyarrow
    check(0, client.run("bench", {"x": reqs[0]}, timeout_s=60.0))
    lat_serial = []
    for i, r in enumerate(reqs):
        t1 = time.perf_counter()
        out = client.run("bench", {"x": r}, timeout_s=60.0, request_id=f"s{i}")
        lat_serial.append(time.perf_counter() - t1)
        check(i, out)
    _check_latencies("(a) serial", lat_serial)

    b = tft.serving.batcher()
    before = b.snapshot()
    per_client = requests // clients

    def work(c):
        lat = []
        cl = tft.serving.ServingClient(url)
        for k in range(per_client):
            i = c * per_client + k
            t1 = time.perf_counter()
            out = cl.run("bench", {"x": reqs[i]}, timeout_s=60.0, request_id=f"c{i}")
            lat.append(time.perf_counter() - t1)
            check(i, out)
        return lat

    _clients_round(clients, work, "(a) concurrent")
    after = b.snapshot()
    batches = after["batches"] - before["batches"]
    batched = after["batched_requests"] - before["batched_requests"]
    if batched != clients * per_client or batches >= batched:
        raise AssertionError(
            f"serving (a): {batched} requests in {batches} batches; they did not coalesce"
        )
    compile_delta = ex.compile_count - compiles0
    if compile_delta != 0:
        raise AssertionError(f"serving (a): {compile_delta} new lowerings after warm()")
    return dict(
        clients=clients, requests=requests, rows_per_request=[rows - 7, rows - 1],
        max_batch_rows=max_batch_rows, warmed_rungs=len(ep.warmed_rungs),
        batches=batches, requests_batched=batched, mean_fill=batched / batches,
        compile_count_delta_after_warm=compile_delta, bit_identical=True,
    ), 2 * requests + 1


def _serving_mlp(tft, url, clients: int, per_client: int, rows: int):
    """(b) the MLP scoring endpoint at BASELINE config 3's widths."""
    from tensorframes_tpu_torch.models import MLP

    sizes = [512, 512, 512, 10]
    rng = np.random.default_rng(SEED)
    params = [
        (
            (rng.standard_normal((a, b)) * math.sqrt(2.0 / a)).astype(np.float32),
            (rng.standard_normal(b) * 0.1).astype(np.float32),
        )
        for a, b in zip(sizes[:-1], sizes[1:])
    ]
    probs = MLP.from_jax_params(params).scoring_graph("features", block=True)
    ep = tft.serving.register(
        "mlp", probs, {"features": ("float32", [sizes[0]])}, device="cuda"
    )
    if ep.batchable:
        raise AssertionError("serving (b): the MLP endpoint must not be batchable")
    feats = [
        rng.standard_normal((rows, sizes[0])).astype(np.float32) for _ in range(clients * per_client)
    ]
    # each client's first request is checked against a direct map_blocks
    direct = [
        tft.map_blocks(
            probs, tft.TensorFrame.from_dict({"features": feats[c * per_client]}), device="cuda"
        ).column("probs").values
        for c in range(clients)
    ]
    errs = []

    def work(c):
        lat = []
        cl = tft.serving.ServingClient(url)
        for k in range(per_client):
            i = c * per_client + k
            t1 = time.perf_counter()
            out = cl.run("mlp", {"features": feats[i]}, timeout_s=60.0, request_id=f"m{i}")
            lat.append(time.perf_counter() - t1)
            if k == 0:
                got = torch.from_numpy(out.column("probs").host_values())
                errs.append(_check_close(
                    f"serving (b) request {i}", got, direct[c].cpu(), _MLP_RTOL, _MLP_ATOL
                ))
        return lat

    inline0 = tft.serving.batcher().snapshot()["inline"]
    _clients_round(clients, work, "(b)")
    n = clients * per_client
    if tft.serving.batcher().snapshot()["inline"] - inline0 != n:
        raise AssertionError("serving (b): the MLP requests did not dispatch inline")
    return dict(
        clients=clients, requests=n, rows_per_request=rows, sizes=sizes,
        request_mib=rows * sizes[0] * 4 / 2**20,
        max_abs_err=max(errs), tolerance={"rtol": _MLP_RTOL, "atol": _MLP_ATOL},
    ), n


def _http_error(url: str, body: bytes, headers: dict):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST", headers=headers)
    try:
        urllib.request.urlopen(req, timeout=30)
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Retry-After"), json.loads(e.read().decode())
    raise AssertionError(f"serving (c): POST {url} did not fail")


def _serving_errors(tft, handle, sent: int):
    """(c) 429 and 504 under an injected hang, the scrapes, and drain()."""
    import threading
    import urllib.request

    from tensorframes_tpu_torch import config
    from tensorframes_tpu_torch.testing import faults as chaos

    base = f"http://{handle.host}:{handle.port}"
    client = tft.serving.ServingClient(handle.url)
    x = {"x": np.ones(2041, np.float32)}
    body = tft.io.frame_to_ipc_bytes(tft.TensorFrame.from_dict(x))
    held = []

    def hold():
        held.append(client.run("bench", x, timeout_s=30.0))

    def wait_for(cond, what):
        deadline = time.monotonic() + 30.0
        while not cond():
            if time.monotonic() > deadline:
                raise AssertionError(f"serving (c): timed out waiting for {what}")
            time.sleep(0.01)

    with config.override(serve_queue_limit=1):
        with chaos.inject(rate=1.0, seed=1, fault="hang", delay_s=3.0, max_faults=1) as plan:
            threads = [threading.Thread(target=hold)]
            threads[0].start()
            wait_for(lambda: plan.injected == 1, "the lane's dispatcher to enter the hang")
            threads.append(threading.Thread(target=hold))
            threads[1].start()
            wait_for(lambda: tft.serving.batcher().pending() == 1, "the second request to queue")
            code, retry_after, payload = _http_error(
                handle.url + "/bench", body, {"X-TFS-Timeout-S": "30"}
            )
            for t in threads:
                t.join(timeout=60)
    if code != 429 or payload["error"] != "OverloadError" or int(retry_after) < 1:
        raise AssertionError(f"serving (c): expected 429 + Retry-After, got {code} {retry_after}")
    if len(held) != 2:
        raise AssertionError("serving (c): the held requests did not finish")

    # the 504 must come within 3 s of its budget
    budget = 0.3
    t0 = time.perf_counter()
    with chaos.inject(rate=1.0, seed=1, fault="hang", delay_s=30.0):
        try:
            client.run("bench", x, timeout_s=budget)
            raise AssertionError("serving (c): a hung request did not time out")
        except tft.DeadlineExceeded:
            pass
    deadline_s = time.perf_counter() - t0
    if deadline_s > budget + 3.0:
        raise AssertionError(f"serving (c): the 504 took {deadline_s:.2f} s for a {budget} s budget")
    sent += 4

    metrics = urllib.request.urlopen(base + "/metrics", timeout=30).read().decode()
    served = sum(
        float(line.rsplit(" ", 1)[1])
        for line in metrics.splitlines() if line.startswith("tfs_serve_requests{")
    )
    if served != sent:
        raise AssertionError(f"serving (c): /metrics counts {served} requests, {sent} were sent")
    health = json.loads(urllib.request.urlopen(base + "/healthz", timeout=30).read())
    rows = health["devices"]
    name = torch.cuda.get_device_name(0)
    if health["status"] != "ok" or [r["device"] for r in rows][:1] != ["cuda:0"] \
            or rows[0]["device_kind"] != name:
        raise AssertionError(f"serving (c): /healthz says {health}")
    trace = json.loads(urllib.request.urlopen(base + "/trace", timeout=30).read())
    traced = sum(1 for e in trace["traceEvents"] if e["cat"] == "verb" and "request" in e["args"])
    if not traced:
        raise AssertionError("serving (c): no verb span in /trace carries a request id")

    acct = tft.serving.drain(timeout_s=30.0)
    try:
        urllib.request.urlopen(base + "/healthz", timeout=5)
        raise AssertionError("serving (c): the port still answers after drain()")
    except OSError:
        pass
    return dict(
        overload_status=code, retry_after=retry_after, deadline_status=504,
        deadline_budget_s=budget, metrics_serve_requests=served,
        healthz_status=health["status"], healthz_devices=rows, trace_verb_spans_with_request=traced,
        drained=acct["drained"], stopped_server=acct["stopped_server"],
    )


def phase_serving(tft, clients: int = 8, requests: int = 48, rows: int = 2048,
                  max_batch_rows: int = 16_384, mlp_per_client: int = 16,
                  mlp_rows: int = 2048) -> None:
    """Phase 15: the serving runtime on the card, through `ServingClient`
    over loopback HTTP: (a) `serving_bench.py`'s batchable endpoint, (b)
    BASELINE config 3's MLP, which dispatches inline, (c) the error paths,
    the scrapes and a drain."""
    from tensorframes_tpu_torch.utils import telemetry

    tft.serving.reset()
    telemetry.reset()
    handle = tft.serving.serve(port=0)
    try:
        batched, sent_a = _serving_batched(tft, handle.url, clients, requests, rows, max_batch_rows)
        mlp, sent_b = _serving_mlp(tft, handle.url, clients, mlp_per_client, mlp_rows)
        errors = _serving_errors(tft, handle, sent_a + sent_b)
    finally:
        tft.serving.reset()
        telemetry.shutdown()
    _emit("serving", batched=batched, mlp=mlp, error_paths=errors)


def _runtime_autotune(tft) -> dict:
    """The autotuner over the live profile phase 15's serving traffic left
    (taken before this phase resets the telemetry): the same
    recommendations twice, and a knob pinned through `update()` that
    `apply` leaves alone."""
    from tensorframes_tpu_torch.runtime import autotune as at

    first = tft.autotune(apply_recommendations=False)
    second = tft.autotune(apply_recommendations=False)
    if first["recommendations"] != second["recommendations"]:
        raise AssertionError(
            f"autotune is not deterministic: {first['recommendations']} vs "
            f"{second['recommendations']}"
        )
    knob = "serve_batch_window_ms"
    value = tft.config.get().serve_batch_window_ms
    tft.config.update(**{knob: value})  # an operator pin
    recs = at.recommend() + [
        at.Recommendation(knob, "config", value, value * 2, "pinned-knob check")
    ]
    decisions = at.apply(recs)
    pinned = [d for d in decisions if d["knob"] == knob and d["scope"] == "config"]
    if (
        not pinned or any(d["outcome"] != "skipped:pinned" for d in pinned)
        or tft.config.get().serve_batch_window_ms != value or knob in tft.config.tuned()
    ):
        raise AssertionError(f"apply moved the pinned knob {knob}: {pinned}")
    tft.config.reset_tuning()
    return {
        "recommendations": first["recommendations"],
        "decisions": [(d["knob"], d["scope"], d["outcome"]) for d in decisions],
    }


def _ledger_workloads(tft, ex, rows: int, blocks: int, mlp_rows: int):
    """Phase 3's x+3 map and phase 4's MLP map_rows (graph route), with
    the ledger and telemetry reset, run through the executor ``ex``: the
    x+3 map twice, the MLP once. Returns the frame, the x+3 graph and the
    MLP's sizes; holds the outputs to their references."""
    from tensorframes_tpu_torch.models import MLP
    from tensorframes_tpu_torch.runtime import costmodel
    from tensorframes_tpu_torch.utils import telemetry

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.rand(rows, device="cuda", generator=gen)
    df = tft.TensorFrame([tft.Column("x", x)]).repartition(blocks)
    z = (tft.block(df, "x") + 3.0).named("z")

    sizes = [512, 512, 512, 10]
    rng = np.random.default_rng(SEED)
    params = [
        (
            (rng.standard_normal((a, b)) * math.sqrt(2.0 / a)).astype(np.float32),
            (rng.standard_normal(b) * 0.1).astype(np.float32),
        )
        for a, b in zip(sizes[:-1], sizes[1:])
    ]
    probs = MLP.from_jax_params(params).scoring_graph("features", block=False)
    feats = torch.rand(mlp_rows, sizes[0], device="cuda", generator=gen)
    mdf = tft.TensorFrame([tft.Column("features", feats)])
    torch.cuda.synchronize()
    telemetry.reset()
    costmodel.reset()

    for _ in range(2):
        out = tft.map_blocks(z, df, executor=ex)
    if not torch.equal(out.column("z").values, x + 3.0):
        raise AssertionError("phase 16 map_blocks x+3 disagrees with x + 3")
    del out
    got = tft.map_rows(probs, mdf, executor=ex).column("probs").values
    if tuple(got.shape) != (mlp_rows, sizes[-1]) or not torch.isfinite(got).all():
        raise AssertionError(f"phase 16 map_rows MLP: bad output {tuple(got.shape)}")
    torch.cuda.synchronize()
    return df, z, sizes


def _check_ledger(tft, ex, rows: int, blocks: int, mlp_rows: int, sizes) -> dict:
    """Every cached program has flops, bytes and a footprint; the MLP's
    flops and the x+3 map's bytes equal their hand counts."""
    diag = tft.diagnostics(ex, format="json")
    costs = {r["program"]: r for r in diag["cost"]["programs"]}
    kinds = {str(k[1]): k[0] for k in ex.cache_keys()}
    if set(kinds.values()) != {"block", "vmap-rows"}:
        raise AssertionError(f"phase 16 cached {sorted(kinds.values())}")
    rows_out = {}
    for fp, kind in kinds.items():
        r = costs[fp]
        for key in ("flops_per_exec", "bytes_per_exec", "footprint_bytes"):
            if not r[key]:
                raise AssertionError(f"program {kind} ({fp}) has no {key}: {r}")
        rows_out[kind] = {
            "program": fp, "execs": r["execs"], "dispatches": r["dispatches"],
            "flops_per_exec": r["flops_per_exec"], "bytes_per_exec": r["bytes_per_exec"],
            "footprint_bytes": r["footprint_bytes"],
        }
    block_rows = rows // blocks
    if rows_out["block"]["bytes_per_exec"] != 2 * 4 * block_rows:
        raise AssertionError(
            f"x+3 bytes/exec {rows_out['block']['bytes_per_exec']} != 2*4*{block_rows}"
        )
    if rows_out["block"]["execs"] != 2 * blocks:
        raise AssertionError(f"x+3 execs {rows_out['block']['execs']} != {2 * blocks}")
    # per row: the three products at 2 flops a multiply-add; by the
    # ledger's convention also the bias adds, the ReLUs and the softmax
    # (4N - 1 over the 10 logits)
    mm = 2 * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    elementwise = sum(sizes[1:]) + sum(sizes[1:-1]) + (4 * sizes[-1] - 1)
    want = mlp_rows * (mm + elementwise)
    got = rows_out["vmap-rows"]["flops_per_exec"]
    if abs(got - want) > 0.01 * want:
        raise AssertionError(f"MLP flops/exec {got} vs 2*rows*(...) + elementwise = {want}")
    return {
        "programs": rows_out, "mlp_flops_expected": want,
        "mlp_matmul_flops": mlp_rows * mm, "memory": diag["memory"],
    }


def _http_surface(tft) -> dict:
    """/diagnostics and /profile answer 200 with the same program set; a
    snapshot survives save -> load."""
    import tempfile
    import urllib.request

    from tensorframes_tpu_torch.runtime import profiler
    from tensorframes_tpu_torch.utils import telemetry

    handle = telemetry.serve(port=0)
    try:
        got = {}
        for route in ("/diagnostics", "/profile"):
            with urllib.request.urlopen(handle.url + route, timeout=60) as r:
                if r.status != 200:
                    raise AssertionError(f"{route} answered {r.status}")
                got[route] = json.loads(r.read())
    finally:
        telemetry.shutdown()
    ledger = {p["program"] for p in got["/diagnostics"]["cost"]["programs"] if p["execs"]}
    if ledger != set(got["/profile"]["programs"]):
        raise AssertionError(
            f"/diagnostics programs {sorted(ledger)} != /profile {sorted(got['/profile']['programs'])}"
        )
    snap = profiler.snapshot(note="phase 16")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "profile.json")
        snap.save(path)
        loaded = profiler.load(path)
    if loaded.to_dict() != json.loads(json.dumps(snap.to_dict())):
        raise AssertionError("profile save -> load changed the snapshot")
    return {"programs": sorted(ledger)}


def _genuine_oom_split(tft, rows: int) -> dict:
    """One block whose program needs about 4 blocks of memory (four chained
    elementwise ops keep their results until the block returns) runs out
    of memory under a cap of 3.25 blocks above what is live, while each
    half needs at most 2.5: the verb splits on a real
    `torch.cuda.OutOfMemoryError` and the result equals the uncapped run.
    Then the same for `reduce_blocks` of a sum over that transform, which
    combines the halves by the monoid."""
    from tensorframes_tpu_torch.runtime import faults

    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    x = torch.rand(rows, device="cuda", generator=gen)
    df = tft.TensorFrame([tft.Column("x", x)])
    xb = tft.block(df, "x")
    chain = (((xb + 3.0) * 2.0 - 1.0) * 0.5)
    zmap = chain.named("z")
    xin = tft.block(df, "x", tf_name="x_input")
    zred = tft.dsl.reduce_sum((((xin + 3.0) * 2.0 - 1.0) * 0.5), axes=[0]).named("x")
    ref = tft.map_blocks(zmap, df).column("z").values
    torch.cuda.synchronize()
    block_bytes = rows * 4
    total = torch.cuda.get_device_properties(0).total_memory
    out = {"rows": rows, "block_bytes": block_bytes}
    for what, run in (
        ("map_blocks", lambda: tft.map_blocks(zmap, df).column("z").values),
        ("reduce_blocks", lambda: tft.reduce_blocks(zred, df)),
    ):
        faults.reset_ledger()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved()
        cap = base + 3.25 * block_bytes
        torch.cuda.set_per_process_memory_fraction(cap / total)
        try:
            got = run()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
        led = faults.ledger_snapshot()
        snaps = faults.forensics_snapshot()
        if led["splits"] < 1 or led["resource"] < 1:
            raise AssertionError(f"{what}: no OOM split under the cap: {led}")
        if not snaps or not snaps[0]["error"].startswith("OutOfMemoryError"):
            raise AssertionError(f"{what}: the OOM was not genuine: {snaps[:1]}")
        dev = snaps[0]["devices"][0] if snaps[0]["devices"] else {}
        if dev.get("device") != "cuda:0" or not dev.get("bytes_in_use"):
            raise AssertionError(f"{what}: forensics name no cuda:0 bytes_in_use: {dev}")
        if what == "map_blocks":
            if not torch.equal(got, ref):
                raise AssertionError("OOM-split map_blocks differs from the uncapped run")
            err = 0.0
        else:
            xh = x.cpu().numpy().astype(np.float64)
            want = float((((xh + 3.0) * 2.0 - 1.0) * 0.5).sum())
            err = abs(got.item() - want) / abs(want)
            if err > _SUM_RTOL:
                raise AssertionError(f"OOM-split reduce_sum rel err {err:.3e} > {_SUM_RTOL}")
        out[what] = {
            "cap_bytes": cap, "live_before_bytes": base, "splits": led["splits"],
            "resource": led["resource"], "decisions": [s["decision"] for s in snaps],
            "bytes_in_use_at_fault": dev["bytes_in_use"], "rel_err": err,
        }
        del got
    return out


def _numerics_guard(tft, df, z, ex, blocks: int) -> dict:
    """check_numerics on the 200M-row x+3 map: one host sync a block;
    ``x / 0.0`` raises naming the block and fetch."""
    from tensorframes_tpu_torch.utils.profiling import reset_stats, stats

    with tft.config.override(check_numerics=True):
        tft.map_blocks(z, df, executor=ex)
        reset_stats()
        tft.map_blocks(z, df, executor=ex)
        syncs = stats().get("host_sync", 0)
        bad = (tft.block(df, "x") / 0.0).named("bad")
        try:
            tft.map_blocks(bad, df, executor=ex)
        except FloatingPointError as e:
            msg = str(e)
        else:
            raise AssertionError("x / 0.0 under check_numerics did not raise")
    if syncs != blocks:
        raise AssertionError(f"check_numerics cost {syncs} host syncs for {blocks} blocks")
    if not msg.startswith("map_blocks block 0: fetch 'bad' contains"):
        raise AssertionError(f"numerics message: {msg}")
    return {"host_syncs": syncs, "message": msg}


def phase_runtime_services(tft, rows: int = 200_000_000, blocks: int = 8,
                           mlp_rows: int = 1_000_000, oom_rows: int = 1 << 28) -> None:
    """Phase 16: the cost ledger's counts on phase 3's x+3 map and phase
    4's MLP, /diagnostics and /profile, the autotuner over phase 15's
    serving profile, a genuine OOM split, and the numerics guard."""
    from tensorframes_tpu_torch.runtime.executor import Executor

    autotune = _runtime_autotune(tft)
    ex = Executor()
    df, z, sizes = _ledger_workloads(tft, ex, rows, blocks, mlp_rows)
    ledger = _check_ledger(tft, ex, rows, blocks, mlp_rows, sizes)
    http = _http_surface(tft)
    numerics = _numerics_guard(tft, df, z, ex, blocks)
    del df
    torch.cuda.empty_cache()
    oom = _genuine_oom_split(tft, oom_rows)
    torch.cuda.empty_cache()
    _emit(
        "runtime_services", rows=rows, blocks=blocks, mlp_rows=mlp_rows,
        ledger=ledger, http=http, autotune=autotune, oom_split=oom, numerics=numerics,
    )


# ---------------------------------------------------------------------------
# phase 17: the mesh verbs
# ---------------------------------------------------------------------------


def _mesh_dispatches():
    """(name, shards) of every mesh dispatch span in the telemetry ring."""
    from tensorframes_tpu_torch.utils import telemetry

    return [(s.name, s.attrs.get("shards")) for s in telemetry.spans()
            if s.kind == "dispatch" and s.name.startswith("mesh.")]


def _mesh_and_local(what: str, local_call, mesh_call):
    """(local result, mesh result, the mesh call's dispatch spans): the
    mesh call's dispatch spans are those of its second call."""
    from tensorframes_tpu_torch.utils import telemetry

    local = local_call()
    mesh_call()
    telemetry.reset()
    meshed = mesh_call()
    spans = _mesh_dispatches()
    if not spans or spans[0][1] != torch.cuda.device_count():
        raise AssertionError(f"{what}: mesh dispatch spans {spans}")
    return local, meshed, spans


def phase_mesh_verbs(tft, rows: int = 200_000_000, blocks: int = 8, mlp_rows: int = 1_000_000,
                     agg_rows: int = 100_000_000, dim: int = 8, nkeys: int = 16) -> None:
    """Phase 17: the five verbs with ``mesh=data_mesh()`` (every visible
    card), each against the local verb on the same data: phase 3's x+3
    `map_blocks` and `reduce_blocks` sum / min over ``rows`` float32 rows,
    phase 4's MLP `map_rows` over ``mlp_rows`` rows, a keyed sum over
    ``agg_rows`` x ``dim`` float32 rows and ``nkeys`` keys through the
    segment plan, and phase 5's mean / mean-of-squares graph through the
    same plan (one segment table a shard, combined by each fetch's monoid,
    a mean over the group counts); `reduce_rows` folds phase
    3's column on the mesh. Maps, min and max `torch.equal` the local verb;
    sums rtol 1e-5 against numpy float64."""
    from tensorframes_tpu_torch.models import MLP
    from tensorframes_tpu_torch.parallel import data_mesh

    dsl = tft.dsl
    mesh = data_mesh()
    ndev = int(mesh.devices.size)
    if ndev != torch.cuda.device_count():
        raise AssertionError(f"data_mesh() holds {ndev} devices, the machine {torch.cuda.device_count()}")
    out = dict(devices=ndev, mesh=repr(mesh))

    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    x = torch.rand(rows, device="cuda", generator=gen)
    df = tft.TensorFrame([tft.Column("x", x)]).repartition(blocks)
    z = (tft.block(df, "x") + 3.0).named("z")
    local, meshed, spans = _mesh_and_local(
        "map_blocks", lambda: tft.map_blocks(z, df), lambda: tft.map_blocks(z, df, mesh=mesh))
    mz = meshed.column("z").values
    if not (torch.equal(mz, local.column("z").values) and torch.equal(mz, x + 3.0)):
        raise AssertionError("mesh map_blocks x+3 differs from the local verb")
    out["map_blocks"] = dict(rows=rows, dispatch_spans=spans)
    del local, meshed, mz

    xh = x.cpu().numpy()
    for name, op in (("reduce_sum", dsl.reduce_sum), ("reduce_min", dsl.reduce_min)):
        g = op(tft.block(df, "x", tf_name="x_input")).named("x")
        local, meshed, spans = _mesh_and_local(
            name, lambda: tft.reduce_blocks(g, df), lambda: tft.reduce_blocks(g, df, mesh=mesh))
        if name == "reduce_min":
            if not (torch.equal(meshed, local) and meshed.item() == xh.min()):
                raise AssertionError("mesh reduce_min differs from the local verb or numpy")
            err = 0.0
        else:
            want = float(xh.sum(dtype=np.float64))
            err = abs(meshed.item() - want) / want
            if meshed.dtype != torch.float32 or err > _SUM_RTOL:
                raise AssertionError(f"mesh reduce_sum rel err {err:.3e} > {_SUM_RTOL}")
        out[name] = dict(rows=rows, rel_err=err, dispatch_spans=spans)

    pair = _pair_graph(tft, dsl.add)
    local, meshed, spans = _mesh_and_local(
        "reduce_rows", lambda: tft.reduce_rows(pair, df), lambda: tft.reduce_rows(pair, df, mesh=mesh))
    want = float(xh.sum(dtype=np.float64))
    err = abs(meshed.item() - want) / want
    if err > _SUM_RTOL:
        raise AssertionError(f"mesh reduce_rows sum rel err {err:.3e} > {_SUM_RTOL}")
    out["reduce_rows"] = dict(rows=rows, rel_err=err, dispatch_spans=spans)
    del df, x, xh

    sizes = [512, 512, 512, 10]
    rng = np.random.default_rng(SEED)
    params = [
        ((rng.standard_normal((a, b)) * math.sqrt(2.0 / a)).astype(np.float32),
         (rng.standard_normal(b) * 0.1).astype(np.float32))
        for a, b in zip(sizes[:-1], sizes[1:])
    ]
    probs = MLP.from_jax_params(params).scoring_graph("features", block=False)
    feats = torch.rand(mlp_rows, sizes[0], device="cuda", generator=gen)
    fdf = tft.TensorFrame([tft.Column("features", feats)])
    local, meshed, spans = _mesh_and_local(
        "map_rows", lambda: tft.map_rows(probs, fdf), lambda: tft.map_rows(probs, fdf, mesh=mesh))
    mp, lp = meshed.column("probs").values, local.column("probs").values
    if ndev == 1 and not torch.equal(mp, lp):
        raise AssertionError("mesh map_rows MLP differs from the local verb")
    # over several cards each shard's products run at its own row count,
    # for which cuBLAS may pick another kernel: the MLP's float tolerance
    mlp_err = _check_close("mesh map_rows MLP", mp.to(lp.device), lp, _MLP_RTOL, _MLP_ATOL)
    out["map_rows_mlp"] = dict(rows=mlp_rows, max_abs_err=mlp_err, dispatch_spans=spans)
    del local, meshed, fdf, feats

    v = torch.rand(agg_rows, dim, device="cuda", generator=gen)
    keys = torch.arange(agg_rows, device="cuda") % nkeys
    adf = tft.TensorFrame([tft.Column("k", keys), tft.Column("v", v)])
    grouped = tft.group_by(adf, "k")
    kh, vh = keys.cpu().numpy(), v.cpu().numpy()
    counts = np.bincount(kh, minlength=nkeys).astype(np.float64)
    want_s = np.stack([np.bincount(kh, weights=vh[:, j].astype(np.float64), minlength=nkeys)
                       for j in range(dim)], 1)
    want_q = np.stack([np.bincount(kh, weights=vh[:, j].astype(np.float64) ** 2,
                                   minlength=nkeys) for j in range(dim)], 1)
    del vh
    total = dsl.reduce_sum(dsl.block(adf, "v", tf_name="v_input"), axes=[0]).named("v")
    local, meshed, spans = _mesh_and_local(
        "aggregate sum", lambda: tft.aggregate(total, grouped),
        lambda: tft.aggregate(total, grouped, mesh=mesh))
    if spans[0][0] != "mesh.aggregate.segment":
        raise AssertionError(f"mesh aggregate sum took {spans}")
    errs = [_check_close(f"{w} aggregate sum",
                         torch.from_numpy(r.host_values("v").astype(np.float64)),
                         torch.from_numpy(want_s), _SUM_RTOL, 0.0)
            for w, r in (("mesh", meshed), ("local", local))]
    out["aggregate_segment"] = dict(rows=agg_rows, dim=dim, keys=nkeys, max_abs_err=errs[0],
                                    dispatch_spans=spans)
    m = dsl.reduce_mean(dsl.block(adf, "v", tf_name="m_input"), axes=[0]).named("m")
    q = dsl.reduce_mean(dsl.square(dsl.block(adf, "v", tf_name="q_input")), axes=[0]).named("q")
    feed = {"m_input": "v", "q_input": "v"}
    local, meshed, spans = _mesh_and_local(
        "aggregate general", lambda: tft.aggregate([m, q], grouped, feed_dict=feed),
        lambda: tft.aggregate([m, q], grouped, feed_dict=feed, mesh=mesh))
    if spans != [("mesh.aggregate.segment", ndev)]:
        raise AssertionError(f"mesh aggregate general took {spans}")
    errs = [
        _check_close(f"mesh aggregate {c}", torch.from_numpy(meshed.host_values(c).astype(np.float64)),
                     torch.from_numpy(w / counts[:, None]), _SUM_RTOL, 0.0)
        for c, w in (("m", want_s), ("q", want_q))
    ]
    out["aggregate_general"] = dict(rows=agg_rows, dim=dim, keys=nkeys, max_abs_err=max(errs),
                                    local_plan="segment", dispatch_spans=spans)
    del local, meshed, adf, grouped, v, keys
    torch.cuda.empty_cache()
    _emit("mesh_verbs", sum_rtol=_SUM_RTOL, **out)


# ---------------------------------------------------------------------------
# phase 18: the block scheduler, device failover and GlobalFrame
# ---------------------------------------------------------------------------


def _sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _lies_on(t: torch.Tensor, i: int) -> bool:
    """Whether ``t`` is on card ``i``: a shard that fell to the host fails."""
    return t.device == torch.device("cuda", i)


def _span_labels(prefix: str):
    """The device label of every dispatch span named ``prefix...``."""
    from tensorframes_tpu_torch.utils import telemetry

    return [s.attrs.get("device") for s in telemetry.spans()
            if s.kind == "dispatch" and s.name.startswith(prefix)]


def _scheduled(tft, ex, what: str, call, span: str, items: int, ndev: int):
    """A scheduled call, run twice: the second's result, each of its
    dispatch spans labelled with a card, and the executor's per-card
    dispatch ledger summing to ``items``."""
    from tensorframes_tpu_torch.utils import telemetry

    call()
    ex.device_dispatches.clear()
    telemetry.reset()
    out = call()
    _sync_all()
    labels = _span_labels(span)
    cards = {f"cuda:{i}" for i in range(ndev)}
    if len(labels) != items or not set(labels) <= cards:
        raise AssertionError(f"{what}: dispatch span labels {labels}, cards {sorted(cards)}")
    if sum(ex.device_dispatches.values()) != items:
        raise AssertionError(f"{what}: device_dispatches {ex.device_dispatches} for {items} items")
    return out, dict(ex.device_dispatches)


def _scheduled_verbs(tft, ndev: int, rows: int, blocks: int, mlp_rows: int,
                     agg_rows: int, nkeys: int) -> dict:
    """Phase 3's x+3 map and sum / min reduces, the reduce_rows sum, phase
    4's MLP and an exact-plan keyed sum, with ``devices=[0, ...]`` under
    ``block_scheduler="on"``, against the local verb on cuda:0."""
    from tensorframes_tpu_torch.models import MLP
    from tensorframes_tpu_torch.runtime.executor import Executor

    dsl = tft.dsl
    devices = list(range(ndev))
    ex = Executor()
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    x = torch.rand(rows, device="cuda:0", generator=gen)
    df = tft.TensorFrame([tft.Column("x", x)]).repartition(blocks)
    z = (tft.block(df, "x") + 3.0).named("z")
    with tft.config.override(block_scheduler="on"):
        local = tft.map_blocks(z, df, device="cuda:0")
        got, ledger = _scheduled(
            tft, ex, "map_blocks", lambda: tft.map_blocks(z, df, devices=devices, executor=ex),
            "map_blocks.block", blocks, ndev)
        if not torch.equal(got.column("z").values, local.column("z").values):
            raise AssertionError("scheduled map_blocks x+3 differs from the local verb")
        out["map_blocks"] = dict(rows=rows, blocks=blocks, device_dispatches=ledger)
        del got, local
        xh = x.cpu().numpy()
        want = float(xh.sum(dtype=np.float64))
        for name, op in (("reduce_sum", dsl.reduce_sum), ("reduce_min", dsl.reduce_min)):
            g = op(tft.block(df, "x", tf_name="x_input"), axes=[0]).named("x")
            local = tft.reduce_blocks(g, df, device="cuda:0")
            got, ledger = _scheduled(
                tft, ex, name, lambda: tft.reduce_blocks(g, df, devices=devices, executor=ex),
                "reduce_blocks.block", blocks, ndev)
            if name == "reduce_min":
                if not (torch.equal(got.cpu(), local.cpu()) and got.item() == xh.min()):
                    raise AssertionError("scheduled reduce_min differs from the local verb")
                err = 0.0
            else:
                err = abs(got.item() - want) / want
                if err > _SUM_RTOL:
                    raise AssertionError(f"scheduled reduce_sum rel err {err:.3e} > {_SUM_RTOL}")
            out[name] = dict(rows=rows, rel_err=err, device_dispatches=ledger)
        pair = _pair_graph(tft, dsl.add)
        got, ledger = _scheduled(
            tft, ex, "reduce_rows", lambda: tft.reduce_rows(pair, df, devices=devices, executor=ex),
            "reduce_rows.block", blocks, ndev)
        err = abs(got.item() - want) / want
        if err > _SUM_RTOL:
            raise AssertionError(f"scheduled reduce_rows sum rel err {err:.3e} > {_SUM_RTOL}")
        out["reduce_rows"] = dict(rows=rows, rel_err=err, device_dispatches=ledger)
        del df, x, xh

        sizes = [512, 512, 512, 10]
        rng = np.random.default_rng(SEED)
        params = [
            ((rng.standard_normal((a, b)) * math.sqrt(2.0 / a)).astype(np.float32),
             (rng.standard_normal(b) * 0.1).astype(np.float32))
            for a, b in zip(sizes[:-1], sizes[1:])
        ]
        probs = MLP.from_jax_params(params).scoring_graph("features", block=False)
        feats = torch.rand(mlp_rows, sizes[0], device="cuda:0", generator=gen)
        fdf = tft.TensorFrame([tft.Column("features", feats)]).repartition(blocks)
        local = tft.map_rows(probs, fdf, device="cuda:0").column("probs").values
        got, ledger = _scheduled(
            tft, ex, "map_rows MLP", lambda: tft.map_rows(probs, fdf, devices=devices, executor=ex),
            "map_rows.block", blocks, ndev)
        gp = got.column("probs").values
        if ndev == 1 and not torch.equal(gp, local):
            raise AssertionError("scheduled map_rows MLP differs from the local verb")
        err = _check_close("scheduled map_rows MLP", gp, local, _MLP_RTOL, _MLP_ATOL)
        out["map_rows_mlp"] = dict(rows=mlp_rows, max_abs_err=err, device_dispatches=ledger)
        del fdf, feats, got, gp, local

        v = torch.rand(agg_rows, device="cuda:0", generator=gen)
        keys = torch.randint(0, nkeys, (agg_rows,), device="cuda:0", generator=gen)
        adf = tft.TensorFrame([tft.Column("k", keys), tft.Column("v", v)])
        total = dsl.reduce_sum(dsl.block(adf, "v", tf_name="v_input"), axes=[0]).named("v")
        kh, vh = keys.cpu().numpy(), v.cpu().numpy().astype(np.float64)
        counts = np.bincount(kh, minlength=nkeys)
        nsizes = len(np.unique(counts[counts > 0]))
        with tft.config.override(aggregate_segment_fast=False,
                                 aggregate_exact_size_limit=agg_rows):
            local = tft.aggregate(total, tft.group_by(adf, "k"), device="cuda:0")
            got, ledger = _scheduled(
                tft, ex, "aggregate exact",
                lambda: tft.aggregate(total, tft.group_by(adf, "k"), devices=devices, executor=ex),
                "aggregate.size", nsizes, ndev)
        want_v = np.bincount(kh, weights=vh, minlength=nkeys)
        err = _check_close("scheduled exact aggregate",
                           torch.from_numpy(got.host_values("v").astype(np.float64)),
                           torch.from_numpy(want_v), _SUM_RTOL, 0.0)
        if not np.array_equal(got.host_values("v"), local.host_values("v")):
            raise AssertionError("scheduled exact aggregate differs from the local verb")
        out["aggregate_exact"] = dict(rows=agg_rows, keys=nkeys, sizes=nsizes, max_abs_err=err,
                                      device_dispatches=ledger)
    return out


def _healthz() -> dict:
    import urllib.request

    from tensorframes_tpu_torch.utils import telemetry

    srv = telemetry.serve(port=0)
    try:
        with urllib.request.urlopen(srv.url + "/healthz", timeout=10) as r:
            return json.loads(r.read().decode())
    finally:
        srv.close()


def _failover_drill(tft, ndev: int, rows: int = 16_000_000, blocks: int = 8) -> dict:
    """One transient fault injected into a block on cuda:0 under
    ``block_scheduler="on"``: with one card the block retries in place and
    nothing is evicted; with more the block moves, cuda:0's circuit opens
    (``device_evictions`` 1, /healthz ``degraded``, one ``eviction``
    incident bundle), then the circuit is reset. The result is exact."""
    import tempfile

    from tensorframes_tpu_torch.runtime import faults
    from tensorframes_tpu_torch.runtime.executor import Executor
    from tensorframes_tpu_torch.runtime.scheduler import device_health
    from tensorframes_tpu_torch.testing import faults as chaos
    from tensorframes_tpu_torch.utils import telemetry

    ex = Executor()
    x = torch.arange(rows, device="cuda:0", dtype=torch.float32)
    df = tft.TensorFrame([tft.Column("x", x)]).repartition(blocks)
    z = (tft.block(df, "x") * 2.0).named("z")
    faults.reset_ledger()
    telemetry.reset()
    with tempfile.TemporaryDirectory() as incident_dir, tft.config.override(
        block_scheduler="on", block_retry_attempts=4, verb_retry_budget=20,
        retry_backoff_base_s=0.001, retry_backoff_max_s=0.002, incident_dir=incident_dir,
    ):
        with chaos.inject(rate=1.0, fault="transient", device="cuda:0", max_faults=1) as plan:
            got = tft.map_blocks(z, df, executor=ex)
        bundles = [r["trigger"] for r in tft.incidents()]
        health = _healthz()
    if not torch.equal(got.column("z").values.to("cuda:0"), x * 2.0):
        raise AssertionError("failover drill: the map's result is not exact")
    led = faults.ledger_snapshot()
    evictions = telemetry.flat_counters().get("device_evictions{device=cuda:0}", 0.0)
    labels = _span_labels("map_blocks.block")
    if plan.injected != 1 or led["retries"] != 1:
        raise AssertionError(f"failover drill: injected {plan.injected}, ledger {led}")
    if ndev == 1:
        if led["evictions"] or evictions or device_health().table() or health["degraded"]:
            raise AssertionError(f"one card: evicted anyway ({led}, {health})")
        if labels.count("cuda:0") != blocks + 1:
            raise AssertionError(f"one card: labels {labels}")
    else:
        if led["evictions"] != 1 or evictions != 1.0:
            raise AssertionError(f"failover drill: evictions {led['evictions']} / {evictions}")
        if not health["degraded"] or health["status"] != "degraded":
            raise AssertionError(f"failover drill: /healthz {health}")
        if bundles != ["eviction"]:
            raise AssertionError(f"failover drill: incident bundles {bundles}")
        if labels[0] != "cuda:0" or labels[1] == "cuda:0" or len(labels) != blocks + 1:
            raise AssertionError(f"failover drill: the failed block did not move: {labels}")
    circuits = device_health().table()
    device_health().reset()
    return dict(rows=rows, blocks=blocks, retries=led["retries"],
                evictions=led["evictions"], device_evictions=evictions, span_labels=labels,
                healthz_status=health["status"], incident_bundles=bundles, circuits=circuits)


def _global_frame(tft, ndev: int, rows: int, blocks: int, chunk_rows: int, chunks: int) -> dict:
    """`to_global()` of ``rows`` float32 rows; x+3 -> x*2 -> reduce_sum with
    the outputs left on their shards; the ``"global"`` auto-route; a
    `LazyFrame.force` over the global base; `filter_global`; a stream of
    ``chunks`` x ``chunk_rows`` rows through the double-buffered
    accumulator. Each against the local arithmetic on cuda:0."""
    from tensorframes_tpu_torch import globalframe
    from tensorframes_tpu_torch.graph.plan import col
    from tensorframes_tpu_torch.utils import telemetry

    dsl = tft.dsl
    globalframe.reset_state()
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 29)
    x = torch.rand(rows, device="cuda:0", generator=gen)
    df = tft.TensorFrame([tft.Column("x", x)]).repartition(blocks)
    gf = df.to_global()
    if gf.data_size != ndev or not all(
            _lies_on(s, i) for i, s in enumerate(gf.shards("x"))):
        raise AssertionError(f"to_global: {gf!r} on {[s.device for s in gf.shards('x')]}")
    z = (tft.block(df, "x") + 3.0).named("y")
    telemetry.reset()
    m1 = gf.map_blocks(z)
    spans = [(s.name, s.attrs.get("sharding")) for s in telemetry.spans() if s.kind == "dispatch"]
    if spans[-1] != ("map_blocks.global", f"data:{ndev}"):
        raise AssertionError(f"global map dispatch spans {spans[-3:]}")
    m2 = m1.map_blocks((tft.block(m1, "y") * 2.0).named("w"))
    for i, s in enumerate(m2.shards("w")):
        if not _lies_on(s, i):
            raise AssertionError(f"global map output shard {i} left its card: {s.device}")
    w = m2.to_frame().column("w").values
    if not torch.equal(w, (x + 3.0) * 2.0):
        raise AssertionError("global x+3 -> x*2 differs from the local arithmetic")
    g = dsl.reduce_sum(tft.block(m2, "w", tf_name="w_input"), axes=[0]).named("w")
    total = m2.reduce_blocks(g)
    want = float(((x.cpu().numpy().astype(np.float64) + 3.0) * 2.0).sum())
    err = abs(total.item() - want) / want
    if err > _SUM_RTOL:
        raise AssertionError(f"global reduce_sum rel err {err:.3e} > {_SUM_RTOL}")
    out["chain"] = dict(rows=rows, shards=gf.data_size, pad_rows=gf.pad_rows, rel_err=err)
    del m1, m2, w

    telemetry.reset()
    with tft.config.override(block_scheduler="global"):
        routed = tft.map_blocks(z, df)
        rmin = tft.reduce_blocks(
            dsl.reduce_min(tft.block(df, "x", tf_name="x_input"), axes=[0]).named("x"), df)
    names = [s.name for s in telemetry.spans() if s.kind == "dispatch"]
    if "map_blocks.global" not in names or "reduce_blocks.global" not in names:
        raise AssertionError(f"global auto-route took {names}")
    if not torch.equal(routed.column("y").values, x + 3.0) or rmin.item() != x.min().item():
        raise AssertionError("global auto-route results differ")
    out["auto_route"] = dict(dispatches=names)
    del routed

    telemetry.reset()
    forced = gf.lazy().map_blocks(z).force()
    if [s.name for s in telemetry.spans() if s.kind == "dispatch"] != ["lazy.force.global"]:
        raise AssertionError("LazyFrame.force did not take the global route")
    if not torch.equal(forced.column("y").values, x + 3.0):
        raise AssertionError("global LazyFrame.force differs")
    out["lazy_force"] = dict(route="lazy.force.global")
    del forced

    kept = gf.filter(col("x") > 0.5).force()
    want_rows = x[x > 0.5]
    if kept.nrows != want_rows.shape[0] or not torch.equal(
            kept.to_frame().column("x").values, want_rows):
        raise AssertionError("filter_global differs from the mask on the card")
    out["filter"] = dict(rows_kept=kept.nrows)
    del kept, want_rows, gf, df, x

    parts = [torch.rand(chunk_rows, device="cuda:0", generator=gen) for _ in range(chunks)]
    frames = [tft.TensorFrame([tft.Column("x", p)]) for p in parts]
    sg = dsl.reduce_sum(tft.block(frames[0], "x", tf_name="x_input"), axes=[0]).named("x")
    want = sum(float(p.cpu().numpy().sum(dtype=np.float64)) for p in parts)
    with tft.config.override(block_scheduler="global"):
        globalframe.reset_state()
        got = tft.reduce_blocks_stream(sg, iter(frames))
    st = globalframe.state()
    local = tft.reduce_blocks_stream(sg, iter(frames), device="cuda:0")
    errs = [abs(v.item() - want) / want for v in (got, local)]
    if max(errs) > _SUM_RTOL:
        raise AssertionError(f"global stream sum rel errs {errs} > {_SUM_RTOL}")
    if st["stream_folds"] < 1 or st["dispatches"] < chunks:
        raise AssertionError(f"global stream state {st}")
    out["stream"] = dict(chunks=chunks, chunk_rows=chunk_rows, rel_err=errs[0], state=st)
    del parts, frames
    return out


def phase_scheduler_and_global(tft, rows: int = 200_000_000, blocks: int = 8,
                               mlp_rows: int = 1_000_000, agg_rows: int = 1_000_000,
                               nkeys: int = 1000, chunk_rows: int = 128_000_000,
                               chunks: int = 4) -> None:
    """Phase 18: the scheduled verbs over every card, the failover drill,
    and `GlobalFrame` (see `_scheduled_verbs`, `_failover_drill`,
    `_global_frame`)."""
    ndev = torch.cuda.device_count()
    sched = _scheduled_verbs(tft, ndev, rows, blocks, mlp_rows, agg_rows, nkeys)
    torch.cuda.empty_cache()
    drill = _failover_drill(tft, ndev)
    torch.cuda.empty_cache()
    gfr = _global_frame(tft, ndev, rows, blocks, chunk_rows, chunks)
    torch.cuda.empty_cache()
    _emit("scheduler_and_global", devices=ndev, sum_rtol=_SUM_RTOL,
          scheduled=sched, failover=drill, global_frame=gfr)


# ---------------------------------------------------------------------------
# phase 20: multi-process execution, one rank a card
# ---------------------------------------------------------------------------

# seconds a multi-process world may take, its start-up included
_MULTIHOST_TIMEOUT_S = 300


def _reduced(t: torch.Tensor, op) -> torch.Tensor:
    """``t`` all-reduced over every rank (the references' collective, not
    the one under test)."""
    import torch.distributed as dist

    t = t.clone()
    dist.all_reduce(t, op=op)
    return t


def _multihost_keyed(tft, mh, mesh, keys_col, codes: np.ndarray, want_keys: np.ndarray, v,
                     single) -> dict:
    """`aggregate_global` of ``v`` by ``keys_col`` (a device int64 tensor or
    a host string vector; row r is in group ``codes[r]`` of the sorted keys
    ``want_keys``) on this rank's rows: a keyed sum and mean, against every
    rank's float64 numpy sums (the key column exact). ``single`` is the
    world-1 check against the single-process ``mesh=data_mesh()``
    aggregate."""
    import torch.distributed as dist

    dsl = tft.dsl
    kcol = tft.Column("k", keys_col) if isinstance(keys_col, torch.Tensor) else \
        tft.Column("k", keys_col, tft.ScalarType.string)
    df = tft.TensorFrame([kcol, tft.Column("v", v)])
    grouped = tft.group_by(df, "k")
    fetches = [dsl.reduce_sum(dsl.block(df, "v", tf_name="s_input"), axes=[0]).named("s"),
               dsl.reduce_mean(dsl.block(df, "v", tf_name="m_input"), axes=[0]).named("m")]
    feed = {"s_input": "v", "m_input": "v"}
    out = mh.aggregate_global(fetches, grouped, feed_dict=feed)
    # the references: this rank's float64 numpy sums, summed over the ranks
    nkeys = len(want_keys)
    vh = v.cpu().numpy()
    sums = np.stack([np.bincount(codes, weights=vh[:, j].astype(np.float64), minlength=nkeys)
                     for j in range(vh.shape[1])], 1)
    del vh
    want_s = _reduced(torch.from_numpy(sums).cuda(), dist.ReduceOp.SUM).cpu()
    counts = _reduced(torch.from_numpy(np.bincount(codes, minlength=nkeys)).cuda(),
                      dist.ReduceOp.SUM).cpu()
    keys = out.host_values("k")
    if len(keys) != nkeys or not np.array_equal(keys, want_keys):
        raise AssertionError(f"aggregate_global keys {keys[:5]}... differ from {want_keys[:5]}...")
    errs = [_check_close(f"aggregate_global {c}",
                         torch.from_numpy(out.host_values(c).astype(np.float64)), w, _SUM_RTOL, 0.0)
            for c, w in (("s", want_s), ("m", want_s / counts.to(torch.float64)[:, None]))]
    res = dict(rows=int(counts.sum()), max_abs_err=max(errs))
    if single is not None:
        ref = tft.aggregate(fetches, grouped, feed_dict=feed, mesh=single)
        if not np.array_equal(ref.host_values("k"), keys):
            raise AssertionError("aggregate_global keys differ from the mesh aggregate's")
        for c in ("s", "m"):
            _check_close(f"aggregate_global {c} against the mesh aggregate",
                         torch.from_numpy(out.host_values(c)),
                         torch.from_numpy(ref.host_values(c)), _SUM_RTOL, 0.0)
    return res


def _multihost_worker(sizes: dict) -> int:
    """One rank of phase 20 (``python3 chip_smoke.py --multihost-worker
    SIZES``, the torchrun environment set by the parent): NCCL on card
    LOCAL_RANK, this rank's share of every verb's rows, built on the card
    from ``SEED`` and the rank. Prints one JSON line of its results."""
    import torch.distributed as dist

    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch.ops.flash_attention import flash_attention
    from tensorframes_tpu_torch.parallel import data_mesh
    from tensorframes_tpu_torch.parallel import multihost as mh

    tft.config.update(block_scheduler="off")
    mh.initialize_distributed(timeout_s=_MULTIHOST_TIMEOUT_S)
    if dist.get_backend() != "nccl":
        raise AssertionError(f"the process group runs {dist.get_backend()}, not NCCL")
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = mh.global_data_mesh()
    if mesh.process_count != world or mesh.size != world:
        raise AssertionError(f"global_data_mesh() is {mesh!r} in a world of {world}")
    single = data_mesh() if world == 1 else None
    dsl = tft.dsl
    out = dict(rank=rank, world=world, backend=dist.get_backend(), mesh=repr(mesh))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20 + 1000 * rank)

    # phase 17's rows: x+3 map_blocks, reduce_blocks sum and min
    n = sizes["rows"] // world
    x = torch.rand(n, device="cuda", generator=gen)
    df = mh.host_local_frame_to_global(tft.TensorFrame([tft.Column("x", x)]), mesh)
    plain = tft.TensorFrame([tft.Column("x", x)])

    def both(name, call):
        """``call(frame, mesh)`` over the spanning frame, and at one rank
        over the plain frame on ``mesh=data_mesh()`` (phase 17's verb)."""
        out[name] = dict(rows=n * world)
        return call(df, mesh), None if single is None else call(plain, single)

    z = (tft.block(df, "x") + 3.0).named("z")
    mapped, ref = both("map_blocks", lambda f, m: tft.map_blocks(z, f, mesh=m))
    shard = mapped.shards("z")[0]
    if not (shard.index == slice(rank * n, (rank + 1) * n) and torch.equal(shard.data, x + 3.0)):
        raise AssertionError(f"rank {rank}: the x+3 shard {shard.index} differs from x + 3")
    if ref is not None and not torch.equal(ref.column("z").values, shard.data):
        raise AssertionError("multihost x+3 differs from the mesh verb's")
    del mapped, shard, ref
    xh = x.cpu().numpy()
    want_sum = float(_reduced(torch.tensor(xh.sum(dtype=np.float64), device="cuda"),
                              dist.ReduceOp.SUM))
    want_min = float(_reduced(torch.tensor(xh.min(), device="cuda"), dist.ReduceOp.MIN))
    del xh
    for name, op in (("reduce_sum", dsl.reduce_sum), ("reduce_min", dsl.reduce_min)):
        g = op(tft.block(df, "x", tf_name="x_input")).named("x")
        got, ref = both(name, lambda f, m: tft.reduce_blocks(g, f, mesh=m))
        if name == "reduce_min":
            err = 0.0
            if got.item() != want_min:
                raise AssertionError(f"multihost reduce_min {got.item()} != {want_min}")
        else:
            err = abs(got.item() - want_sum) / want_sum
            if got.dtype != torch.float32 or err > _SUM_RTOL:
                raise AssertionError(f"multihost reduce_sum rel err {err:.3e} > {_SUM_RTOL}")
        if ref is not None and not torch.equal(got, ref):
            raise AssertionError(f"multihost {name} differs from the mesh verb's")
        out[name]["rel_err"] = err
    del df, plain, x
    torch.cuda.empty_cache()

    # config 4's widths through aggregate_global: int64 keys, then strings
    n = sizes["agg_rows"] // world
    nkeys = sizes["nkeys"]
    v = torch.rand(n, sizes["dim"], device="cuda", generator=gen)
    keys = (torch.arange(n, device="cuda") + rank * n) % nkeys
    codes = keys.cpu().numpy()
    out["aggregate_int_keys"] = _multihost_keyed(
        tft, mh, mesh, keys, codes, np.arange(nkeys), v, single)
    del keys
    # ids in sorted order: key i has group id i
    names = np.asarray([f"id-{i:02d}" for i in range(nkeys)], dtype=object)
    skeys = names[codes]
    # phase 17 has no string keys: against numpy alone
    out["aggregate_string_keys"] = _multihost_keyed(tft, mh, mesh, skeys, codes, names, v, None)
    del v, skeys, codes
    torch.cuda.empty_cache()

    # analyze_global over ragged rows: lengths 1..max_len on every rank
    cells = _ragged_column(sizes["ragged_rows"] // world, sizes["max_len"], SEED + 20 + rank)[0]
    rdf = tft.TensorFrame.from_dict({"v": cells})
    merged = mh.analyze_global(rdf)
    dims = merged.info["v"].cell_shape.dims
    if dims != (None,):
        raise AssertionError(f"analyze_global merged the ragged cells to {dims}")
    out["analyze_global"] = dict(rows=len(cells) * world, dims=list(dims))
    out["flash_attention_launches"] = flash_attention.launches
    print(json.dumps({"multihost_worker": out}), flush=True)
    dist.destroy_process_group()
    return 0


def phase_multihost(tft, rows: int = 200_000_000, agg_rows: int = 100_000_000, dim: int = 8,
                    nkeys: int = 16, ragged_rows: int = 1_000_000, max_len: int = 64) -> int:
    """Phase 20: `parallel.multihost` with one process a card
    (``torch.cuda.device_count()`` ranks, the torchrun environment, NCCL):
    each rank owns 1/N of phase 17's ``rows`` float32 rows (x+3
    `map_blocks`, `reduce_blocks` sum and min over a `SpanningFrame`),
    of ``agg_rows`` x ``dim`` float32 rows with ``nkeys`` int64 keys
    through `aggregate_global` (sum and mean), then with ``nkeys`` string
    keys (sum and max), and of ``ragged_rows`` ragged rows through
    `analyze_global`. Every rank returns the same results, held to numpy
    float64 (sums rtol ``_SUM_RTOL``; min, max and keys exact) and, at
    world size 1, to the single-process ``mesh=data_mesh()`` verbs. Any
    rank's failure or timeout fails the phase. Returns the ranks'
    flash_attention launches (none: no graph here holds attention)."""
    import socket

    world = torch.cuda.device_count()
    torch.cuda.empty_cache()  # the ranks share the cards with this process
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    root = os.path.dirname(os.path.abspath(__file__))
    sizes = dict(rows=rows, agg_rows=agg_rows, dim=dim, nkeys=nkeys, ragged_rows=ragged_rows,
                 max_len=max_len)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port, WORLD_SIZE=str(world),
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()  # the ranks' deadline
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(root, "chip_smoke.py"), "--multihost-worker",
             json.dumps(sizes)],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(world)
    ]
    outs = []
    try:
        for p in procs:
            left = max(1.0, _MULTIHOST_TIMEOUT_S - (time.perf_counter() - t0))
            outs.append(p.communicate(timeout=left))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks = []
    for r, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"multihost rank {r} exited {p.returncode}:\n{stderr[-4000:]}")
        line = [ln for ln in stdout.splitlines() if ln.startswith('{"multihost_worker"')]
        ranks.append(json.loads(line[-1])["multihost_worker"])
    launches = sum(r.pop("flash_attention_launches") for r in ranks)
    _emit("multihost", world=world, sum_rtol=_SUM_RTOL, ranks=ranks)
    return launches


def phase_scheduled_lm(tft, cfg, n_seqs: int = 16, block_seqs: int = 4) -> int:
    """On two or more cards: `TransformerLM` scoring of ``n_seqs`` sequences
    with ``devices=`` over every card, a copy of the model a card (the same
    seed), the flash-attention kernel launching on each card's stream. Each
    block's logits equal cuda:0's for the same tokens within the logit
    tolerance. Returns the kernel's launches in the call."""
    from tensorframes_tpu_torch.models import TransformerLM
    from tensorframes_tpu_torch.ops.flash_attention import flash_attention

    ndev = torch.cuda.device_count()
    models = [TransformerLM(**cfg, seed=SEED, device=f"cuda:{i}") for i in range(ndev)]
    tokens = np.random.default_rng(SEED + 31).integers(
        0, cfg["vocab"], (n_seqs, cfg["max_seq"])).astype(np.int32)
    df = tft.TensorFrame.from_dict({"tokens": tokens}, num_blocks=n_seqs // block_seqs)

    def score(tokens):
        return {"logits": models[tokens.device.index or 0](tokens)}

    want = models[0](torch.from_numpy(tokens).cuda())
    before = flash_attention.launches
    out = tft.map_blocks(score, df, devices=list(range(ndev)))
    launches = flash_attention.launches - before
    logits = out.column("logits").values
    err = _check_close("devices= LM logits", logits.to("cuda:0"), want, _LOGIT_RTOL, _LOGIT_ATOL)
    expected = cfg["n_layers"] * (n_seqs // block_seqs)
    if launches != expected:
        raise AssertionError(f"devices= LM: {launches} launches, expected {expected}")
    _emit("scheduled_lm_scoring", devices=ndev, sequences=n_seqs, block_sequences=block_seqs,
          launches=launches, max_abs_err=err)
    return launches


def phase_transformer(tft, cfg, n_seqs: int, block_seqs: int,
                      phase: str = "transformer_map_blocks") -> None:
    from tensorframes_tpu_torch.models import TransformerLM
    from tensorframes_tpu_torch.ops.flash_attention import flash_attention_reference

    model = TransformerLM(**cfg, seed=SEED, device="cuda")
    seq = cfg["max_seq"]
    tokens = np.random.default_rng(SEED).integers(0, cfg["vocab"], (n_seqs, seq)).astype(np.int32)
    df = tft.TensorFrame.from_dict({"tokens": tokens}, num_blocks=n_seqs // block_seqs)

    def score(tokens):
        return {"logits": model(tokens)}

    logits = tft.map_blocks(score, df).column("logits").values
    if tuple(logits.shape) != (n_seqs, seq, cfg["vocab"]) or not torch.isfinite(logits).all():
        raise AssertionError(f"TransformerLM: bad logits {tuple(logits.shape)}")

    first = torch.from_numpy(tokens[:block_seqs]).cuda()
    want = model(first, attention=flash_attention_reference)
    err = _check_close(
        "TransformerLM block 0 logits", logits[:block_seqs], want, _LOGIT_RTOL, _LOGIT_ATOL
    )
    _emit(
        phase, config=cfg, sequences=n_seqs, block_sequences=block_seqs, max_abs_err=err,
        tolerance={"rtol": _LOGIT_RTOL, "atol": _LOGIT_ATOL},
    )


# ---------------------------------------------------------------------------
# phase 19: the sequence, pipeline, expert and 3-D parallel paths
# ---------------------------------------------------------------------------

# pipeline_apply against the sequential stages: JAX's test bar
# (tests/test_pp_ep.py); the reference runs the same microbatch shapes, so
# cuBLAS picks the same kernels and only the hand-offs differ
_PIPE_RTOL, _PIPE_ATOL = 2e-5, 1e-6
# the MLP's sharded step against the unsharded one: JAX's bar
# (tests/test_models.py), loss rtol 1e-5 and parameters rtol 1e-4, with atol
# 1e-7 for the elements near zero (the biases start at 0 and move by lr x
# a gradient summed over the data shards in another order)
_MLP_STEP_LOSS_RTOL, _MLP_STEP_RTOL, _MLP_STEP_ATOL = 1e-5, 1e-4, 1e-7
# the 3-D step against the single-card step: JAX's bar (tests/test_ring.py)
_STEP3D_LOSS_RTOL, _STEP3D_RTOL, _STEP3D_ATOL = 1e-5, 2e-4, 2e-6


def _slot_mesh(shape, names, cards: int):
    """A mesh of ``shape`` whose slots take the first ``cards`` cards in
    turn: on one card every slot is cuda:0, so each collective still runs
    between its slots."""
    from tensorframes_tpu_torch.parallel import Mesh

    n = int(np.prod(shape))
    devices = [torch.device("cuda", i % cards) for i in range(n)]
    return Mesh(np.asarray(devices, dtype=object).reshape(shape), names)


# bf16 and fp16 outputs against the plain version's: both compute in float32
# and round once to the dtype, so they may differ by one unit in its last
# place, a relative 2^-7 (bf16) or 2^-10 (fp16); atol for values near 0
_HALF_RTOL = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}
_HALF_ATOL = 1e-5


def _lse_entry(lm_shape, ring_slots: int = 4) -> dict:
    """`flash_attention_lse` against its plain version at the LM's shape
    and at the shape of one step of the ring's scoring (the sequence cut
    over ``ring_slots``), causal and not, and at head_dim 128; its output
    equal to the entry without the statistics. Then bf16 and fp16 at the
    LM's shape, causal: the output within one unit in the dtype's last
    place, both entries on the tensor-core kernels."""
    from tensorframes_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_lse,
        flash_attention_lse_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    errs = {}
    bh, s, d = lm_shape
    step = (bh, s // ring_slots, d)
    for bh, s, d, causal in ((*lm_shape, True), (*lm_shape, False), (*step, True),
                             (*step, False), (8, 1024, 128, True)):
        q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen) for _ in range(3))
        out, lse = flash_attention_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_lse_reference(q, k, v, causal=causal)
        what = f"flash_attention_lse {(bh, s, d)} causal={causal}"
        key = f"{bh}x{s}x{d}{'-causal' if causal else ''}"
        errs[key] = max(
            _check_close(what + " out", out, ref, _ATTN_RTOL, _ATTN_ATOL),
            _check_close(what + " lse", lse, ref_lse, _ATTN_RTOL, _ATTN_ATOL),
        )
        if not torch.equal(out, flash_attention(q, k, v, causal=causal)):
            raise AssertionError(f"{what}: output differs from the entry without the statistics")
    half_errs = {}
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float16, "fp16")):
        q, k, v = (torch.randn(*lm_shape, device="cuda", generator=gen).to(dtype)
                   for _ in range(3))
        before = dict(flash_attention.launches_by_route)
        out, lse = flash_attention_lse(q, k, v, causal=True)
        plain_out = flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        routes = {r: n - before[r] for r, n in flash_attention.launches_by_route.items()
                  if n != before[r]}
        what = f"flash_attention_lse {name} {lm_shape} causal=True"
        if routes != {"tensor_core": 2}:
            raise AssertionError(f"{what}: the two entries launched {routes}, expected "
                                 "{'tensor_core': 2}")
        ref, ref_lse = flash_attention_lse_reference(q, k, v, causal=True)
        if out.dtype != dtype:
            raise AssertionError(f"{what}: output {out.dtype}")
        half_errs[name] = max(
            _check_close(what + " out", out.float(), ref.float(), _HALF_RTOL[dtype], _HALF_ATOL),
            _check_close(what + " lse", lse, ref_lse, _ATTN_RTOL, _ATTN_ATOL),
        )
        if not torch.equal(out, plain_out):
            raise AssertionError(f"{what}: output differs from the entry without the statistics")
    return dict(
        max_abs_err_each=errs, max_abs_err=max(errs.values()),
        tolerance={"rtol": _ATTN_RTOL, "atol": _ATTN_ATOL},
        half_max_abs_err_each=half_errs, half_max_abs_err=max(half_errs.values()),
        half_tolerance={"rtol": {"bf16": _HALF_RTOL[torch.bfloat16],
                                  "fp16": _HALF_RTOL[torch.float16]}, "atol": _HALF_ATOL},
    )


def _ring_scoring(cfg, cards: int, n_seqs: int = 8, n_slots: int = 4) -> dict:
    """`TransformerLM.apply(mesh=)` over a ``data`` mesh of ``n_slots``
    slots against `apply` without a mesh and against the model on the
    kernel's plain version: the ring's kernel launches in one call are
    counted (n_layers x n(n+1)/2)."""
    from tensorframes_tpu_torch.models import TransformerLM
    from tensorframes_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference

    mesh = _slot_mesh((n_slots,), ("data",), cards)
    model = TransformerLM(**cfg, seed=SEED, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(SEED + 41).integers(
        0, cfg["vocab"], (n_seqs, cfg["max_seq"])).astype(np.int32)).cuda()
    want = model(tokens)
    plain = model(tokens, attention=flash_attention_reference)
    flash_attention.launches = 0
    got = model(tokens, mesh=mesh)
    launches = flash_attention.launches
    expected = cfg["n_layers"] * n_slots * (n_slots + 1) // 2
    if launches != expected:
        raise AssertionError(f"apply(mesh=): {launches} kernel launches, expected {expected}")
    err = _check_close("apply(mesh=) logits", got, want, _LOGIT_RTOL, _LOGIT_ATOL)
    err_plain = _check_close("apply(mesh=) logits against the plain attention", got, plain,
                             _LOGIT_RTOL, _LOGIT_ATOL)
    del want, plain, got
    return dict(
        sequences=n_seqs, seq=cfg["max_seq"], slots=n_slots, ring_launches=launches,
        max_abs_err=err, max_abs_err_vs_plain=err_plain,
        tolerance={"rtol": _LOGIT_RTOL, "atol": _LOGIT_ATOL},
    )


def _ring_gradients(cards: int, seq: int = 2048, hd: int = 64, n_slots: int = 4) -> dict:
    """`ring_attention_reference`'s gradients on one causal head of the
    LM's shape, and `full_attention`'s, each within 1e-3 of its norm of
    the float64 gradients (phase 14's bar)."""
    from tensorframes_tpu_torch.parallel import full_attention, ring_attention_reference

    mesh = _slot_mesh((n_slots,), ("data",), cards)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 42)
    q, k, v, r = (torch.randn(seq, hd, device="cuda", generator=gen) for _ in range(4))

    def grads(attend, dtype):
        ts = [t.to(dtype).requires_grad_(True) for t in (q, k, v)]
        return torch.autograd.grad((attend(*ts) * r.to(dtype)).sum(), ts)

    g64 = grads(lambda a, b, c: _attention_f64(a, b, c, causal=True), torch.float64)
    worst = {}
    for name, attend in (
        ("ring_attention_reference",
         lambda a, b, c: ring_attention_reference(a, b, c, mesh, causal=True)),
        ("full_attention", lambda a, b, c: full_attention(a, b, c, causal=True)),
    ):
        ratios = [float((g.double() - w).norm() / w.norm()) for g, w in
                  zip(grads(attend, torch.float32), g64)]
        if not max(ratios) <= _TRAIN_GRAD_RTOL:
            raise AssertionError(f"{name}: gradients off float64 by {ratios} of their norms")
        worst[name] = max(ratios)
    return dict(shape=[seq, hd], slots=n_slots, max_grad_err_over_norm=worst,
                grad_rtol_of_norm=_TRAIN_GRAD_RTOL)


def _all_to_all(cards: int, n_slots: int = 4) -> dict:
    """`seq_all_to_all` of a (2048, 8, 64) tensor and back, each shard's
    device, shape and values checked, exact."""
    from tensorframes_tpu_torch.parallel import seq_all_to_all

    mesh = _slot_mesh((n_slots,), ("data",), cards)
    x = torch.randn(2048, 8, 64, device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED + 43))
    y = seq_all_to_all(x, mesh, seq_axis=0, head_axis=1)
    hb = 8 // n_slots
    for i in range(n_slots):
        t = y.shards[(i,)]
        if t.device != mesh.devices[(i,)] or tuple(t.shape) != (2048, hb, 64):
            raise AssertionError(f"seq_all_to_all: shard {i} {tuple(t.shape)} on {t.device}")
        if not torch.equal(t.to(x.device), x[:, i * hb:(i + 1) * hb]):
            raise AssertionError(f"seq_all_to_all: shard {i} holds other values")
    back = seq_all_to_all(y, mesh, seq_axis=1, head_axis=0)
    if [tuple(back.shards[(i,)].shape) for i in range(n_slots)] != [(2048 // n_slots, 8, 64)] * n_slots:
        raise AssertionError("seq_all_to_all: the way back is not split over the sequence")
    if not torch.equal(back.gather(x.device), x):
        raise AssertionError("seq_all_to_all: the round trip changed the tensor")
    return dict(shape=[2048, 8, 64], slots=n_slots, exact=True)


def _pipeline(cards: int, d: int = 2048, batch: int = 8192, micro: int = 8, stages: int = 4) -> dict:
    """`pipeline_apply` of 4 linear + ReLU stages against the sequential
    stages over the same microbatches."""
    from tensorframes_tpu_torch.parallel import pipeline_apply

    mesh = _slot_mesh((stages,), ("stage",), cards)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 44)
    params = {
        "w": torch.randn(stages, d, d, device="cuda", generator=gen) / math.sqrt(d),
        "b": torch.randn(stages, d, device="cuda", generator=gen) * 0.1,
    }
    x = torch.randn(batch, d, device="cuda", generator=gen)

    def stage(p, h):
        return torch.relu(h @ p["w"] + p["b"])

    def sequential():
        mb = batch // micro
        outs = []
        for j in range(micro):
            h = x[j * mb:(j + 1) * mb]
            for s in range(stages):
                h = stage({"w": params["w"][s], "b": params["b"][s]}, h)
            outs.append(h)
        return torch.cat(outs)

    with torch.no_grad():
        got = pipeline_apply(stage, params, x, mesh, num_microbatches=micro)
        want = sequential()
    err = _check_close("pipeline_apply", got, want, _PIPE_RTOL, _PIPE_ATOL)
    return dict(stages=stages, d=d, batch=batch, microbatches=micro, max_abs_err=err,
                tolerance={"rtol": _PIPE_RTOL, "atol": _PIPE_ATOL})


def _moe_ep(cards: int, tokens: int = 4096, n_slots: int = 8, d: int = 4096,
            h: int = 14336) -> dict:
    """`MoEFFN.apply_ep` at Mixtral-8x7B's widths (phase 14's) over an
    8-slot ``model`` axis against `apply`, phase 14's tolerance."""
    from tensorframes_tpu_torch.models import MoEFFN
    from tensorframes_tpu_torch.parallel import P, shard

    mesh = _slot_mesh((n_slots,), ("model",), cards)
    model = MoEFFN(d, h, 8, 2, seed=SEED, device="cuda")
    x = torch.randn(tokens, d, device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED + 45))
    with torch.no_grad():
        want = model(x)
        params = dict(model.params)
        params["w1"] = shard(model.params["w1"], mesh, P("model"))
        params["w2"] = shard(model.params["w2"], mesh, P("model"))
        got = model.apply_ep(params, x, mesh)
    err = _check_close("MoEFFN.apply_ep", got, want, _MOE_RTOL, _MOE_ATOL)
    del params, want, got
    return dict(widths=[d, h, 8, 2], tokens=tokens, slots=n_slots, max_abs_err=err, tolerance={"rtol": _MOE_RTOL, "atol": _MOE_ATOL})


def _mlp_sharded_step(cards: int, rows: int = 8192) -> dict:
    """`MLP.sharded_train_step` (512-512-512-10) on a 2 x 2 ``data`` x
    ``model`` mesh against `train_step`, every parameter."""
    from tensorframes_tpu_torch.models import MLP

    mesh = _slot_mesh((2, 2), ("data", "model"), cards)
    sizes = [512, 512, 512, 10]
    model = MLP(sizes, seed=SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 46)
    x = torch.rand(rows, sizes[0], device="cuda", generator=gen)
    y = torch.randint(0, sizes[-1], (rows,), device="cuda", generator=gen)
    step = model.sharded_train_step(mesh, lr=0.05)
    sharded = model.shard_params(model.params, mesh)
    new, loss = step(sharded, x, y)
    ref = [(w.detach().clone(), b.detach().clone()) for w, b in model.params]
    _, rloss = model.train_step(ref, x, y, lr=0.05)
    if abs(float(loss) - float(rloss)) > _MLP_STEP_LOSS_RTOL * abs(float(rloss)):
        raise AssertionError(f"MLP sharded step loss {float(loss)} vs {float(rloss)}")
    err = 0.0
    for i, ((w, b), (rw, rb)) in enumerate(zip(new, ref)):
        err = max(err, _check_close(f"MLP sharded w{i}", w.gather(), rw, _MLP_STEP_RTOL, _MLP_STEP_ATOL),
                  _check_close(f"MLP sharded b{i}", b.gather(), rb, _MLP_STEP_RTOL, _MLP_STEP_ATOL))
    return dict(sizes=sizes, rows=rows, mesh=[2, 2], loss=float(loss), loss_unsharded=float(rloss),
                max_abs_err=err,
                tolerance={"loss_rtol": _MLP_STEP_LOSS_RTOL, "rtol": _MLP_STEP_RTOL,
                           "atol": _MLP_STEP_ATOL})


def _step_3d(cards: int, batch_shard: int = 8, seq_shard: int = 128) -> dict:
    """`TransformerLM.sharded_train_step_3d` at `benchmarks/train_bench.py`'s
    widths on a 2 x 2 x 2 mesh (one card) or 1 x 2 x 2 (four cards) against
    the single-card step, every parameter."""
    from tensorframes_tpu_torch.models import TransformerLM

    shape = (2, 2, 2) if cards == 1 else (1, 2, 2)
    mesh = _slot_mesh(shape, ("data", "seq", "model"), cards)
    dp, sp, _ = shape
    cfg = dict(vocab=256, d_model=256, n_heads=4, n_layers=4, max_seq=sp * seq_shard)
    model = TransformerLM(**cfg, seed=SEED, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(SEED + 47).integers(
        0, cfg["vocab"], (dp * batch_shard, sp * seq_shard)).astype(np.int32)).cuda()
    step = model.sharded_train_step_3d(mesh, lr=0.1)
    layout, loss = step(model.device_layout(model.params), tokens)
    ref = {k: v.detach().clone() for k, v in model.params.items()}
    _, rloss = model.train_step(ref, tokens, lr=0.1)
    if abs(float(loss) - float(rloss)) > _STEP3D_LOSS_RTOL * abs(float(rloss)):
        raise AssertionError(f"3-D step loss {float(loss)} vs the single-card step's {float(rloss)}")
    got = model.merge_layout(layout)
    err = max(_check_close(f"3-D step {k}", got[k].to("cuda"), ref[k], _STEP3D_RTOL, _STEP3D_ATOL)
              for k in ref)
    return dict(config=cfg, mesh=list(shape), tokens_per_step=tokens.numel(), loss=float(loss),
                loss_single_card=float(rloss), max_abs_err=err,
                tolerance={"loss_rtol": _STEP3D_LOSS_RTOL, "rtol": _STEP3D_RTOL,
                           "atol": _STEP3D_ATOL})


def phase_parallel_models(cfg, lm_shape, cards: int = 1) -> dict:
    """Phase 19: the log-sum-exp entry of the kernel, `TransformerLM`
    scoring through the ring (its launches counted apart from the main
    path's), the differentiable ring, `seq_all_to_all`, `pipeline_apply`,
    `MoEFFN.apply_ep`, the MLP's sharded step and the 3-D step. Every mesh
    is a set of slots over the first ``cards`` cards. Returns what the
    kernels line carries."""
    out = dict(cards=cards)
    if cards == 1:
        out["lse_entry"] = _lse_entry(lm_shape)
    for name, part in (
        ("ring_scoring", lambda: _ring_scoring(cfg, cards)),
        ("ring_gradients", lambda: _ring_gradients(cards)),
        ("seq_all_to_all", lambda: _all_to_all(cards)),
        ("pipeline", lambda: _pipeline(cards)),
        ("moe_apply_ep", lambda: _moe_ep(cards)),
        ("mlp_sharded_step", lambda: _mlp_sharded_step(cards)),
        ("step_3d", lambda: _step_3d(cards)),
    ):
        out[name] = part()
        torch.cuda.empty_cache()
    _emit("parallel_models" if cards == 1 else f"parallel_models_on_{cards}_cards", **out)
    return out


# ---------------------------------------------------------------------------
# phase 21: LMs and rings at other head widths
# ---------------------------------------------------------------------------


def phase_attention_widths(tft, cfg, n_seqs: int, block_seqs: int) -> dict:
    """Phase 21: `TransformerLM` scoring at head widths 128, 256 and 15
    (phase 7's route and widths, other head counts) against the plain
    attention, and the ``mesh=`` ring at 15 and 256, their launches
    counted apart from the main path's. Returns what the kernels line
    carries."""
    from tensorframes_tpu_torch.ops.flash_attention import flash_attention

    lms = {}
    for name, over in (("head_dim_128", dict(n_heads=2)), ("head_dim_256", dict(n_heads=1)),
                       ("head_dim_15", dict(d_model=240, n_heads=16))):
        lm_cfg = {**cfg, **over}
        flash_attention.launches = 0
        phase_transformer(tft, lm_cfg, n_seqs, block_seqs, phase=f"transformer_{name}")
        expected = lm_cfg["n_layers"] * (n_seqs // block_seqs)
        if flash_attention.launches != expected:
            raise AssertionError(
                f"TransformerLM {name}: {flash_attention.launches} kernel launches, "
                f"expected n_layers x blocks = {expected}")
        lms[name] = dict(config=lm_cfg, launches=flash_attention.launches)
        torch.cuda.empty_cache()
    rings = {}
    for name, over in (("head_dim_15", dict(d_model=240, n_heads=16)),
                       ("head_dim_256", dict(n_heads=1))):
        rings[name] = _ring_scoring({**cfg, **over}, cards=1)
        torch.cuda.empty_cache()
    out = dict(lm_scoring=lms, ring_scoring=rings)
    _emit("attention_widths", **out)
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    if argv:
        print(f"chip_smoke.py: unknown arguments {argv} (it takes none)", file=sys.stderr)
        return 2
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch.ops.flash_attention import flash_attention
    from tensorframes_tpu_torch.ops.factorize_keys import factorize as factorize_keys
    from tensorframes_tpu_torch.ops.keyed_sums import keyed_sums

    # widths of benchmarks/train_bench.py, max_seq of examples/long_context.py
    cfg = dict(vocab=256, d_model=256, n_heads=4, n_layers=4, max_seq=2048)
    n_seqs, block_seqs = 64, 8
    lm_shape = (block_seqs * cfg["n_heads"], cfg["max_seq"], cfg["d_model"] // cfg["n_heads"])

    phase_card_and_build()
    # phases 3-17 and 7 run on one card, as their checks assume; phase 18
    # places its blocks itself (devices=, "on", "global")
    tft.config.update(block_scheduler="off")

    # the main path: every launch counter starts at 0 here
    flash_attention.launches = 0
    flash_attention.launches_by_route = dict.fromkeys(flash_attention.launches_by_route, 0)
    keyed_sums.launches = 0
    factorize_keys.launches = dict.fromkeys(factorize_keys.launches, 0)
    verbs_df = phase_graph_verbs(tft)
    phase_map_rows_mlp(tft)
    sums, factorized = phase_aggregate(tft)
    phase_kmeans(tft)
    phase_inception(tft)
    phase_control_flow(tft)
    phase_freezing(tft, verbs_df)
    del verbs_df
    phase_frame_breadth(tft)
    phase_streaming(tft)
    phase_lazy_and_spark(tft)
    phase_training_and_moe(tft, cfg)
    phase_serving(tft)
    phase_runtime_services(tft)
    phase_mesh_verbs(tft)
    phase_scheduler_and_global(tft)
    # the ranks' launches are their own processes' counts
    launched = flash_attention.launches + phase_multihost(tft)
    if launched:
        raise AssertionError(
            f"the verb, aggregate, k-means, Inception, control-flow, freezing, "
            f"frame-breadth, streaming, lazy-plan, training, serving, runtime-services, "
            f"mesh, scheduler and multihost phases launched flash_attention {launched} "
            f"times; none of their graphs holds attention"
        )
    # every segment plan of these phases that sums on the card
    sums["launches"] = keyed_sums.launches
    phase_transformer(tft, cfg, n_seqs, block_seqs)
    launches = flash_attention.launches
    main_routes = {r: n for r, n in flash_attention.launches_by_route.items() if n}
    expected = cfg["n_layers"] * (n_seqs // block_seqs)
    if launches != expected or main_routes != {"cuda_core": expected}:
        raise AssertionError(
            f"flash_attention launched {launches} times on the main path ({main_routes}), "
            f"expected n_layers x blocks = {expected}, all on the float32 kernel"
        )
    if torch.cuda.device_count() >= 2:
        # counted apart from the main path's launches read above
        phase_scheduled_lm(tft, cfg)
    # phase 19 counts the ring's launches apart, from 0 before its scoring
    par = phase_parallel_models(cfg, lm_shape)
    if torch.cuda.device_count() >= 2:
        phase_parallel_models(cfg, lm_shape, cards=torch.cuda.device_count())
    # phase 21 counts its launches apart, from 0 before each LM
    widths = phase_attention_widths(tft, cfg, n_seqs, block_seqs)

    print(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "tensorframes_tpu_torch/csrc/flash_attention.cuh",
        # the CUDA-core kernels (float32 up to head_dim 128 in one slice,
        # float32 past 128 in the wide kernel) and the tensor-core kernels
        # of bf16 and fp16 at every head_dim
        "headers": ["tensorframes_tpu_torch/csrc/flash_attention.cuh",
                    "tensorframes_tpu_torch/csrc/flash_attention_tc.cuh"],
        # one library an element type; the 2-byte ones include both headers
        "builds": ["tensorframes_tpu_torch/csrc/flash_attention.cu",
                   "tensorframes_tpu_torch/csrc/flash_attention_f16.cu",
                   "tensorframes_tpu_torch/csrc/flash_attention_bf16.cu"],
        "replaces": "tensorframes_tpu/ops/pallas_kernels.py:122",
        "launches": launches,
        "launches_by_route": main_routes,
        "lse_max_abs_err": par["lse_entry"]["max_abs_err"],
        "half_max_abs_err": par["lse_entry"]["half_max_abs_err"],
        "ring_launches": par["ring_scoring"]["ring_launches"],
        "ring_max_abs_err": par["ring_scoring"]["max_abs_err"],
        # phase 21: the LMs and rings at other head widths, counted apart
        "lm_launches_by_head_dim": {k: r["launches"] for k, r in widths["lm_scoring"].items()},
        "ring_launches_by_head_dim": {
            k: r["ring_launches"] for k, r in widths["ring_scoring"].items()},
    }, {
        "name": "keyed_sums",
        "route": "cuda",
        "source": "tensorframes_tpu_torch/csrc/keyed_sums.cu",
        # the segment plan's sums and counts; the JAX package leaves them to XLA
        "replaces": None,
        **sums,
    }, {
        "name": "factorize_keys",
        "route": "cuda",
        "source": "tensorframes_tpu_torch/csrc/factorize_keys.cu",
        # the aggregate's key stage; the JAX package leaves it to XLA's sort
        "replaces": None,
        "launches": dict(factorize_keys.launches),
        **factorized,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-worker"]:
        sys.exit(_multihost_worker(json.loads(sys.argv[2])))
    sys.exit(main(sys.argv[1:]))
