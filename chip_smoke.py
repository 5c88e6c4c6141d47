#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`tensorframes_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, then drives the port's
main path through the entry points a user calls:

1. the card's name and power limit, and the kernel build;
2. the flash-attention kernel against `flash_attention_reference` at the
   shapes of `tests/test_pallas.py`, at the kernel's edge shapes and at the
   LM's shape, with times;
3. the graph verbs at `bench.py`'s data size: `map_blocks` of x+3 and
   `reduce_blocks` sum / min over 200,000,000 float32 rows in 8 blocks;
   then `reduce_rows` over the same column through its monoid plan (sum,
   min), and a non-associative fold (0.5 x_1 + x_2, 20,000 rows in 8
   blocks) through its general plan;
4. `map_rows` of `models.MLP`'s 512-512-512-10 scoring graph over 1,000,000
   rows, and the same weights through the function front end (`map_rows`
   of a plain function with the weights bound);
5. keyed `aggregate`: BASELINE config 4 (mean and variance of 100,000,000
   rows x 8 float32 values over 16 int64 keys) through the segment plan,
   and a Div-rooted graph over 1,000,000 rows and 1,000 keys of uneven
   size through the exact plan; then a ``reduce_sum(x * 2)`` +
   ``reduce_max(x)`` graph over 1,000,000 x 8 float32 rows in 1,000 groups
   of all-distinct sizes with the segment plan off: the chunk plan (one
   vmapped call a power-of-two chunk size) and the exact plan (one a
   distinct size);
6. `models.kmeans` at the k-means demo's widths (dim 100, k 10, 10
   iterations) over 10,000,000 float32 rows in 8 blocks, one iteration
   held against a numpy float64 Lloyd step;
7. `TransformerLM` scoring through `map_blocks` with a plain function, and
   the attention kernel's share of that call's wall time;
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
    1,000 string ids), a bytes pass-through over 10,000,000 rows, and the
    function front end on all-empty frames;
12. out-of-core streaming: `reduce_blocks_stream` of the README vector
    `reduce_sum` (with a `reduce_min`) as GraphDef bytes over the north
    star's 1,000,000,000 float32 rows in chunks of 128,000,000
    (`examples/billion_row_reduce.py`), with the H2D rate of one pinned
    chunk, the on-chip and ingest rates, the device's busy share and its
    peak memory; the same stream over 256,000,000 rows with the ingest
    pipeline on and off; 16 Parquet and 16 Arrow IPC shards (4,000,000
    rows of ``x`` float32 and ``v`` float32[8], uneven row groups, one
    empty shard) through `stream_dataset`; that stream made durable, cut
    by its deadline and resumed in a fresh process; and a slow stream's
    deadline, after which no pipeline thread may live;
13. lazy plans and the Spark bridge: `benchmarks/fusion_bench.py`'s three
    maps + `reduce_sum` over phase 3's 200,000,000 float32 rows in 8 blocks,
    fused (`df.lazy()`) against eager, with the lowered programs, the block
    calls, a second fused run's cache misses and the peak device memory of
    each way; the same maps over a host-resident base through `force()`
    with the plan-prep pipeline on and off; `benchmarks/relational_bench.py`'s
    plan (`scan -> filter(x > its 95th percentile) -> map_blocks(x*0.5+1) ->
    group_by(y).agg(sum, max)`) over 16 Parquet shards x 8 row groups x
    500,000 float64 rows with the optimizer on and off, and the rows each
    way decoded; a `sort_by` of 10,000,000 device rows and an inner join of
    10,000,000 x 1,000 keys with their device-to-host bytes; and
    `spark.reduce_blocks` / `map_blocks` / `aggregate` over a duck-typed
    Spark DataFrame of 16 partitions x 2,000,000 rows (``k`` int64 of 16
    keys, ``x0``..``x7`` float64); and a second `force()` of the three maps
    over a 20,000,000-row host base served by the materialization cache
    (no block dispatch, equal to the first force);
14. training and the expert FFN: `TransformerLM` at phase 7's widths
    trained by SGD (lr 0.1, `benchmarks/train_bench.py`'s) on 8 x 2,048
    tokens through the plain attention `full_attention`, one warm-up step
    and 5 timed, step 1's loss and four gradients held against float64 on
    the card, the loss falling; `flash_attention` refusing a gradient; a
    `save_params` / `load_params` round trip that scores the same; the MLP
    (512-512-512-10) trained by Adam through `make_train_step` on 65,536
    rows of a column `map_blocks` produced, 10 timed steps, step 1 against
    float64; `MoEFFN.apply` at Mixtral-8x7B's published widths (hidden
    4096, intermediate 14336, 8 experts, top 2) over 4,096 float32 tokens,
    its first 256 tokens against float64 with the same routing;
15. the serving runtime, through `ServingClient` over loopback HTTP:
    (a) `benchmarks/serving_bench.py`'s elementwise endpoint at its sizes
    (48 requests of 2,041-2,047 rows, 8 clients, ``max_batch_rows``
    16,384), serially and concurrently, every response bit-identical to a
    direct `map_blocks`, the requests coalesced and no new lowering after
    `warm()`; (b) the 512-512-512-10 MLP endpoint (BASELINE config 3, not
    batchable, so inline) with 8 clients x 16 requests of 2,048 rows, its
    rates, latencies and the device's busy share; (c) a 429 with
    ``Retry-After`` and a 504 under an injected hang, the /metrics,
    /healthz and /trace scrapes, and `drain()` freeing the port;
16. runtime services: the autotuner over the live profile phase 15 left
    (the same recommendations twice; a knob pinned through `update()` that
    `apply` leaves alone); the cost ledger over phase 3's x+3 map (200M
    rows, 8 blocks) and phase 4's MLP ``map_rows`` (graph route), with
    every cached program's flops, bytes and footprint, the MLP's flops and
    the map's bytes against their hand counts and every roofline fraction
    in (0, 1.05] (execute time from the dispatch spans' CUDA events); the
    ledger's overhead on the x+3 map (at most 5%); ``/diagnostics`` and
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
    left on their shards (timed beside the local and the ``mesh=`` map),
    the ``"global"`` auto-route, a `LazyFrame.force` and `filter_global` on
    the shards, and a stream of 4 x 128,000,000 rows through the
    double-buffered accumulator; on two or more cards, after phase 7, a
    ``devices=`` `TransformerLM` scoring of 16 sequences, its kernel
    launches counted apart from the main path's;
19. the sequence, pipeline, expert and 3-D parallel paths, after the main
    path's launches are read (their launches counted apart), every mesh a
    set of slots on cuda:0 (and again over every card where there are
    two or more): the kernel's log-sum-exp entry against its plain version
    at the LM's shape (causal and not) and at head_dim 128, timed in turns
    with the entry without it; phase 7's `TransformerLM` scoring 8
    sequences through `apply(mesh=)` on a 4-slot ``data`` mesh (the ring:
    n_layers x 10 launches of that entry) against `apply`;
    `ring_attention_reference`'s gradients on one head of the LM's shape
    against float64; `seq_all_to_all` of (2048, 8, 64) over 4 slots and
    back, exact; `pipeline_apply` of 4 linear + ReLU stages (d 2048, batch
    8,192, 8 microbatches); `MoEFFN.apply_ep` at phase 14's Mixtral widths
    over 8 ``model`` slots; the 512-512-512-10 MLP's sharded step on a 2 x 2
    mesh; and `TransformerLM.sharded_train_step_3d` at
    `benchmarks/train_bench.py`'s widths on a 2 x 2 x 2 mesh, every
    parameter against the single-card step, with 5 timed steps;
20. multi-process execution (`parallel.multihost`), after phase 18: one
    rank a card (``torch.cuda.device_count()`` processes started with the
    torchrun environment, NCCL, never a gloo fallback), each owning 1/N of
    phase 17's 200,000,000 float32 rows (x+3 `map_blocks`, `reduce_blocks`
    sum and min over a `SpanningFrame`), of 100,000,000 x 8 float32 rows
    through `aggregate_global` (sum and mean) with 16 int64 keys and again
    with 16 string keys, and of 1,000,000 ragged rows through
    `analyze_global`; every rank's results held to numpy float64 and, at
    one rank, to the single-process ``mesh=data_mesh()`` verbs, with each
    verb's wall time and rows/s; any rank's failure or timeout (300 s)
    fails the run;
21. attention at every width and dtype, after phase 19, its launches
    counted apart from the main path's: both kernel entries against the
    plain version at head_dim 1, 15, 24, 120, 136, 200, 256 and 512 (ragged
    S, causal and not), negative and zero scales, JAX's ``(S, D)`` and
    ``(B, H, S, D)`` layouts, transposed and misaligned inputs, float64
    and int32 (through float32), bf16 and fp16 loaded by the kernels (within
    one unit in their last place, at widths up to 1000, every one asserted
    on the tensor-core kernels); one causal head of 65,535 x 64 + 1 rows;
    phase 7's scoring route and widths with 2, 1 and 16 heads (head_dim
    128, 256 and 15; d_model 240 for the last) and phase 19's ``mesh=``
    ring at head_dim 15 and 256, each against the plain attention; the
    kernels at D 128, 136 and 256 (BH 16, S 2048) and at the LM's shape,
    float32, bf16 and fp16, at D 512 in float32 and at D 384, 512 and 576
    in bf16 and fp16, timed beside the plain version, SDPA of the same
    dtype and the bound. ``python3
    chip_smoke.py --phase 21`` runs phases 1 and 21 alone and prints no
    result line;
22. one JSON line listing every kernel with its launches on the main path
    (phases 3-18 and 20), its error and its times, the ring's launches and
    phase 21's variants;
23. as the last line, ``{"ok": true, "device": {...}}``.

Phases 3-17 run with ``block_scheduler="off"``: they measure one card.
Phases 8-18 and 20 run after phase 6 and before phase 7. Phases 3-6, 8-18
and 20 run no hand-written kernel (their ops are ATen, cuBLAS and cuDNN
calls, host numpy, the stream's copies and NCCL; phase 14 trains through
the plain attention; phases 15-18 run graphs of elementwise ops and
products), so the script checks that the attention kernel's count is
still 0 after them (phase 20's ranks report their own counts) and counts
its launches in phase 7 alone. Phase 15 needs pyarrow (the
serving wire format is Arrow IPC). Phase 12 imports pyarrow for its dataset and durable parts, and
prints them as skipped where pyarrow is missing; phase 13 needs pyarrow and
pandas and fails without them. The port factorizes string keys with pandas
where pandas imports, and in one dict pass where it does not; phase 11
times both.

Every check raises on failure, so the script exits non-zero and prints no
result line. Without a CUDA device it exits non-zero at once. It imports
nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA's data sheet): float32 outside the
# tensor cores, and HBM3 bandwidth. `bound_ms` is computed against them.
_PEAK_F32_FLOPS = 67e12
_PEAK_HBM_BYTES = 3.35e12

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


def _time_ms(fn, iters: int) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls
    after one warm-up call, the stream first held by a spin kernel long
    enough for the host to queue every call: where a call's host work
    (a wrapper's layout step, the launch) outlasts its kernel, back-to-back
    calls leave the device waiting and `_time_ms` reads the host."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000 * iters)  # ~0.5 ms of clock cycles a call
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _wall(fn):
    """(result, seconds) of ``fn()`` ending in a device synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _plan_ran(what: str, key: str, *also: str) -> None:
    """Raise unless the verb call since the last `reset_stats` took exactly
    the plan ``key``, and the steps ``also`` once each (the port's plan
    counters)."""
    from tensorframes_tpu_torch.utils.profiling import stats

    want = dict.fromkeys((key, *also), 1.0)
    if stats() != want:
        raise AssertionError(f"{what}: expected {want}, counters say {stats()}")


def _attention_bound(bh: int, s: int, d: int, causal: bool, elem_bytes: int = 4,
                     peak_flops: float = _PEAK_F32_FLOPS, products: int = 2):
    """(bound_ms, bound_by) of attention over (bh, s, d) elements of
    ``elem_bytes`` bytes: ``products`` products of depth or width d (Q K^T
    and P V; 3 where P V runs twice, for the P pair) at 2 operations per
    multiply-add over the pairs the mask keeps, at ``peak_flops``, against
    q, k, v read once and o written once."""
    pairs = s * (s + 1) // 2 if causal else s * s
    t_ops = 2 * products * d * pairs * bh / peak_flops
    t_bytes = 4 * bh * s * d * elem_bytes / _PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# attention kernels the three libraries compile: float32 at head_dim 8-128
# (16 widths), the tensor-core kernels of bf16 and fp16 at 1-8, 10, 12, 14
# and 16 k16 steps (12 widths) and past 256 (5 shapes: a resident Q tile of
# 5, 6, 8 or 9 boxes, windows of 4 reloaded past it), the float32 wide
# kernel; each with and without the log-sum-exp
_TC_INSTANTIATIONS = 2 * (12 + 5) * 2
_INSTANTIATIONS = 16 * 2 + _TC_INSTANTIATIONS + 2


def _ptxas_line(log: str, d: int, lse: bool = False):
    """ptxas's resource and spill lines for the float32 head_dim-``d``
    attention kernel (the instantiation that stores the log-sum-exp with
    ``lse``), from the build log, or None for a cached build."""
    m = re.search(
        rf"Compiling entry function '[^']*flash_attention_kernelILi{d}ELb{int(lse)}E.*?"
        r"(\d+ bytes stack frame, \d+ bytes spill stores, \d+ bytes spill loads)"
        r".*?(Used [^\n]*)",
        log, re.S,
    )
    return f"{m.group(2)}; {m.group(1)}" if m else None


def _ptxas_table(logs) -> dict:
    """Every kernel instantiation in the build logs: its mangled name's
    template arguments -> (registers, spill store bytes, spill load bytes,
    stack frame bytes)."""
    table = {}
    for name, log in sorted(logs.items()):
        for m in re.finditer(
            r"Compiling entry function '[^']*?(flash_attention\w*kernel)(I\w*?EE)\w*'.*?"
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads"
            r".*?Used (\d+) registers",
            log, re.S,
        ):
            key = f"{name}:{m.group(1)}{m.group(2)}"
            table[key] = [int(m.group(6)), int(m.group(4)), int(m.group(5)), int(m.group(3))]
    return table


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


# the card's name and power limit as nvidia-smi gives them, set by phase 1
# and printed beside the numbers of the later phases
_CARD = None


def phase_card_and_build() -> None:
    global _CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    _CARD = smi.stdout.strip().splitlines()[0]
    print(_CARD, flush=True)

    from tensorframes_tpu_torch.ops import _cuda_build

    t0 = time.perf_counter()
    libs = _cuda_build.build_all()
    seconds = time.perf_counter() - t0
    # ptxas's registers and spills for the float32 head_dim-64 kernel the LM
    # runs and for head_dim 128; every instantiation must spill nothing: the
    # float32 kernel at head_dim 8-128, the tensor-core kernels of bf16 and
    # fp16 at 1-8, 10, 12, 14 and 16 k16 steps (padded head_dim up to 256)
    # and past 256, the float32 wide kernel, each with and without the
    # log-sum-exp. The tensor-core kernels are built for wgmma pipelines:
    # ptxas must not serialize them (its C7510-C7520 notes)
    log = _cuda_build.build_logs.get("flash_attention", "")
    ptxas = _ptxas_table(_cuda_build.build_logs)
    spilled = {k: r for k, r in ptxas.items() if r[1] or r[2]}
    if spilled:
        raise AssertionError(f"ptxas spilled in {spilled} ([registers, stores, loads, stack])")
    tc = {k: r[0] for k, r in ptxas.items() if "flash_attention_tc_" in k}
    if ptxas and (len(ptxas) != _INSTANTIATIONS or len(tc) != _TC_INSTANTIATIONS):
        raise AssertionError(
            f"ptxas compiled {len(ptxas)} attention kernels ({len(tc)} tensor-core), "
            f"expected {_INSTANTIATIONS} ({_TC_INSTANTIATIONS})")
    serialized = sorted({
        line.strip() for build_log in _cuda_build.build_logs.values()
        for line in build_log.splitlines()
        if "wgmma.mma_async instructions are serialized" in line})
    if serialized:
        raise AssertionError(f"ptxas serialized the tensor-core kernel's wgmma: {serialized[:3]}")
    _emit(
        "build", libraries=sorted(libs), seconds=seconds,
        ptxas_d64=_ptxas_line(log, 64), ptxas_d128=_ptxas_line(log, 128),
        ptxas_instantiations=len(ptxas), ptxas_spill_bytes=0,
        ptxas_tensor_core_registers=tc, ptxas_registers=ptxas,
    )


def phase_kernel_vs_plain(lm_shape):
    from tensorframes_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = [  # (bh, seq, d, causal)
        # tests/test_pallas.py's shapes
        (1, 64, 16, False), (1, 128, 8, False), (1, 256, 32, False),
        (1, 128, 16, True), (1, 100, 8, False), (1, 75, 8, True),
        # ragged ends against the 64-row query and key tiles (and against
        # 128-row query tiles), a single row, an odd width, the non-causal
        # path at the LM's length, the widest head
        (3, 200, 64, True), (2, 129, 128, True), (1, 1, 8, False),
        (4, 1000, 40, True), (2, 2048, 64, False), (8, 1024, 128, True),
        (*lm_shape, True),
    ]
    errs = []
    for bh, s, d, causal in shapes:
        q, k, v = (
            torch.randn(bh, s, d, device="cuda", generator=gen) for _ in range(3)
        )
        out = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = flash_attention_reference(q, k, v, causal=causal)
        errs.append(_check_close(
            f"flash_attention {(bh, s, d)} causal={causal}", out, ref,
            _ATTN_RTOL, _ATTN_ATOL,
        ))

    # the kernel folds a negative scale's sign into the staged Q tile; a
    # zero scale gives every visible key the same weight
    qs, ks, vs = (torch.randn(2, 200, 64, device="cuda", generator=gen) for _ in range(3))
    scale_errs = []
    for scale in (-0.125, 0.0):
        out = flash_attention(qs, ks, vs, causal=True, scale=scale)
        torch.cuda.synchronize()
        ref = flash_attention_reference(qs, ks, vs, causal=True, scale=scale)
        scale_errs.append(_check_close(
            f"flash_attention (2, 200, 64) causal scale={scale}", out, ref,
            _ATTN_RTOL, _ATTN_ATOL,
        ))

    # times at the LM's shape (q, k, v of the last case)
    ms = _time_ms(lambda: flash_attention(q, k, v, causal=True), 20)
    plain_ms = _time_ms(lambda: flash_attention_reference(q, k, v, causal=True), 10)
    # SDPA on a (1, BH, S, D) view, where its fused kernels run; on the
    # (BH, S, D) tensors themselves it takes its plain math path, the
    # yardstick PERF.md's earlier rows record (library_ms_3d)
    library_ms = _time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True),
        20,
    )
    library_ms_3d = _time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True),
        20,
    )
    bound_ms, bound_by = _attention_bound(*lm_shape, True)
    result = dict(
        max_abs_err=max(errs + scale_errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms, library_ms_3d=library_ms_3d,
    )
    _emit(
        "flash_attention_vs_plain",
        shapes=[list(s) for s in shapes], max_abs_err_each=errs,
        scales_at_2x200x64_causal={"-0.125": scale_errs[0], "0.0": scale_errs[1]},
        tolerance={"rtol": _ATTN_RTOL, "atol": _ATTN_ATOL}, **result,
    )
    return result


def phase_graph_verbs(tft):
    n, blocks = 200_000_000, 8
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.rand(n, device="cuda", generator=gen)  # float32
    df = tft.TensorFrame([tft.Column("x", x)]).repartition(blocks)

    z = (tft.block(df, "x") + 3.0).named("z")
    tft.map_blocks(z, df)  # lowers once; the timed call reuses it
    out, map_s = _wall(lambda: tft.map_blocks(z, df))
    zt = out.column("z").values
    if zt.dtype != torch.float32 or not torch.equal(zt, x + 3.0):
        raise AssertionError("map_blocks x+3 disagrees with x + 3")
    del out, zt

    s = tft.dsl.reduce_sum(tft.block(df, "x", tf_name="x_input")).named("x")
    mn = tft.dsl.reduce_min(tft.block(df, "x", tf_name="x_input")).named("x")
    tft.reduce_blocks(s, df)
    got_sum, sum_s = _wall(lambda: tft.reduce_blocks(s, df))
    tft.reduce_blocks(mn, df)
    got_min, min_s = _wall(lambda: tft.reduce_blocks(mn, df))

    xh = x.cpu().numpy()
    want_sum, want_min = float(xh.sum(dtype=np.float64)), xh.min()
    if got_min.dtype != torch.float32 or got_min.item() != want_min:
        raise AssertionError(f"reduce_min {got_min.item()} != numpy {want_min}")
    sum_rel = abs(got_sum.item() - want_sum) / abs(want_sum)
    if got_sum.dtype != torch.float32 or sum_rel > _SUM_RTOL:
        raise AssertionError(f"reduce_sum rel err {sum_rel:.3e} > {_SUM_RTOL}")
    _emit(
        "graph_verbs", rows=n, blocks=blocks,
        map_blocks_s=map_s, map_blocks_rows_per_s=n / map_s,
        reduce_sum_s=sum_s, reduce_min_s=min_s,
        reduce_sum_rel_err=sum_rel, sum_rtol=_SUM_RTOL,
    )
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
        got, secs = _wall(lambda: tft.reduce_rows(g, df))
        _plan_ran(f"reduce_rows {name}", "reduce_rows.plan.monoid")
        out[name] = (got, secs)
    got_min, min_s = out["min"]
    if got_min.dtype != torch.float32 or got_min.item() != want_min:
        raise AssertionError(f"reduce_rows min {got_min.item()} != numpy {want_min}")
    got_sum, sum_s = out["sum"]
    sum_rel = abs(got_sum.item() - want_sum) / abs(want_sum)
    if got_sum.dtype != torch.float32 or sum_rel > _SUM_RTOL:
        raise AssertionError(f"reduce_rows sum rel err {sum_rel:.3e} > {_SUM_RTOL}")

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    y = torch.rand(fold_rows, device="cuda", generator=gen)
    fdf = tft.TensorFrame([tft.Column("x", y)]).repartition(fold_blocks)
    g = _pair_graph(tft, lambda a, b: a * 0.5 + b)
    tft.reduce_rows(g, fdf)  # lowers once
    reset_stats()
    got_fold, fold_s = _wall(lambda: tft.reduce_rows(g, fdf))
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
        "reduce_rows", rows=n, blocks=df.num_blocks,
        monoid_sum_s=sum_s, monoid_sum_rows_per_s=n / sum_s, monoid_min_s=min_s,
        monoid_min_rows_per_s=n / min_s, monoid_sum_rel_err=sum_rel, sum_rtol=_SUM_RTOL,
        general_rows=fold_rows, general_blocks=fold_blocks, general_s=fold_s,
        general_rows_per_s=fold_rows / fold_s, general_rel_err=fold_rel,
        general_rtol=_FOLD_RTOL,
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
    tft.map_rows(probs, df)  # lowers once
    out, secs = _wall(lambda: tft.map_rows(probs, df))
    got = out.column("probs").values
    if tuple(got.shape) != (rows, sizes[-1]) or not torch.isfinite(got).all():
        raise AssertionError(f"map_rows MLP: bad output {tuple(got.shape)}")

    # the same weights through the function front end, bound once per call
    bound = {f"{p}{i}": t for i, wb in enumerate(params) for p, t in zip("wb", wb)}

    def score(features, w0, b0, w1, b1, w2, b2):
        h = torch.relu(features @ w0 + b0)
        h = torch.relu(h @ w1 + b1)
        return {"probs": torch.softmax(h @ w2 + b2, dim=-1)}

    tft.map_rows(score, df, bindings=bound)
    fn_out, fn_secs = _wall(lambda: tft.map_rows(score, df, bindings=bound))
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
        "map_rows_mlp", rows=rows, sizes=sizes, seconds=secs, rows_per_s=rows / secs,
        function_seconds=fn_secs, function_rows_per_s=rows / fn_secs,
        checked_rows=len(idx), max_abs_err=err, function_max_abs_err=fn_err,
        graph_vs_function_max_abs_err=routes_err,
        tolerance={"rtol": _MLP_RTOL, "atol": _MLP_ATOL},
    )


def phase_aggregate(tft, rows: int = 100_000_000, dim: int = 8, nkeys: int = 16,
                    exact_rows: int = 1_000_000, exact_keys: int = 1000) -> dict:
    """BASELINE config 4 through the segment plan (one keyed-sums launch a
    call), the keyed-sums kernel alone against its plain version on the
    same card tensors, then a graph the segment plan refuses (its root is a
    Div) through the exact plan. Returns what the kernels line carries of
    the keyed-sums kernel and of the key factorization kernel."""
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
    first, first_s = _wall(lambda: tft.aggregate([m, q], grouped, feed_dict=feed))
    del first
    reset_stats()
    out, seg_s = _wall(lambda: tft.aggregate([m, q], grouped, feed_dict=feed))
    _plan_ran("aggregate mean/variance", "aggregate.plan.segment", "aggregate.segment.kernel",
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

    # the plan's float segment sum alone (chunks, then a tree sum over
    # them), and one float32 index_add over all rows in its place
    from tensorframes_tpu_torch.ops.standard import segment_reduce

    vsq = v * v
    segment_sum_ms = _time_ms(lambda: segment_reduce(vsq, keys, nkeys, "sum"), 5)

    def one_level():
        return torch.zeros(nkeys, dim, device="cuda").index_add_(0, keys, vsq)

    one_level_ms = _time_ms(one_level, 5)
    one_level_sq = one_level().cpu().numpy()

    # the keyed-sums kernel and its plain version on the same card tensors:
    # the same counts, means within 1e-6 of each other
    (ks_s, ks_q), ks_counts = ks.keyed_sums([v, vsq], keys, nkeys)
    (pl_s, pl_q), pl_counts = ks.keyed_sums_reference([v, vsq], keys, nkeys)
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
    ks_ms = _time_ms(lambda: ks.keyed_sums([v, vsq], keys, nkeys), 20)
    ks_plain_ms = _time_ms(lambda: ks.keyed_sums_reference([v, vsq], keys, nkeys), 3)

    def library():  # the segment plan's step before the kernel
        segment_reduce(v, keys, nkeys, "sum")
        segment_reduce(vsq, keys, nkeys, "sum")
        torch.bincount(keys, minlength=nkeys)

    ks_library_ms = _time_ms(library, 3)
    del vsq
    factorize = _factorize_at_the_cell_shape(rows, nkeys)

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
    one_level_rel_err = float(np.abs(one_level_sq / (want_q * counts[:, None]) - 1).max())
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
    eout, exact_s = _wall(lambda: tft.aggregate(ratio, egrouped))
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
        "aggregate", rows=rows, dim=dim, keys=nkeys, segment_first_s=first_s,
        segment_s=seg_s, segment_rows_per_s=rows / seg_s, mean_max_abs_err=mean_err,
        mean_of_squares_max_abs_err=sq_err, variance_max_abs_err=var_err,
        mean_rtol=_SUM_RTOL, segment_sum_ms=segment_sum_ms,
        one_level_index_add_ms=one_level_ms,
        one_level_sum_of_squares_rel_err=one_level_rel_err,
        exact_rows=exact_rows, exact_keys=len(present),
        exact_distinct_sizes=len(np.unique(sizes[present])), exact_s=exact_s,
        exact_rows_per_s=exact_rows / exact_s, exact_max_abs_err=exact_err,
        exact_rtol=_SUM_RTOL,
    )
    del eout, edf, egrouped, ek, ev, u
    _chunk_and_exact(tft)
    # ids and both outputs read once at the HBM peak
    bound_ms = rows * (8 + 2 * dim * 4) / _PEAK_HBM_BYTES * 1e3
    return {
        "segment_plan_launches": segment_launches, "ms": ks_ms, "plain_ms": ks_plain_ms,
        "library_ms": ks_library_ms, "bound_ms": bound_ms, "share_of_bound": bound_ms / ks_ms,
        "mean_max_rel_err": ks_err, "plain_max_rel_gap": ks_plain_gap,
        "shape": [rows, dim, nkeys, 2],
    }, factorize


def _factorize_at_the_cell_shape(rows: int, nkeys: int) -> dict:
    """The key factorization kernel on ``rows`` int64 keys drawn uniformly
    from ``nkeys`` (``meanvar.k16``'s keys) against ``torch.unique``, the
    route it replaces: equal bit for bit, and each call's time between CUDA
    events (the one host read of the distinct count included). Returns what
    the kernels line carries of it."""
    from tensorframes_tpu_torch.ops import _cuda_build
    from tensorframes_tpu_torch.ops import factorize_keys as fk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    keys = torch.randint(0, nkeys, (rows,), device="cuda", generator=gen)
    (uniq, inverse), (want_uniq, want_inverse) = fk.factorize(keys), fk.factorize_reference(keys)
    equal = (uniq.dtype == want_uniq.dtype and torch.equal(uniq, want_uniq)
             and torch.equal(inverse, want_inverse))
    if not equal:
        raise AssertionError("factorize_keys: the kernel's keys or inverse differ from torch.unique's")
    del uniq, inverse, want_uniq, want_inverse
    ms = _time_ms(lambda: fk.factorize(keys), 20)
    plain_ms = _time_ms(lambda: fk.factorize_reference(keys), 3)
    # each key read twice, each group id written once, at the HBM peak
    bound_ms = rows * 8 * 3 / _PEAK_HBM_BYTES * 1e3
    ptxas = {}  # kernel<key type> -> [registers, spill store bytes, spill load bytes]
    for m in re.finditer(
        r"Compiling entry function '\w*?\d([a-z_]+_kernel)(I[ix]E)?\w*'.*?(\d+) bytes spill stores, "
        r"(\d+) bytes spill loads.*?Used (\d+) registers",
        _cuda_build.build_logs.get("factorize_keys", ""), re.S,
    ):
        key = m.group(1) + {"IiE": "<int32>", "IxE": "<int64>"}.get(m.group(2), "")
        ptxas[key] = [int(m.group(5)), int(m.group(3)), int(m.group(4))]
    if any(r[1] or r[2] for r in ptxas.values()):
        raise AssertionError(f"factorize_keys: ptxas spilled ([registers, stores, loads]): {ptxas}")
    return {"ms": ms, "bound_ms": bound_ms, "share_of_bound": bound_ms / ms, "plain_ms": plain_ms,
            "equal_to_plain": equal, "ptxas_registers_spills": ptxas, "shape": [rows, nkeys]}


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
            res, secs = _wall(lambda: tft.aggregate([s2, mx], grouped, feed_dict=feed))
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
        out[plan] = dict(seconds=secs, rows_per_s=rows / secs, vmapped_calls=calls,
                         sum_max_abs_err=s_err, max_exact=True)
        del res
    _emit(
        "aggregate_chunk_and_exact", card=_CARD, rows=rows, dim=dim, keys=nkeys,
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

    (one_c, one_n), one_s = _wall(lambda: kmeans(df, "features", k, num_iters=1, seed=SEED))
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

    (cs, ns), secs = _wall(lambda: kmeans(df, "features", k, num_iters=iters, seed=SEED))
    if cs.shape != (k, dim) or not np.isfinite(cs).all() or ns.sum() != rows:
        raise AssertionError(f"kmeans: bad result {cs.shape}, {ns.sum()} points counted")
    _emit(
        "kmeans", rows=rows, dim=dim, k=k, blocks=blocks, iterations=iters,
        seconds=secs, s_per_iteration=secs / iters, rows_per_s=rows * iters / secs,
        one_iteration_s=one_s, centre_max_abs_err=centre_err,
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

    def score():
        return tft.map_blocks(wire, df, fetch_names=["probs"], trim=True)

    # the first call lowers the graph and lets cuDNN choose and cache its
    # plans for these shapes; the timed call finds them cached
    first, first_s = _wall(score)
    del first
    torch.cuda.reset_peak_memory_stats()
    out, secs = _wall(score)
    peak = torch.cuda.max_memory_allocated()
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
    # the graph's operations (convolutions and the matmul, 2 per
    # multiply-add), counted by torch's FLOP counter on one CPU image
    from torch.utils.flop_counter import FlopCounterMode

    from tensorframes_tpu_torch.ops.lowering import build_callable

    one = build_callable(graph, ["probs"], ["images"], torch.device("cpu"))
    with FlopCounterMode(display=False) as flops:
        one(torch.zeros(1, image_size, image_size, 3))
    flop_per_image = flops.get_total_flops()
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
        width=width, classes=classes, graph_bytes=len(wire), first_call_s=first_s,
        seconds=secs, images_per_s=images / secs, gflop_per_image=flop_per_image / 1e9,
        achieved_tflop_s=flop_per_image * images / secs / 1e12,
        float32_bound_s=flop_per_image * images / _PEAK_F32_FLOPS,
        cudnn_plans="cached (the timed call follows an untimed call at the same shapes)",
        peak_memory_bytes=peak, checked_images=checked, max_abs_err=err,
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
        out, secs = _wall(lambda: tft.map_rows(data, df, fetch_names=fetches))
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
            seconds=secs, rows_per_s=rows / secs,
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
    out, block_s = _wall(lambda: tft.map_blocks(data, ydf, fetch_names=["out"]))
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
        "control_flow", card=_CARD, rows=rows, blocks=blocks, map_rows=result,
        map_rows_one_call=one_call, aggregate_group_cond=group_cond,
        block_level=dict(
            seconds=block_s, rows_per_s=rows / block_s,
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
        res, secs = _wall(lambda: tft.map_rows(graph, df, fetch_names=["y"], bindings=bound))
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
            seconds=secs, rows_per_s=rows / secs, plan="vmap",
            selects=counts.get("vectorize.lowered.cond"), host_syncs_per_block=syncs / blocks,
        )
        if kind == "sum":
            head = tft.TensorFrame([tft.Column("x", x[:per_row_rows])])
            with tft.config.override(row_vectorize=False):
                reset_stats()
                pr, pr_s = _wall(lambda: tft.map_rows(graph, head, fetch_names=["y"], bindings=bound))
                pr_counts = stats()
            if pr_counts.get("map_rows.plan.per_row") != 1.0:
                raise AssertionError(f"per-row plan did not run: {pr_counts}")
            if not np.array_equal(pr.host_values("y"), want[:per_row_rows].astype(np.float32)):
                raise AssertionError("map_rows sum cond, per-row plan: differs from numpy")
            out[kind].update(
                per_row_rows=per_row_rows, per_row_seconds=pr_s,
                per_row_rows_per_s=per_row_rows / pr_s,
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
    res, secs = _wall(lambda: tft.map_rows(graph, df, fetch_names=fetches, bindings=bound))
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
        pr, pr_s = _wall(lambda: tft.map_rows(graph, head, fetch_names=fetches, bindings=bound))
        pr_counts = stats()
    if pr_counts.get("map_rows.plan.per_row") != 1.0:
        raise AssertionError(f"per-row plan did not run: {pr_counts}")
    if not np.array_equal(pr.host_values("y"), want_y[:per_row_rows]):
        raise AssertionError("map_rows sum loop, per-row plan: differs from numpy")
    del res, df, x
    return dict(
        seconds=secs, rows_per_s=rows / secs, plan="vmap",
        map_rows_plan_per_row=counts.get("map_rows.plan.per_row", 0.0),
        trips_per_block=counts.get("control.while.trips") / blocks,
        host_syncs_per_block=counts.get("control.while.host_syncs") / blocks,
        max_row_trips=int(want_trips.max()),
        per_row_rows=per_row_rows, per_row_seconds=pr_s, per_row_rows_per_s=per_row_rows / pr_s,
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
    out, secs = _wall(lambda: tft.aggregate(graph, grouped, fetch_names=["x"]))
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
    return dict(rows=rows, keys=len(present), distinct_sizes=calls, seconds=secs,
                rows_per_s=rows / secs, selects=counts.get("vectorize.lowered.cond"),
                sum_max_abs_err=err, sum_rtol=_SUM_RTOL)


def phase_freezing(tft, df) -> None:
    """Stateful graphs as TF wrote them, a ref variable (``VariableV2`` +
    ``Assign``: ``z = x + 3``) and resource variables (``VarHandleOp``:
    ``z = x * 2 + (-1)``), frozen at import and run by `map_blocks` over
    phase 3's column. Exact."""
    x = df.column("x").values
    result = {}
    for name, want in (
        ("var_ref.pb", lambda: x + 3.0),
        ("var_resource.pb", lambda: x * 2.0 + (-1.0)),
    ):
        data = _fixture(name)
        tft.map_blocks(data, df, fetch_names=["z"])  # lowers once
        out, secs = _wall(lambda: tft.map_blocks(data, df, fetch_names=["z"]))
        z = out.column("z").values
        if z.dtype != torch.float32 or not torch.equal(z, want()):
            raise AssertionError(f"map_blocks {name}: differs from the variable's arithmetic")
        result[name.replace(".pb", "")] = dict(seconds=secs, rows_per_s=df.nrows / secs)
        del out, z
    _emit("freezing", rows=df.nrows, blocks=df.num_blocks, **result)


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
    from tensorframes_tpu_torch.fn_frontend import _assemble_ragged, _bucket_rows, _run_buckets
    from tensorframes_tpu_torch.frame import factorize_keys
    from tensorframes_tpu_torch.utils.profiling import reset_stats, stats

    dev = torch.device("cuda")
    dsl = tft.dsl
    result = {}

    # (a) ragged map_rows: one call per length bucket
    t0 = time.perf_counter()
    cells, flat, starts, lens = _ragged_column(ragged_rows, max_len, SEED)
    df = tft.TensorFrame.from_dict({"v": cells}, num_blocks=blocks)
    build_s = time.perf_counter() - t0
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
        out, secs = _wall(call)
        counts = stats()
        if counts.get("map_rows.plan.ragged") != 1.0 or counts.get("map_rows.ragged.buckets") != buckets:
            raise AssertionError(f"ragged map_rows {what}: counters say {counts}, "
                                 f"expected the ragged plan over {buckets} buckets")
        return out, secs

    out, sum_s = ragged_call("sum", lambda: tft.map_rows(s_graph, df))
    got_sum = out.column("s").values
    if not (got_sum.is_cuda and got_sum.dtype == torch.float32):
        raise AssertionError(f"ragged sum: {got_sum.device} {got_sum.dtype}, expected float32 on cuda")
    sum_err = _check_close("ragged map_rows sum", got_sum.cpu().double(),
                           torch.from_numpy(want_sum), _SUM_RTOL, 0.0)
    got_sum = got_sum.cpu().numpy()
    del out

    out, twice_s = ragged_call("v * 2", lambda: tft.map_rows(w_graph, df))
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

    out, max_s = ragged_call("max", lambda: tft.map_rows(lambda v: {"m": v.max()}, df))
    if not np.array_equal(out.host_values("m"), want_max):
        raise AssertionError("ragged map_rows(fn) max differs from numpy")
    del out

    # the plan's stages apart: bucketing and assembly on the host, the
    # bucket calls (host gather, one copy, kernels) between them; the
    # device time is CUDA events around each bucket's call
    column = df.column("v")
    vsum = torch.func.vmap(lambda v: {"s": v.sum()})
    events = []

    def timed(feeds, rows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = vsum(*feeds)
        end.record()
        events.append((start, end))
        return out

    t0 = time.perf_counter()
    parts = _bucket_rows([column], ragged_rows)
    bucket_s = time.perf_counter() - t0
    chunks, run_s = _wall(lambda: _run_buckets(timed, [column], parts, dev))
    device_ms = sum(a.elapsed_time(b) for a, b in events)
    _, dense_assemble_s = _wall(lambda: _assemble_ragged(chunks, ragged_rows))
    vtwice = torch.func.vmap(lambda v: {"w": v * 2.0})
    wchunks = _run_buckets(lambda feeds, rows: vtwice(*feeds), [column], parts, dev)
    torch.cuda.synchronize()
    _, ragged_assemble_s = _wall(lambda: _assemble_ragged(wchunks, ragged_rows))
    del chunks, wchunks
    result["ragged_map_rows"] = dict(
        rows=ragged_rows, values=int(lens.sum()), max_len=max_len, blocks=blocks,
        buckets=buckets, column_build_s=build_s,
        sum_s=sum_s, sum_rows_per_s=ragged_rows / sum_s, sum_max_abs_err=sum_err,
        sum_rtol=_SUM_RTOL, times_two_s=twice_s, times_two_rows_per_s=ragged_rows / twice_s,
        times_two_checksum=checksum, fn_max_s=max_s, fn_max_rows_per_s=ragged_rows / max_s,
        stages_of_the_sum=dict(bucketing_host_s=bucket_s, bucket_calls_s=run_s,
                               bucket_calls_device_ms=device_ms,
                               dense_assembly_s=dense_assemble_s),
        ragged_assembly_of_times_two_s=ragged_assemble_s,
    )

    # (b) pad_ragged, then a masked block sum on the card
    padded, pad_s = _wall(lambda: df.pad_ragged("v").to_device())
    if tuple(padded.column("v").values.shape) != (ragged_rows, max_len):
        raise AssertionError(f"pad_ragged: shape {tuple(padded.column('v').values.shape)}")

    def masked_sum(v, v_len):
        keep = torch.arange(v.shape[1], device=v.device) < v_len[:, None]
        return {"t": torch.where(keep, v, 0.0).sum(1)}

    tft.map_blocks(masked_sum, padded)
    out, masked_s = _wall(lambda: tft.map_blocks(masked_sum, padded))
    got_t = out.column("t").values
    masked_err = _check_close("masked sum over pad_ragged", got_t.cpu().double(),
                              torch.from_numpy(want_sum), _SUM_RTOL, 0.0)
    vs_ragged = float(np.abs(got_t.cpu().numpy() - got_sum).max())
    result["pad_ragged"] = dict(
        pad_and_copy_s=pad_s, masked_sum_s=masked_s, masked_rows_per_s=ragged_rows / masked_s,
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
    t0 = time.perf_counter()
    kdf = tft.TensorFrame([tft.Column("k", keys), tft.Column("v", vals)])
    key_column_s = time.perf_counter() - t0
    # the two host factorizations `factorize_keys` has: pandas' where it
    # imports (a first call imports it), and the dict pass that runs
    # without pandas, timed with pandas hidden; they give the same codes
    factorize_keys(["k"], [keys[:10]], dev)
    pandas = sys.modules.get("pandas")
    (_, codes_default), factorize_s = _wall(lambda: factorize_keys(["k"], [kdf.host_values("k")], dev))
    sys.modules["pandas"] = None
    try:
        (_, codes_dict), dict_pass_s = _wall(lambda: factorize_keys(["k"], [kdf.host_values("k")], dev))
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
    out, agg_s = _wall(lambda: tft.aggregate([m, q], grouped, feed_dict=feed))
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
        rows=agg_rows, dim=dim, ids=nids, key_column_build_s=key_column_s,
        factorize_host_s=factorize_s, factorize_dict_pass_host_s=dict_pass_s,
        pandas_version=getattr(pandas, "__version__", None),
        aggregate_s=agg_s, rows_per_s=agg_rows / agg_s, mean_max_abs_err=mean_err,
        mean_of_squares_max_abs_err=sq_err, variance_max_abs_err=var_err, rtol=_SUM_RTOL,
    )
    del out, grouped, kdf

    # (d) a bytes column through map_blocks beside a computed fetch
    x = vals[:, 0].contiguous()
    del vals
    sdf = tft.TensorFrame([tft.Column("x", x), tft.Column("id", keys)]).repartition(blocks)
    tag = dsl.placeholder(tft.ScalarType.string, tft.Shape(()), name="id")
    fetches = [(tft.block(sdf, "x") + 3.0).named("z"), dsl.identity(tag).named("t")]
    tft.map_blocks(fetches, sdf)  # lowers once
    out, pass_s = _wall(lambda: tft.map_blocks(fetches, sdf))
    z, t = out.column("z"), out.column("t")
    if t.device is not None or t.dtype is not tft.ScalarType.string or not np.array_equal(
        t.host_values(), keys
    ):
        raise AssertionError("bytes pass-through: the ids did not come back unchanged on the host")
    if not (z.values.is_cuda and torch.equal(z.values, x + 3.0)):
        raise AssertionError("bytes pass-through: x + 3 is not x + 3 on the card")
    if out.columns != ["t", "z", "x", "id"]:
        raise AssertionError(f"bytes pass-through: columns {out.columns}")
    result["string_passthrough"] = dict(rows=agg_rows, blocks=blocks, seconds=pass_s,
                                        rows_per_s=agg_rows / pass_s)
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


def _stage_counters():
    """ingest_stage_busy_seconds / ingest_stage_wait_seconds by stage."""
    from tensorframes_tpu_torch.utils import telemetry

    out = {}
    for (name, labels), v in telemetry.labeled_counters().items():
        if name in ("ingest_stage_busy_seconds", "ingest_stage_wait_seconds", "ingest_chunks"):
            out.setdefault(dict(labels).get("stage", "?"), {})[name] = v
    return out


class _ReduceEvents:
    """CUDA events around every `reduce_blocks` call the stream makes (its
    chunks and combines), for the device's busy time; restores the verb on
    exit."""

    def __init__(self, api):
        self.api, self.pairs = api, []

    def __enter__(self):
        inner = self.inner = self.api.reduce_blocks

        def timed(*a, **k):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(*a, **k)
            end.record()
            self.pairs.append((start, end))
            return out

        self.api.reduce_blocks = timed
        return self

    def __exit__(self, *exc):
        self.api.reduce_blocks = self.inner
        return False

    def busy_s(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs) / 1e3


def _chunk_reference(arr: np.ndarray):
    """(float64 sum, min, seconds) of one chunk's float32 values."""
    t0 = time.perf_counter()
    return float(arr.sum(dtype=np.float64)), float(arr.min()), time.perf_counter() - t0


def _north_star_chunks(tft, rows: int, chunk_rows: int, acc: dict, pool):
    """`examples/billion_row_reduce.py`'s chunks as host frames. The
    float64 reference of each chunk is computed on ``pool`` (numpy's
    reductions release the GIL), so the producer pays only the
    synthesis."""
    made = 0
    while made < rows:
        n = min(chunk_rows, rows - made)
        t0 = time.perf_counter()
        arr = np.arange(made, made + n, dtype=np.float64).astype(np.float32)
        acc["synth_s"] += time.perf_counter() - t0
        acc["refs"].append(pool.submit(_chunk_reference, arr))
        yield tft.TensorFrame.from_dict({"x": arr})
        made += n


def _north_star(tft, rows: int, chunk_rows: int):
    """The README vector `reduce_sum` (and a `reduce_min` beside it) as
    GraphDef bytes over ``rows`` float32 rows in chunks of ``chunk_rows``."""
    from tensorframes_tpu_torch import api
    from tensorframes_tpu_torch.utils.profiling import reset_stats, stats

    probe = tft.TensorFrame.from_dict({"x": np.zeros(4, np.float32)})
    s = tft.dsl.reduce_sum(tft.block(probe, "x", tf_name="x_input"), axes=[0]).named("x")
    mn = tft.dsl.reduce_min(tft.block(probe, "x", tf_name="m_input"), axes=[0]).named("m")
    g, fetches = tft.dsl.build([s, mn])
    wire, feed = g.to_bytes(), {"x_input": "x", "m_input": "x"}
    from concurrent.futures import ThreadPoolExecutor

    acc = {"synth_s": 0.0, "refs": []}
    reset_stats()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with _ReduceEvents(api) as ev, ThreadPoolExecutor(1) as pool:
        t0 = time.perf_counter()
        out = tft.reduce_blocks_stream(wire, _north_star_chunks(tft, rows, chunk_rows, acc, pool),
                                       feed, fetch_names=fetches)
        got_sum, got_min = out["x"].item(), out["m"].item()  # reads end in a sync
        secs = time.perf_counter() - t0
        busy = ev.busy_s()
        refs = [f.result() for f in acc["refs"]]
    peak = torch.cuda.max_memory_allocated() - base
    acc.update(sum=sum(r[0] for r in refs), min=min(r[1] for r in refs),
               ref_s=sum(r[2] for r in refs))
    counts = stats()
    rel = abs(got_sum - acc["sum"]) / abs(acc["sum"])
    if out["x"].dtype != torch.float32 or rel > _SUM_RTOL:
        raise AssertionError(f"stream sum {got_sum} vs float64 {acc['sum']}: rel err {rel:.3e}")
    if got_min != acc["min"]:
        raise AssertionError(f"stream min {got_min} != numpy {acc['min']}")
    if counts.get("reduce_blocks_stream.transfer_fallback", 0):
        raise AssertionError(f"the transfer stage fell back: {counts}")
    return dict(
        seconds=secs, rows_per_s=rows / secs, sum_rel_err=rel, min=got_min,
        chunks=int(counts.get("reduce_blocks_stream.chunks", 0)),
        folds=int(counts.get("reduce_blocks_stream.fold", 0)),
        transfer_fallbacks=int(counts.get("reduce_blocks_stream.transfer_fallback", 0)),
        synthesis_s=acc["synth_s"], reference_s=acc["ref_s"],
        compute_busy_s=busy, compute_busy_share=busy / secs,
        peak_device_bytes=peak,
    )


def _stream_probes(tft, chunk_rows: int):
    """One chunk's synthesis, its trip through the transfer stage, the H2D
    copy of one pinned chunk alone, and the reduce of a device-resident
    chunk (CUDA events), each timed apart."""
    from tensorframes_tpu_torch.streaming import _TransferStage

    t0 = time.perf_counter()
    arr = np.arange(0, chunk_rows, dtype=np.float64).astype(np.float32)
    synth_s = time.perf_counter() - t0
    frame = tft.TensorFrame.from_dict({"x": arr})
    stage = _TransferStage(torch.device("cuda"))
    for _ in range(2):  # warm: both pinned slots, the copy stream
        stage(frame)
    stage.close()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged = stage.receive(stage(frame))
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    resident = staged.column("x").values
    if not torch.equal(resident.cpu(), torch.from_numpy(arr)):
        raise AssertionError("the transfer stage changed the chunk's values")
    del staged

    pinned = torch.empty(chunk_rows, dtype=torch.float32, pin_memory=True)
    pinned.copy_(torch.from_numpy(arr))
    h2d_ms = _time_ms(lambda: resident.copy_(pinned, non_blocking=True), 3)

    df = tft.TensorFrame([tft.Column("x", resident)])
    probe = tft.TensorFrame.from_dict({"x": np.zeros(4, np.float32)})
    s = tft.dsl.reduce_sum(tft.block(probe, "x", tf_name="x_input"), axes=[0]).named("x")
    wire = tft.dsl.build(s)[0].to_bytes()
    reduce_ms = _time_ms(lambda: tft.reduce_blocks(wire, df, fetch_names=["x"]), 5)
    del df, resident, pinned
    nbytes = chunk_rows * 4
    return dict(
        synthesis_s_per_chunk=synth_s, transfer_stage_s_per_chunk=stage_s,
        h2d_pinned_ms=h2d_ms, h2d_pinned_gbps=nbytes / (h2d_ms * 1e-3) / 1e9,
        on_chip_reduce_ms=reduce_ms, on_chip_rows_per_s=chunk_rows / (reduce_ms * 1e-3),
        ingest_rows_per_s=chunk_rows / (synth_s + stage_s),
        reduce_bytes_bound_ms=nbytes / _PEAK_HBM_BYTES * 1e3,
    )


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
        t0 = time.perf_counter()
        ref, rows = _write_dataset(tft, data, shards, shard_rows, width)
        write_s = time.perf_counter() - t0
        wire, names, feed = _dataset_fetches(tft, width)

        telemetry.reset()
        reset_stats()
        t0 = time.perf_counter()
        out = tft.reduce_blocks_stream(wire, tft.stream_dataset(data), feed, fetch_names=names)
        err = _check_dataset("dataset stream", out, ref)
        secs = time.perf_counter() - t0
        counts = stats()
        if counts.get("reduce_blocks_stream.transfer_fallback", 0):
            raise AssertionError(f"dataset stream: the transfer stage fell back: {counts}")
        _emit(
            "stream_dataset", shards=2 * shards, empty_shards=1, rows=rows, bytes_per_row=4 * (1 + width),
            write_s=write_s, seconds=secs, rows_per_s=rows / secs,
            chunks=int(counts.get("reduce_blocks_stream.chunks", 0)),
            folds=int(counts.get("reduce_blocks_stream.fold", 0)),
            decode_workers=_auto_decode_workers(), stages=_stage_counters(),
            max_sum_rel_err=err, sum_rtol=_SUM_RTOL,
        )

        # durable: the same stream, cut by its deadline, resumed elsewhere
        ck = os.path.join(tmp, "stream.ckpt")
        budget = 0.5 * secs
        reset_stats()
        t0 = time.perf_counter()
        try:
            tft.reduce_blocks_stream(wire, tft.stream_dataset(data), feed, fetch_names=names,
                                     checkpoint=ck, timeout_s=budget)
        except tft.DeadlineExceeded as e:
            watermark = e.tfs_checkpoint_watermark
        else:
            raise AssertionError(f"durable stream finished inside its {budget:.2f} s budget")
        cut_s = time.perf_counter() - t0
        wire_path = os.path.join(tmp, "fetches.pb")
        with open(wire_path, "wb") as f:
            f.write(wire)
        repo = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _RESUME_CHILD, data, ck, wire_path, json.dumps(names),
             json.dumps(feed)],
            capture_output=True, text=True, timeout=600, env=env, cwd=repo,
        )
        resume_s = time.perf_counter() - t0
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
            "stream_durable", budget_s=budget, cut_after_s=cut_s, watermark=watermark,
            chunks_before_cut=int(stats().get("reduce_blocks_stream.chunks", 0)),
            resume_process_s=resume_s,
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

    probes = _stream_probes(tft, chunk_rows)
    ns = _north_star(tft, rows, chunk_rows)
    depth = config.get().stream_prefetch_depth
    limit = (depth + 3) * chunk_rows * 4
    if ns["peak_device_bytes"] > limit:
        raise AssertionError(f"device memory peaked at {ns['peak_device_bytes']} bytes over the "
                             f"stream, above (depth + 3) chunks = {limit}")
    if ns["folds"] < 1:
        raise AssertionError(f"the stream never folded: {ns}")
    n_chunks = math.ceil(rows / chunk_rows)
    stage_s = [probes["synthesis_s_per_chunk"], probes["transfer_stage_s_per_chunk"],
               probes["on_chip_reduce_ms"] * 1e-3]
    bound_s = n_chunks * max(stage_s)
    _emit(
        "stream_north_star", rows=rows, chunk_rows=chunk_rows, chunk_bytes=chunk_rows * 4,
        prefetch_depth=depth, **ns, **probes,
        perfect_overlap_bound_s=bound_s, overhead_vs_bound=ns["seconds"] / bound_s,
        peak_device_chunks=ns["peak_device_bytes"] / (chunk_rows * 4), peak_limit_chunks=depth + 3,
        sum_rtol=_SUM_RTOL,
    )

    times = {}
    for on in (True, False):
        with config.override(ingest_pipeline=on):
            r = _north_star(tft, overlap_rows, chunk_rows)
        times["pipeline_on" if on else "pipeline_off"] = r["seconds"]
    _emit("stream_overlap", rows=overlap_rows, chunk_rows=chunk_rows, **times,
          off_over_on=times["pipeline_off"] / times["pipeline_on"])

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
    t0 = time.perf_counter()
    try:
        tft.reduce_blocks_stream(s, slow(), timeout_s=0.5)
    except tft.DeadlineExceeded:
        raised_s = time.perf_counter() - t0
    else:
        raise AssertionError("the slow stream finished inside its 0.5 s budget")
    t1 = time.perf_counter()
    while _ingest_threads() and time.perf_counter() - t1 < 2.0:
        time.sleep(0.01)
    left = _ingest_threads()
    if left:
        raise AssertionError(f"pipeline threads alive 2 s after the deadline: {left}")
    _emit("stream_deadline", budget_s=0.5, raised_after_s=raised_s,
          threads_gone_after_s=time.perf_counter() - t1)


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


def _device_kernels(fn):
    """(device seconds summed over kernels, kernel launches, device
    seconds by kind) of one ``fn()`` under `torch.profiler`."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kind = defaultdict(float)
    for e in kernels:
        low = e.name.lower()
        kind = ("cat / copy" if any(p in low for p in ("cat", "copy", "memcpy", "memset"))
                else "reduce" if "reduce" in low else "elementwise")
        by_kind[kind] += e.device_time / 1e6
    return sum(e.device_time for e in kernels) / 1e6, len(kernels), dict(by_kind)


def _measured(fn):
    """(result, seconds, peak device bytes, peak above the bytes live at
    the start) of ``fn()``, ending in a device synchronise."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, seconds = _wall(fn)
    peak = torch.cuda.max_memory_allocated()
    return out, seconds, peak, peak - base


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

    times = {"eager": [], "fused": []}
    peaks = {}
    for way in ("eager", "fused", "fused", "eager", "eager", "fused"):
        ex = ex_e if way == "eager" else ex_f
        out, seconds, peak, above = _measured(
            lambda: _chain_reduce(tft, df, stages, way == "eager", ex))
        if not torch.equal(out, fused):
            raise AssertionError(f"{way} run disagrees with the first fused run")
        times[way].append(seconds)
        peaks[way] = (peak, above)
    device = {way: _device_kernels(lambda: _chain_reduce(tft, df, stages, way == "eager", ex))
              for way, ex in (("eager", ex_e), ("fused", ex_f))}
    want = float(x.double().mul(1.125).add(1).mul(1.0625).add(1).mul(1.03125).add(1).sum())
    rel = abs(fused.item() - want) / abs(want)
    if rel > _SUM_RTOL:
        raise AssertionError(f"fused chain sum rel err {rel:.3e} > {_SUM_RTOL} vs float64")
    _emit(
        "lazy_fused_chain", rows=rows, blocks=blocks, maps=stages,
        eager_s=times["eager"], fused_s=times["fused"],
        eager_median_s=float(np.median(times["eager"])),
        fused_median_s=float(np.median(times["fused"])),
        eager_over_fused=float(np.median(times["eager"]) / np.median(times["fused"])),
        programs={"fused": fused_programs, "eager": eager_programs},
        block_calls={"fused": fused_calls, "eager": eager_calls},
        second_fused_run_misses=ex_f.cache_misses - misses,
        peak_device_bytes={"eager": peaks["eager"][0], "fused": peaks["fused"][0]},
        peak_above_start_bytes={"eager": peaks["eager"][1], "fused": peaks["fused"][1]},
        device_kernel_s={w: d[0] for w, d in device.items()},
        kernel_launches={w: d[1] for w, d in device.items()},
        device_kernel_s_by_kind={w: d[2] for w, d in device.items()},
        fused_equals_eager=True, sum_rel_err_vs_f64=rel,
    )

    # the same maps over a host-resident base: force() with the plan-prep
    # pipeline on and off, in turns
    x_host = x.cpu().numpy()
    device_c = _chain_maps(tft, df.lazy(), stages, False)[0].force()
    host_df = tft.TensorFrame([tft.Column("x", x_host)]).repartition(blocks)
    from tensorframes_tpu_torch.utils import telemetry

    # one untimed run each way first: the first pipelined force pins its
    # staging slots (PyTorch's host allocator keeps them for later forces)
    times = {"on": [], "off": []}
    ref = None
    reset_stats()
    for i, on in enumerate((False, True) + (False, True, True, False) * 2):
        telemetry.reset_counters()
        with config.override(plan_pipeline=on):
            lf = _chain_maps(tft, host_df.lazy(), stages, False)[0]
            out, seconds = _wall(lf.force)
        if on:
            stages_on = _stage_counters()
        cols = [out.column(f"c{k}").values for k in range(stages)]
        if ref is None:
            ref = cols
            for c, d in zip(cols, (device_c.column(f"c{k}").values for k in range(stages))):
                if not torch.equal(c, d):
                    raise AssertionError("host-resident force disagrees with device-resident")
        elif not all(torch.equal(a, b) for a, b in zip(cols, ref)):
            raise AssertionError(f"plan_pipeline={on} disagrees bit for bit")
        if i >= 2:
            times["on" if on else "off"].append(seconds)
        del out, cols
    fallbacks = stats().get("lazy.force.transfer_fallback", 0.0)
    if fallbacks:
        raise AssertionError(f"{fallbacks} plan-prep transfers fell back to synchronous copies")
    _emit(
        "lazy_host_pipeline", rows=rows, blocks=blocks, maps=stages,
        pipeline_on_s=times["on"], pipeline_off_s=times["off"],
        off_over_on=float(np.median(times["off"]) / np.median(times["on"])),
        h2d_bytes=rows * 4, transfer_fallbacks=fallbacks, on_equals_off=True,
        pipeline_stages_last_on_run=stages_on,
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
        first, first_s = _wall(force)
        policy = mat.state()
        miss, miss_s = first, first_s
        if policy["stores"] == 0:
            priced_out = mat._priced_out
            mat._priced_out = lambda *a, **k: False
            try:
                miss, miss_s = _wall(force)
            finally:
                mat._priced_out = priced_out
        stored = mat.state()
        if stored["stores"] != 1:
            raise AssertionError(f"force cache: the result was not stored: {stored}")
        sid = telemetry.allocate_span_id()
        hit, hit_s = _wall(force)
        dispatched = sum(1 for s in telemetry.spans() if s.span_id > sid and s.kind == "dispatch")
        st = mat.state()
    if st["hits"] != 1 or dispatched:
        raise AssertionError(f"force cache: {st['hits']} hits, {dispatched} block dispatches")
    for c in names:
        if not torch.equal(_as_host(hit.column(c).values), _as_host(miss.column(c).values)):
            raise AssertionError(f"force cache: the hit's {c!r} differs from the first force")
    _emit(
        "lazy_force_cache", card=_CARD, rows=rows, blocks=blocks, maps=stages,
        first_force_s=first_s, miss_s=miss_s, hit_s=hit_s, hit_over_miss=hit_s / miss_s,
        hit_block_dispatches=dispatched, hit_equals_miss=True,
        admission_policy_stored=policy["stores"], admission_policy_rejected=policy["rejected"],
        entry_bytes=st["last_hit"]["bytes"], load_s=st["last_hit"]["load_seconds"],
        store_s=stored["last_store"]["store_seconds"],
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
        t0 = time.perf_counter()
        x, y = _write_relational(tft, root, shards, groups, group_rows)
        write_s = time.perf_counter() - t0
        parquet_bytes = sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root))
        keep = x > cutoff
        survivors = int(keep.sum())
        zs, ks = x[keep] * 0.5 + 1.0, y[keep]
        keys = np.unique(ks)
        want_sum = np.array([zs[ks == k].sum() for k in keys])
        want_max = np.array([zs[ks == k].max() for k in keys])
        del x, y, keep, zs, ks

        runs, decisions = {"on": [], "off": []}, None
        results, decoded = {}, {}
        for on in (True, False, False, True):
            tplan.reset_state()
            telemetry.reset_counters()
            with config.override(plan_optimizer=on):
                rel = build(root)
                out, seconds = _wall(rel.force)
                if on:
                    decisions = [d for d in rel.optimize()[1] if d["accepted"]]
            runs["on" if on else "off"].append(seconds)
            decoded["on" if on else "off"] = telemetry.flat_counters()["ingest_rows_decoded"]
            results.setdefault(on, out)
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
        parquet_bytes=parquet_bytes, write_s=write_s, survivors=survivors,
        optimizer_on_s=runs["on"], optimizer_off_s=runs["off"],
        off_over_on=float(np.median(runs["off"]) / np.median(runs["on"])),
        rows_decoded=decoded, pushdown_rows_skipped=pushed, accepted_rewrites=accepted,
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
    out, sort_s = _wall(df.sort_by("k").force)
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
    out, join_s = _wall(left.join(right, on="id").force)
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
    _emit("relational_sort_join", sort_rows=rows, sort_s=sort_s, sort_d2h_bytes=sort_d2h,
          join_rows=rows, join_keys=keys, join_s=join_s, join_d2h_bytes=join_d2h,
          join_out_rows=out.nrows)


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

    # time the bridge's two host steps inside the user's calls
    ingest_s, collect_s = [], []
    real_ingest, real_collect = tspark.ingest, tspark._collected_frame

    def timed(real, into):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = real(*a, **kw)
            into.append(time.perf_counter() - t0)
            return out
        return call

    tspark.ingest = timed(real_ingest, ingest_s)
    tspark._collected_frame = timed(real_collect, collect_s)
    try:
        with tempfile.TemporaryDirectory(prefix="tfs-spark-") as ingest_dir:
            reset_stats()
            s = d.reduce_sum(tft.block(probe, "x0", tf_name="x0_input"), axes=[0]).named("x0")
            total, reduce_s = _wall(lambda: tspark.reduce_blocks(s, sdf, ingest_dir=ingest_dir))
            if stats().get("reduce_blocks_stream.transfer_fallback", 0.0):
                raise AssertionError("spark.reduce_blocks: transfers fell back to the host")
            want = x_all[:, 0].sum()
            sum_err = abs(total.item() - want) / want
            if total.dtype != torch.float64 or sum_err > 1e-12:
                raise AssertionError(f"spark.reduce_blocks rel err {sum_err:.3e} > 1e-12")

            zt = (tft.block(probe, "x0") * 2.0 + 1.0).named("z")
            mapped, map_s = _wall(lambda: tspark.map_blocks(zt, sdf, ingest_dir=ingest_dir))
            zv = mapped.column("z").values
            if (mapped.num_blocks != partitions or zv.device.type != "cuda"
                    or not np.array_equal(zv.cpu().numpy(), x_all[:, 0] * 2.0 + 1.0)):
                raise AssertionError("spark.map_blocks disagrees with numpy or lost the partitions")
            del mapped, zv

            fetches = [d.reduce_mean(tft.block(probe, f"x{i}", tf_name=f"m{i}_input"), axes=[0])
                       .named(f"m{i}") for i in range(width)]
            feed = {f"m{i}_input": f"x{i}" for i in range(width)}
            agg, agg_s = _wall(lambda: tspark.aggregate(fetches, sdf, keys=["k"], feed_dict=feed,
                                                        ingest_dir=ingest_dir))
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
    finally:
        tspark.ingest, tspark._collected_frame = real_ingest, real_collect
    verbs = {"reduce_blocks": reduce_s, "map_blocks": map_s, "aggregate": agg_s}
    # reduce_blocks streams the files; map_blocks and aggregate collect them
    collect = {"reduce_blocks": 0.0, "map_blocks": collect_s[0], "aggregate": collect_s[1]}
    _emit(
        "spark_bridge", partitions=partitions, rows=rows, columns=width + 1,
        ipc_bytes_per_ingest=rows * (width + 1) * 8, ingest_s=ingest_s,
        collect_s=collect_s, call_s=verbs,
        verb_after_ingest_and_collect_s={
            v: t - i - collect[v] for (v, t), i in zip(verbs.items(), ingest_s)},
        rows_per_s={v: rows / t for v, t in verbs.items()},
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
    _, first = model.train_step(model.params, tokens, lr=lr)  # step 1, the warm-up
    if abs(float(first) - loss1) > _TRAIN_LOSS_RTOL * abs(loss64):
        raise AssertionError(f"TransformerLM train_step loss {float(first)} vs {loss1}")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    losses = []

    def train():
        for _ in range(steps):
            losses.append(model.train_step(model.params, tokens, lr=lr)[1])

    _, secs = _wall(train)
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        after = float(model.loss(model.params, tokens))
    if not after < float(first):
        raise AssertionError(f"TransformerLM: loss {after} after {steps + 1} steps, first {float(first)}")

    # where a step's time goes: the device's busy time in one more step,
    # and the attention of one layer forward and backward at the step's
    # shape, through full_attention and through SDPA (a fused backward the
    # port does not have)
    step_s = secs / steps
    busy_s, step_launches, _ = _device_kernels(lambda: model.train_step(model.params, tokens, lr=lr))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    hd = cfg["d_model"] // cfg["n_heads"]
    qkv = [
        torch.randn(batch * cfg["n_heads"], seq - 1, hd, device="cuda", generator=gen,
                    requires_grad=True)
        for _ in range(3)
    ]

    def fwd_bwd(attend):
        return lambda: torch.autograd.grad(attend(*qkv).sum(), qkv)

    attn_ms = _time_ms(fwd_bwd(lambda q, k, v: full_attention(q, k, v, causal=True)), 5)
    sdpa_ms = _time_ms(fwd_bwd(lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True)), 5)
    del qkv

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
    tokens_per_step = batch * (seq - 1)
    return dict(
        config=cfg, batch=batch, seq=seq, lr=lr, timed_steps=steps, seconds=secs,
        seconds_per_step=step_s, tokens_per_s=tokens_per_step * steps / secs,
        peak_memory_bytes=peak, peak_above_start_bytes=peak - base,
        device_busy_share_of_step=busy_s / step_s, kernel_launches_per_step=step_launches,
        attention_fwd_bwd_ms_per_layer=attn_ms,
        attention_share_of_step=cfg["n_layers"] * attn_ms / (step_s * 1e3),
        sdpa_fwd_bwd_ms_per_layer=sdpa_ms,
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
    losses = []

    def train():
        nonlocal state
        for _ in range(steps):
            _, state, loss = step(model.params, state, x, labels)
            losses.append(loss)

    _, secs = _wall(train)
    with torch.no_grad():
        after = float(model.loss(model.params, x, labels))
    if not after < float(first):
        raise AssertionError(f"MLP: loss {after} after {steps + 1} steps, first {float(first)}")
    return dict(
        sizes=sizes, rows=rows, optimizer="Adam lr 1e-3", timed_steps=steps, seconds=secs,
        seconds_per_step=secs / steps, rows_per_s=rows * steps / secs,
        batch_from="map_blocks output column", loss_step1=float(first), loss_step1_f64=loss64,
        loss_after=after, max_grad_err_over_norm=grad_err,
    )


def _moe_forward(tokens: int, checked: int, iters: int = 3) -> dict:
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
        model(x)  # warm-up: cuBLAS picks its kernels
        out, secs = _wall(lambda: [model(x) for _ in range(iters)][-1])
    secs /= iters
    if tuple(out.shape) != (tokens, d) or not torch.isfinite(out).all():
        raise AssertionError(f"MoEFFN: bad output {tuple(out.shape)}")
    flop = 2 * tokens * d * e + e * 2 * (2 * tokens * d * h) + 2 * tokens * e * d
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
        tokens=tokens, weight_bytes=weight_bytes, seconds=secs, tflop=flop / 1e12,
        achieved_tflop_s=flop / secs / 1e12, float32_bound_s=flop / _PEAK_F32_FLOPS,
        share_of_float32_bound=flop / _PEAK_F32_FLOPS / secs, checked_tokens=checked,
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


def _percentiles_ms(lat):
    """p50, p99 and the slowest of a latency list, in ms."""
    a = np.asarray(lat, dtype=np.float64) * 1e3
    return float(np.percentile(a, 50.0)), float(np.percentile(a, 99.0)), float(a.max())


def _check_latencies(what: str, lat) -> None:
    slowest = max(lat)
    if slowest > _SERVE_MAX_REQUEST_S:
        raise AssertionError(
            f"serving {what}: a request took {slowest:.2f} s (bound {_SERVE_MAX_REQUEST_S} s)"
        )


def _clients_round(n_clients: int, work, what: str):
    """Run ``work(client_index)`` on ``n_clients`` threads started
    together; (wall seconds, every returned latency list joined). Raises
    the first error a client met, and fails when a request outlasts
    ``_SERVE_MAX_REQUEST_S``."""
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
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=300)
    secs = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("serving: a client thread did not finish within 300 s")
    if errors:
        raise errors[0]
    _check_latencies(what, lat)
    return secs, lat


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

    # one untimed request first: the client's first call imports pyarrow
    check(0, client.run("bench", {"x": reqs[0]}, timeout_s=60.0))
    lat_serial = []
    t0 = time.perf_counter()
    for i, r in enumerate(reqs):
        t1 = time.perf_counter()
        out = client.run("bench", {"x": r}, timeout_s=60.0, request_id=f"s{i}")
        lat_serial.append(time.perf_counter() - t1)
        check(i, out)
    serial_s = time.perf_counter() - t0
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

    conc_s, lat_conc = _clients_round(clients, work, "(a) concurrent")
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
    p50, p99, pmax = _percentiles_ms(lat_conc)
    s50, s99, smax = _percentiles_ms(lat_serial)
    return dict(
        clients=clients, requests=requests, rows_per_request=[rows - 7, rows - 1],
        max_batch_rows=max_batch_rows, warmed_rungs=len(ep.warmed_rungs),
        serial_requests_per_s=requests / serial_s, serial_p50_ms=s50, serial_p99_ms=s99,
        serial_max_ms=smax, concurrent_requests_per_s=batched / conc_s,
        concurrent_p50_ms=p50, concurrent_p99_ms=p99, concurrent_max_ms=pmax,
        batches=batches, requests_batched=batched, mean_fill=batched / batches,
        compile_count_delta_after_warm=compile_delta, bit_identical=True,
    ), 2 * requests + 1


def _serving_mlp(tft, url, clients: int, per_client: int, rows: int):
    """(b) the MLP scoring endpoint at BASELINE config 3's widths."""
    from tensorframes_tpu_torch.models import MLP
    from tensorframes_tpu_torch.utils import telemetry

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
    errs, by_request = [], {}

    def work(c):
        lat = []
        cl = tft.serving.ServingClient(url)
        for k in range(per_client):
            i = c * per_client + k
            t1 = time.perf_counter()
            out = cl.run("mlp", {"features": feats[i]}, timeout_s=60.0, request_id=f"m{i}")
            lat.append(time.perf_counter() - t1)
            by_request[f"m{i}"] = lat[-1]
            if k == 0:
                got = torch.from_numpy(out.column("probs").host_values())
                errs.append(_check_close(
                    f"serving (b) request {i}", got, direct[c].cpu(), _MLP_RTOL, _MLP_ATOL
                ))
        return lat

    _clients_round(clients, work, "(b) warm-up")  # the cuBLAS handles of every thread
    inline0 = tft.serving.batcher().snapshot()["inline"]
    secs, lat = _clients_round(clients, work, "(b)")
    # the slowest request's server-side verb: compute, or the transport?
    slowest = max(by_request, key=by_request.get)
    verb_s = [sp.seconds for sp in telemetry.spans()
              if sp.kind == "verb" and sp.attrs.get("request") == slowest]
    n = clients * per_client
    if tft.serving.batcher().snapshot()["inline"] - inline0 != n:
        raise AssertionError("serving (b): the MLP requests did not dispatch inline")
    # the device's busy share over one more round, under the profiler
    holder = {}
    busy_s, launches, _ = _device_kernels(
        lambda: holder.update(r=_clients_round(clients, work, "(b) profiled"))
    )
    p50, p99, pmax = _percentiles_ms(lat)
    return dict(
        clients=clients, requests=n, rows_per_request=rows, sizes=sizes,
        request_mib=rows * sizes[0] * 4 / 2**20,
        requests_per_s=n / secs, rows_per_s=n * rows / secs, p50_ms=p50, p99_ms=p99,
        max_ms=pmax, slowest_request_verb_ms=verb_s[-1] * 1e3 if verb_s else None,
        profiled_round_s=holder["r"][0], device_busy_s=busy_s,
        device_busy_share=busy_s / holder["r"][0], kernel_launches=launches,
        max_abs_err=max(errs), tolerance={"rtol": _MLP_RTOL, "atol": _MLP_ATOL},
    ), 3 * n


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
        deadline_budget_s=budget, deadline_seconds=deadline_s, metrics_serve_requests=served,
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
    t0 = time.perf_counter()
    handle = tft.serving.serve(port=0)
    try:
        batched, sent_a = _serving_batched(tft, handle.url, clients, requests, rows, max_batch_rows)
        mlp, sent_b = _serving_mlp(tft, handle.url, clients, mlp_per_client, mlp_rows)
        errors = _serving_errors(tft, handle, sent_a + sent_b)
    finally:
        tft.serving.reset()
        telemetry.shutdown()
    _emit(
        "serving", batched=batched, mlp=mlp, error_paths=errors,
        seconds=time.perf_counter() - t0,
    )


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


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
    """Phase 3's x+3 map and phase 4's MLP map_rows (graph route), each
    run once to warm the kernels (a first launch loads its module, a first
    product sets cuBLAS up: neither belongs in a steady-state roofline),
    then with the ledger and telemetry reset run through the executor
    ``ex``: the x+3 map twice, the MLP once. Returns the frame, the x+3
    graph and the MLP's sizes; holds the outputs to their references."""
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
    tft.map_blocks(z, df)
    tft.map_rows(probs, mdf)
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
    flops and the x+3 map's bytes equal their hand counts; every roofline
    fraction lies in (0, 1.05]."""
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
        for key in ("flops_frac_of_peak", "hbm_frac_of_peak"):
            if r[key] is None or not 0.0 < r[key] <= 1.05:
                raise AssertionError(
                    f"program {kind} ({fp}) {key} = {r[key]}: outside (0, 1.05]"
                )
        rows_out[kind] = {
            "program": fp, "execs": r["execs"], "dispatches": r["dispatches"],
            "flops_per_exec": r["flops_per_exec"], "bytes_per_exec": r["bytes_per_exec"],
            "footprint_bytes": r["footprint_bytes"], "execute_s": r["execute_s"],
            "achieved_tflop_s": r["achieved_flops_s"] / 1e12,
            "achieved_gb_s": r["achieved_hbm_bytes_s"] / 1e9,
            "flops_frac_of_peak": r["flops_frac_of_peak"],
            "hbm_frac_of_peak": r["hbm_frac_of_peak"],
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
        "mlp_matmul_flops": mlp_rows * mm, "peaks": diag["cost"]["peaks"],
        "memory": diag["memory"],
    }


def _ledger_overhead(tft, df, z, ex, calls: int = 21) -> dict:
    """x+3 with the ledger and telemetry off, then on: medians of
    ``calls`` interleaved calls each, after a warm-up each way, the order
    of the pair alternating so that neither side always runs first. One
    call takes about 1.4 ms and single calls on the card's host spread by
    several percent, so 5 calls a side could not tell a 2% overhead from
    a 7% one. Between the timed calls (outside their windows) the
    dispatch events are resolved, as `diagnostics` resolves them, so the
    "on" calls record events from the pool the way a process does once
    its span ring has filled."""
    from tensorframes_tpu_torch.utils import telemetry

    off = dict(cost_ledger=False, telemetry=False)

    def timed(on: bool) -> float:
        if on:
            return _wall(lambda: tft.map_blocks(z, df, executor=ex))[1]
        with tft.config.override(**off):
            return _wall(lambda: tft.map_blocks(z, df, executor=ex))[1]

    timed(False)
    timed(True)
    telemetry.resolve_device_times()
    t_off, t_on = [], []
    for i in range(calls):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            (t_on if on else t_off).append(timed(on))
        telemetry.resolve_device_times()
    off_s, on_s = _median(t_off), _median(t_on)
    if on_s > 1.05 * off_s:
        raise AssertionError(
            f"ledger + telemetry on: {on_s * 1e3:.3f} ms vs off {off_s * 1e3:.3f} ms (> 5%)"
        )
    return {"calls": calls, "off_ms": off_s * 1e3, "on_ms": on_s * 1e3,
            "on_over_off": on_s / off_s,
            "off_each_ms": [t * 1e3 for t in t_off], "on_each_ms": [t * 1e3 for t in t_on]}


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


def _numerics_guard(tft, df, z, ex, blocks: int, calls: int = 3) -> dict:
    """check_numerics on the 200M-row x+3 map: one host sync a block, and
    its time on and off; ``x / 0.0`` raises naming the block and fetch."""
    from tensorframes_tpu_torch.utils.profiling import reset_stats, stats

    t_off = [_wall(lambda: tft.map_blocks(z, df, executor=ex))[1] for _ in range(calls)]
    with tft.config.override(check_numerics=True):
        tft.map_blocks(z, df, executor=ex)
        reset_stats()
        tft.map_blocks(z, df, executor=ex)
        syncs = stats().get("host_sync", 0)
        t_on = [_wall(lambda: tft.map_blocks(z, df, executor=ex))[1] for _ in range(calls)]
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
    return {"host_syncs": syncs, "off_ms": _median(t_off) * 1e3,
            "on_ms": _median(t_on) * 1e3, "message": msg}


def phase_runtime_services(tft, rows: int = 200_000_000, blocks: int = 8,
                           mlp_rows: int = 1_000_000, oom_rows: int = 1 << 28) -> None:
    """Phase 16: the cost ledger and its roofline on phase 3's x+3 map and
    phase 4's MLP, the ledger's overhead, /diagnostics and /profile, the
    autotuner over phase 15's serving profile, a genuine OOM split, and
    the numerics guard."""
    from tensorframes_tpu_torch.runtime.executor import Executor

    t0 = time.perf_counter()
    autotune = _runtime_autotune(tft)
    ex = Executor()
    df, z, sizes = _ledger_workloads(tft, ex, rows, blocks, mlp_rows)
    ledger = _check_ledger(tft, ex, rows, blocks, mlp_rows, sizes)
    http = _http_surface(tft)
    overhead = _ledger_overhead(tft, df, z, ex)
    numerics = _numerics_guard(tft, df, z, ex, blocks)
    del df
    torch.cuda.empty_cache()
    oom = _genuine_oom_split(tft, oom_rows)
    torch.cuda.empty_cache()
    _emit(
        "runtime_services", rows=rows, blocks=blocks, mlp_rows=mlp_rows,
        ledger=ledger, overhead=overhead, http=http, autotune=autotune,
        oom_split=oom, numerics=numerics, seconds=time.perf_counter() - t0,
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
    """(local result, local s, mesh result, mesh s, the mesh call's
    dispatch spans): one warm-up call each way first."""
    from tensorframes_tpu_torch.utils import telemetry

    local_call()
    mesh_call()
    local, local_s = _wall(local_call)
    telemetry.reset()
    meshed, mesh_s = _wall(mesh_call)
    spans = _mesh_dispatches()
    if not spans or spans[0][1] != torch.cuda.device_count():
        raise AssertionError(f"{what}: mesh dispatch spans {spans}")
    return local, local_s, meshed, mesh_s, spans


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
    local, local_s, meshed, mesh_s, spans = _mesh_and_local(
        "map_blocks", lambda: tft.map_blocks(z, df), lambda: tft.map_blocks(z, df, mesh=mesh))
    mz = meshed.column("z").values
    if not (torch.equal(mz, local.column("z").values) and torch.equal(mz, x + 3.0)):
        raise AssertionError("mesh map_blocks x+3 differs from the local verb")
    out["map_blocks"] = dict(rows=rows, local_s=local_s, mesh_s=mesh_s,
                             local_rows_per_s=rows / local_s, mesh_rows_per_s=rows / mesh_s,
                             dispatch_spans=spans)
    del local, meshed, mz

    xh = x.cpu().numpy()
    for name, op in (("reduce_sum", dsl.reduce_sum), ("reduce_min", dsl.reduce_min)):
        g = op(tft.block(df, "x", tf_name="x_input")).named("x")
        local, local_s, meshed, mesh_s, spans = _mesh_and_local(
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
        out[name] = dict(rows=rows, local_s=local_s, mesh_s=mesh_s, rel_err=err,
                         mesh_rows_per_s=rows / mesh_s, local_rows_per_s=rows / local_s,
                         dispatch_spans=spans)

    pair = _pair_graph(tft, dsl.add)
    local, local_s, meshed, mesh_s, spans = _mesh_and_local(
        "reduce_rows", lambda: tft.reduce_rows(pair, df), lambda: tft.reduce_rows(pair, df, mesh=mesh))
    want = float(xh.sum(dtype=np.float64))
    err = abs(meshed.item() - want) / want
    if err > _SUM_RTOL:
        raise AssertionError(f"mesh reduce_rows sum rel err {err:.3e} > {_SUM_RTOL}")
    out["reduce_rows"] = dict(rows=rows, local_s=local_s, mesh_s=mesh_s, rel_err=err,
                              mesh_rows_per_s=rows / mesh_s, dispatch_spans=spans)
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
    local, local_s, meshed, mesh_s, spans = _mesh_and_local(
        "map_rows", lambda: tft.map_rows(probs, fdf), lambda: tft.map_rows(probs, fdf, mesh=mesh))
    mp, lp = meshed.column("probs").values, local.column("probs").values
    if ndev == 1 and not torch.equal(mp, lp):
        raise AssertionError("mesh map_rows MLP differs from the local verb")
    # over several cards each shard's products run at its own row count,
    # for which cuBLAS may pick another kernel: the MLP's float tolerance
    mlp_err = _check_close("mesh map_rows MLP", mp.to(lp.device), lp, _MLP_RTOL, _MLP_ATOL)
    out["map_rows_mlp"] = dict(rows=mlp_rows, local_s=local_s, mesh_s=mesh_s,
                               mesh_rows_per_s=mlp_rows / mesh_s,
                               local_rows_per_s=mlp_rows / local_s, max_abs_err=mlp_err,
                               dispatch_spans=spans)
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
    local, local_s, meshed, mesh_s, spans = _mesh_and_local(
        "aggregate sum", lambda: tft.aggregate(total, grouped),
        lambda: tft.aggregate(total, grouped, mesh=mesh))
    if spans[0][0] != "mesh.aggregate.segment":
        raise AssertionError(f"mesh aggregate sum took {spans}")
    errs = [_check_close(f"{w} aggregate sum",
                         torch.from_numpy(r.host_values("v").astype(np.float64)),
                         torch.from_numpy(want_s), _SUM_RTOL, 0.0)
            for w, r in (("mesh", meshed), ("local", local))]
    out["aggregate_segment"] = dict(rows=agg_rows, dim=dim, keys=nkeys, local_s=local_s,
                                    mesh_s=mesh_s, mesh_rows_per_s=agg_rows / mesh_s,
                                    local_rows_per_s=agg_rows / local_s,
                                    max_abs_err=errs[0], dispatch_spans=spans)
    m = dsl.reduce_mean(dsl.block(adf, "v", tf_name="m_input"), axes=[0]).named("m")
    q = dsl.reduce_mean(dsl.square(dsl.block(adf, "v", tf_name="q_input")), axes=[0]).named("q")
    feed = {"m_input": "v", "q_input": "v"}
    local, local_s, meshed, mesh_s, spans = _mesh_and_local(
        "aggregate general", lambda: tft.aggregate([m, q], grouped, feed_dict=feed),
        lambda: tft.aggregate([m, q], grouped, feed_dict=feed, mesh=mesh))
    if spans != [("mesh.aggregate.segment", ndev)]:
        raise AssertionError(f"mesh aggregate general took {spans}")
    errs = [
        _check_close(f"mesh aggregate {c}", torch.from_numpy(meshed.host_values(c).astype(np.float64)),
                     torch.from_numpy(w / counts[:, None]), _SUM_RTOL, 0.0)
        for c, w in (("m", want_s), ("q", want_q))
    ]
    out["aggregate_general"] = dict(rows=agg_rows, dim=dim, keys=nkeys, local_s=local_s,
                                    mesh_s=mesh_s, mesh_rows_per_s=agg_rows / mesh_s,
                                    local_rows_per_s=agg_rows / local_s,
                                    max_abs_err=max(errs), local_plan="segment",
                                    dispatch_spans=spans)
    del local, meshed, adf, grouped, v, keys
    torch.cuda.empty_cache()
    _emit("mesh_verbs", card=_CARD, sum_rtol=_SUM_RTOL, **out)


# ---------------------------------------------------------------------------
# phase 18: the block scheduler, device failover and GlobalFrame
# ---------------------------------------------------------------------------


def _sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _wall_all(fn):
    """(result, seconds) of ``fn()`` ending when every card is done."""
    _sync_all()
    t0 = time.perf_counter()
    out = fn()
    _sync_all()
    return out, time.perf_counter() - t0


def _best_wall(fn, calls: int = 3):
    """(result of the last call, least seconds of ``calls`` calls) after one
    warm-up call."""
    fn()
    best, out = math.inf, None
    for _ in range(calls):
        out, s = _wall_all(fn)
        best = min(best, s)
    return out, best


def _lies_on(t: torch.Tensor, i: int) -> bool:
    """Whether ``t`` is on card ``i``: a shard that fell to the host fails."""
    return t.device == torch.device("cuda", i)


def _span_labels(prefix: str):
    """The device label of every dispatch span named ``prefix...``."""
    from tensorframes_tpu_torch.utils import telemetry

    return [s.attrs.get("device") for s in telemetry.spans()
            if s.kind == "dispatch" and s.name.startswith(prefix)]


def _scheduled(tft, ex, what: str, call, span: str, items: int, ndev: int):
    """One scheduled call (a warm-up first): its result and seconds, each
    dispatch span labelled with a card, and the executor's per-card
    dispatch ledger summing to ``items``."""
    from tensorframes_tpu_torch.utils import telemetry

    call()
    ex.device_dispatches.clear()
    telemetry.reset()
    out, secs = _wall_all(call)
    labels = _span_labels(span)
    cards = {f"cuda:{i}" for i in range(ndev)}
    if len(labels) != items or not set(labels) <= cards:
        raise AssertionError(f"{what}: dispatch span labels {labels}, cards {sorted(cards)}")
    if sum(ex.device_dispatches.values()) != items:
        raise AssertionError(f"{what}: device_dispatches {ex.device_dispatches} for {items} items")
    return out, secs, dict(ex.device_dispatches)


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
        local, local_s = _best_wall(lambda: tft.map_blocks(z, df, device="cuda:0"))
        got, secs, ledger = _scheduled(
            tft, ex, "map_blocks", lambda: tft.map_blocks(z, df, devices=devices, executor=ex),
            "map_blocks.block", blocks, ndev)
        if not torch.equal(got.column("z").values, local.column("z").values):
            raise AssertionError("scheduled map_blocks x+3 differs from the local verb")
        out["map_blocks"] = dict(rows=rows, blocks=blocks, seconds=secs, local_s=local_s,
                                 device_dispatches=ledger)
        del got, local
        xh = x.cpu().numpy()
        want = float(xh.sum(dtype=np.float64))
        for name, op in (("reduce_sum", dsl.reduce_sum), ("reduce_min", dsl.reduce_min)):
            g = op(tft.block(df, "x", tf_name="x_input"), axes=[0]).named("x")
            local = tft.reduce_blocks(g, df, device="cuda:0")
            got, secs, ledger = _scheduled(
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
            out[name] = dict(rows=rows, seconds=secs, rel_err=err, device_dispatches=ledger)
        pair = _pair_graph(tft, dsl.add)
        got, secs, ledger = _scheduled(
            tft, ex, "reduce_rows", lambda: tft.reduce_rows(pair, df, devices=devices, executor=ex),
            "reduce_rows.block", blocks, ndev)
        err = abs(got.item() - want) / want
        if err > _SUM_RTOL:
            raise AssertionError(f"scheduled reduce_rows sum rel err {err:.3e} > {_SUM_RTOL}")
        out["reduce_rows"] = dict(rows=rows, seconds=secs, rel_err=err, device_dispatches=ledger)
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
        got, secs, ledger = _scheduled(
            tft, ex, "map_rows MLP", lambda: tft.map_rows(probs, fdf, devices=devices, executor=ex),
            "map_rows.block", blocks, ndev)
        gp = got.column("probs").values
        if ndev == 1 and not torch.equal(gp, local):
            raise AssertionError("scheduled map_rows MLP differs from the local verb")
        err = _check_close("scheduled map_rows MLP", gp, local, _MLP_RTOL, _MLP_ATOL)
        out["map_rows_mlp"] = dict(rows=mlp_rows, seconds=secs, max_abs_err=err,
                                   device_dispatches=ledger)
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
            got, secs, ledger = _scheduled(
                tft, ex, "aggregate exact",
                lambda: tft.aggregate(total, tft.group_by(adf, "k"), devices=devices, executor=ex),
                "aggregate.size", nsizes, ndev)
        want_v = np.bincount(kh, weights=vh, minlength=nkeys)
        err = _check_close("scheduled exact aggregate",
                           torch.from_numpy(got.host_values("v").astype(np.float64)),
                           torch.from_numpy(want_v), _SUM_RTOL, 0.0)
        if not np.array_equal(got.host_values("v"), local.host_values("v")):
            raise AssertionError("scheduled exact aggregate differs from the local verb")
        out["aggregate_exact"] = dict(rows=agg_rows, keys=nkeys, sizes=nsizes, seconds=secs,
                                      max_abs_err=err, device_dispatches=ledger)
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
            got, secs = _wall_all(lambda: tft.map_blocks(z, df, executor=ex))
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
    return dict(rows=rows, blocks=blocks, seconds=secs, retries=led["retries"],
                evictions=led["evictions"], device_evictions=evictions, span_labels=labels,
                healthz_status=health["status"], incident_bundles=bundles, circuits=circuits)


def _global_frame(tft, ndev: int, rows: int, blocks: int, chunk_rows: int, chunks: int) -> dict:
    """`to_global()` of ``rows`` float32 rows; x+3 -> x*2 -> reduce_sum with
    the outputs left on their shards; the ``"global"`` auto-route; a
    `LazyFrame.force` over the global base; `filter_global`; a stream of
    ``chunks`` x ``chunk_rows`` rows through the double-buffered
    accumulator. Seconds beside the local verb on cuda:0 and ``mesh=``."""
    from tensorframes_tpu_torch import globalframe
    from tensorframes_tpu_torch.graph.plan import col
    from tensorframes_tpu_torch.parallel import data_mesh
    from tensorframes_tpu_torch.utils import telemetry

    dsl = tft.dsl
    globalframe.reset_state()
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 29)
    x = torch.rand(rows, device="cuda:0", generator=gen)
    df = tft.TensorFrame([tft.Column("x", x)]).repartition(blocks)
    gf, to_global_s = _wall_all(lambda: df.to_global())
    if gf.data_size != ndev or not all(
            _lies_on(s, i) for i, s in enumerate(gf.shards("x"))):
        raise AssertionError(f"to_global: {gf!r} on {[s.device for s in gf.shards('x')]}")
    z = (tft.block(df, "x") + 3.0).named("y")
    telemetry.reset()
    m1, map_s = _best_wall(lambda: gf.map_blocks(z))
    spans = [(s.name, s.attrs.get("sharding")) for s in telemetry.spans() if s.kind == "dispatch"]
    if spans[-1] != ("map_blocks.global", f"data:{ndev}"):
        raise AssertionError(f"global map dispatch spans {spans[-3:]}")
    _, local_s = _best_wall(lambda: tft.map_blocks(z, df, device="cuda:0"))
    mesh = data_mesh()
    _, mesh_s = _best_wall(lambda: tft.map_blocks(z, df, mesh=mesh))
    m2 = m1.map_blocks((tft.block(m1, "y") * 2.0).named("w"))
    for i, s in enumerate(m2.shards("w")):
        if not _lies_on(s, i):
            raise AssertionError(f"global map output shard {i} left its card: {s.device}")
    w = m2.to_frame().column("w").values
    if not torch.equal(w, (x + 3.0) * 2.0):
        raise AssertionError("global x+3 -> x*2 differs from the local arithmetic")
    g = dsl.reduce_sum(tft.block(m2, "w", tf_name="w_input"), axes=[0]).named("w")
    total, reduce_s = _best_wall(lambda: m2.reduce_blocks(g))
    want = float(((x.cpu().numpy().astype(np.float64) + 3.0) * 2.0).sum())
    err = abs(total.item() - want) / want
    if err > _SUM_RTOL:
        raise AssertionError(f"global reduce_sum rel err {err:.3e} > {_SUM_RTOL}")
    out["chain"] = dict(rows=rows, shards=gf.data_size, pad_rows=gf.pad_rows,
                        to_global_s=to_global_s, map_s=map_s, local_map_s=local_s,
                        mesh_map_s=mesh_s, reduce_sum_s=reduce_s, rel_err=err)
    del m1, m2, w

    telemetry.reset()
    with tft.config.override(block_scheduler="global"):
        routed, route_s = _wall_all(lambda: tft.map_blocks(z, df))
        rmin = tft.reduce_blocks(
            dsl.reduce_min(tft.block(df, "x", tf_name="x_input"), axes=[0]).named("x"), df)
    names = [s.name for s in telemetry.spans() if s.kind == "dispatch"]
    if "map_blocks.global" not in names or "reduce_blocks.global" not in names:
        raise AssertionError(f"global auto-route took {names}")
    if not torch.equal(routed.column("y").values, x + 3.0) or rmin.item() != x.min().item():
        raise AssertionError("global auto-route results differ")
    out["auto_route"] = dict(map_s=route_s, dispatches=names)
    del routed

    telemetry.reset()
    forced, force_s = _wall_all(lambda: gf.lazy().map_blocks(z).force())
    if [s.name for s in telemetry.spans() if s.kind == "dispatch"] != ["lazy.force.global"]:
        raise AssertionError("LazyFrame.force did not take the global route")
    if not torch.equal(forced.column("y").values, x + 3.0):
        raise AssertionError("global LazyFrame.force differs")
    out["lazy_force"] = dict(seconds=force_s)
    del forced

    kept, filter_s = _wall_all(lambda: gf.filter(col("x") > 0.5).force())
    want_rows = x[x > 0.5]
    if kept.nrows != want_rows.shape[0] or not torch.equal(
            kept.to_frame().column("x").values, want_rows):
        raise AssertionError("filter_global differs from the mask on the card")
    out["filter"] = dict(seconds=filter_s, rows_kept=kept.nrows)
    del kept, want_rows, gf, df, x

    parts = [torch.rand(chunk_rows, device="cuda:0", generator=gen) for _ in range(chunks)]
    frames = [tft.TensorFrame([tft.Column("x", p)]) for p in parts]
    sg = dsl.reduce_sum(tft.block(frames[0], "x", tf_name="x_input"), axes=[0]).named("x")
    want = sum(float(p.cpu().numpy().sum(dtype=np.float64)) for p in parts)
    local_stream = lambda: tft.reduce_blocks_stream(sg, iter(frames), device="cuda:0")  # noqa: E731
    local_stream()  # warm: the transfer stage's stream, the pipeline threads
    with tft.config.override(block_scheduler="global"):
        tft.reduce_blocks_stream(sg, iter(frames))
        globalframe.reset_state()
        got, stream_s = _wall_all(lambda: tft.reduce_blocks_stream(sg, iter(frames)))
    st = globalframe.state()
    local, local_stream_s = _wall_all(local_stream)
    errs = [abs(v.item() - want) / want for v in (got, local)]
    if max(errs) > _SUM_RTOL:
        raise AssertionError(f"global stream sum rel errs {errs} > {_SUM_RTOL}")
    if st["stream_folds"] < 1 or st["dispatches"] < chunks:
        raise AssertionError(f"global stream state {st}")
    out["stream"] = dict(chunks=chunks, chunk_rows=chunk_rows, seconds=stream_s,
                         local_seconds=local_stream_s, rel_err=errs[0], state=st)
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
    t0 = time.perf_counter()
    sched = _scheduled_verbs(tft, ndev, rows, blocks, mlp_rows, agg_rows, nkeys)
    torch.cuda.empty_cache()
    drill = _failover_drill(tft, ndev)
    torch.cuda.empty_cache()
    gfr = _global_frame(tft, ndev, rows, blocks, chunk_rows, chunks)
    torch.cuda.empty_cache()
    _emit("scheduler_and_global", card=_CARD, devices=ndev, sum_rtol=_SUM_RTOL,
          scheduled=sched, failover=drill, global_frame=gfr,
          seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 20: multi-process execution, one rank a card
# ---------------------------------------------------------------------------

# seconds a multi-process world may take, its start-up included
_MULTIHOST_TIMEOUT_S = 300


def _barrier_best(fn, calls: int = 3, warm: bool = True):
    """(result of the last call, least seconds of ``calls`` calls) of
    ``fn()`` on this rank, after a warm-up call when ``warm``: every rank
    starts each call together (a barrier first), and the card is done at
    its end."""
    import torch.distributed as dist

    if warm:
        fn()
    best, out = math.inf, None
    for _ in range(calls):
        dist.barrier()
        out, secs = _wall(fn)
        best = min(best, secs)
    return out, best


def _reduced(t: torch.Tensor, op) -> torch.Tensor:
    """``t`` all-reduced over every rank (the references' collective, not
    the one under test)."""
    import torch.distributed as dist

    t = t.clone()
    dist.all_reduce(t, op=op)
    return t


def _multihost_keyed(tft, mh, mesh, keys_col, codes: np.ndarray, want_keys: np.ndarray, v,
                     single, warm: bool) -> dict:
    """`aggregate_global` of ``v`` by ``keys_col`` (a device int64 tensor or
    a host string vector; row r is in group ``codes[r]`` of the sorted keys
    ``want_keys``) on this rank's rows: a keyed sum and mean, against every
    rank's float64 numpy sums (the key column exact), timed after a
    warm-up call when ``warm``. ``single`` is the world-1 check against the
    single-process ``mesh=data_mesh()`` aggregate."""
    import torch.distributed as dist

    dsl = tft.dsl
    kcol = tft.Column("k", keys_col) if isinstance(keys_col, torch.Tensor) else \
        tft.Column("k", keys_col, tft.ScalarType.string)
    df = tft.TensorFrame([kcol, tft.Column("v", v)])
    grouped = tft.group_by(df, "k")
    fetches = [dsl.reduce_sum(dsl.block(df, "v", tf_name="s_input"), axes=[0]).named("s"),
               dsl.reduce_mean(dsl.block(df, "v", tf_name="m_input"), axes=[0]).named("m")]
    feed = {"s_input": "v", "m_input": "v"}
    out, secs = _barrier_best(lambda: mh.aggregate_global(fetches, grouped, feed_dict=feed),
                              calls=3 if warm else 1, warm=warm)
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
    res = dict(rows=int(counts.sum()), seconds=secs, rows_per_s=int(counts.sum()) / secs,
               max_abs_err=max(errs))
    if single is not None:
        ref, res["mesh_seconds"] = _barrier_best(
            lambda: tft.aggregate(fetches, grouped, feed_dict=feed, mesh=single))
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
    from ``SEED`` and the rank. Prints one JSON line of its numbers."""
    import torch.distributed as dist

    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch.ops.flash_attention import flash_attention
    from tensorframes_tpu_torch.parallel import data_mesh
    from tensorframes_tpu_torch.parallel import multihost as mh

    t_start = time.perf_counter()
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
    out = dict(rank=rank, world=world, backend=dist.get_backend(), mesh=repr(mesh),
               init_s=time.perf_counter() - t_start)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20 + 1000 * rank)

    # phase 17's rows: x+3 map_blocks, reduce_blocks sum and min
    n = sizes["rows"] // world
    x = torch.rand(n, device="cuda", generator=gen)
    df = mh.host_local_frame_to_global(tft.TensorFrame([tft.Column("x", x)]), mesh)
    plain = tft.TensorFrame([tft.Column("x", x)])

    def timed(name, call):
        """``call(frame, mesh)`` over the spanning frame, and at one rank
        over the plain frame on ``mesh=data_mesh()`` (phase 17's verb)."""
        got, secs = _barrier_best(lambda: call(df, mesh))
        out[name] = dict(rows=n * world, seconds=secs, rows_per_s=n * world / secs)
        if single is None:
            return got, None
        ref, out[name]["mesh_seconds"] = _barrier_best(lambda: call(plain, single))
        return got, ref

    z = (tft.block(df, "x") + 3.0).named("z")
    mapped, ref = timed("map_blocks", lambda f, m: tft.map_blocks(z, f, mesh=m))
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
        got, ref = timed(name, lambda f, m: tft.reduce_blocks(g, f, mesh=m))
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
    if world > 1:
        # where the cross-process combine's time goes: its one NCCL
        # all-gather, a gloo gather of host metadata (aggregate_global's
        # row counts), the whole partials gather of one float32 a rank,
        # and the same reduce over this rank's rows without a mesh
        import types

        one = [(torch.ones((), device="cuda"),)]
        scalar = [types.SimpleNamespace(shape=tft.Shape(()), dtype=tft.ScalarType.float32)]
        parts = dict(
            int64_gather_gloo=lambda: mh._allgather_host(np.zeros(1, np.int64)),
            bytes_gather_nccl=lambda: mh._gather_padded(one[0][0].reshape(1), [1] * world),
            gather_partials=lambda: mh.gather_partials(one, mesh, one[0][0].device, scalar),
            local_reduce_sum=lambda: tft.reduce_blocks(
                dsl.reduce_sum(tft.block(plain, "x", tf_name="x_input")).named("x"), plain),
        )
        out["combine_ms"] = {k: _barrier_best(f, calls=5)[1] * 1e3 for k, f in parts.items()}
    del df, plain, x
    torch.cuda.empty_cache()

    # config 4's widths through aggregate_global: int64 keys, then strings
    n = sizes["agg_rows"] // world
    nkeys = sizes["nkeys"]
    v = torch.rand(n, sizes["dim"], device="cuda", generator=gen)
    keys = (torch.arange(n, device="cuda") + rank * n) % nkeys
    codes = keys.cpu().numpy()
    out["aggregate_int_keys"] = _multihost_keyed(
        tft, mh, mesh, keys, codes, np.arange(nkeys), v, single, warm=True)
    del keys
    # ids in sorted order: key i has group id i
    names = np.asarray([f"id-{i:02d}" for i in range(nkeys)], dtype=object)
    t0 = time.perf_counter()
    skeys = names[codes]
    build_s = time.perf_counter() - t0
    # phase 17 has no string keys: against numpy alone
    out["aggregate_string_keys"] = dict(
        _multihost_keyed(tft, mh, mesh, skeys, codes, names, v, None, warm=False),
        key_build_s=build_s)
    del v, skeys, codes
    torch.cuda.empty_cache()

    # analyze_global over ragged rows: lengths 1..max_len on every rank
    cells = _ragged_column(sizes["ragged_rows"] // world, sizes["max_len"], SEED + 20 + rank)[0]
    rdf = tft.TensorFrame.from_dict({"v": cells})
    merged, secs = _barrier_best(lambda: mh.analyze_global(rdf), calls=1, warm=False)
    dims = merged.info["v"].cell_shape.dims
    if dims != (None,):
        raise AssertionError(f"analyze_global merged the ragged cells to {dims}")
    out["analyze_global"] = dict(rows=len(cells) * world, seconds=secs,
                                 rows_per_s=len(cells) * world / secs, dims=list(dims))
    out["flash_attention_launches"] = flash_attention.launches
    out["seconds"] = time.perf_counter() - t_start
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
    t0 = time.perf_counter()
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
    wall = time.perf_counter() - t0
    ranks = []
    for r, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"multihost rank {r} exited {p.returncode}:\n{stderr[-4000:]}")
        line = [ln for ln in stdout.splitlines() if ln.startswith('{"multihost_worker"')]
        ranks.append(json.loads(line[-1])["multihost_worker"])
    launches = sum(r.pop("flash_attention_launches") for r in ranks)
    _emit("multihost", card=_CARD, world=world, sum_rtol=_SUM_RTOL, wall_s=wall, ranks=ranks)
    return launches


def phase_scheduled_lm(tft, cfg, n_seqs: int = 16, block_seqs: int = 4) -> int:
    """On two or more cards: `TransformerLM` scoring of ``n_seqs`` sequences
    with ``devices=`` over every card, a copy of the model a card (the same
    seed), the flash-attention kernel launching on each card's stream; one
    warm-up call, then the timed one. Each block's logits equal cuda:0's
    for the same tokens within the logit tolerance. Returns the kernel's
    launches in the timed call."""
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
    tft.map_blocks(score, df, devices=list(range(ndev)))  # warm every card
    before = flash_attention.launches
    out, secs = _wall_all(lambda: tft.map_blocks(score, df, devices=list(range(ndev))))
    launches = flash_attention.launches - before
    logits = out.column("logits").values
    err = _check_close("devices= LM logits", logits.to("cuda:0"), want, _LOGIT_RTOL, _LOGIT_ATOL)
    expected = cfg["n_layers"] * (n_seqs // block_seqs)
    if launches != expected:
        raise AssertionError(f"devices= LM: {launches} launches, expected {expected}")
    _emit("scheduled_lm_scoring", devices=ndev, sequences=n_seqs, block_sequences=block_seqs,
          seconds=secs, tokens_per_s=n_seqs * cfg["max_seq"] / secs, launches=launches,
          max_abs_err=err)
    return launches


def phase_transformer(tft, cfg, n_seqs: int, block_seqs: int,
                      phase: str = "transformer_map_blocks") -> float:
    from tensorframes_tpu_torch.models import TransformerLM
    from tensorframes_tpu_torch.ops.flash_attention import flash_attention_reference

    model = TransformerLM(**cfg, seed=SEED, device="cuda")
    seq = cfg["max_seq"]
    tokens = np.random.default_rng(SEED).integers(0, cfg["vocab"], (n_seqs, seq)).astype(np.int32)
    df = tft.TensorFrame.from_dict({"tokens": tokens}, num_blocks=n_seqs // block_seqs)

    def score(tokens):
        return {"logits": model(tokens)}

    out, secs = _wall(lambda: tft.map_blocks(score, df))
    logits = out.column("logits").values
    if tuple(logits.shape) != (n_seqs, seq, cfg["vocab"]) or not torch.isfinite(logits).all():
        raise AssertionError(f"TransformerLM: bad logits {tuple(logits.shape)}")

    first = torch.from_numpy(tokens[:block_seqs]).cuda()
    want = model(first, attention=flash_attention_reference)
    err = _check_close(
        "TransformerLM block 0 logits", logits[:block_seqs], want, _LOGIT_RTOL, _LOGIT_ATOL
    )
    _emit(
        phase, config=cfg, sequences=n_seqs, block_sequences=block_seqs,
        seconds=secs, tokens_per_s=n_seqs * seq / secs, max_abs_err=err,
        tolerance={"rtol": _LOGIT_RTOL, "atol": _LOGIT_ATOL},
    )
    return secs


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


def _lse_entry(lm_shape, ring_slots: int = 4) -> dict:
    """`flash_attention_lse` against its plain version at the LM's shape
    and at the shape of one step of the ring's scoring (the sequence cut
    over ``ring_slots``), causal and not, and at head_dim 128; its output
    equal to the entry without the statistics; both entries timed in turns;
    ptxas's lines for the instantiation that stores the statistics."""
    from tensorframes_tpu_torch.ops import _cuda_build
    from tensorframes_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_lse,
        flash_attention_lse_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    errs, times = {}, {}
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
        # in turns: without, with, with, without
        a1 = _time_ms(lambda: flash_attention(q, k, v, causal=causal), 20)
        b1 = _time_ms(lambda: flash_attention_lse(q, k, v, causal=causal), 20)
        b2 = _time_ms(lambda: flash_attention_lse(q, k, v, causal=causal), 20)
        a2 = _time_ms(lambda: flash_attention(q, k, v, causal=causal), 20)
        times[key] = dict(ms=[a1, a2], lse_ms=[b1, b2])
    log = _cuda_build.build_logs.get("flash_attention", "")
    return dict(
        max_abs_err_each=errs, max_abs_err=max(errs.values()), times=times,
        tolerance={"rtol": _ATTN_RTOL, "atol": _ATTN_ATOL},
        ptxas_d64=_ptxas_line(log, 64, lse=True), ptxas_d128=_ptxas_line(log, 128, lse=True),
    )


def _ring_scoring(cfg, cards: int, n_seqs: int = 8, n_slots: int = 4) -> dict:
    """`TransformerLM.apply(mesh=)` over a ``data`` mesh of ``n_slots``
    slots against `apply` without a mesh and against the model on the
    kernel's plain version: the ring's kernel launches in one call are
    counted (n_layers x n(n+1)/2); the ring and `apply` without a mesh
    timed, the least of three calls each."""
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
    _, ring_s = _best_wall(lambda: model(tokens, mesh=mesh))
    _, single_s = _best_wall(lambda: model(tokens))
    return dict(
        sequences=n_seqs, seq=cfg["max_seq"], slots=n_slots, ring_launches=launches,
        ring_s=ring_s, single_s=single_s, ring_tokens_per_s=n_seqs * cfg["max_seq"] / ring_s,
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
    y, secs = _best_wall(lambda: seq_all_to_all(x, mesh, seq_axis=0, head_axis=1))
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
    return dict(shape=[2048, 8, 64], slots=n_slots, exact=True, seconds=secs)


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
        run = lambda: pipeline_apply(stage, params, x, mesh, num_microbatches=micro)  # noqa: E731
        got, secs = _best_wall(run)
        want, seq_secs = _best_wall(sequential)
    err = _check_close("pipeline_apply", got, want, _PIPE_RTOL, _PIPE_ATOL)
    return dict(stages=stages, d=d, batch=batch, microbatches=micro, seconds=secs,
                sequential_seconds=seq_secs, max_abs_err=err,
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
        want, dense_s = _best_wall(lambda: model(x))
        params = dict(model.params)
        params["w1"] = shard(model.params["w1"], mesh, P("model"))
        params["w2"] = shard(model.params["w2"], mesh, P("model"))
        got, ep_s = _best_wall(lambda: model.apply_ep(params, x, mesh))
    err = _check_close("MoEFFN.apply_ep", got, want, _MOE_RTOL, _MOE_ATOL)
    del params, want, got
    return dict(widths=[d, h, 8, 2], tokens=tokens, slots=n_slots, ep_seconds=ep_s, dense_seconds=dense_s,
                max_abs_err=err, tolerance={"rtol": _MOE_RTOL, "atol": _MOE_ATOL})


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
    # steps from the same parameters, the least of three after a warm-up
    _, secs = _best_wall(lambda: step(sharded, x, y))
    _, ref_secs = _best_wall(lambda: model.train_step(
        [(w.detach().clone(), b.detach().clone()) for w, b in model.params], x, y, lr=0.05))
    if abs(float(loss) - float(rloss)) > _MLP_STEP_LOSS_RTOL * abs(float(rloss)):
        raise AssertionError(f"MLP sharded step loss {float(loss)} vs {float(rloss)}")
    err = 0.0
    for i, ((w, b), (rw, rb)) in enumerate(zip(new, ref)):
        err = max(err, _check_close(f"MLP sharded w{i}", w.gather(), rw, _MLP_STEP_RTOL, _MLP_STEP_ATOL),
                  _check_close(f"MLP sharded b{i}", b.gather(), rb, _MLP_STEP_RTOL, _MLP_STEP_ATOL))
    return dict(sizes=sizes, rows=rows, mesh=[2, 2], loss=float(loss), loss_unsharded=float(rloss),
                seconds=secs, unsharded_seconds=ref_secs, max_abs_err=err,
                tolerance={"loss_rtol": _MLP_STEP_LOSS_RTOL, "rtol": _MLP_STEP_RTOL,
                           "atol": _MLP_STEP_ATOL})


def _step_3d(cards: int, steps: int = 5, batch_shard: int = 8, seq_shard: int = 128) -> dict:
    """`TransformerLM.sharded_train_step_3d` at `benchmarks/train_bench.py`'s
    widths on a 2 x 2 x 2 mesh (one card) or 1 x 2 x 2 (four cards) against
    the single-card step, every parameter; then ``steps`` timed steps after
    a warm-up."""
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

    def train():
        nonlocal layout
        for _ in range(steps):
            layout, _ = step(layout, tokens)

    _, secs = _wall_all(train)
    n_tokens = tokens.numel()
    return dict(config=cfg, mesh=list(shape), tokens_per_step=n_tokens, loss=float(loss),
                loss_single_card=float(rloss), max_abs_err=err, timed_steps=steps,
                ms_per_step=secs / steps * 1e3, tokens_per_s=n_tokens * steps / secs,
                tolerance={"loss_rtol": _STEP3D_LOSS_RTOL, "rtol": _STEP3D_RTOL,
                           "atol": _STEP3D_ATOL})


def phase_parallel_models(cfg, lm_shape, cards: int = 1) -> dict:
    """Phase 19: the log-sum-exp entry of the kernel, `TransformerLM`
    scoring through the ring (its launches counted apart from the main
    path's), the differentiable ring, `seq_all_to_all`, `pipeline_apply`,
    `MoEFFN.apply_ep`, the MLP's sharded step and the 3-D step. Every mesh
    is a set of slots over the first ``cards`` cards; each pair of calls
    compared in time is the least of three calls after a warm-up. Returns
    the numbers the kernels line carries."""
    t0 = time.perf_counter()
    out = dict(card=_CARD, cards=cards)
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
    out["seconds"] = time.perf_counter() - t0
    _emit("parallel_models" if cards == 1 else f"parallel_models_on_{cards}_cards", **out)
    return out


# ---------------------------------------------------------------------------
# phase 21: attention at every width and dtype
# ---------------------------------------------------------------------------

# bf16 and fp16 outputs against the plain version's: both compute in float32
# and round once to the dtype, so they may differ by one unit in its last
# place, a relative 2^-7 (bf16) or 2^-10 (fp16); atol for values near 0
_HALF_RTOL = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}
_HALF_ATOL = 1e-5
# bf16 and fp16 products run on the tensor cores (dense, NVIDIA's data
# sheet): the bound of a half-precision call is taken against them
_PEAK_HALF_FLOPS = 989e12


def _close_in_dtype(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """`_check_close` at the tolerance of ``want``'s dtype: float32 and
    float64 (float32 arithmetic) at the kernel's bar, bf16 and fp16 within
    one unit in their last place."""
    if want.dtype in _HALF_RTOL:
        if got.dtype != want.dtype:
            raise AssertionError(f"{what}: {got.dtype} vs {want.dtype}")
        return _check_close(what, got.float(), want.float(), _HALF_RTOL[want.dtype], _HALF_ATOL)
    return _check_close(what, got, want, _ATTN_RTOL, _ATTN_ATOL)


def _both_entries(what: str, q, k, v, causal: bool, scale=None) -> float:
    """`flash_attention` and `flash_attention_lse` on the card against
    `flash_attention_lse_reference` on the same tensors: output (q's shape
    and dtype) and log-sum-exp (float32, q's shape without D); the two
    entries' outputs equal. Returns the max abs error."""
    from tensorframes_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_lse,
        flash_attention_lse_reference,
    )

    out = flash_attention(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    out_l, lse = flash_attention_lse(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    ref, ref_lse = flash_attention_lse_reference(q, k, v, causal=causal, scale=scale)
    if not torch.equal(out, out_l):
        raise AssertionError(f"{what}: the two entries' outputs differ")
    return max(
        _close_in_dtype(what + " out", out, ref),
        _check_close(what + " lse", lse, ref_lse, _ATTN_RTOL, _ATTN_ATOL),
    )


def _width_and_layout_cases(gen) -> dict:
    """Every head width class, layouts, strides, offsets and dtypes through
    both entries against the plain version; max abs error by case."""
    from tensorframes_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    errs = {}
    # widths not a multiple of 8 (zero-padded), up to 128 (one slice) and
    # past it (column slices), at ragged lengths
    for d, s in zip((1, 15, 24, 120, 136, 200, 256, 512), (75, 129, 200, 1000) * 2):
        for causal in (False, True):
            q, k, v = (rand(2, s, d) for _ in range(3))
            errs[f"2x{s}x{d}{'-causal' if causal else ''}"] = _both_entries(
                f"(2, {s}, {d}) causal={causal}", q, k, v, causal)
    # the wide kernel's and the padded width's negative and zero scales
    for d in (15, 256):
        q, k, v = (rand(2, 200, d) for _ in range(3))
        for scale in (-0.05, 0.0):
            errs[f"2x200x{d}-causal-scale{scale}"] = _both_entries(
                f"(2, 200, {d}) causal scale={scale}", q, k, v, True, scale)
    # JAX's (S, D) signature and (B, H, S, D)
    for shape in ((200, 15), (129, 256), (2, 3, 129, 24), (2, 2, 200, 136)):
        q, k, v = (rand(*shape) for _ in range(3))
        errs["x".join(map(str, shape)) + "-causal"] = _both_entries(
            f"{shape} causal", q, k, v, True)
    # strided (a transposed view) and misaligned (a view 4 bytes into its
    # storage) inputs
    q, k, v = (rand(3, 64, 200).transpose(1, 2) for _ in range(3))
    errs["transposed-3x200x64-causal"] = _both_entries("transposed (3, 200, 64)", q, k, v, True)
    n = 3 * 129 * 40
    q, k, v = (rand(n + 1)[1:].view(3, 129, 40) for _ in range(3))
    if q.data_ptr() % 16 == 0:
        raise AssertionError("misaligned case: the view is aligned")
    errs["misaligned-3x129x40-causal"] = _both_entries("misaligned (3, 129, 40)", q, k, v, True)
    # float64 goes through float32 (the Pallas kernel's cast of each block):
    # the same as the float32 call, widened
    for shape in ((2, 200, 24), (3, 75, 15)):
        q, k, v = (rand(*shape, dtype=torch.float64) for _ in range(3))
        what = f"float64 {shape}"
        errs["float64-" + "x".join(map(str, shape)) + "-causal"] = _both_entries(
            what, q, k, v, True)
        f32 = flash_attention(q.float(), k.float(), v.float(), causal=True).double()
        if not torch.equal(flash_attention(q, k, v, causal=True), f32):
            raise AssertionError(f"{what}: differs from the float32 call widened")
    # int32: the float32 result truncated, as JAX's astype truncates; a
    # truncation may fall either side of an integer where the two float32
    # results differ by rounding, so the plain version's integers are held
    # within 1 and the float32 results at the kernel's bar
    qi, ki, vi = (torch.randint(-3, 4, (2, 129, 16), device="cuda", generator=gen,
                                dtype=torch.int32) for _ in range(3))
    got = flash_attention(qi, ki, vi, causal=True)
    torch.cuda.synchronize()
    f32 = flash_attention(qi.float(), ki.float(), vi.float(), causal=True)
    if got.dtype != torch.int32 or not torch.equal(got, f32.to(torch.int32)):
        raise AssertionError("int32 (2, 129, 16): not the float32 call truncated")
    plain = flash_attention_reference(qi, ki, vi, causal=True)
    if (got - plain).abs().max() > 1:
        raise AssertionError("int32 (2, 129, 16): more than 1 from the plain version")
    errs["int32-2x129x16-causal"] = _check_close(
        "int32 (2, 129, 16) as float32", f32,
        flash_attention_reference(qi.float(), ki.float(), vi.float(), causal=True),
        _ATTN_RTOL, _ATTN_ATOL)
    return errs


def _routes_since(before: dict) -> dict:
    """Kernel launches by route since the counts ``before``."""
    from tensorframes_tpu_torch.ops.flash_attention import flash_attention

    now = flash_attention.launches_by_route
    return {r: n - before[r] for r, n in now.items() if n != before[r]}


def _half_cases(gen, lm_shape) -> dict:
    """bf16 and fp16 loaded by the kernels themselves, against the plain
    version within one unit in their last place; max abs error by case.
    Every case, at every width, must have run both entries on the
    tensor-core kernels (the library's route report)."""
    from tensorframes_tpu_torch.ops.flash_attention import flash_attention

    cases = [  # (shape, causal, scale)
        ((3, 200, 64), False, None), ((3, 200, 64), True, None),
        ((2, 129, 128), False, None), ((2, 129, 128), True, None),
        ((4, 300, 256), False, None), ((4, 300, 256), True, None),
        (lm_shape, True, None),
        # widths the k16 step does not divide (zero-filled box columns), a
        # padded width, ragged lengths against the 128-row tiles, one row
        ((2, 300, 8), True, None), ((2, 200, 24), False, None),
        ((2, 1000, 120), True, None), ((2, 129, 15), True, None), ((1, 1, 8), False, None),
        # scales: the scores are scaled before the row max
        ((3, 200, 64), True, -0.125), ((4, 300, 256), True, -0.125),
        ((2, 200, 24), True, 0.0), ((2, 129, 120), False, -0.05),
        # three and four 64-column boxes a row: a width the k16 step does
        # not divide (136: 9 steps run as 10), ragged lengths, a negative
        # scale
        ((2, 300, 136), False, None), ((2, 300, 136), True, None),
        ((2, 1000, 200), True, None), ((2, 129, 200), False, None),
        ((2, 200, 200), True, -0.125),
        # past 256: two slices over a resident Q tile of 5-8 boxes (264 and
        # 320 with a zero-filled V box in the second slice; 448 with a
        # zero-filled box in its second window of Q K^T), three slices over
        # 9 boxes (520, 576); windows of 4 with Q reloaded past them (640: a
        # zero-filled window tail; 1000: four slices, four windows); negative
        # and zero scales, ragged lengths against the 64- and 32-key tiles
        ((2, 129, 264), False, -0.05), ((2, 200, 264), True, 0.0),
        ((2, 200, 320), True, None), ((2, 129, 384), False, None),
        ((2, 300, 448), True, -0.125), ((2, 300, 512), True, None),
        ((2, 300, 520), True, None), ((2, 129, 576), False, None),
        ((2, 200, 576), True, -0.05), ((2, 129, 640), True, None),
        ((1, 200, 1000), True, None),
    ]
    errs = {}
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float16, "fp16")):
        for shape, causal, scale in cases:
            q, k, v = (torch.randn(*shape, device="cuda", generator=gen).to(dtype)
                       for _ in range(3))
            key = f"{name}-" + "x".join(map(str, shape)) + ("-causal" if causal else "")
            if scale is not None:
                key += f"-scale{scale}"
            before = dict(flash_attention.launches_by_route)
            errs[key] = _both_entries(f"{name} {shape} causal={causal} scale={scale}",
                                      q, k, v, causal, scale)
            if _routes_since(before) != {"tensor_core": 2}:
                raise AssertionError(
                    f"{key}: the two entries launched {_routes_since(before)}, expected "
                    "{'tensor_core': 2}")
    return errs


def _long_sequence(gen, d: int = 8) -> dict:
    """One causal head of 65,535 x 64 + 1 rows: one query tile past the
    65,535 that a grid's y dimension would count. The plain version cannot
    hold S^2 scores, so the first query tile (the lightest, scheduled last),
    the last (one row over every key) and one in the middle are held against
    the plain arithmetic over the keys they see."""
    from tensorframes_tpu_torch.ops.flash_attention import flash_attention

    s = 65535 * 64 + 1
    q, k, v = (torch.randn(1, s, d, device="cuda", generator=gen) for _ in range(3))
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = flash_attention(q, k, v, causal=True)
    end.record()
    end.synchronize()
    scale = 1.0 / math.sqrt(d)
    errs = {}
    for r0 in (0, 32768 * 64, s - 1):
        r1 = min(r0 + 64, s)
        scores = (q[0, r0:r1] @ k[0, :r1].T) * scale
        seen = torch.arange(r1, device="cuda")[None, :] <= torch.arange(r0, r1, device="cuda")[:, None]
        w = torch.softmax(scores.masked_fill(~seen, -math.inf), dim=-1)
        errs[f"rows {r0}-{r1 - 1}"] = _check_close(
            f"S {s} rows {r0}-{r1 - 1}", out[0, r0:r1], w @ v[0, :r1], _ATTN_RTOL, _ATTN_ATOL)
        del scores, seen, w
    return dict(seq=s, head_dim=d, ms=start.elapsed_time(end), max_abs_err_each=errs,
                max_abs_err=max(errs.values()))


def _variant_times(bh: int, s: int, d: int, dtype, gen) -> dict:
    """The kernel, its plain version and SDPA of the same dtype, causal, at
    (bh, s, d): device ms each, the wrapper's back-to-back ms, the route
    the kernel took, and the bound at the peak the dtype could use (for
    the tensor-core kernel also at the operations it does, P V twice for
    the pair). Both entries' outputs on the timed inputs are first held
    against the plain version (`_both_entries`: the one-ulp bar for bf16
    and fp16), and bf16 and fp16 must take the tensor-core route."""
    from tensorframes_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen).to(dtype) for _ in range(3))
    # SDPA on a (1, BH, S, D) view: its fused kernels take 4-D inputs only
    q4, k4, v4 = q[None], k[None], v[None]
    half = dtype in _HALF_RTOL
    peak = _PEAK_HALF_FLOPS if half else _PEAK_F32_FLOPS
    bound_ms, bound_by = _attention_bound(bh, s, d, True, q.element_size(), peak)
    before = dict(flash_attention.launches_by_route)
    what = f"{dtype} ({bh}, {s}, {d}) causal"
    err = _both_entries(what, q, k, v, True)
    (route,) = _routes_since(before)
    if _routes_since(before) != {route: 2} or (half and route != "tensor_core"):
        raise AssertionError(f"{what}: the two entries launched {_routes_since(before)}")
    torch.cuda.empty_cache()
    ms = _device_ms(lambda: flash_attention(q, k, v, causal=True), 20)
    extra = {}
    if route == "tensor_core":
        # the operations the kernel does: Q K^T once, P V twice (the pair)
        extra["bound_pair_ms"] = _attention_bound(bh, s, d, True, q.element_size(), peak,
                                                  products=3)[0]
    return dict(
        shape=[bh, s, d], dtype=str(dtype).replace("torch.", ""), causal=True, route=route,
        max_abs_err=err, ms=ms, **extra,
        wrapper_ms=_time_ms(lambda: flash_attention(q, k, v, causal=True), 20),
        plain_ms=_device_ms(lambda: flash_attention_reference(q, k, v, causal=True), 5),
        library_ms=_device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), 20),
        bound_ms=bound_ms, bound_by=bound_by,
        bound_peak=("989 TFLOP/s bf16/fp16 tensor cores" if half
                    else "67 TFLOP/s float32 CUDA cores"),
        share_of_bound=bound_ms / ms,
    )


def phase_attention_widths(tft, cfg, lm_shape, n_seqs: int, block_seqs: int) -> dict:
    """Phase 21: the kernels at every head width, dtype and layout the
    Pallas kernel takes, against their plain version, bf16 and fp16 at every
    head_dim asserted on the tensor-core kernels; `TransformerLM`
    scoring at head widths 128, 256 and 15 (phase 7's route and widths,
    other head counts) and the ``mesh=`` ring at 15 and 256, their launches
    counted apart from the main path's; times of the variants beside SDPA
    and their bounds. Returns what the kernels line carries."""
    from tensorframes_tpu_torch.ops.flash_attention import flash_attention

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 60)
    flash_attention.launches = 0
    flash_attention.launches_by_route = dict.fromkeys(flash_attention.launches_by_route, 0)
    errs = _width_and_layout_cases(gen)
    half_errs = _half_cases(gen, lm_shape)
    case_launches = flash_attention.launches
    case_routes = dict(flash_attention.launches_by_route)
    long_seq = _long_sequence(gen)
    torch.cuda.empty_cache()

    lms = {}
    for name, over in (("head_dim_128", dict(n_heads=2)), ("head_dim_256", dict(n_heads=1)),
                       ("head_dim_15", dict(d_model=240, n_heads=16))):
        lm_cfg = {**cfg, **over}
        flash_attention.launches = 0
        secs = phase_transformer(tft, lm_cfg, n_seqs, block_seqs, phase=f"transformer_{name}")
        expected = lm_cfg["n_layers"] * (n_seqs // block_seqs)
        if flash_attention.launches != expected:
            raise AssertionError(
                f"TransformerLM {name}: {flash_attention.launches} kernel launches, "
                f"expected n_layers x blocks = {expected}")
        lms[name] = dict(config=lm_cfg, launches=flash_attention.launches, seconds=secs,
                         tokens_per_s=n_seqs * lm_cfg["max_seq"] / secs)
        torch.cuda.empty_cache()
    rings = {}
    for name, over in (("head_dim_15", dict(d_model=240, n_heads=16)),
                       ("head_dim_256", dict(n_heads=1))):
        rings[name] = _ring_scoring({**cfg, **over}, cards=1)
        torch.cuda.empty_cache()

    times = {
        # the main path's shape again, beside SDPA on 4-D inputs
        "f32-lm": _variant_times(*lm_shape, torch.float32, gen),
        "f32-16x2048x128": _variant_times(16, 2048, 128, torch.float32, gen),
        # the wide kernel: one slice at D 136 and at D 256, two at D 512
        "f32-16x2048x136": _variant_times(16, 2048, 136, torch.float32, gen),
        "f32-16x2048x256": _variant_times(16, 2048, 256, torch.float32, gen),
        "f32-16x2048x512": _variant_times(16, 2048, 512, torch.float32, gen),
        "bf16-lm": _variant_times(*lm_shape, torch.bfloat16, gen),
        "fp16-lm": _variant_times(*lm_shape, torch.float16, gen),
        # the tensor-core kernel at two, three and four boxes a row
        "bf16-16x2048x128": _variant_times(16, 2048, 128, torch.bfloat16, gen),
        "fp16-16x2048x128": _variant_times(16, 2048, 128, torch.float16, gen),
        "bf16-16x2048x136": _variant_times(16, 2048, 136, torch.bfloat16, gen),
        "fp16-16x2048x136": _variant_times(16, 2048, 136, torch.float16, gen),
        "bf16-16x2048x256": _variant_times(16, 2048, 256, torch.bfloat16, gen),
        "fp16-16x2048x256": _variant_times(16, 2048, 256, torch.float16, gen),
        # half precision past 256 on the tensor cores, over a resident Q
        # tile: two slices (264, a width not a multiple of 64; 384, 512),
        # three (576, the width of DeepSeek-V2/V3's absorbed MLA heads)
        "bf16-16x2048x264": _variant_times(16, 2048, 264, torch.bfloat16, gen),
        "fp16-16x2048x264": _variant_times(16, 2048, 264, torch.float16, gen),
        "bf16-16x2048x384": _variant_times(16, 2048, 384, torch.bfloat16, gen),
        "fp16-16x2048x384": _variant_times(16, 2048, 384, torch.float16, gen),
        "bf16-16x2048x512": _variant_times(16, 2048, 512, torch.bfloat16, gen),
        "fp16-16x2048x512": _variant_times(16, 2048, 512, torch.float16, gen),
        "bf16-16x2048x576": _variant_times(16, 2048, 576, torch.bfloat16, gen),
        "fp16-16x2048x576": _variant_times(16, 2048, 576, torch.float16, gen),
    }
    out = dict(
        card=_CARD, max_abs_err_each={**errs, **half_errs},
        max_abs_err=max(errs.values()), half_max_abs_err=max(half_errs.values()),
        tolerance={"float32": {"rtol": _ATTN_RTOL, "atol": _ATTN_ATOL},
                   "bf16": {"rtol": _HALF_RTOL[torch.bfloat16], "atol": _HALF_ATOL},
                   "fp16": {"rtol": _HALF_RTOL[torch.float16], "atol": _HALF_ATOL},
                   "int32": "float32 results at the float32 bar; integers within 1"},
        case_launches=case_launches, case_launches_by_route=case_routes,
        long_sequence=long_seq, lm_scoring=lms,
        ring_scoring=rings, times=times, seconds=time.perf_counter() - t0,
    )
    _emit("attention_widths", **out)
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch.ops.flash_attention import flash_attention
    from tensorframes_tpu_torch.ops.factorize_keys import factorize as factorize_keys
    from tensorframes_tpu_torch.ops.keyed_sums import keyed_sums

    # widths of benchmarks/train_bench.py, max_seq of examples/long_context.py
    cfg = dict(vocab=256, d_model=256, n_heads=4, n_layers=4, max_seq=2048)
    n_seqs, block_seqs = 64, 8
    lm_shape = (block_seqs * cfg["n_heads"], cfg["max_seq"], cfg["d_model"] // cfg["n_heads"])

    phase_card_and_build()
    if argv == ["--phase", "21"]:
        # phase 21 alone, after the build: no main path, no result line
        phase_attention_widths(tft, cfg, lm_shape, n_seqs, block_seqs)
        return 0
    if argv:
        print(f"chip_smoke.py: unknown arguments {argv} (none, or --phase 21)", file=sys.stderr)
        return 2
    attn = phase_kernel_vs_plain(lm_shape)
    # phases 3-17 and 7 measure one card, as their checks and numbers
    # assume; phase 18 places its blocks itself (devices=, "on", "global")
    tft.config.update(block_scheduler="off")

    # the main path: every launch counter starts at 0 here
    flash_attention.launches = 0
    flash_attention.launches_by_route = dict.fromkeys(flash_attention.launches_by_route, 0)
    keyed_sums.launches = 0
    factorize_keys.launches = dict.fromkeys(factorize_keys.launches, 0)
    verbs_df = phase_graph_verbs(tft)
    phase_map_rows_mlp(tft)
    sums, factorize = phase_aggregate(tft)
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
    scoring_s = phase_transformer(tft, cfg, n_seqs, block_seqs)
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
    # phase 21 counts its launches apart, from 0 before each part
    widths = phase_attention_widths(tft, cfg, lm_shape, n_seqs, block_seqs)
    lse = par["lse_entry"]
    lm_times = lse["times"]["x".join(map(str, lm_shape)) + "-causal"]
    # every launch of the main path is in the scoring call: the kernel's
    # event time x its launches over that call's wall time
    _emit(
        "attention_share_of_lm_scoring", kernel_ms=attn["ms"], launches=launches,
        scoring_s=scoring_s, share=attn["ms"] * launches / (scoring_s * 1e3),
    )

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
        **attn,
        "lse_ms": min(lm_times["lse_ms"]),
        "lse_max_abs_err": lse["max_abs_err"],
        "ring_launches": par["ring_scoring"]["ring_launches"],
        # phase 21: every width, dtype and layout, counted apart
        "widths_max_abs_err": widths["max_abs_err"],
        "half_max_abs_err": widths["half_max_abs_err"],
        "widths_case_launches": widths["case_launches"],
        "widths_case_launches_by_route": widths["case_launches_by_route"],
        "lm_launches_by_head_dim": {k: r["launches"] for k, r in widths["lm_scoring"].items()},
        "ring_launches_by_head_dim": {
            k: r["ring_launches"] for k, r in widths["ring_scoring"].items()},
        "variants": {k: {n: t[n] for n in ("route", "max_abs_err", "ms", "wrapper_ms", "plain_ms",
                                            "library_ms", "bound_ms", "bound_pair_ms", "bound_by",
                                            "bound_peak")
                         if n in t}
                     for k, t in widths["times"].items()},
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
        **factorize,
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
