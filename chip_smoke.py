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
   size through the exact plan;
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
   `map_blocks`, with the host syncs counted;
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
13. one JSON line listing every kernel with its launches on the main path
    (phases 3-12), its error and its times;
14. as the last line, ``{"ok": true, "device": {...}}``.

Phases 8-12 run after phase 6 and before phase 7. Phases 3-6 and 8-12 run
no hand-written kernel (their ops are ATen, cuBLAS and cuDNN calls and the
stream's copies), so the script checks that the attention kernel's count
is still 0 after them and counts its launches in phase 7 alone. The script
never imports pandas; phase 12 alone imports pyarrow, for its dataset and
durable parts, and prints them as skipped where pyarrow is missing. The
port factorizes string keys with pandas where pandas imports, and in one
dict pass where it does not; phase 11 times both.

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


def _wall(fn):
    """(result, seconds) of ``fn()`` ending in a device synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _plan_ran(what: str, key: str) -> None:
    """Raise unless the verb call since the last `reset_stats` took exactly
    the plan ``key`` (the port's plan counters)."""
    from tensorframes_tpu_torch.utils.profiling import stats

    if stats() != {key: 1.0}:
        raise AssertionError(f"{what}: expected plan {key}, counters say {stats()}")


def _attention_bound(bh: int, s: int, d: int, causal: bool):
    """(bound_ms, bound_by) of attention over (bh, s, d) float32: the two
    products Q K^T and P V at 2 operations per multiply-add over the pairs
    the mask keeps, against q, k, v read once and o written once."""
    pairs = s * (s + 1) // 2 if causal else s * s
    t_ops = 4 * d * pairs * bh / _PEAK_F32_FLOPS
    t_bytes = 4 * bh * s * d * 4 / _PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _ptxas_line(log: str, d: int):
    """ptxas's resource and spill lines for the head_dim-``d`` attention
    kernel, from the build log, or None for a cached build."""
    m = re.search(
        rf"Compiling entry function '[^']*flash_attention_f32_kernelILi{d}E.*?"
        r"(\d+ bytes stack frame, \d+ bytes spill stores, \d+ bytes spill loads)"
        r".*?(Used [^\n]*)",
        log, re.S,
    )
    return f"{m.group(2)}; {m.group(1)}" if m else None


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_card_and_build() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)

    from tensorframes_tpu_torch.ops import _cuda_build

    t0 = time.perf_counter()
    libs = _cuda_build.build_all()
    seconds = time.perf_counter() - t0
    # ptxas's registers and spills for the head_dim-64 kernel the LM runs
    # and the widest, head_dim 128
    log = _cuda_build.build_logs.get("flash_attention", "")
    _emit(
        "build", libraries=sorted(libs), seconds=seconds,
        ptxas_d64=_ptxas_line(log, 64), ptxas_d128=_ptxas_line(log, 128),
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
    library_ms = _time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True),
        20,
    )
    bound_ms, bound_by = _attention_bound(*lm_shape, True)
    result = dict(
        max_abs_err=max(errs + scale_errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
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
                    exact_rows: int = 1_000_000, exact_keys: int = 1000) -> None:
    """BASELINE config 4 through the segment plan, then a graph the
    segment plan refuses (its root is a Div) through the exact plan."""
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
    first, first_s = _wall(lambda: tft.aggregate([m, q], grouped, feed_dict=feed))
    del first
    reset_stats()
    out, seg_s = _wall(lambda: tft.aggregate([m, q], grouped, feed_dict=feed))
    _plan_ran("aggregate mean/variance", "aggregate.plan.segment")
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
    del vsq

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
    _plan_ran("aggregate Sum/Max", "aggregate.plan.exact")
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
    _emit(
        "control_flow", rows=rows, blocks=blocks, map_rows=result,
        block_level=dict(
            seconds=block_s, rows_per_s=rows / block_s,
            cond_host_syncs=counts.get("control.cond.host_syncs"),
            while_trips=counts.get("control.while.trips"),
            while_host_syncs=counts.get("control.while.host_syncs"),
        ),
    )


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
    _plan_ran("string-keyed aggregate", "aggregate.plan.segment")
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


def phase_transformer(tft, cfg, n_seqs: int, block_seqs: int) -> float:
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
        "transformer_map_blocks", config=cfg, sequences=n_seqs, block_sequences=block_seqs,
        seconds=secs, tokens_per_s=n_seqs * seq / secs, max_abs_err=err,
        tolerance={"rtol": _LOGIT_RTOL, "atol": _LOGIT_ATOL},
    )
    return secs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch.ops.flash_attention import flash_attention

    # widths of benchmarks/train_bench.py, max_seq of examples/long_context.py
    cfg = dict(vocab=256, d_model=256, n_heads=4, n_layers=4, max_seq=2048)
    n_seqs, block_seqs = 64, 8
    lm_shape = (block_seqs * cfg["n_heads"], cfg["max_seq"], cfg["d_model"] // cfg["n_heads"])

    phase_card_and_build()
    attn = phase_kernel_vs_plain(lm_shape)

    # the main path: every launch counter starts at 0 here
    flash_attention.launches = 0
    verbs_df = phase_graph_verbs(tft)
    phase_map_rows_mlp(tft)
    phase_aggregate(tft)
    phase_kmeans(tft)
    phase_inception(tft)
    phase_control_flow(tft)
    phase_freezing(tft, verbs_df)
    del verbs_df
    phase_frame_breadth(tft)
    phase_streaming(tft)
    if flash_attention.launches:
        raise AssertionError(
            f"the verb, aggregate, k-means, Inception, control-flow, freezing, "
            f"frame-breadth and streaming phases launched flash_attention "
            f"{flash_attention.launches} times; none of their graphs holds attention"
        )
    scoring_s = phase_transformer(tft, cfg, n_seqs, block_seqs)
    launches = flash_attention.launches
    expected = cfg["n_layers"] * (n_seqs // block_seqs)
    if launches != expected:
        raise AssertionError(
            f"flash_attention launched {launches} times on the main path, "
            f"expected n_layers x blocks = {expected}"
        )
    # every launch of the main path is in the scoring call: the kernel's
    # event time x its launches over that call's wall time
    _emit(
        "attention_share_of_lm_scoring", kernel_ms=attn["ms"], launches=launches,
        scoring_s=scoring_s, share=attn["ms"] * launches / (scoring_s * 1e3),
    )

    print(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "tensorframes_tpu_torch/csrc/flash_attention.cu",
        "replaces": "tensorframes_tpu/ops/pallas_kernels.py:122",
        "launches": launches,
        **attn,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
