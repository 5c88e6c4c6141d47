#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`tensorframes_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, then drives the port's
main path through the entry points a user calls:

1. the card's name and power limit, and the kernel build;
2. the flash-attention kernel against `flash_attention_reference` at the
   shapes of `tests/test_pallas.py` and at the LM's shape, with times;
3. the graph verbs at `bench.py`'s data size: `map_blocks` of x+3 and
   `reduce_blocks` sum / min over 200,000,000 float32 rows in 8 blocks;
4. `map_rows` of the 512-512-512-10 MLP scoring graph over 1,000,000 rows;
5. `TransformerLM` scoring through `map_blocks` with a plain function;
6. one JSON line listing every kernel with its launches on the main path
   (phases 3-5), its error and its times;
7. as the last line, ``{"ok": true, "device": {...}}``.

Every check raises on failure, so the script exits non-zero and prints no
result line. Without a CUDA device it exits non-zero at once. It imports
nothing of JAX.
"""

from __future__ import annotations

import json
import math
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


def _attention_bound(bh: int, s: int, d: int, causal: bool):
    """(bound_ms, bound_by) of attention over (bh, s, d) float32: the two
    products Q K^T and P V at 2 operations per multiply-add over the pairs
    the mask keeps, against q, k, v read once and o written once."""
    pairs = s * (s + 1) // 2 if causal else s * s
    t_ops = 4 * d * pairs * bh / _PEAK_F32_FLOPS
    t_bytes = 4 * bh * s * d * 4 / _PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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
    # ptxas's resource line for the head_dim-64 instantiation the LM runs
    log = _cuda_build.build_logs.get("flash_attention", "")
    m = re.search(r"ILi64E.*?(Used [^\n]*)", log, re.S)
    _emit(
        "build", libraries=sorted(libs), seconds=seconds,
        ptxas_d64=m.group(1) if m else None,
    )


def phase_kernel_vs_plain(lm_shape):
    from tensorframes_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = [  # (bh, seq, d, causal)
        (1, 64, 16, False), (1, 128, 8, False), (1, 256, 32, False),
        (1, 128, 16, True), (1, 100, 8, False), (1, 75, 8, True),
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

    # times at the LM's shape (q, k, v of the last case)
    ms = _time_ms(lambda: flash_attention(q, k, v, causal=True), 20)
    plain_ms = _time_ms(lambda: flash_attention_reference(q, k, v, causal=True), 10)
    library_ms = _time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True),
        20,
    )
    bound_ms, bound_by = _attention_bound(*lm_shape, True)
    result = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
    )
    _emit(
        "flash_attention_vs_plain",
        shapes=[list(s) for s in shapes], max_abs_err_each=errs,
        tolerance={"rtol": _ATTN_RTOL, "atol": _ATTN_ATOL}, **result,
    )
    return result


def phase_graph_verbs(tft) -> None:
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


def phase_map_rows_mlp(tft) -> None:
    from tensorframes_tpu_torch import dsl

    rows, sizes = 1_000_000, [512, 512, 512, 10]
    rng = np.random.default_rng(SEED)
    params = [
        (
            (rng.standard_normal((a, b)) * math.sqrt(2.0 / a)).astype(np.float32),
            (rng.standard_normal(b) * 0.1).astype(np.float32),
        )
        for a, b in zip(sizes[:-1], sizes[1:])
    ]
    # the per-row scoring graph of BASELINE config 3 (models/mlp.py's shape)
    h = x = dsl.placeholder(tft.ScalarType.float32, tft.Shape((sizes[0],)), name="features")
    for i, (w, b) in enumerate(params):
        h = dsl.matmul(dsl.reshape(h, [1, -1]) if i == 0 else h, dsl.constant(w, name=f"w{i}"))
        h = dsl._nary("BiasAdd", [h, dsl.constant(b, name=f"b{i}")])
        if i < len(params) - 1:
            h = dsl.relu(h)
    probs = dsl.softmax(dsl.reshape(h, [sizes[-1]])).named("probs")
    del x

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    feats = torch.rand(rows, sizes[0], device="cuda", generator=gen)
    df = tft.TensorFrame([tft.Column("features", feats)])
    tft.map_rows(probs, df)  # lowers once
    out, secs = _wall(lambda: tft.map_rows(probs, df))
    got = out.column("probs").values
    if tuple(got.shape) != (rows, sizes[-1]) or not torch.isfinite(got).all():
        raise AssertionError(f"map_rows MLP: bad output {tuple(got.shape)}")

    idx = np.concatenate([np.arange(1000), np.arange(rows - 1000, rows)])
    a = feats[torch.from_numpy(idx).cuda()].cpu().numpy().astype(np.float64)
    for i, (w, b) in enumerate(params):
        a = a @ w.astype(np.float64) + b
        if i < len(params) - 1:
            a = np.maximum(a, 0.0)
    a = np.exp(a - a.max(axis=1, keepdims=True))
    want = torch.from_numpy((a / a.sum(axis=1, keepdims=True)).astype(np.float32))
    err = _check_close(
        "map_rows MLP", got[torch.from_numpy(idx).cuda()].cpu(), want, _MLP_RTOL, _MLP_ATOL
    )
    _emit(
        "map_rows_mlp", rows=rows, sizes=sizes, seconds=secs, rows_per_s=rows / secs,
        checked_rows=len(idx), max_abs_err=err,
        tolerance={"rtol": _MLP_RTOL, "atol": _MLP_ATOL},
    )


def phase_transformer(tft, cfg, n_seqs: int, block_seqs: int) -> None:
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
    phase_graph_verbs(tft)
    phase_map_rows_mlp(tft)
    phase_transformer(tft, cfg, n_seqs, block_seqs)
    launches = flash_attention.launches
    expected = cfg["n_layers"] * (n_seqs // block_seqs)
    if launches != expected:
        raise AssertionError(
            f"flash_attention launched {launches} times on the main path, "
            f"expected n_layers x blocks = {expected}"
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
