"""PyTorch port: the arithmetic of the tensor-core attention kernels
(`tensorframes_tpu_torch/csrc/flash_attention_tc.cuh`, bf16 and fp16 at
every head width), emulated in plain PyTorch on the CPU and held to the
Pallas kernel.

The kernels cannot run here, so `_tc_emulation` below repeats what they
compute, step by step: 64-key tiles (128 at padded head widths 72-128, 64
again past 128, where the output alone takes 96 or 128 registers a thread,
32 past 576, where shared memory holds no more) with the online rescale
between them; past 256 the scores are summed over the 64-column boxes of
the padded depth in order (a block computes them for its slice of output
columns, the same scores in every slice, so the slices split only which
columns P V writes); the row max of the float32 scores scaled by
``scale * log2(e)`` (taken over the raw scores and scaled once, which is
the same number); causal and ragged keys left out, their P 0; ``exp2`` of
``s * scale * log2(e) - m`` rounded once (the kernel's FFMA); the row sum
from the float32 P; P split into a pair of the input dtype, ``P_lo =
T(P - P_hi)`` with ``P_hi = T(P)`` for fp16 and P cut to its top 16 bits
for bf16, each multiplied by V with float32 sums (the tensor cores'
products of two 2-byte values are exact in float32); the output times the
reciprocal of the guarded denominator, rounded once; the log-sum-exp
``m ln 2 + ln l``. The emulation stays in this file: the
package's plain version is `flash_attention_reference`, which keeps P in
float32.

What the tests show. The pair meets the bar that
`tests/test_torch_flash_attention_card.py` holds the kernel to on the card, one unit in the last
place of the output (rtol 2^-7 for bf16, 2^-10 for fp16, atol 1e-5; the
log-sum-exp rtol 1e-4, atol 1e-5), against the Pallas kernel in interpret
mode on the same bf16 / fp16 inputs and against the plain version, causal
and not, at a ragged length and at head widths 8, 24, 64, 120, 136, 200
and 256 (one to four 64-column boxes a row) and past it, 264, 320, 512,
520 and 576 (two or three slices, a resident Q tile or windows). One
rounding of P misses that bar in both dtypes, which is why the kernel
carries the pair. Before the output's rounding the pair stays within 2^-16
of the output's magnitude from float32 P (fp16's P_lo falls into fp16's
subnormal range without mattering).
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorframes_tpu.ops.pallas_kernels import flash_attention as pallas_flash
from tensorframes_tpu_torch.ops import flash_attention as fa

_HALF_RTOL = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}
_HALF_ATOL = 1e-5
_LSE_RTOL, _LSE_ATOL = 1e-4, 1e-5
_JNP = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}
_DTYPES = pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
_NEG_INF = -1e30
_LOG2E = np.float32(1.4426950408889634)
_LN2 = np.float32(0.6931471805599453)
_BOX = 64  # columns of a TMA box (kTcBox)
_TC_SLICE_D = 256  # widest padded head one block computes whole (kTcSliceD)


def _bf16_top_bits(p):
    """float32 P cut to its top 16 bits: the bf16 value the kernel's
    byte permute keeps, in float32."""
    return (p.view(torch.int32) & -65536).view(torch.float32)


def _tc_emulation(q, k, v, causal, scale=None, p_rounding="pair"):
    """The kernel's arithmetic on ``(BH, S, D)`` bf16 / fp16 tensors:
    (output in q's dtype, log-sum-exp, output before its rounding).
    ``p_rounding``: "pair" (the kernel), "single" (P rounded once to the
    dtype) or "float32" (P kept in float32, the Pallas kernel's)."""
    dtype = q.dtype
    bh, seq, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    d8 = -(-d // 8) * 8
    # keys a tile (TcShape::kKeys; past 256 the BK of launch_tc_wide's case)
    block_k = 128 if 64 < d8 <= 128 else 64 if d8 <= _TC_SLICE_D else _wide_plan(d)[3]
    sc = torch.tensor(np.float32(scale) * _LOG2E)  # scale * log2(e) in float32
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((bh, seq), _NEG_INF)
    l = torch.zeros(bh, seq)
    acc = torch.zeros(bh, seq, d)
    rows = torch.arange(seq)
    for k0 in range(0, seq, block_k):
        kt, vt = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        if d8 <= _TC_SLICE_D:
            raw = torch.matmul(qf, kt.transpose(1, 2))
        else:  # box by box, in order, into one float32 sum
            raw = torch.zeros(bh, seq, kt.shape[1])
            for c0 in range(0, d, _BOX):
                box = slice(c0, c0 + _BOX)
                raw = raw + torch.matmul(qf[..., box], kt[..., box].transpose(1, 2))
        keys = torch.arange(k0, k0 + kt.shape[1])
        masked = keys[None, :] > rows[:, None] if causal else torch.zeros(
            seq, kt.shape[1], dtype=torch.bool)
        x = torch.where(masked, torch.tensor(_NEG_INF), raw * sc)
        m_new = torch.maximum(m, x.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        # raw * sc - m rounded once, as the kernel's FFMA
        arg = (raw.double() * sc.double() - m_new.double()[..., None]).float()
        p = torch.where(masked, torch.tensor(0.0), torch.exp2(arg))
        l = l * alpha + p.sum(dim=-1)
        if p_rounding == "pair":
            hi = _bf16_top_bits(p) if dtype == torch.bfloat16 else p.to(dtype).float()
            lo = (p - hi).to(dtype).float()
            pv = torch.matmul(hi, vt) + torch.matmul(lo, vt)
        elif p_rounding == "single":
            pv = torch.matmul(p.to(dtype).float(), vt)
        else:
            pv = torch.matmul(p, vt)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc * (1.0 / torch.where(l == 0, torch.ones_like(l), l))[..., None]
    lse = torch.where(l == 0, torch.tensor(-math.inf), m * _LN2 + torch.log(l))
    return out.to(dtype), lse, out


def _inputs(shape, seed, dtype):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype) for _ in range(3)]


def _pallas(q, k, v, causal, dtype):
    """JAX's kernel in interpret mode, head by head, on the same bf16 /
    fp16 values (float64 numpy out)."""
    heads = []
    for i in range(q.shape[0]):
        qj, kj, vj = (jnp.asarray(t[i].float().numpy()).astype(_JNP[dtype]) for t in (q, k, v))
        out = pallas_flash(qj, kj, vj, causal=causal, block_q=64, block_k=64, interpret=True)
        assert out.dtype == _JNP[dtype]
        heads.append(np.asarray(out.astype(jnp.float32), dtype=np.float64))
    return np.stack(heads)


def _violations(got, want, dtype) -> int:
    """Elements outside the one-ulp bar of ``dtype``."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return int((np.abs(got - want) > _HALF_ATOL + _HALF_RTOL[dtype] * np.abs(want)).sum())


@_DTYPES
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [8, 24, 64, 120, 136, 200, 256, 264, 320, 512, 520, 576])
def test_pair_meets_the_bar_against_pallas_and_the_plain_version(dtype, causal, d):
    """S 300: five 64-key tiles (three of 128 at D 120), the last ragged, so
    the online rescale and the ragged mask both run; 136 and 200 are widths
    the k16 step does not divide (the box's zero columns), 264 and 520
    widths the box does not divide."""
    q, k, v = _inputs((2, 300, d), seed=d + 17 * causal, dtype=dtype)
    out, lse, _ = _tc_emulation(q, k, v, causal)
    assert out.dtype == dtype and out.shape == q.shape
    got = out.double().numpy()
    assert _violations(got, _pallas(q, k, v, causal, dtype), dtype) == 0
    ref, ref_lse = fa.flash_attention_lse_reference(q, k, v, causal=causal)
    assert torch.equal(ref, fa.flash_attention_reference(q, k, v, causal=causal))
    assert _violations(got, ref.double().numpy(), dtype) == 0
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), rtol=_LSE_RTOL, atol=_LSE_ATOL)


@_DTYPES
@pytest.mark.parametrize("scale", [-0.125, 0.0])
def test_negative_and_zero_scale(dtype, scale):
    """The row max is of the scaled scores: for a negative scale the raw
    scores' min scaled, for a zero scale 0, which makes P uniform."""
    q, k, v = _inputs((2, 200, 24), seed=5, dtype=dtype)
    out, lse, _ = _tc_emulation(q, k, v, True, scale=scale)
    ref, ref_lse = fa.flash_attention_lse_reference(q, k, v, causal=True, scale=scale)
    assert _violations(out.double().numpy(), ref.double().numpy(), dtype) == 0
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), rtol=_LSE_RTOL, atol=_LSE_ATOL)


@_DTYPES
def test_single_rounding_of_p_misses_the_bar(dtype):
    """The evidence for the pair: at S 1024 (one head's softmax over ~380
    keys' worth of weight) one rounding of P to the dtype moves outputs near
    0 by more than atol, in thousands of places; the pair on the same
    inputs holds the bar everywhere."""
    q, k, v = _inputs((2, 1024, 64), seed=3, dtype=dtype)
    ref = fa.flash_attention_reference(q, k, v).double().numpy()
    single, _, _ = _tc_emulation(q, k, v, False, p_rounding="single")
    pair, _, _ = _tc_emulation(q, k, v, False)
    assert _violations(single.double().numpy(), ref, dtype) > 1000
    assert _violations(pair.double().numpy(), ref, dtype) == 0


@_DTYPES
@pytest.mark.parametrize("shape,causal", [((4, 2048, 64), True), ((2, 1024, 64), False)],
                         ids=["lm-causal", "full"])
def test_pair_is_float32_p_before_the_output_rounding(dtype, shape, causal):
    """P_hi + P_lo holds P to 2^-16 of itself (bf16, P_hi cut) or 2^-22
    (fp16), so before the output's rounding the pair's result stays within
    2^-16 of the largest output of the float32-P result (the bar's unit is
    2^-8 or 2^-11 of an output). fp16's P_lo falls below fp16's normal range
    for P < 2^-3 and keeps an absolute error under 2^-25 there, which the
    row's denominator only divides: it does not show."""
    q, k, v = _inputs(shape, seed=0, dtype=dtype)
    _, _, pair = _tc_emulation(q, k, v, causal)
    _, _, f32 = _tc_emulation(q, k, v, causal, p_rounding="float32")
    assert float((pair - f32).abs().max()) <= 2.0**-16 * float(f32.abs().max())


def _wide_table() -> dict:
    """``launch_tc_wide``'s switch in `csrc/flash_attention_tc.cuh`, read
    from the source the card builds: {boxes a row (None for the default):
    (W boxes a Q K^T window, NWR windows of a resident Q tile or 0 for Q
    reloaded with each window, NV output boxes a slice, BK keys a tile)}."""
    src = (Path(fa.__file__).parents[1] / "csrc" / "flash_attention_tc.cuh").read_text()
    body = src[src.index("cudaError_t launch_tc_wide("):]
    body = body[:body.index("#undef TFS_TC_WIDE_CASE")]
    table, cases = {}, []
    for m in re.finditer(r"case (\d+):|default:|TFS_TC_WIDE_CASE\((\d+), (\d+), (\d+), (\d+)\)",
                         body):
        if m.group(2) is None:
            cases.append(int(m.group(1)) if m.group(1) else None)
        else:
            table.update(dict.fromkeys(cases, tuple(int(g) for g in m.groups()[1:])))
            cases = []
    assert None in table and not cases
    return table


def _wide_plan(d: int):
    """The tensor-core kernels' plan past 256, from ``launch_tc_wide``'s
    table: (slices, output boxes a slice, Q K^T windows of boxes a key
    tile, keys a tile, resident windows or 0). Slices are ceil(D8 / 256),
    as ``launch_tc_wide_shape`` counts them; a window past the last box
    reads zero-filled boxes."""
    boxes = -(-(-(-d // 8) * 8) // _BOX)
    table = _wide_table()
    w, nwr, nv, bk = table.get(boxes, table[None])
    slices = -(-(-(-d // 8) * 8) // _TC_SLICE_D)
    windows = [list(range(b0, b0 + w)) for b0 in range(0, boxes, w)]
    return slices, nv, windows, bk, nwr


@pytest.mark.parametrize("d", [264, 512, 520, 1024])
def test_slices_and_windows_cover_every_box_and_column_once(d):
    """The plan of the tensor-core kernels past 256, as ``launch_tc_wide``
    in the header sets it: the slices' output boxes are every box of the
    padded row once, each slice 3 or 4 boxes (the P V widths instantiated)
    and every slice holding a column before d; each key tile's Q K^T
    windows are every box once, in order, and a resident Q tile holds
    them all; the output columns the slices store (the box's columns
    before d) are every column once; and the wrapper counts slices x BH x
    128-row tiles."""
    d8 = -(-d // 8) * 8
    boxes = -(-d8 // _BOX)
    slices, nv, windows, bk, nwr = _wide_plan(d)
    assert nv in (3, 4) and bk in (32, 64)
    owned = [s * nv + b for s in range(slices) for b in range(nv)]
    assert owned[:boxes] == list(range(boxes)) and len(owned) - boxes < nv
    assert all(s * nv * _BOX < d for s in range(slices))
    depth = [b for window in windows for b in window]
    assert depth[:boxes] == list(range(boxes)) and all(b >= boxes for b in depth[boxes:])
    assert nwr in (0, len(windows))
    assert len(windows) == 1 or len(windows[0]) in (3, 4)
    stored = [c for s in range(slices) for c in range(s * nv * _BOX, (s + 1) * nv * _BOX)
              if c < d8]
    assert stored == list(range(d8))
    for dtype in (torch.bfloat16, torch.float16):
        assert fa._kernel_blocks(dtype, 3, 300, d8) == slices * 3 * -(-300 // 128)


class TestWrapperRoute:
    @pytest.mark.parametrize(
        "dtype,shape,refused",
        [
            (torch.float32, (2**25, 4097, 8), True),    # 65 tiles of 64 rows a head
            (torch.bfloat16, (2**25, 4097, 8), False),  # 33 tiles of 128 rows
            (torch.float16, (2**25, 8193, 8), True),    # 65 tiles of 128 rows
            (torch.bfloat16, (2**24, 4097, 136), False),  # 33 tiles of 128 rows
            (torch.float32, (2**24, 4097, 136), False),  # wide: 1 slice x 65 tiles of 64
            (torch.float32, (2**24, 4097, 264), True),  # wide: 2 slices x 65 tiles of 64
            (torch.bfloat16, (2**24, 4097, 264), False),  # 2 slices x 33 tiles of 128
            (torch.float16, (2**22, 16385, 576), False),  # 3 slices x 129 tiles of 128
            (torch.bfloat16, (2**23, 16385, 576), True),  # 3 slices x 129 tiles of 128
        ],
        ids=["f32-64-row-tiles", "bf16-128-row-tiles", "fp16-past-the-limit", "bf16-wide",
             "f32-wide-one-slice", "f32-wide-two-slices", "bf16-past-256", "fp16-past-512",
             "bf16-past-512-past-the-limit"],
    )
    def test_block_count_follows_the_kernels_query_tile(self, dtype, shape, refused):
        """The grid-limit check counts the blocks of the kernel the library
        will pick: 128-row query tiles for bf16 / fp16, in ceil(D8 / 256)
        slices of output columns past 256 (the tensor-core kernels), 64 rows
        for float32 up to 128, 64 rows in slices of 256 output columns for
        the float32 wide kernel. Meta tensors allocate nothing."""
        q = torch.empty(*shape, dtype=dtype, device="meta")
        if refused:
            with pytest.raises(ValueError, match="thread blocks"):
                fa._kernel_layout(q, q, q, None)
        else:
            q3 = fa._kernel_layout(q, q, q, None)[0]
            assert q3.dtype == dtype and q3.shape == shape

    def test_routes_are_counted_apart_and_cpu_calls_count_none(self):
        assert set(fa.flash_attention.launches_by_route) == {"cuda_core", "wide", "tensor_core"}
        before = dict(fa.flash_attention.launches_by_route)
        q, k, v = _inputs((2, 40, 16), seed=1, dtype=torch.bfloat16)
        fa.flash_attention(q, k, v, causal=True)
        fa.flash_attention_lse(q, k, v, causal=True)
        assert fa.flash_attention.launches_by_route == before
