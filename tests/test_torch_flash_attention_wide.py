"""PyTorch port: the arithmetic of the wide attention kernel
(`flash_attention_wide_kernel` in `tensorframes_tpu_torch/csrc/
flash_attention.cuh`: float32 heads wider than 128), emulated in plain
PyTorch on the CPU and held to the Pallas kernel.

The kernel cannot run here, so `_wide_emulation` repeats its order of
operations: a block takes 64 query rows and a slice of 256 output columns,
and computes each 64-key tile's scores once for the whole slice. Its two
groups of 128 threads sum the scores over alternate column chunks of 128
bytes (32 float32 columns; group g over chunks 1 - g,
3 - g, ...: group 1 takes the extra chunk of an odd count, since its
output columns are the fewer in the last slice), then each adds the
other's partial sums; a sum of two floats does not depend on their order,
so both groups hold the same scores and run the same online softmax, which
is how their row statistics merge. The softmax keeps the Pallas kernel's
float32 arithmetic: scores masked to -1e30 (ragged keys; keys after the query when
causal), negated for a negative scale, the row max in unscaled units,
``exp2(s * sc - m * sc)`` with ``sc = |scale| log2(e)`` in one FFMA, the
rescale by ``exp2((m_old - m_new) sc)``, P V accumulated in float32, the
denominator guarded to 1, the output rounded once to q's dtype, the
log-sum-exp ``m |scale| + ln(l)``. Within a chunk the kernel sums its FFMAs in
column order; the emulation's float32 products (`torch.matmul`) sum in
theirs, which moves a score by a few float32 units.

What the tests show: the emulation meets the bars
`tests/test_torch_flash_attention_card.py` holds the kernel to on the card (rtol 1e-4, atol 1e-5;
the log-sum-exp too) against the Pallas kernel in interpret mode and
against the plain version `flash_attention_reference`, at head widths 136,
200, 256 and 512 (one or two slices; widths the chunk does not divide),
causal and not, at a ragged length. bf16 and fp16 heads take the
tensor-core kernels at every width (`test_torch_flash_attention_tc.py`).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorframes_tpu.ops.pallas_kernels import flash_attention as pallas_flash
from tensorframes_tpu_torch.ops import flash_attention as fa

_RTOL, _ATOL = 1e-4, 1e-5
_NEG_INF = np.float32(-1e30)
_LOG2E = np.float32(1.4426950408889634)
_ROWS = _KEYS = 64  # kBlockQ, kBlockK
_SLICE = 256  # kWideSliceD: output columns a block


_CHUNK = 32  # kWideChunkD: the float32 columns of a 128-byte row


def _group_chunks(d: int, g: int, chunk: int) -> list:
    """The column chunks group g sums a key tile's scores over."""
    return list(range(1 - g, -(-d // chunk), 2))


def _live_halves(d: int, slice_: int, g: int) -> list:
    """The 64-column halves of group g's columns in a slice that hold a
    column before d: the only ones whose V boxes it loads and multiplies."""
    vcol = slice_ * _SLICE + 128 * g
    return [h for h in (0, 1) if vcol + 64 * h < d]


def _wide_emulation(q, k, v, causal, scale=None):
    """The wide kernel's arithmetic on ``(BH, S, D)`` tensors: (output in
    q's dtype, log-sum-exp)."""
    dtype = q.dtype
    bh, seq, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    neg = scale < 0
    sc = torch.tensor(np.float32(abs(scale)) * _LOG2E)
    qf, kf, vf = q.float(), k.float(), v.float()
    chunk = _CHUNK
    cols = [
        [slice(c * chunk, min((c + 1) * chunk, d)) for c in _group_chunks(d, g, chunk)]
        for g in (0, 1)
    ]
    out = torch.zeros(bh, seq, d)
    lse = torch.zeros(bh, seq)
    for q0 in range(0, seq, _ROWS):
        qt = qf[:, q0:q0 + _ROWS]
        rows = torch.arange(q0, q0 + qt.shape[1])
        k_end = min(seq, q0 + _ROWS) if causal else seq  # whole tiles past it skipped
        m = torch.full((bh, qt.shape[1]), float(_NEG_INF))
        l = torch.zeros(bh, qt.shape[1])
        acc = torch.zeros(bh, qt.shape[1], d)
        for k0 in range(0, k_end, _KEYS):
            kt, vt = kf[:, k0:k0 + _KEYS], vf[:, k0:k0 + _KEYS]
            part = []
            for g in (0, 1):
                s = torch.zeros(bh, qt.shape[1], kt.shape[1])
                for c in cols[g]:  # the group's chunks, in order
                    s = s + torch.matmul(qt[..., c], kt[..., c].transpose(1, 2))
                part.append(s)
            s = part[0] + part[1]
            if neg:
                s = -s
            keys = torch.arange(k0, k0 + kt.shape[1])
            masked = (keys[None, :] > rows[:, None]) if causal else torch.zeros(
                qt.shape[1], kt.shape[1], dtype=torch.bool)
            s = torch.where(masked, torch.tensor(_NEG_INF), s)
            m_new = torch.maximum(m, s.amax(dim=-1))
            mc = m_new * sc
            alpha = torch.exp2((m - m_new) * sc)
            # s * sc - mc rounded once, as the kernel's FFMA
            arg = (s.double() * sc.double() - mc.double()[..., None]).float()
            p = torch.where(masked, torch.tensor(0.0), torch.exp2(arg))
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.matmul(p, vt)
            m = m_new
        guarded = torch.where(l == 0, torch.ones_like(l), l)
        out[:, q0:q0 + _ROWS] = acc / guarded[..., None]
        lse[:, q0:q0 + _ROWS] = torch.where(
            l == 0, torch.tensor(-math.inf), m * np.float32(abs(scale)) + torch.log(l))
    return out.to(dtype), lse


def _inputs(shape, seed, dtype):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype) for _ in range(3)]


def _pallas(q, k, v, causal, scale=None):
    """JAX's kernel in interpret mode, head by head, on the same float32
    values (float64 numpy out)."""
    heads = []
    for i in range(q.shape[0]):
        qj, kj, vj = (jnp.asarray(t[i].numpy()) for t in (q, k, v))
        out = pallas_flash(qj, kj, vj, causal=causal, scale=scale, block_q=64, block_k=64,
                           interpret=True)
        assert out.dtype == jnp.float32
        heads.append(np.asarray(out, dtype=np.float64))
    return np.stack(heads)


@pytest.mark.parametrize("dtype", [torch.float32], ids=["f32"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [136, 200, 256, 512])
def test_scores_once_a_slice_meet_the_bar_against_pallas_and_the_plain_version(dtype, causal, d):
    """S 200: four 64-row query tiles and 64-key tiles, the last ragged, so
    the online rescale, the causal skip and the ragged mask all run; D 512
    takes two slices."""
    q, k, v = _inputs((2, 200, d), seed=d + 31 * causal, dtype=dtype)
    out, lse = _wide_emulation(q, k, v, causal)
    assert out.dtype == dtype and out.shape == q.shape
    got = out.double().numpy()
    np.testing.assert_allclose(got, _pallas(q, k, v, causal), rtol=_RTOL, atol=_ATOL)
    ref, ref_lse = fa.flash_attention_lse_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(got, ref.double().numpy(), rtol=_RTOL, atol=_ATOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), rtol=_RTOL, atol=_ATOL)


@pytest.mark.parametrize("scale", [-0.05, 0.0])
def test_negative_and_zero_scale(scale):
    """A negative scale negates the summed scores, so the running max of the
    unscaled scores is the max of the scaled ones; a zero scale makes P
    uniform over the keys a row sees."""
    q, k, v = _inputs((2, 150, 200), seed=7, dtype=torch.float32)
    out, lse = _wide_emulation(q, k, v, True, scale=scale)
    np.testing.assert_allclose(out.numpy(), _pallas(q, k, v, True, scale=scale),
                               rtol=_RTOL, atol=_ATOL)
    ref, ref_lse = fa.flash_attention_lse_reference(q, k, v, causal=True, scale=scale)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=_RTOL, atol=_ATOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), rtol=_RTOL, atol=_ATOL)


@pytest.mark.parametrize(
    "d,dtype",
    [(d, torch.float32) for d in (136, 200, 256, 264, 512, 520, 1024)],
    ids=lambda x: str(x).replace("torch.", ""),
)
def test_groups_cover_every_chunk_and_column_once(d, dtype):
    """The kernel's index arithmetic for the widths it takes (float32 past
    128): the two groups' chunks are every column chunk once, each group
    has at least two a key tile, and the live halves of the groups of every
    slice are every output column once."""
    chunk = _CHUNK
    chunks = _group_chunks(d, 0, chunk) + _group_chunks(d, 1, chunk)
    assert sorted(chunks) == list(range(-(-d // chunk)))
    assert min(len(_group_chunks(d, g, chunk)) for g in (0, 1)) >= 2
    covered = [
        col for sl in range(-(-d // _SLICE)) for g in (0, 1) for h in _live_halves(d, sl, g)
        for col in range(sl * _SLICE + 128 * g + 64 * h, sl * _SLICE + 128 * g + 64 * h + 64)
    ]
    assert sorted(c for c in covered if c < d) == list(range(d))
    assert len(covered) == len(set(covered)) and len(covered) - d < 64
