"""PyTorch port: the attention kernels of ``csrc/`` against their plain
version on an NVIDIA card (`ops.flash_attention`).

Every case runs both entries, `flash_attention` and `flash_attention_lse`,
on the card and holds them to `flash_attention_lse_reference` on the same
tensors: the two entries' outputs equal, the output in q's shape and dtype
(float32 and float64 at rtol 1e-4 / atol 1e-5, bf16 and fp16 within one
unit in their last place), the log-sum-exp at rtol 1e-4 / atol 1e-5, and
each entry one launch of the kernel the library is expected to pick
(`flash_attention.launches_by_route`): bf16 and fp16 the tensor-core
kernels, float32 up to head_dim 128 the CUDA-core kernel, wider float32
the wide kernel. The cases: the shapes of `tests/test_pallas.py`, the
kernels' edge shapes and the LM's shape (causal and not, negative and zero
scales); head widths 1 to 1,000 at ragged lengths; JAX's ``(S, D)`` and
``(B, H, S, D)`` layouts; transposed and misaligned inputs; float64 (equal
to the float32 call widened) and int32 (the float32 call truncated); bf16
and fp16 at every width class of the tensor-core kernels; the shapes of
`PERF.md`'s attention tables; one causal head of 65,535 x 64 + 1 rows. Then
what ptxas said of each attention library built afresh: no register
spills, every instantiation compiled, no ``wgmma`` serialized.

The CPU tests of the same code (the route a CUDA tensor takes, the layout
step, emulations of the kernels' arithmetic) are the other
``test_torch_flash_attention*.py`` files. This file imports no JAX, so the
card's machine runs it without the repository's conftest:

    python3 -m pytest tests/test_torch_flash_attention_card.py -m card --noconftest -p no:cacheprovider -q
"""

import math
import re

import pytest
import torch

from tensorframes_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_lse,
    flash_attention_lse_reference,
    flash_attention_reference,
)

from _torch_card import build_logs_afresh
from _torch_card import card  # noqa: F401 - the fixture

F32, F64, BF16, F16 = torch.float32, torch.float64, torch.bfloat16, torch.float16

# float32 kernel against the plain version, TF32 off: the kernel sums each
# row's scores tile by tile with an online softmax, the plain version in one
# softmax over the full row, so the two differ only by rounding order
_RTOL, _ATOL = 1e-4, 1e-5
# bf16 and fp16 outputs against the plain version's: both compute in float32
# and round once to the dtype, so they may differ by one unit in its last
# place, a relative 2^-7 (bf16) or 2^-10 (fp16); atol for values near 0
_HALF_RTOL = {BF16: 2.0**-7, F16: 2.0**-10}
_HALF_ATOL = 1e-5
# the LM's attention shape: 8 sequences x 4 heads, 2,048 tokens, head_dim 64
_LM = (32, 2048, 64)
# the seeds of the two sets of cases
_SEED_EDGES, _SEED_WIDTHS = 0, 60


def _close(what, got, want, rtol, atol) -> float:
    """Max abs error; raises where the shapes or dtypes differ, a value is
    not finite, or any element is outside atol + rtol * |want|."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    diff = (got - want).abs()
    bad = diff > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements outside rtol={rtol} "
                             f"atol={atol}, max abs err {float(diff.max()):.3e}")
    return float(diff.max())


def _route(dtype, d: int) -> str:
    """The kernel the library picks for q, k, v of ``dtype`` and head_dim
    ``d``: any other dtype than bf16 and fp16 runs as float32."""
    if dtype in _HALF_RTOL:
        return "tensor_core"
    return "cuda_core" if -(-d // 8) * 8 <= 128 else "wide"


def _both_entries(what, q, k, v, causal, scale=None) -> float:
    """Both entries against `flash_attention_lse_reference`, each one
    launch on the expected route; returns the max abs error."""
    before = dict(flash_attention.launches_by_route)
    out = flash_attention(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    out_l, lse = flash_attention_lse(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    routes = {r: n - before[r] for r, n in flash_attention.launches_by_route.items()
              if n != before[r]}
    assert routes == {_route(q.dtype, q.shape[-1]): 2}, f"{what}: launched {routes}"
    ref, ref_lse = flash_attention_lse_reference(q, k, v, causal=causal, scale=scale)
    assert torch.equal(out, out_l), f"{what}: the two entries' outputs differ"
    if ref.dtype in _HALF_RTOL:
        assert out.dtype == ref.dtype, f"{what}: {out.dtype} vs {ref.dtype}"
        err = _close(what + " out", out.float(), ref.float(), _HALF_RTOL[ref.dtype], _HALF_ATOL)
    else:
        err = _close(what + " out", out, ref, _RTOL, _ATOL)
    return max(err, _close(what + " lse", lse, ref_lse, _RTOL, _ATOL))


def _randn(*shape, dtype=F32):
    """``shape`` drawn from a standard normal in ``dtype``; the tensors of
    a case (q, k, v in turn) come from its generator."""
    return lambda gen: torch.randn(*shape, device=gen.device, generator=gen).to(dtype)


def _transposed(gen):
    """A (3, 200, 64) view of a (3, 64, 200) tensor: strided rows."""
    return torch.randn(3, 64, 200, device=gen.device, generator=gen).transpose(1, 2)


def _misaligned(gen):
    """A (3, 129, 40) view 4 bytes into its storage."""
    t = torch.randn(3 * 129 * 40 + 1, device=gen.device, generator=gen)[1:].view(3, 129, 40)
    assert t.data_ptr() % 16, "the view is aligned"
    return t


def _key(shape, dtype=F32, causal=True, scale=None) -> str:
    name = ("" if dtype is F32 else str(dtype)[6:] + "-") + "x".join(map(str, shape))
    return name + ("-causal" if causal else "") + ("" if scale is None else f"-scale{scale}")


# (id, seed, draws q, k, v, causal, scale)
_CASES = []

# the shapes of tests/test_pallas.py; ragged ends against the 64-row query
# and key tiles (and against 128-row query tiles), a single row, an odd
# width, the non-causal path at the LM's length, the widest one-slice head,
# the LM's shape; a negative scale (its sign folded into the staged Q tile)
# and a zero scale (every visible key the same weight)
for _shape, _causal in (
    ((1, 64, 16), False), ((1, 128, 8), False), ((1, 256, 32), False),
    ((1, 128, 16), True), ((1, 100, 8), False), ((1, 75, 8), True),
    ((3, 200, 64), True), ((2, 129, 128), True), ((1, 1, 8), False),
    ((4, 1000, 40), True), ((2, 2048, 64), False), ((8, 1024, 128), True),
    (_LM, True),
):
    _CASES.append((_key(_shape, causal=_causal), _SEED_EDGES, _randn(*_shape), _causal, None))
for _scale in (-0.125, 0.0):
    _CASES.append((_key((2, 200, 64), scale=_scale), _SEED_EDGES, _randn(2, 200, 64), True,
                   _scale))

# widths not a multiple of 8 (zero-padded), up to 128 (one slice) and past
# it (column slices), at ragged lengths
for _d, _s in zip((1, 15, 24, 120, 136, 200, 256, 512), (75, 129, 200, 1000) * 2):
    for _causal in (False, True):
        _CASES.append((_key((2, _s, _d), causal=_causal), _SEED_WIDTHS, _randn(2, _s, _d),
                       _causal, None))
# the wide kernel's and the padded width's negative and zero scales
for _d in (15, 256):
    for _scale in (-0.05, 0.0):
        _CASES.append((_key((2, 200, _d), scale=_scale), _SEED_WIDTHS, _randn(2, 200, _d), True,
                       _scale))
# JAX's (S, D) signature and (B, H, S, D)
for _shape in ((200, 15), (129, 256), (2, 3, 129, 24), (2, 2, 200, 136)):
    _CASES.append((_key(_shape), _SEED_WIDTHS, _randn(*_shape), True, None))
# strided and misaligned inputs
_CASES.append(("transposed-3x200x64-causal", _SEED_WIDTHS, _transposed, True, None))
_CASES.append(("misaligned-3x129x40-causal", _SEED_WIDTHS, _misaligned, True, None))
# float64 goes through float32 (the Pallas kernel's cast of each block)
for _shape in ((2, 200, 24), (3, 75, 15)):
    _CASES.append((_key(_shape, F64), _SEED_WIDTHS, _randn(*_shape, dtype=F64), True, None))

# bf16 and fp16 loaded by the tensor-core kernels
_HALF_SHAPES = [  # (shape, causal, scale)
    ((3, 200, 64), False, None), ((3, 200, 64), True, None),
    ((2, 129, 128), False, None), ((2, 129, 128), True, None),
    ((4, 300, 256), False, None), ((4, 300, 256), True, None),
    (_LM, True, None),
    # widths the k16 step does not divide (zero-filled box columns), a
    # padded width, ragged lengths against the 128-row tiles, one row
    ((2, 300, 8), True, None), ((2, 200, 24), False, None),
    ((2, 1000, 120), True, None), ((2, 129, 15), True, None), ((1, 1, 8), False, None),
    # scales: the scores are scaled before the row max
    ((3, 200, 64), True, -0.125), ((4, 300, 256), True, -0.125),
    ((2, 200, 24), True, 0.0), ((2, 129, 120), False, -0.05),
    # three and four 64-column boxes a row: a width the k16 step does not
    # divide (136: 9 steps run as 10), ragged lengths, a negative scale
    ((2, 300, 136), False, None), ((2, 300, 136), True, None),
    ((2, 1000, 200), True, None), ((2, 129, 200), False, None),
    ((2, 200, 200), True, -0.125),
    # past 256: two slices over a resident Q tile of 5-8 boxes (264 and 320
    # with a zero-filled V box in the second slice; 448 with a zero-filled
    # box in its second window of Q K^T), three slices over 9 boxes (520,
    # 576); windows of 4 with Q reloaded past them (640: a zero-filled
    # window tail; 1000: four slices, four windows); negative and zero
    # scales, ragged lengths against the 64- and 32-key tiles
    ((2, 129, 264), False, -0.05), ((2, 200, 264), True, 0.0),
    ((2, 200, 320), True, None), ((2, 129, 384), False, None),
    ((2, 300, 448), True, -0.125), ((2, 300, 512), True, None),
    ((2, 300, 520), True, None), ((2, 129, 576), False, None),
    ((2, 200, 576), True, -0.05), ((2, 129, 640), True, None),
    ((1, 200, 1000), True, None),
]
for _dtype in (BF16, F16):
    for _shape, _causal, _scale in _HALF_SHAPES:
        _CASES.append((_key(_shape, _dtype, _causal, _scale), _SEED_WIDTHS,
                       _randn(*_shape, dtype=_dtype), _causal, _scale))

# the shapes of PERF.md's attention tables, causal: float32 at the LM's
# shape and at 16 x 2048 x D (one slice at D 128, the wide kernel at 136,
# 256 and 512); bf16 and fp16 at the LM's shape and at two to nine
# 64-column boxes a row
for _dtype, _widths in ((F32, (128, 136, 256, 512)),
                        (BF16, (128, 136, 256, 264, 384, 512, 576)),
                        (F16, (128, 136, 256, 264, 384, 512, 576))):
    for _shape in (_LM, *((16, 2048, d) for d in _widths)):
        _CASES.append(("tracked-" + _key(_shape, _dtype), _SEED_WIDTHS, _randn(*_shape, dtype=_dtype), True, None))


@pytest.mark.card
@pytest.mark.parametrize("seed,draw,causal,scale", [c[1:] for c in _CASES],
                         ids=[c[0] for c in _CASES])
def test_kernel_matches_plain_version(card, seed, draw, causal, scale):
    gen = torch.Generator(device=card).manual_seed(seed)
    q, k, v = (draw(gen) for _ in range(3))
    _both_entries(f"{q.dtype} {tuple(q.shape)} causal={causal} scale={scale}",
                  q, k, v, causal, scale)


@pytest.mark.card
@pytest.mark.parametrize("shape", [(2, 200, 24), (3, 75, 15)], ids=["2x200x24", "3x75x15"])
def test_float64_is_the_float32_call_widened(card, shape):
    gen = torch.Generator(device=card).manual_seed(_SEED_WIDTHS)
    q, k, v = (torch.randn(*shape, device=card, generator=gen, dtype=F64) for _ in range(3))
    f32 = flash_attention(q.float(), k.float(), v.float(), causal=True).double()
    assert torch.equal(flash_attention(q, k, v, causal=True), f32)


@pytest.mark.card
def test_int32_is_the_float32_call_truncated(card):
    """int32 runs as float32 and truncates, as JAX's astype does. A
    truncation may fall either side of an integer where the two float32
    results differ by rounding, so the plain version's integers are held
    within 1 and the float32 results at the float32 bar."""
    gen = torch.Generator(device=card).manual_seed(_SEED_WIDTHS)
    qi, ki, vi = (torch.randint(-3, 4, (2, 129, 16), device=card, generator=gen,
                                dtype=torch.int32) for _ in range(3))
    before = dict(flash_attention.launches_by_route)
    got = flash_attention(qi, ki, vi, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_route["cuda_core"] == before["cuda_core"] + 1
    f32 = flash_attention(qi.float(), ki.float(), vi.float(), causal=True)
    assert got.dtype == torch.int32 and torch.equal(got, f32.to(torch.int32))
    assert (got - flash_attention_reference(qi, ki, vi, causal=True)).abs().max() <= 1
    _close("int32 (2, 129, 16) as float32", f32,
           flash_attention_reference(qi.float(), ki.float(), vi.float(), causal=True),
           _RTOL, _ATOL)


@pytest.mark.card
def test_a_head_past_the_grids_y_limit(card):
    """One causal head of 65,535 x 64 + 1 rows: one query tile past the
    65,535 that a grid's y dimension would count. The plain version cannot
    hold S^2 scores, so the first query tile (the lightest, scheduled last),
    the last (one row over every key) and one in the middle are held
    against the plain arithmetic over the keys they see."""
    s, d = 65535 * 64 + 1, 8
    gen = torch.Generator(device=card).manual_seed(_SEED_WIDTHS)
    q, k, v = (torch.randn(1, s, d, device=card, generator=gen) for _ in range(3))
    out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    scale = 1.0 / math.sqrt(d)
    for r0 in (0, 32768 * 64, s - 1):
        r1 = min(r0 + 64, s)
        scores = (q[0, r0:r1] @ k[0, :r1].T) * scale
        rows = torch.arange(r0, r1, device=card)[:, None]
        seen = torch.arange(r1, device=card)[None, :] <= rows
        w = torch.softmax(scores.masked_fill(~seen, -math.inf), dim=-1)
        _close(f"S {s} rows {r0}-{r1 - 1}", out[0, r0:r1], w @ v[0, :r1], _RTOL, _ATOL)


# ---------------------------------------------------------------------------
# what ptxas said of the attention libraries
# ---------------------------------------------------------------------------

_LIBRARIES = ["flash_attention", "flash_attention_f16", "flash_attention_bf16"]
# attention kernels the three libraries compile: float32 at head_dim 8-128
# (16 widths), the tensor-core kernels of bf16 and fp16 at 1-8, 10, 12, 14
# and 16 k16 steps (12 widths) and past 256 (5 shapes: a resident Q tile of
# 5, 6, 8 or 9 boxes, windows of 4 reloaded past it), the float32 wide
# kernel; each with and without the log-sum-exp
_TC_INSTANTIATIONS = 2 * (12 + 5) * 2
_INSTANTIATIONS = 16 * 2 + _TC_INSTANTIATIONS + 2


@pytest.fixture(scope="module")
def attention_logs(tmp_path_factory):
    """nvcc's output for each attention library, built afresh."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    return build_logs_afresh(_LIBRARIES, tmp_path_factory.mktemp("build"))


def _ptxas_table(logs) -> dict:
    """Every attention kernel instantiation in the build logs: its
    library and mangled name's template arguments -> (registers, spill
    store bytes, spill load bytes, stack frame bytes)."""
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


@pytest.mark.card
@pytest.mark.parametrize("library", _LIBRARIES)
def test_ptxas_spills_nothing(card, attention_logs, library):
    table = _ptxas_table({library: attention_logs[library]})
    assert table, f"no kernel in {library}'s build log"
    spilled = {k: r for k, r in table.items() if r[1] or r[2]}
    assert not spilled, f"ptxas spilled in {spilled} ([registers, stores, loads, stack])"


@pytest.mark.card
def test_ptxas_compiles_every_instantiation(card, attention_logs):
    table = _ptxas_table(attention_logs)
    tc = [k for k in table if "flash_attention_tc_" in k]
    assert (len(table), len(tc)) == (_INSTANTIATIONS, _TC_INSTANTIATIONS)


@pytest.mark.card
def test_ptxas_serializes_no_wgmma(card, attention_logs):
    """The tensor-core kernels are built for wgmma pipelines: ptxas must
    not serialize them (its C7510-C7520 notes)."""
    serialized = sorted({line.strip() for log in attention_logs.values()
                         for line in log.splitlines()
                         if "wgmma.mma_async instructions are serialized" in line})
    assert not serialized, serialized[:3]
