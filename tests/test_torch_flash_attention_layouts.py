"""PyTorch port: the attention wrapper at every head width, dtype and layout
the Pallas kernel takes, held to that kernel on the CPU.

`tensorframes_tpu.ops.pallas_kernels.flash_attention` runs in Pallas
interpret mode, as `tests/test_pallas.py` runs it, one ``(S, D)`` head at a
time. Against it run two routes of `tensorframes_tpu_torch`:

- the port's `flash_attention` on CPU tensors, which is its plain version;
- the route a CUDA tensor takes with the launch replaced by the plain
  version: the layout step `_kernel_layout` (flatten the leading
  dimensions, cast, zero-pad D to a multiple of 8, copy strided or
  misaligned inputs), the plain version on what it hands the kernel, and
  its restore. That runs the pad, cast and reshape logic that only CUDA
  tensors take; `tests/test_torch_flash_attention_card.py` holds the
  kernel itself to the plain version on the card.

Tolerances. float32, and float64 (which both kernels compute in float32):
rtol 1e-4, atol 1e-5, as `tests/test_torch_flash_attention.py`. bf16 and
fp16: both sides compute in float32 and round once to the dtype, so they
may differ by one unit in its last place: rtol 2^-7 (bf16), 2^-10 (fp16),
atol 1e-5. int32: both sides truncate a float32 result, and where the two
float32 results straddle an integer by rounding the truncations differ by
1, so the integers are held within 1. LM logits rtol 1e-4, atol 1e-5, as
`tests/test_torch_transformer.py`.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorframes_tpu.models.transformer import TransformerLM as JaxLM
from tensorframes_tpu.ops.pallas_kernels import flash_attention as pallas_flash
from tensorframes_tpu_torch.models import TransformerLM
from tensorframes_tpu_torch.ops import flash_attention as fa

_RTOL, _ATOL = 1e-4, 1e-5
_HALF_RTOL = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}
_JNP = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def _arrays(shape, seed, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _pallas(q, k, v, causal, scale=None, block=64):
    """JAX's kernel in interpret mode over the trailing ``(S, D)`` of jax
    arrays, head by head."""
    if q.ndim == 2:
        return pallas_flash(q, k, v, causal=causal, scale=scale, block_q=block,
                            block_k=block, interpret=True)
    return jnp.stack([_pallas(q[i], k[i], v[i], causal, scale, block) for i in range(q.shape[0])])


def _as_numpy(x):
    """A jax or torch array as float64 numpy (bf16 has no numpy dtype)."""
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x.astype(jnp.float64) if x.dtype == jnp.float64 else x.astype(jnp.float32),
                      dtype=np.float64)


def _kernel_route(q, k, v, causal, scale=None):
    """What a CUDA tensor goes through, with the plain version in place of
    the launch: (output, log-sum-exp). Checks that the layout step hands
    the kernel what it takes."""
    q3, k3, v3, sc, restore = fa._kernel_layout(q, k, v, scale)
    for t in (q3, k3, v3):
        assert t.dim() == 3 and t.shape == q3.shape
        assert t.dtype in (torch.float32, torch.float16, torch.bfloat16)
        assert t.is_contiguous() and t.data_ptr() % 16 == 0
    assert q3.shape[-1] % 8 == 0 and 0 <= q3.shape[-1] - q.shape[-1] < 8
    return restore(*fa.flash_attention_lse_reference(q3, k3, v3, causal=causal, scale=sc))


def _assert_both_routes(q, k, v, want, causal, rtol=_RTOL, atol=_ATOL, scale=None):
    """The port's CPU call and the kernel's route against ``want``, in q's
    shape and dtype; the route's log-sum-exp against the CPU entry's."""
    cpu = fa.flash_attention(q, k, v, causal=causal, scale=scale)
    routed, lse = _kernel_route(q, k, v, causal, scale)
    _, cpu_lse = fa.flash_attention_lse(q, k, v, causal=causal, scale=scale)
    for got in (cpu, routed):
        assert got.shape == q.shape and got.dtype == q.dtype
        np.testing.assert_allclose(_as_numpy(got), _as_numpy(want), rtol=rtol, atol=atol)
    assert lse.shape == q.shape[:-1] and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), cpu_lse.numpy(), rtol=_RTOL, atol=_ATOL)


class TestWidths:
    # widths not a multiple of 8 (zero-padded), one slice, and past 128
    # (the kernel's column slices), at ragged lengths
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("d,s", [(1, 75), (15, 40), (24, 33), (136, 64), (256, 75)])
    def test_head_width_matches_pallas(self, d, s, causal):
        q, k, v = _arrays((2, s, d), seed=d)
        want = _pallas(*map(jnp.asarray, (q, k, v)), causal)
        _assert_both_routes(*map(torch.from_numpy, (q, k, v)), want, causal)

    def test_default_scale_is_the_true_widths(self):
        """1/sqrt(15), not 1/sqrt(16) of the padded width."""
        q, k, v = map(torch.from_numpy, _arrays((1, 20, 15), seed=1))
        assert fa._kernel_layout(q, k, v, None)[3] == 1.0 / math.sqrt(15)
        assert fa._kernel_layout(q, k, v, 0.3)[3] == 0.3

    @pytest.mark.parametrize("scale", [-0.05, 0.0])
    def test_negative_and_zero_scale_at_a_padded_width(self, scale):
        q, k, v = _arrays((1, 48, 15), seed=2)
        want = _pallas(*map(jnp.asarray, (q, k, v)), True, scale=scale)
        _assert_both_routes(*map(torch.from_numpy, (q, k, v)), want, True, scale=scale)


class TestLayouts:
    @pytest.mark.parametrize("s,d", [(75, 15), (64, 136), (40, 8)])
    def test_jax_signature_s_d(self, s, d):
        q, k, v = _arrays((s, d), seed=s + d)
        want = _pallas(*map(jnp.asarray, (q, k, v)), True)
        _assert_both_routes(*map(torch.from_numpy, (q, k, v)), want, True)

    @pytest.mark.parametrize("shape", [(2, 3, 40, 24), (2, 2, 33, 15)])
    def test_four_dimensions(self, shape):
        q, k, v = _arrays(shape, seed=shape[-1])
        want = np.stack([
            _as_numpy(_pallas(*(jnp.asarray(t[b]) for t in (q, k, v)), True))
            for b in range(shape[0])
        ])
        _assert_both_routes(*map(torch.from_numpy, (q, k, v)), want, True)

    def test_transposed_input(self):
        q, k, v = _arrays((2, 24, 40), seed=3)
        want = _pallas(*(jnp.asarray(np.swapaxes(t, 1, 2)) for t in (q, k, v)), True)
        qt, kt, vt = (torch.from_numpy(t).transpose(1, 2) for t in (q, k, v))
        assert not qt.is_contiguous()
        _assert_both_routes(qt, kt, vt, want, True)

    def test_misaligned_input(self):
        """A contiguous view 4 bytes into its storage: ``.contiguous()``
        would keep it, the layout step copies it."""
        shape = (2, 33, 16)
        q, k, v = _arrays(shape, seed=4)
        want = _pallas(*map(jnp.asarray, (q, k, v)), False)
        views = []
        for t in (q, k, v):
            flat = torch.zeros(t.size + 1)
            flat[1:] = torch.from_numpy(t).reshape(-1)
            views.append(flat[1:].view(shape))
        assert views[0].is_contiguous() and views[0].data_ptr() % 16
        _assert_both_routes(*views, want, False)

    def test_block_sizes_are_accepted(self):
        """JAX's block_q / block_k choose the TPU kernel's tiles: its result
        changes only by rounding, and the port's not at all."""
        q, k, v = _arrays((100, 16), seed=5)
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        ref = fa.flash_attention(tq, tk, tv, causal=True)
        for bq, bk in ((16, 32), (64, 64), (128, 8)):
            want = pallas_flash(*map(jnp.asarray, (q, k, v)), causal=True, block_q=bq,
                                block_k=bk, interpret=True)
            got = fa.flash_attention(tq, tk, tv, causal=True, block_q=bq, block_k=bk)
            assert torch.equal(got, ref)
            _, lse = fa.flash_attention_lse(tq, tk, tv, causal=True, block_q=bq, block_k=bk)
            assert lse.shape == (100,)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=_RTOL, atol=_ATOL)


class TestDtypes:
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
    @pytest.mark.parametrize("shape", [(2, 75, 15), (2, 64, 64), (1, 40, 136)])
    def test_half_precision_within_one_ulp(self, dtype, shape):
        """Both sides round the float32 inputs to the dtype alike (to
        nearest even), load them as they are and round the output once."""
        q, k, v = _arrays(shape, seed=shape[-1] + 7)
        want = _pallas(*(jnp.asarray(t).astype(_JNP[dtype]) for t in (q, k, v)), True)
        assert want.dtype == _JNP[dtype]
        tq, tk, tv = (torch.from_numpy(t).to(dtype) for t in (q, k, v))
        assert fa._kernel_layout(tq, tk, tv, None)[0].dtype == dtype  # loaded as it is
        _assert_both_routes(tq, tk, tv, want, True, rtol=_HALF_RTOL[dtype], atol=1e-5)

    def test_float64_goes_through_float32(self):
        q, k, v = _arrays((2, 50, 15), seed=8)
        q64, k64, v64 = (t.astype(np.float64) for t in (q, k, v))
        with jax.enable_x64(True):
            want = _pallas(*map(jnp.asarray, (q64, k64, v64)), True)
            assert want.dtype == jnp.float64
            want = np.asarray(want)
        tq, tk, tv = map(torch.from_numpy, (q64, k64, v64))
        assert fa._kernel_layout(tq, tk, tv, None)[0].dtype == torch.float32
        _assert_both_routes(tq, tk, tv, want, True)
        # the route of a float64 call is the float32 call's, widened
        routed, _ = _kernel_route(tq, tk, tv, True)
        f32, _ = _kernel_route(*(t.float() for t in (tq, tk, tv)), True)
        assert torch.equal(routed, f32.double())

    def test_int32_truncates_like_astype(self):
        rng = np.random.RandomState(9)
        q, k, v = (rng.randint(-3, 4, (2, 40, 16)).astype(np.int32) for _ in range(3))
        want = np.asarray(_pallas(*map(jnp.asarray, (q, k, v)), True))
        assert want.dtype == np.int32
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        cpu = fa.flash_attention(tq, tk, tv, causal=True)
        routed, _ = _kernel_route(tq, tk, tv, True)
        for got in (cpu, routed):
            assert got.dtype == torch.int32 and got.shape == (2, 40, 16)
            assert np.abs(got.numpy().astype(np.int64) - want).max() <= 1
        f32, _ = _kernel_route(*(t.float() for t in (tq, tk, tv)), True)
        assert torch.equal(routed, f32.to(torch.int32))  # truncated toward zero

    def test_mixed_dtypes_go_through_float32(self):
        q, k, v = map(torch.from_numpy, _arrays((1, 30, 8), seed=10))
        qb = q.to(torch.bfloat16)
        q3, k3, v3, _, _ = fa._kernel_layout(qb, k, v, None)
        assert q3.dtype == k3.dtype == v3.dtype == torch.float32
        routed, _ = _kernel_route(qb, k, v, True)
        assert routed.dtype == torch.bfloat16
        want = fa.flash_attention_reference(qb.float(), k, v, causal=True).to(torch.bfloat16)
        assert torch.equal(routed, want)


class TestLogSumExp:
    @pytest.mark.parametrize("shape", [(40, 15), (2, 3, 33, 136)])
    def test_lse_against_float64(self, shape):
        q, k, v = _arrays(shape, seed=11)
        scale = 1.0 / math.sqrt(shape[-1])
        s = np.einsum("...qd,...kd->...qk", q.astype(np.float64), k.astype(np.float64)) * scale
        n = shape[-2]
        s = np.where(np.tril(np.ones((n, n), dtype=bool)), s, -np.inf)
        m = s.max(axis=-1, keepdims=True)
        want = (m + np.log(np.exp(s - m).sum(axis=-1, keepdims=True)))[..., 0]
        _, lse = _kernel_route(*map(torch.from_numpy, (q, k, v)), True)
        assert lse.shape == shape[:-1]
        np.testing.assert_allclose(lse.numpy(), want, rtol=_RTOL, atol=_ATOL)


# --------------------------------------------------------------------------
# TransformerLM at head widths the card had not served: 15 (d_model 60, 4
# heads) and 256 (one head), JAX's parameters carried across
# --------------------------------------------------------------------------


def _routed_attention(q, k, v, causal):
    return _kernel_route(q, k, v, causal)[0]


@pytest.mark.parametrize(
    "cfg",
    [dict(vocab=32, d_model=60, n_heads=4, n_layers=2, max_seq=24, seed=0),
     dict(vocab=32, d_model=256, n_heads=1, n_layers=1, max_seq=16, seed=1)],
    ids=["head_dim_15", "head_dim_256"],
)
def test_lm_at_head_width_matches_jax(cfg):
    jm = JaxLM(**cfg)
    tm = TransformerLM.from_jax_params(
        {k: np.asarray(v) for k, v in jm.params.items()}, n_heads=cfg["n_heads"], device="cpu")
    assert tm.head_dim == cfg["d_model"] // cfg["n_heads"]
    tokens = np.random.default_rng(cfg["seed"]).integers(
        0, cfg["vocab"], (2, cfg["max_seq"])).astype(np.int32)
    want = np.stack([np.asarray(jm.apply(jm.params, t)) for t in tokens])
    t = torch.from_numpy(tokens)
    for got in (tm(t), tm(t, attention=_routed_attention)):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=_RTOL, atol=_ATOL)
