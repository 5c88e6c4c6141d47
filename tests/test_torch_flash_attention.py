"""PyTorch port: the flash-attention plain version held to the Pallas kernel.

`tensorframes_tpu.ops.pallas_kernels.flash_attention` runs in Pallas
interpret mode on the CPU (as `tests/test_pallas.py` runs it) and
`tensorframes_tpu_torch.ops.flash_attention` runs its plain version, which
is what the wrapper takes for a CPU tensor. The CUDA kernel itself needs the
card: `tests/test_torch_flash_attention_card.py` holds it against the same
plain version there.

Tolerance: rtol 1e-4, atol 1e-5. Both sides are float32; the Pallas kernel
sums scores tile by tile with an online softmax while the plain version
takes one softmax over the full row, so the two round in different orders.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensorframes_tpu.ops.pallas_kernels import flash_attention as pallas_flash
from tensorframes_tpu_torch.ops import flash_attention as fa

_RTOL, _ATOL = 1e-4, 1e-5


def _qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


# (seq, d, causal, block, seed): the cases of tests/test_pallas.py, then the
# CUDA kernel's edge shapes (tests/test_torch_flash_attention_card.py holds
# the kernel to this plain version at the same (seq, d, causal)): ragged ends against its 64-row query
# and key tiles (and against 128-row query tiles), a single row, the widest
# head, an odd width, and the non-causal path at the LM's length
_CASES = [
    (64, 16, False, 64, 0),
    (128, 8, False, 64, 0),
    (256, 32, False, 64, 0),
    (128, 16, True, 64, 1),
    (100, 8, False, 64, 2),
    (75, 8, True, 32, 3),
    (200, 64, True, 64, 7),
    (129, 128, True, 64, 8),
    (1, 8, False, 64, 9),
    (1000, 40, True, 64, 10),
    (2048, 64, False, 64, 11),
    (1024, 128, True, 64, 12),
]


class TestPlainVersionMatchesPallas:
    @pytest.mark.parametrize(
        "seq,d,causal,block,seed", _CASES,
        ids=[f"s{c[0]}-d{c[1]}{'-causal' if c[2] else ''}" for c in _CASES],
    )
    def test_single_head(self, seq, d, causal, block, seed):
        q, k, v = _qkv((seq, d), seed)
        ref = pallas_flash(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            block_q=block, block_k=block, interpret=True,
        )
        out = fa.flash_attention_reference(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal,
        )
        assert out.shape == (seq, d) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=_RTOL, atol=_ATOL)

    @pytest.mark.parametrize("causal", [False, True])
    def test_heads_batched_match_per_head_pallas(self, causal):
        """(BH, S, D) in one call, as the model sends it, equals the
        Pallas kernel run head by head."""
        q, k, v = _qkv((6, 40, 16), seed=4)
        out = fa.flash_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal,
        )
        for h in range(q.shape[0]):
            ref = pallas_flash(
                jnp.asarray(q[h]), jnp.asarray(k[h]), jnp.asarray(v[h]),
                causal=causal, block_q=16, block_k=16, interpret=True,
            )
            np.testing.assert_allclose(
                out[h].numpy(), np.asarray(ref), rtol=_RTOL, atol=_ATOL
            )

    def test_explicit_scale(self):
        q, k, v = _qkv((48, 8), seed=5)
        ref = pallas_flash(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            scale=0.05, block_q=16, block_k=16, interpret=True,
        )
        out = fa.flash_attention_reference(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=True, scale=0.05,
        )
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=_RTOL, atol=_ATOL)

    @pytest.mark.parametrize("scale", [-0.125, 0.0])
    def test_negative_and_zero_scale(self, scale):
        """The CUDA kernel takes a negative scale's sign into its staged Q
        tile; the card tests hold it to this plain version at these scales."""
        q, k, v = _qkv((200, 64), seed=13)
        ref = pallas_flash(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            scale=scale, block_q=64, block_k=64, interpret=True,
        )
        out = fa.flash_attention_reference(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=True, scale=scale,
        )
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=_RTOL, atol=_ATOL)


class TestWrapper:
    def test_cpu_tensor_takes_the_plain_version_and_launches_nothing(self):
        q, k, v = (torch.from_numpy(a) for a in _qkv((2, 32, 8), seed=6))
        before = fa.flash_attention.launches
        out = fa.flash_attention(q, k, v, causal=True)
        assert fa.flash_attention.launches == before
        torch.testing.assert_close(
            out, fa.flash_attention_reference(q, k, v, causal=True), rtol=0, atol=0
        )

    def test_other_devices_are_refused(self):
        q = torch.empty((4, 8), device="meta")
        with pytest.raises(ValueError, match="no kernel for device"):
            fa.flash_attention(q, q, q)

    @pytest.mark.parametrize(
        "make,err",
        [
            (lambda: [torch.zeros(2, 16, 8, dtype=torch.float64)] * 3, None),
            (lambda: [torch.zeros(2, 8, 16).transpose(1, 2)] * 3, None),
            (lambda: [torch.zeros(2, 16, 8), torch.zeros(2, 8, 8), torch.zeros(2, 16, 8)], ValueError),
            (lambda: [torch.zeros(2, 16, 12)] * 3, None),
            (lambda: [torch.zeros(2, 16, 136)] * 3, None),
            (lambda: [torch.zeros(16, 8)] * 3, None),
            (lambda: [torch.zeros(2 * 16 * 8 + 1)[1:].view(2, 16, 8)] * 3, None),
            # one query tile past the 65535 a grid's y dimension counts;
            # meta tensors allocate nothing
            (lambda: [torch.empty(1, 65535 * fa._BLOCK_Q + 1, 8, device="meta")] * 3, None),
            (lambda: [torch.zeros(2, 16, 8), torch.zeros(2, 16, 8, device="meta"),
                      torch.zeros(2, 16, 8)], ValueError),
        ],
        ids=[
            "float64", "non-contiguous", "shape-mismatch", "d-not-multiple-of-8",
            "d-over-128", "rank-2", "misaligned", "too-many-query-tiles", "mixed-devices",
        ],
    )
    def test_kernel_arguments_are_checked(self, make, err):
        """The layout step hands the kernel a contiguous, 16-byte aligned
        ``(BH, S, D8)`` tensor of a kernel dtype whatever the caller's
        layout, dtype and width, and restores the caller's shape and dtype;
        what no layout fits raises before any launch."""
        q, k, v = make()
        if err is not None:
            with pytest.raises(err):
                fa._kernel_layout(q, k, v, None)
            return
        q3, k3, v3, _, restore = fa._kernel_layout(q, k, v, None)
        *lead, s, d = q.shape
        bh = math.prod(lead)
        for t in (q3, k3, v3):
            assert t.shape == (bh, s, -(-d // 8) * 8)
            assert t.dtype in (torch.float32, torch.float16, torch.bfloat16)
            assert t.is_contiguous() and t.data_ptr() % 16 == 0
        out, lse = restore(torch.zeros_like(q3), torch.zeros(bh, s, device=q.device))
        assert out.shape == q.shape and out.dtype == q.dtype
        assert lse.shape == q.shape[:-1] and lse.dtype == torch.float32

    def test_grid_past_the_launch_limit_is_refused(self):
        """More thread blocks than one launch takes (2^31 - 1)."""
        q = torch.empty(2**25, 4097, 8, device="meta")
        with pytest.raises(ValueError, match="thread blocks"):
            fa._kernel_layout(q, q, q, None)

    def test_zero_head_dim_is_refused(self):
        q = torch.zeros(2, 16, 0)
        with pytest.raises(ValueError, match="head_dim 0"):
            fa._kernel_layout(q, q, q, None)
