"""PyTorch port: the flash-attention plain version held to the Pallas kernel.

`tensorframes_tpu.ops.pallas_kernels.flash_attention` runs in Pallas
interpret mode on the CPU (as `tests/test_pallas.py` runs it) and
`tensorframes_tpu_torch.ops.flash_attention` runs its plain version, which
is what the wrapper takes for a CPU tensor. The CUDA kernel itself needs the
card: `chip_smoke.py` holds it against the same plain version there.

Tolerance: rtol 1e-4, atol 1e-5. Both sides are float32; the Pallas kernel
sums scores tile by tile with an online softmax while the plain version
takes one softmax over the full row, so the two round in different orders.
"""

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


# the cases of tests/test_pallas.py: (seq, d, causal, block, seed)
_CASES = [
    (64, 16, False, 64, 0),
    (128, 8, False, 64, 0),
    (256, 32, False, 64, 0),
    (128, 16, True, 64, 1),
    (100, 8, False, 64, 2),
    (75, 8, True, 32, 3),
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
            (lambda: [torch.zeros(2, 16, 8, dtype=torch.float64)] * 3, TypeError),
            (lambda: [torch.zeros(2, 8, 16).transpose(1, 2)] * 3, ValueError),
            (lambda: [torch.zeros(2, 16, 8), torch.zeros(2, 8, 8), torch.zeros(2, 16, 8)], ValueError),
            (lambda: [torch.zeros(2, 16, 12)] * 3, ValueError),
            (lambda: [torch.zeros(2, 16, 136)] * 3, ValueError),
            (lambda: [torch.zeros(16, 8)] * 3, ValueError),
        ],
        ids=["float64", "non-contiguous", "shape-mismatch", "d-not-multiple-of-8", "d-over-128", "rank-2"],
    )
    def test_kernel_arguments_are_checked(self, make, err):
        """What the CUDA kernel cannot take raises before any launch."""
        with pytest.raises(err):
            fa._check_kernel_args(*make())
