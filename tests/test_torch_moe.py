"""PyTorch port: `models.MoEFFN` held to the JAX package's `MoEFFN` on the
CPU.

The JAX model's parameters (from its seed) are carried across with
`MoEFFN.from_jax_params`, and the same seeded numpy tokens go through both
`apply`s. The inputs have no near-ties at the top-k boundary (checked),
since `torch.topk` and `lax.top_k` may break a tie differently.

Tolerance: rtol 1e-5, atol 1e-6 (float32 on both sides; the expert
products and the combine sum in different orders). Routing rows sum to 1
within 1e-6 and have exactly k nonzeros.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorframes_tpu.models import MoEFFN as JMoE
from tensorframes_tpu_torch.models import MoEFFN

CPU = "cpu"
_RTOL, _ATOL = 1e-5, 1e-6

_CASES = {  # d_model, d_hidden, num_experts, top_k, tokens
    "default": (32, 64, 8, 2, 24),
    "top1": (16, 48, 4, 1, 17),
    "top3-wide": (48, 96, 6, 3, 40),
}


def _pair(d, h, e, k, seed=0):
    jm = JMoE(d_model=d, d_hidden=h, num_experts=e, top_k=k, seed=seed)
    params = {n: np.asarray(v) for n, v in jm.params.items()}
    return jm, MoEFFN.from_jax_params(params, top_k=k, device=CPU), params


def _tokens(n, d, params, k, seed=1):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    logits = np.sort(x.astype(np.float64) @ params["gate"], axis=1)[:, ::-1]
    # no near-tie between the k-th and (k+1)-th gate logit of any token
    assert k == logits.shape[1] or (logits[:, k - 1] - logits[:, k]).min() > 1e-4
    return x


@pytest.mark.parametrize("case", sorted(_CASES))
def test_apply_matches_jax(case):
    d, h, e, k, n = _CASES[case]
    jm, tm, params = _pair(d, h, e, k)
    x = _tokens(n, d, params, k)
    want = np.asarray(jm.apply(jm.params, jnp.asarray(x)))
    got = tm(torch.from_numpy(x))
    assert got.shape == (n, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=_RTOL, atol=_ATOL)
    np.testing.assert_allclose(
        tm.apply(tm.params, torch.from_numpy(x)).numpy(), got.numpy(), rtol=0, atol=0
    )


@pytest.mark.parametrize("case", sorted(_CASES))
def test_routing_matches_jax_and_sums_to_one_over_k(case):
    d, h, e, k, n = _CASES[case]
    jm, tm, params = _pair(d, h, e, k)
    x = _tokens(n, d, params, k)
    w = tm._route(tm.params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(w, np.asarray(jm._route(jm.params, jnp.asarray(x))), rtol=_RTOL, atol=_ATOL)
    assert ((w > 0).sum(axis=1) == k).all()
    np.testing.assert_allclose(w.sum(axis=1), 1.0, rtol=0, atol=1e-6)


def test_own_init_is_seeded_and_scaled():
    a = MoEFFN(d_model=64, d_hidden=256, num_experts=4, seed=3, device=CPU)
    b = MoEFFN(d_model=64, d_hidden=256, num_experts=4, seed=3, device=CPU)
    assert all(torch.equal(a.params[n], b.params[n]) for n in ("gate", "w1", "w2"))
    assert a.params["w1"].shape == (4, 64, 256) and a.params["w2"].shape == (4, 256, 64)
    # the JAX model's scales: 1/sqrt(d_model) for gate and w1, 1/sqrt(d_hidden) for w2
    np.testing.assert_allclose(float(a.params["w1"].std()), 1 / 8, rtol=0.05)
    np.testing.assert_allclose(float(a.params["w2"].std()), 1 / 16, rtol=0.05)
    assert not any(p.requires_grad for p in a.parameters())
    with pytest.raises(ValueError):
        MoEFFN(num_experts=2, top_k=3, device=CPU)
