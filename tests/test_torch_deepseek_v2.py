"""PyTorch port: `models.DeepSeekV2LM` and the sparse routed-expert layer
`models.RoutedExperts` held to the plain reference `plain_deepseek_v2`
(this directory; an identical copy serves the benchmark) on the CPU.

The tiny configuration keeps every structure of DeepSeek-V2-Lite: 3 layers,
the first dense; 8 routed experts, top 2, plus 2 shared; latent 32; nope 16,
pe 8, v 16; 4 heads; the published YaRN settings. Its weights are drawn
with std 0.02 · sqrt(2048 / 64), so that its activations have the published
model's sizes at width 64.

Tolerance: rtol 1e-5, atol 1e-5 on logits of order 1 (float32 on both sides,
sums in other orders: the padded attention, the experts' per-expert slices,
the combine), set from float32's 1.2e-7 ulp. A token whose k-th and
(k+1)-th gate logits lie within 1e-4 in some MoE layer is left out of the
logits' comparison: two summation orders may route it differently (the
benchmark's comparison follows the program's experts inside its band
instead).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import plain_deepseek_v2 as ref
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.models import DeepSeekV2LM, RoutedExperts, moe
from tensorframes_tpu_torch.models.deepseek_v2 import softmax_scale, weight_shapes, yarn_inv_freq
from tensorframes_tpu_torch.ops.flash_attention import flash_attention
from tensorframes_tpu_torch.utils import profiling
from tensorframes_tpu_torch.utils import telemetry as ttele

from _torch_runtime import reset_port

_RTOL, _ATOL = 1e-5, 1e-5
_TIE = 1e-4

PUBLISHED = {  # DeepSeek-V2-Lite's config.json, the keys the model reads
    "hidden_size": 2048, "vocab_size": 102400, "num_hidden_layers": 27,
    "num_attention_heads": 16, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "v_head_dim": 128, "kv_lora_rank": 512, "q_lora_rank": None, "intermediate_size": 10944,
    "moe_intermediate_size": 1408, "n_routed_experts": 64, "num_experts_per_tok": 6,
    "n_shared_experts": 2, "first_k_dense_replace": 1, "rms_norm_eps": 1e-6,
    "rope_theta": 10000, "norm_topk_prob": False, "routed_scaling_factor": 1,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                     "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                     "type": "yarn"},
}
TINY = dict(
    PUBLISHED, hidden_size=64, vocab_size=97, num_hidden_layers=3, num_attention_heads=4,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32,
    intermediate_size=96, moe_intermediate_size=24, n_routed_experts=8, num_experts_per_tok=2,
    initializer_range=0.02 * math.sqrt(2048 / 64),
)


@pytest.fixture(autouse=True)
def _reset_port_state():
    reset_port()
    yield
    reset_port()


def _draw(seed=0, config=TINY):
    """Weights in the model's layout: normal, std ``initializer_range``;
    RMSNorm gains 1."""
    gen = torch.Generator().manual_seed(seed)
    std = config["initializer_range"]
    return {k: torch.ones(s) if len(s) == 1 else torch.randn(s, generator=gen) * std
            for k, s in weight_shapes(config).items()}


def _model(seed=0, config=TINY):
    return DeepSeekV2LM(config, _draw(seed, config))


def _weights(model):
    return {k: v.data for k, v in model.params.items()}


def _tokens(b, s, seed=1, vocab=TINY["vocab_size"]):
    return torch.randint(0, vocab, (b, s), generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("seed,b,s", [(0, 3, 40), (7, 2, 64), (2**31 + 3, 5, 17)])
def test_logits_match_the_reference(seed, b, s):
    model = _model(seed)
    tokens = _tokens(b, s, seed + 1)
    with torch.no_grad():
        got = model(tokens)
    want, tied, _, _ = ref.forward(_weights(model), tokens, TINY, tie_gap=_TIE)
    assert got.shape == (b, s, 97) and got.dtype == torch.float32
    assert float(tied.float().mean()) < 0.05  # few tokens left out
    torch.testing.assert_close(got[~tied], want[~tied], rtol=_RTOL, atol=_ATOL)


def test_the_reported_routing_is_the_references_and_is_followed():
    """The experts the model reports are the reference's own wherever the
    boundary is clear; the reference that follows them agrees on every
    token and counts nothing routed wrongly; a report that swaps a clearly
    chosen expert is counted, and the reference keeps its own pick."""
    model = _model(6)
    tokens = _tokens(3, 30, 2)
    with torch.no_grad():
        got, experts = model(tokens, routing=True)
    assert experts.shape == (3, 30, 2, 2) and experts.dtype == torch.int64
    w = _weights(model)
    want, tied, wrong, own = ref.forward(w, tokens, TINY, tie_gap=_TIE, follow=experts)
    assert int(wrong.sum()) == 0
    torch.testing.assert_close(got, want, rtol=_RTOL, atol=_ATOL)
    clear = ~tied
    assert torch.equal(experts.sort(-1).values[clear], own.sort(-1).values[clear])
    bad = experts.clone()
    bad[0, 5, 0] = torch.tensor([e for e in range(8) if e not in bad[0, 5, 0].tolist()][:2])
    _, _, wrong, taken = ref.forward(w, tokens, TINY, tie_gap=_TIE, follow=bad)
    assert int(wrong[0, 5]) == 1 and int(wrong.sum()) == 1
    assert torch.equal(taken[0, 5, 0].sort().values, own[0, 5, 0].sort().values)


def _without_ties(x, router, k):
    """The rows of x whose k-th and (k+1)-th gate logits lie 1e-3 apart."""
    top = (x.double() @ router.double()).topk(k + 1, dim=-1).values
    keep = (top[:, k - 1] - top[:, k]) > 1e-3
    return x[keep]


@pytest.mark.parametrize("k,norm,scaling", [(2, False, 1.0), (3, True, 1.0), (2, False, 2.5)])
def test_routing_equals_the_reference(k, norm, scaling):
    model = _model(4)
    router = model.params["l1_router"].data
    x = _without_ties(torch.randn(200, 64, generator=torch.Generator().manual_seed(3)),
                      router, k)
    assert len(x) > 150
    w, e = moe.route(x @ router, k, norm, scaling)
    rw, re, _ = ref.route(x, router, k, norm, scaling)
    assert torch.equal(e, re)
    torch.testing.assert_close(w, rw, rtol=1e-6, atol=1e-7)


def test_one_expert_set_for_every_token_drops_nothing():
    """Every token routed to the same two experts (positive rows, a router
    whose first two columns are positive and the others negative): the
    whole batch lands on two experts, with no capacity limit, and the layer
    still gives the reference's output."""
    model = _model(5)
    p = _weights(model)
    g = torch.Generator().manual_seed(8)
    router = torch.rand(64, 8, generator=g) * 0.1 - 1.0
    router[:, 0] += 2.0
    router[:, 1] += 1.5
    x = torch.randn(300, 64, generator=g).abs() + 0.1
    layer = RoutedExperts(top_k=2)
    w = {"router": router, "gate_up": p["l1_experts_gate_up"], "down": p["l1_experts_down"]}
    profiling.reset_stats()
    got, experts = layer(w, x)
    assert set(experts.unique().tolist()) == {0, 1}
    stats = profiling.stats()
    assert stats["moe.routed_pairs"] == 300 * 2 and stats["moe.max_expert_rows"] == 300
    assert stats["moe.layers"] == 1 and stats["moe.host_syncs"] == 1
    cfg = dict(TINY, n_shared_experts=0)
    layer_weights = {"l1_router": router, "l1_experts_gate_up": w["gate_up"],
                     "l1_experts_down": w["down"]}
    want = ref._moe(layer_weights, 1, x, cfg, torch.float32, None, False)[0]
    torch.testing.assert_close(got, want, rtol=_RTOL, atol=1e-6)


def test_the_published_yarn_numbers():
    _, (low, high) = yarn_inv_freq(PUBLISHED)
    assert (low, high) == (10, 23) == ref.yarn_correction_range(PUBLISHED)
    mscale = 0.1 * 0.707 * math.log(40) + 1
    assert mscale == pytest.approx(1.26080, abs=1e-5)
    assert softmax_scale(PUBLISHED) == pytest.approx(192 ** -0.5 * mscale ** 2, rel=1e-12)
    assert round(softmax_scale(PUBLISHED), 5) == 0.11472 == round(ref.softmax_scale(PUBLISHED), 5)
    inv_freq, _ = yarn_inv_freq(PUBLISHED)
    extra = 10000.0 ** (-np.arange(0, 64, 2) / 64)
    np.testing.assert_allclose(inv_freq[:10].numpy(), extra[:10], rtol=1e-15)
    np.testing.assert_allclose(inv_freq[23:].numpy(), extra[23:] / 40, rtol=1e-15)


def test_padded_v_attention_equals_plain_attention_at_v_width():
    g = torch.Generator().manual_seed(11)
    q, k = (torch.randn(6, 33, 192, generator=g) for _ in range(2))
    v = torch.randn(6, 33, 128, generator=g)
    scale = softmax_scale(PUBLISHED)
    out = flash_attention(q, k, torch.nn.functional.pad(v, (0, 64)), causal=True, scale=scale)
    assert torch.count_nonzero(out[..., 128:]) == 0
    s = (q @ k.transpose(1, 2)) * scale
    s = s.masked_fill(torch.ones(33, 33, dtype=torch.bool).triu(1), float("-inf"))
    torch.testing.assert_close(out[..., :128], torch.softmax(s, -1) @ v, rtol=1e-5, atol=1e-6)


def test_the_models_attention_layer_equals_the_references():
    model = _model(9)
    p = _weights(model)
    x = torch.randn(2, 29, 64, generator=torch.Generator().manual_seed(12))
    cos, sin = ref._cos_sin(TINY, 29, x.device)
    torch.testing.assert_close(model.attention(0, x), ref._attention(p, 0, x, TINY, cos, sin),
                               rtol=_RTOL, atol=1e-6)


def test_one_span_of_each_stage_per_moe_layer_per_block():
    model = _model(2)
    tokens = _tokens(4, 12, 3)
    df = tft.TensorFrame([tft.Column("tokens", tokens)]).repartition(2)
    ttele.reset()
    out = tft.map_blocks(lambda tokens: {"logits": model(tokens)}, df, device="cpu")
    assert out.column("logits").values.shape == (4, 12, 97)
    spans = ttele.spans()
    blocks = [s for s in spans if s.name == "map_blocks.block"]
    assert len(blocks) == 2
    moe_layers = TINY["num_hidden_layers"] - TINY["first_k_dense_replace"]
    by_parent = {}
    for s in spans:
        by_parent.setdefault(s.parent_id, []).append(s.name)
    for b in blocks:
        names = by_parent[b.span_id]
        for stage in ("moe.route", "moe.experts", "moe.combine"):
            assert names.count(stage) == moe_layers, (stage, names)
    assert profiling.stats()["moe.routed_pairs"] == 4 * 12 * 2 * moe_layers


def test_weights_from_the_caller_are_used_without_a_copy():
    model = _model(1)
    w = _weights(model)
    again = DeepSeekV2LM(TINY, w)
    assert all(again.params[k].data_ptr() == w[k].data_ptr() for k in w)
    with pytest.raises(ValueError, match="missing"):
        DeepSeekV2LM(TINY, {k: v for k, v in w.items() if k != "head"})
    with pytest.raises(ValueError, match="unsupported"):
        DeepSeekV2LM(dict(TINY, scoring_func="sigmoid"), w)


@pytest.mark.parametrize("idle", [0, 3, 6])
def test_uneven_loads_and_idle_experts_give_the_references_output(idle):
    """A router that sends no row to ``idle`` of the 8 experts and most
    rows to expert 7 (through a constant input column): each expert
    computes its own rows only, the counters give the rows computed and the
    largest load, and the output is the reference's."""
    p = _weights(_model(10))
    g = torch.Generator().manual_seed(20 + idle)
    router = torch.randn(64, 8, generator=g) * 0.1
    router[0, :idle] = -10.0
    router[0, 7] = 1.0
    x = torch.randn(400, 64, generator=g)
    x[:, 0] = 3.0
    x = _without_ties(x, router, 2)
    assert len(x) > 300
    w = {"router": router, "gate_up": p["l1_experts_gate_up"], "down": p["l1_experts_down"]}
    profiling.reset_stats()
    got, experts = RoutedExperts(top_k=2)(w, x)
    loads = torch.bincount(experts.flatten(), minlength=8)
    assert int(loads[:idle].sum()) == 0 and int(loads[7]) == int(loads.max())
    stats = profiling.stats()
    assert stats["moe.routed_pairs"] == len(x) * 2
    assert stats["moe.max_expert_rows"] == int(loads.max())
    cfg = dict(TINY, n_shared_experts=0)
    layer_weights = {"l1_router": router, "l1_experts_gate_up": w["gate_up"],
                     "l1_experts_down": w["down"]}
    want, _, idx, _ = ref._moe(layer_weights, 1, x, cfg, torch.float32, None, False)
    assert torch.equal(experts.sort(-1).values, idx.sort(-1).values)
    torch.testing.assert_close(got, want, rtol=_RTOL, atol=1e-6)
