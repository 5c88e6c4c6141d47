"""PyTorch port: `models.KimiLinearLM`, the KDA recurrence of `ops.kda`, the
sigmoid router and the held share of `models.RoutedExperts` held to the
plain reference `plain_kimi_linear` (this directory; an identical copy
serves the benchmark) on the CPU.

The tiny configuration keeps every structure of Kimi-Linear-48B-A3B: 5
layers whose mixers are KDA, KDA, KDA, MLA, KDA (the published 3 : 1
pattern and a last KDA layer), the first with a dense MLP; 8 routed experts,
top 2, a sigmoid router with a selection bias, renormalised and scaled by
2.446, plus 1 shared expert; 4 heads of 16 in both mixers (MLA's nope 16, pe
8, v 16, latent 32), a short convolution of 4 taps. Its weights are drawn
with std 0.02 · sqrt(2304 / 64), so that its activations have the published
model's sizes at width 64, and A_log, dt_bias, the selection bias and the
filters by the laws of the benchmark's configuration.

Tolerances: logits rtol 1e-5, atol 5e-5 (logits up to ~5, whose float32
ulp is 4.8e-7: ~100 ulp; float32 on both sides, sums in other orders
through 5 layers: the fused q/k/v product, the convolution's taps, the
recurrence, the padded attention, the experts' slices, the combine; the
widest gap over 12 seeds was 2.0e-5); the routing is compared exactly on
tokens whose boundary scores lie 1e-4 apart, and the reference follows the
program's experts inside that band elsewhere. The recurrence against float64 at rtol
1e-5, atol 1e-6 (float32 sums of 16 products a step; the state forgets an
error at the rate it forgets anything).
"""

from __future__ import annotations

import math

import pytest
import torch
import torch.nn.functional as F

import plain_kimi_linear as ref
import tensorframes_tpu_torch as tft
from tensorframes_tpu_torch.models import KimiLinearLM, RoutedExperts, moe
from tensorframes_tpu_torch.models.kimi_linear import layer_kinds, routed_widths, weight_shapes
from tensorframes_tpu_torch.ops.kda import kda, kda_reference
from tensorframes_tpu_torch.utils import profiling
from tensorframes_tpu_torch.utils import telemetry as ttele

from _torch_runtime import reset_port

_RTOL, _ATOL = 1e-5, 5e-5
_TIE = 1e-4

TINY = {
    "hidden_size": 64, "vocab_size": 97, "num_hidden_layers": 5, "num_attention_heads": 4,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16, "kv_lora_rank": 32,
    "q_lora_rank": None, "intermediate_size": 96, "moe_intermediate_size": 24,
    "num_experts": 8, "num_experts_per_token": 2, "num_shared_experts": 1,
    "first_k_dense_replace": 1, "rms_norm_eps": 1e-5, "rope_theta": 10000, "rope_scaling": None,
    "moe_renormalize": True, "routed_scaling_factor": 2.446, "mla_use_nope": True,
    "moe_router_activation_func": "sigmoid", "hidden_act": "silu", "moe_layer_freq": 1,
    "num_expert_group": 1, "topk_group": 1, "tie_word_embeddings": False,
    "linear_attn_config": {"full_attn_layers": [4], "kda_layers": [1, 2, 3, 5], "head_dim": 16,
                           "num_heads": 4, "short_conv_kernel_size": 4},
}
STD = 0.02 * math.sqrt(2304 / 64)


@pytest.fixture(autouse=True)
def _reset_port_state():
    reset_port()
    yield
    reset_port()


def _draw(seed=0, config=TINY):
    """Weights in the model's layout, by the configuration's laws."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in weight_shapes(config).items():
        if name.endswith("_A_log"):
            t = torch.log(torch.rand(shape, generator=gen) * 15 + 1)
        elif name.endswith("_dt_bias"):
            lo, hi = math.log(1e-3), math.log(1e-1)
            dt = torch.exp(lo + (hi - lo) * torch.rand(shape, generator=gen))
            t = dt + torch.log(-torch.expm1(-dt))
        elif name.endswith("_router_bias"):
            t = torch.randn(shape, generator=gen) * 1e-3
        elif name.endswith("_kda_conv"):
            t = torch.rand(shape, generator=gen) - 0.5
        elif len(shape) == 1:
            t = torch.ones(shape)
        else:
            t = torch.randn(shape, generator=gen) * STD
        out[name] = t
    return out


def _tokens(b, s, seed=1):
    return torch.randint(0, TINY["vocab_size"], (b, s),
                         generator=torch.Generator().manual_seed(seed))


def _held(config, weights, lo, hi):
    """The configuration and weights of a chip that holds experts [lo, hi)."""
    cfg = dict(config, num_experts=hi - lo, experts_held=[lo, hi],
               published={"num_experts": config["num_experts"]})
    w = dict(weights)
    for k in weights:
        if k.endswith(("_experts_gate_up", "_experts_down")):
            w[k] = weights[k][lo:hi]
    return cfg, w


# --- the model against the reference ----------------------------------------

@pytest.mark.parametrize("seed,b,s,blocks", [(0, 3, 40, 1), (7, 4, 33, 2), (2**31 + 3, 2, 1, 2)])
def test_logits_match_the_reference_through_map_blocks(seed, b, s, blocks):
    w = _draw(seed)
    model = KimiLinearLM(TINY, w)
    tokens = _tokens(b, s, seed + 1)
    df = tft.TensorFrame([tft.Column("tokens", tokens)]).repartition(blocks)
    with torch.no_grad():
        out = tft.map_blocks(lambda tokens: dict(zip(("logits", "experts"),
                                                     model(tokens, routing=True))),
                             df, device="cpu")
    got, experts = out.column("logits").values, out.column("experts").values
    assert got.shape == (b, s, 97) and got.dtype == torch.float32
    assert experts.shape == (b, s, 4, 2) and experts.dtype == torch.int64
    want, tied, wrong, own = ref.forward(w, tokens, TINY, tie_gap=_TIE, follow=experts)
    assert int(wrong.sum()) == 0 and float(tied.float().mean()) < 0.1
    torch.testing.assert_close(got, want, rtol=_RTOL, atol=_ATOL)
    clear = ~tied
    assert torch.equal(experts.sort(-1).values[clear], own.sort(-1).values[clear])


def test_a_chips_share_matches_the_reference_given_the_same_share():
    cfg, w = _held(TINY, _draw(5), 2, 6)
    tokens = _tokens(2, 30, 6)
    with torch.no_grad():
        got, experts = KimiLinearLM(cfg, w)(tokens, routing=True)
    assert int(experts.max()) > 5 or int(experts.min()) < 2  # experts not held are routed to
    want, _, wrong, _ = ref.forward(w, tokens, cfg, tie_gap=_TIE, follow=experts)
    assert int(wrong.sum()) == 0
    torch.testing.assert_close(got, want, rtol=_RTOL, atol=_ATOL)


def test_the_reported_routing_outside_the_band_is_counted():
    w = _draw(6)
    tokens = _tokens(3, 30, 2)
    with torch.no_grad():
        _, experts = KimiLinearLM(TINY, w)(tokens, routing=True)
    _, _, _, own = ref.forward(w, tokens, TINY, tie_gap=_TIE)
    bad = experts.clone()
    bad[0, 5, 0] = torch.tensor([e for e in range(8) if e not in bad[0, 5, 0].tolist()][:2])
    _, _, wrong, taken = ref.forward(w, tokens, TINY, tie_gap=_TIE, follow=bad)
    assert int(wrong[0, 5]) == 1 and int(wrong.sum()) == 1
    assert torch.equal(taken[0, 5, 0].sort().values, own[0, 5, 0].sort().values)


def test_one_span_of_each_kda_stage_per_layer_per_block():
    model = KimiLinearLM(TINY, _draw(2))
    tokens = _tokens(4, 12, 3)
    df = tft.TensorFrame([tft.Column("tokens", tokens)]).repartition(2)
    ttele.reset()
    profiling.reset_stats()
    tft.map_blocks(lambda tokens: {"logits": model(tokens)}, df, device="cpu")
    spans = ttele.spans()
    blocks = [s for s in spans if s.name == "map_blocks.block"]
    assert len(blocks) == 2
    by_parent = {}
    for s in spans:
        by_parent.setdefault(s.parent_id, []).append(s.name)
    for blk in blocks:
        names = by_parent[blk.span_id]
        for stage in ("kda.prep", "kda.core", "kda.out"):
            assert names.count(stage) == 4, (stage, names)
        assert names.count("moe.route") == 4
    stats = profiling.stats()
    assert stats["kda.layers"] == 8 and stats["kda.tokens"] == 8 * 2 * 12
    assert "kda.launches" not in stats  # the CPU runs the plain version
    assert stats["moe.routed_pairs"] == 4 * 12 * 2 * 4 and stats["moe.foreign_pairs"] == 0


# --- the layer kinds --------------------------------------------------------

def test_the_one_based_layer_lists_choose_each_mixer():
    assert layer_kinds(TINY) == ["kda", "kda", "kda", "mla", "kda"]
    published = dict(TINY, num_hidden_layers=27, linear_attn_config=dict(
        TINY["linear_attn_config"], full_attn_layers=[4, 8, 12, 16, 20, 24, 27],
        kda_layers=[i for i in range(1, 27) if i % 4]))
    kinds = layer_kinds(published)
    assert [i + 1 for i, k in enumerate(kinds) if k == "mla"] == [4, 8, 12, 16, 20, 24, 27]
    assert kinds.count("kda") == 20
    shapes = weight_shapes(TINY)
    assert "l3_q" in shapes and "l3_kda_qkv" not in shapes
    assert "l4_kda_qkv" in shapes and "l4_q" not in shapes
    with pytest.raises(ValueError, match="both"):
        layer_kinds(dict(TINY, linear_attn_config=dict(TINY["linear_attn_config"],
                                                       full_attn_layers=[3, 4])))
    with pytest.raises(ValueError, match="covers"):
        layer_kinds(dict(TINY, linear_attn_config=dict(TINY["linear_attn_config"],
                                                       kda_layers=[1, 2, 3])))


def test_the_kda_layer_is_the_references_and_mla_leaves_pe_unrotated():
    w = _draw(9)
    model = KimiLinearLM(TINY, w)
    x = torch.randn(2, 29, 64, generator=torch.Generator().manual_seed(12))
    with torch.no_grad():
        torch.testing.assert_close(model.attention(0, x), ref._kda(w, 0, x, TINY),
                                   rtol=_RTOL, atol=1e-6)
        torch.testing.assert_close(model.attention(3, x), ref._mla(w, 3, x, TINY),
                                   rtol=_RTOL, atol=1e-6)
        # a token's MLA output depends on no position: reversing the prefix
        # before a token keeps the token's output
        y = x.clone()
        y[:, :28] = x[:, :28].flip(1)
        torch.testing.assert_close(model.attention(3, y)[:, 28], model.attention(3, x)[:, 28],
                                   rtol=1e-5, atol=1e-6)


def test_settings_the_model_lacks_are_refused():
    w = _draw(1)
    with pytest.raises(ValueError, match="unsupported"):
        KimiLinearLM(dict(TINY, mla_use_nope=False), w)
    with pytest.raises(ValueError, match="unsupported"):
        KimiLinearLM(dict(TINY, moe_router_activation_func="softmax"), w)
    with pytest.raises(ValueError, match="experts_held"):
        KimiLinearLM(dict(TINY, experts_held=[0, 4]), w)
    with pytest.raises(ValueError, match="missing"):
        KimiLinearLM(TINY, {k: v for k, v in w.items() if k != "l4_kda_conv"})
    cfg, _ = _held(TINY, w, 4, 8)
    assert routed_widths(cfg) == (8, (4, 8))
    with pytest.raises(ValueError, match="misshapen"):
        KimiLinearLM(cfg, w)  # every expert's weights for a share of four


# --- the recurrence ---------------------------------------------------------

def _recurrence_inputs(b, s, h, d, seed, g_range=(-3.0, -1e-3), dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    q = F.normalize(torch.randn(b, s, h, d, generator=gen, dtype=dtype), dim=-1)
    k = F.normalize(torch.randn(b, s, h, d, generator=gen, dtype=dtype), dim=-1)
    lo, hi = math.log(-g_range[0]), math.log(-g_range[1])
    g = -torch.exp(hi + (lo - hi) * torch.rand(b, s, h, d, generator=gen, dtype=dtype))
    beta = torch.rand(b, s, h, generator=gen, dtype=dtype)
    v = torch.randn(b, s, h, d, generator=gen, dtype=dtype)
    return q, k, g, beta, v


def _matrix_form(q, k, g, beta, v):
    """S_t = (I - beta k k^T) Diag(exp g) S + beta k v^T, o = D^-1/2 S^T q,
    one (sequence, head) at a time in float64 with explicit matrices."""
    b, s, h, d = q.shape
    out = torch.empty(b, s, h, v.shape[-1], dtype=torch.float64)
    eye = torch.eye(d, dtype=torch.float64)
    for i in range(b):
        for j in range(h):
            state = torch.zeros(d, v.shape[-1], dtype=torch.float64)
            for t in range(s):
                kt = k[i, t, j].double()[:, None]
                bt = float(beta[i, t, j])
                state = ((eye - bt * kt @ kt.T) @ torch.diag(g[i, t, j].double().exp()) @ state
                         + bt * kt @ v[i, t, j].double()[None])
                out[i, t, j] = state.T @ q[i, t, j].double() * d ** -0.5
    return out


def _kernel_arithmetic(q, k, g, beta, v):
    """The kernel's order of work: o = scale * (S'^T q + beta u (k . q)),
    with S' the decayed state, then the update."""
    b, s, h, d = q.shape
    state = q.new_zeros(b, h, d, d)
    out = torch.empty_like(v)
    for t in range(s):
        decayed = state * g[:, t].exp().unsqueeze(-1)
        sk = (decayed * k[:, t].unsqueeze(-1)).sum(-2)
        sq = (decayed * q[:, t].unsqueeze(-1)).sum(-2)
        w = beta[:, t, :, None] * (v[:, t] - sk)
        out[:, t] = d ** -0.5 * (sq + w * (k[:, t] * q[:, t]).sum(-1, keepdim=True))
        state = decayed + k[:, t].unsqueeze(-1) * w.unsqueeze(-2)
    return out


@pytest.mark.parametrize("b,s,h,d,g_range", [
    (1, 1, 1, 16, (-3.0, -1e-3)), (2, 63, 3, 16, (-3.0, -1e-3)), (1, 40, 2, 128, (-3.0, -1e-3)),
    (2, 50, 2, 16, (-30.0, -20.0)), (2, 50, 2, 16, (-1e-6, -1e-7)),
], ids=["s1", "s63", "d128", "decay-near-0", "decay-near-1"])
def test_the_recurrence_matches_the_matrix_form(b, s, h, d, g_range):
    args = _recurrence_inputs(b, s, h, d, seed=s + d, g_range=g_range)
    got = kda(*args)
    assert got.shape == (b, s, h, d) and torch.equal(got, kda_reference(*args))
    want = _matrix_form(*args)
    torch.testing.assert_close(got.double(), want, rtol=_RTOL, atol=1e-6)
    torch.testing.assert_close(_kernel_arithmetic(*args).double(), want, rtol=_RTOL, atol=1e-6)


def test_the_recurrence_is_the_references():
    args = _recurrence_inputs(2, 30, 4, 16, seed=5)
    torch.testing.assert_close(kda(*args), ref._kda_recurrence(*args), rtol=_RTOL, atol=1e-6)


def test_the_op_refuses_what_it_cannot_take():
    q, k, g, beta, v = _recurrence_inputs(1, 4, 2, 16, seed=1)
    with pytest.raises(ValueError, match="share one"):
        kda(q, k[..., :8], g, beta, v)
    with pytest.raises(ValueError, match="beta"):
        kda(q, k, g, beta[:, :2], v)
    with pytest.raises(ValueError, match="no kernel"):
        kda(*(t.to("meta") for t in (q, k, g, beta, v)))


def test_importing_the_port_builds_no_library():
    from tensorframes_tpu_torch.ops import _cuda_build

    assert "kda" not in _cuda_build._libs and "kda" not in _cuda_build.build_logs


# --- the router and the held share ------------------------------------------

def _clear_rows(x, router, bias, k, gap=1e-3):
    """The rows of x whose k-th and (k+1)-th selection scores lie ``gap``
    apart."""
    top = (torch.sigmoid(x.double() @ router.double()) + bias.double()).topk(k + 1).values
    return x[(top[:, k - 1] - top[:, k]) > gap]


def test_the_sigmoid_router_equals_the_references():
    w = _draw(4)
    router, bias = w["l1_router"], w["l1_router_bias"] * 30  # a bias that moves choices
    x = _clear_rows(torch.randn(300, 64, generator=torch.Generator().manual_seed(3)),
                    router, bias, 2)
    assert len(x) > 200
    weights, experts = moe.route(x @ router, 2, True, 2.446, "sigmoid", bias)
    rw, re, _, _ = ref.route(x, router, bias, TINY)
    assert torch.equal(experts, re)
    torch.testing.assert_close(weights, rw, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(weights.sum(-1), torch.full((len(x),), 2.446))
    unbiased = moe.route(x @ router, 2, True, 2.446, "sigmoid", torch.zeros_like(bias))[1]
    assert not torch.equal(unbiased, experts)  # the bias chooses, and does not weigh
    with pytest.raises(ValueError, match="scoring"):
        moe.route(x @ router, 2, scoring="relu")


@pytest.mark.parametrize("seed", [0, 2**31 + 1])
def test_the_held_shares_add_up_to_the_uncut_layer(seed):
    """Four chips' shares (0, 2), (2, 4), (4, 6), (6, 8) of one MoE layer,
    the shared expert counted once, give the whole layer; each share counts
    its pairs and the others', which add up to N · k."""
    w = _draw(seed)
    x = torch.randn(120, 64, generator=torch.Generator().manual_seed(seed + 1))
    whole = {"router": w["l2_router"], "bias": w["l2_router_bias"],
             "gate_up": w["l2_experts_gate_up"], "down": w["l2_experts_down"]}
    total = torch.zeros_like(x)
    routed = 0
    for lo in (0, 2, 4, 6):
        share = dict(whole, gate_up=whole["gate_up"][lo:lo + 2], down=whole["down"][lo:lo + 2])
        profiling.reset_stats()
        out, experts = RoutedExperts(2, True, 2.446, "sigmoid", (lo, lo + 2))(share, x)
        stats = profiling.stats()
        assert stats["moe.routed_pairs"] + stats["moe.foreign_pairs"] == 120 * 2
        assert stats["moe.routed_pairs"] == int(((experts >= lo) & (experts < lo + 2)).sum())
        routed += stats["moe.routed_pairs"]
        total += out
    assert routed == 120 * 2
    model = KimiLinearLM(TINY, w)
    total += model.shared_experts(2, x)
    want = ref._moe(w, 2, x, TINY)[0]
    torch.testing.assert_close(total, want, rtol=_RTOL, atol=1e-6)
    uncut, _ = RoutedExperts(2, True, 2.446, "sigmoid")(whole, x)
    torch.testing.assert_close(total, uncut + model.shared_experts(2, x), rtol=_RTOL, atol=1e-6)


# --- DeepSeek-V2's softmax layer, unchanged ---------------------------------

def _softmax_layer_as_before(w, x, k):
    """`RoutedExperts` with the softmax rule as it was before the sigmoid
    rule and the held share: every expert held."""
    n, d = x.shape
    weights, experts = torch.softmax(x @ w["router"], dim=-1).topk(k, dim=-1)
    pairs = experts.reshape(-1)
    order = torch.argsort(pairs, stable=True)
    counts = torch.bincount(pairs, minlength=w["router"].shape[1])
    rows = x.index_select(0, order // k)
    h = w["down"].shape[1]
    t = rows.new_empty(len(rows), 2 * h)
    lo = 0
    spans = []
    for e, m in enumerate(counts.tolist()):
        if m:
            spans.append((e, lo, lo + m))
            torch.mm(rows[lo:lo + m], w["gate_up"][e], out=t[lo:lo + m])
            lo += m
    a = F.silu(t[:, :h]).mul_(t[:, h:])
    out = torch.empty_like(rows)
    for e, r0, r1 in spans:
        torch.mm(a[r0:r1], w["down"][e], out=out[r0:r1])
    y = torch.empty_like(out).index_copy_(0, order, out).view(n, k, d)
    return torch.bmm(weights.unsqueeze(1), y).squeeze(1), experts


@pytest.mark.parametrize("held", [None, (0, 8)])
def test_the_softmax_layer_is_unchanged(held):
    g = torch.Generator().manual_seed(21)
    w = {"router": torch.randn(64, 8, generator=g) * 0.1,
         "gate_up": torch.randn(8, 64, 48, generator=g) * 0.1,
         "down": torch.randn(8, 24, 64, generator=g) * 0.1}
    x = torch.randn(200, 64, generator=g)
    profiling.reset_stats()
    got, experts = RoutedExperts(2, held=held)(w, x)
    want, want_experts = _softmax_layer_as_before(w, x, 2)
    assert torch.equal(experts, want_experts) and torch.equal(got, want)
    stats = profiling.stats()
    assert stats["moe.routed_pairs"] == 400 and stats["moe.foreign_pairs"] == 0
    assert stats["moe.host_syncs"] == 1 and stats["moe.layers"] == 1
    logits = x @ w["router"]
    for norm, scaling in ((False, 1.0), (True, 2.5)):
        a = moe.route(logits, 3, norm, scaling)
        b = moe.route(logits, 3, norm, scaling, "softmax")
        assert all(torch.equal(p, q) for p, q in zip(a, b))
