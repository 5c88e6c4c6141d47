"""The benchmark's arithmetic for Kimi-Linear-style models (KDA layers beside
latent attention, a chip's share of sigmoid-routed experts), from the
published configuration's keys alone: the operations a scored token costs,
and the bound of one launch of the KDA recurrence. Nothing here reads the
program.
"""

from __future__ import annotations

from typing import Dict, Tuple

from portbench.yardstick import PEAKS
from portbench.yardstick_moe import expert_flops_per_pair

# operations of the recurrence a state element a token: the decay's product,
# the two reductions (S'^T k, S^T q) and the update, a multiply-add 2
RECURRENCE_OPS = 7


def held_share(config: Dict) -> float:
    """The share of the router's experts held here: ``num_experts`` over
    the published count."""
    return config["num_experts"] / config.get("published", {}).get("num_experts",
                                                                    config["num_experts"])


def flops_per_token(config: Dict, seq: int) -> Dict[str, float]:
    """Operations a scored token costs in sequences of ``seq``, by part, and
    their ``total``, at 2 operations a multiply-add: the KDA layers'
    products (q, k, v, the decay's and the gate's low ranks, beta, the
    output) and their recurrence; the MLA layers' products (q, kv_a, kv_b,
    o) and their share of the causal attention (scores nope + pe deep,
    values v_head_dim wide, over the s(s+1)/2 pairs the mask keeps); the
    dense MLP; the router over every expert; the routed experts at the held
    share (``num_experts_per_token`` x the share pairs a token); the shared
    experts; the head. At Kimi-Linear-48B-A3B's widths, 64 of 256 experts
    held and seq 4096, the total is 4,370,307,072."""
    d, layers = config["hidden_size"], config["num_hidden_layers"]
    lac = config["linear_attn_config"]
    kda, mla = len(lac["kda_layers"]), len(lac["full_attn_layers"])
    H, D = lac["num_heads"], lac["head_dim"]
    nh = config["num_attention_heads"]
    nope, pe, vd = config["qk_nope_head_dim"], config["qk_rope_head_dim"], config["v_head_dim"]
    lora = config["kv_lora_rank"]
    dense = config["first_k_dense_replace"]
    moe = layers - dense
    h = config["moe_intermediate_size"]
    experts = config.get("published", {}).get("num_experts", config["num_experts"])
    kda_proj = 4 * d * H * D + 2 * (d * D + D * H * D) + d * H
    mla_proj = d * nh * (nope + pe) + d * (lora + pe) + lora * nh * (nope + vd) + nh * vd * d
    parts = {
        "kda_projections": 2.0 * kda * kda_proj,
        "kda_recurrence": float(kda * RECURRENCE_OPS * H * D * D),
        "mla_projections": 2.0 * mla * mla_proj,
        "mla_attention": 2.0 * mla * nh * (nope + pe + vd) * (seq * (seq + 1) // 2) / seq,
        "dense_mlp": 2.0 * dense * 3 * d * config["intermediate_size"],
        "router": 2.0 * moe * d * experts,
        "routed_experts": (moe * config["num_experts_per_token"] * held_share(config)
                           * expert_flops_per_pair(config)),
        "shared_experts": 2.0 * moe * 3 * d * (config["num_shared_experts"] or 0) * h,
        "head": 2.0 * d * config["vocab_size"],
    }
    parts["total"] = sum(parts.values())
    return parts


def kda_bound(b: int, s: int, h: int, d: int, elem_bytes: int = 4) -> Tuple[float, str]:
    """(bound_ms, bound_by) of one launch of the recurrence over ``b``
    sequences of ``s`` tokens and ``h`` heads of ``d`` channels:
    `RECURRENCE_OPS` operations a state element (d x d) a token-head at 67
    TFLOP/s, against q, k, g, v and o (d wide) and beta moved once at 3.35
    TB/s."""
    rows = b * s * h
    t_ops = RECURRENCE_OPS * d * d * rows / PEAKS["float32_flops"]
    t_bytes = (5 * d + 1) * rows * elem_bytes / PEAKS["hbm_bytes_per_s"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
