"""The benchmark's arithmetic for DeepSeek-V2-style models (latent attention,
routed experts), from the published configuration's keys alone: the
operations a scored token costs, and the bound of one latent-attention
launch. Nothing here reads the program.
"""

from __future__ import annotations

from typing import Dict, Tuple

from portbench.yardstick import PEAKS


def expert_flops_per_pair(config: Dict) -> int:
    """One routed (token, expert) pair's SwiGLU: gate, up and down
    products of d x h, 2 operations a multiply-add."""
    return 2 * 3 * config["hidden_size"] * config["moe_intermediate_size"]


def flops_per_token(config: Dict, seq: int) -> Dict[str, float]:
    """Operations a scored token costs in sequences of ``seq``, by part, and
    their ``total``: the active products (q, kv_a, kv_b and o projections,
    the dense layers' MLP, the router, the routed experts a token is sent
    to, the shared experts, the head) and its share of the causal attention
    (scores at nope + pe, values at v_head_dim, over the s(s+1)/2 pairs the
    mask keeps), at 2 operations a multiply-add. At DeepSeek-V2-Lite's
    widths and seq 1024 the total is 5,044,313,088."""
    d, H = config["hidden_size"], config["num_attention_heads"]
    nope, pe, vd = config["qk_nope_head_dim"], config["qk_rope_head_dim"], config["v_head_dim"]
    lora, layers = config["kv_lora_rank"], config["num_hidden_layers"]
    dense = config["first_k_dense_replace"]
    moe = layers - dense
    shared = (config["n_shared_experts"] or 0) * config["moe_intermediate_size"]
    proj = d * H * (nope + pe) + d * (lora + pe) + lora * H * (nope + vd) + H * vd * d
    parts = {
        "projections": 2.0 * layers * proj,
        "dense_mlp": 2.0 * dense * 3 * d * config["intermediate_size"],
        "router": 2.0 * moe * d * config["n_routed_experts"],
        "routed_experts": float(moe * config["num_experts_per_tok"]
                                * expert_flops_per_pair(config)),
        "shared_experts": 2.0 * moe * 3 * d * shared,
        "head": 2.0 * d * config["vocab_size"],
        "attention": 2.0 * layers * H * (nope + pe + vd) * (seq * (seq + 1) // 2) / seq,
    }
    parts["total"] = sum(parts.values())
    return parts


def mla_attention_bound(bh: int, s: int, d_qk: int, d_v: int, causal: bool,
                        elem_bytes: int = 4) -> Tuple[float, str]:
    """(bound_ms, bound_by) of one attention launch over ``bh`` heads of
    ``s`` rows: scores d_qk deep and values d_v wide over the pairs the mask
    keeps, at 2 operations a multiply-add and 67 TFLOP/s, against q and k
    (d_qk wide) and v and o (d_v wide) moved once at 3.35 TB/s, whatever
    width a kernel pads them to."""
    pairs = s * (s + 1) // 2 if causal else s * s
    t_ops = 2 * (d_qk + d_v) * pairs * bh / PEAKS["float32_flops"]
    t_bytes = 2 * bh * s * (d_qk + d_v) * elem_bytes / PEAKS["hbm_bytes_per_s"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
