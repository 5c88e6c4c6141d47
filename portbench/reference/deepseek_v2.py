"""DeepSeek-V2's forward pass in plain float32 PyTorch: the reference the
DeepSeek-V2-Lite scoring cell's logits are held to.

It follows the published ``modeling_deepseek.py`` (DeepSeek-V2 and
V2-Lite, query compression off: ``q_lora_rank`` null) line by line:
RMSNorm; multi-head latent attention (queries per head ``[nope ‖ pe]``, the
latent ``c_kv`` RMS-normed and expanded into per-head ``k_nope`` and ``v``,
one ``k_pe`` shared by the heads); the published RoPE layout (the ``pe``
columns de-interleaved, then rotated half against half) under YaRN scaling;
plain materialised causal attention with the softmax in float32, values at
their own width ``v_head_dim``; the first ``first_k_dense_replace`` layers
a dense SwiGLU MLP, the others ``MoEGate`` (softmax over every logit, greedy
top k, ``norm_topk_prob``, ``routed_scaling_factor``) with each routed
token's experts computed expert by expert over the rows routed to it, plus
the shared experts; a final RMSNorm and an untied head.

Departures, which the configuration file lists too: random weights, and
scoring only (no cache, no training path, no auxiliary loss). The rotary
angles are computed in float64 and their cosines and sines rounded once to
float32. It imports no part of the program under test, uses no fused
attention kernel, and runs its matrix products in full float32 (TF32 off)
unless the caller asks for TF32, which is how one precision control is
computed; the others are keywords of `forward`: the router's product or
the routed experts' products in bfloat16, the top-k weights renormalised,
the shared experts left out.

`near_ties` flags a token whose k-th and (k+1)-th gate logits lie closer
than a gap in some MoE layer: there two float32 summation orders may pick
different experts. One such pick moves that token's hidden state far more
than rounding does, and, through attention, every later token of its
sequence. So `forward` can follow the routing a program reports
(``follow``): at each MoE layer a token takes the program's experts where
they differ from the reference's own only inside the near-tie band (no
expert whose logit lies more than the gap above the (k+1)-th left out, none
more than the gap below the k-th taken), and keeps its own otherwise,
counting that layer as routed wrongly (`follow_routing`). The weights are
always the reference's own softmax at the experts taken.

Weights come as a dict, every matrix (in, out): ``embed`` (V, d), ``head``
(d, V), ``norm`` (d,), and per layer i ``l{i}_attn_norm``, ``l{i}_q``,
``l{i}_kv_a``, ``l{i}_kv_norm``, ``l{i}_kv_b``, ``l{i}_o``,
``l{i}_mlp_norm``, then ``l{i}_gate`` / ``l{i}_up`` / ``l{i}_down`` (dense)
or ``l{i}_router`` (d, E), ``l{i}_experts_gate_up`` (E, d, 2h: each
expert's gate, then its up), ``l{i}_experts_down`` (E, h, d) and
``l{i}_shared_gate`` /
``l{i}_shared_up`` / ``l{i}_shared_down``. This file is kept identical in
``tests/plain_deepseek_v2.py`` (the test suite's copy) and
``portbench/reference/deepseek_v2.py`` (the benchmark's).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

__all__ = ["follow_routing", "forward", "forward_blocks", "matmul_precision", "near_ties",
           "route", "softmax_scale", "yarn_correction_range"]


@contextlib.contextmanager
def matmul_precision(tf32: bool) -> Iterator[None]:
    """Run the products inside with TF32 on or off, and restore the flags."""
    cuda, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


# --- YaRN, as modeling_deepseek.py writes it --------------------------------

def _find_correction_dim(num_rotations, dim, base, max_position_embeddings):
    return (dim * math.log(max_position_embeddings / (num_rotations * 2 * math.pi))) / (
        2 * math.log(base))


def yarn_correction_range(config: Dict) -> Tuple[int, int]:
    rs, dim, base = config["rope_scaling"], config["qk_rope_head_dim"], config["rope_theta"]
    orig = rs["original_max_position_embeddings"]
    low = math.floor(_find_correction_dim(rs["beta_fast"], dim, base, orig))
    high = math.ceil(_find_correction_dim(rs["beta_slow"], dim, base, orig))
    return max(low, 0), min(high, dim - 1)


def _get_mscale(scale=1.0, mscale=1.0):
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def softmax_scale(config: Dict) -> float:
    scale = (config["qk_nope_head_dim"] + config["qk_rope_head_dim"]) ** -0.5
    rs = config.get("rope_scaling")
    if rs is not None and rs.get("mscale_all_dim", 0):
        m = _get_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def _cos_sin(config: Dict, seq: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, pe) cosines and sines of ``cat(freqs, freqs)``, as the published
    ``DeepseekV2YarnRotaryEmbedding`` caches them (angles in float64 here)."""
    dim, base = config["qk_rope_head_dim"], config["rope_theta"]
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim))
    rs = config.get("rope_scaling")
    if rs is None:
        inv_freq, m = freq_extra, 1.0
    else:
        freq_inter = freq_extra / rs["factor"]
        low, high = yarn_correction_range(config)
        if low == high:
            high += 0.001
        ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low) / (high - low)).clamp(0, 1)
        inv_freq_mask = 1.0 - ramp
        inv_freq = freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask
        m = _get_mscale(rs["factor"], rs.get("mscale", 1)) / _get_mscale(
            rs["factor"], rs.get("mscale_all_dim", 0))
    freqs = torch.outer(torch.arange(seq, dtype=torch.float64), inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    return (emb.cos() * m).float().to(device), (emb.sin() * m).float().to(device)


def _rotate_half(x):
    x1, x2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def _apply_rotary(x, cos, sin):
    """The published ``apply_rotary_pos_emb`` on one (b, h, s, d) tensor."""
    b, h, s, d = x.shape
    x = x.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    return (x * cos) + (_rotate_half(x) * sin)


# --- the blocks -------------------------------------------------------------

def _rms_norm(x, weight, eps):
    variance = x.pow(2).mean(-1, keepdim=True)
    return weight * (x * torch.rsqrt(variance + eps))


def _mlp(x, gate, up, down, dtype=torch.float32):
    if dtype != torch.float32:
        x, gate, up, down = (t.to(dtype) for t in (x, gate, up, down))
    return ((F.silu(x @ gate) * (x @ up)) @ down).float()


def _attention(w, i, x, config, cos, sin):
    bsz, q_len, _ = x.shape
    H = config["num_attention_heads"]
    nope, pe, vd = config["qk_nope_head_dim"], config["qk_rope_head_dim"], config["v_head_dim"]
    lora = config["kv_lora_rank"]
    q = (x @ w[f"l{i}_q"]).view(bsz, q_len, H, nope + pe).transpose(1, 2)
    q_nope, q_pe = torch.split(q, [nope, pe], dim=-1)
    compressed_kv = x @ w[f"l{i}_kv_a"]
    compressed_kv, k_pe = torch.split(compressed_kv, [lora, pe], dim=-1)
    k_pe = k_pe.view(bsz, q_len, 1, pe).transpose(1, 2)
    kv = (_rms_norm(compressed_kv, w[f"l{i}_kv_norm"], config["rms_norm_eps"])
          @ w[f"l{i}_kv_b"]).view(bsz, q_len, H, nope + vd).transpose(1, 2)
    k_nope, value_states = torch.split(kv, [nope, vd], dim=-1)
    q_pe, k_pe = _apply_rotary(q_pe, cos, sin), _apply_rotary(k_pe, cos, sin)
    query_states = torch.cat([q_nope, q_pe], dim=-1)
    key_states = torch.cat([k_nope, k_pe.expand(bsz, H, q_len, pe)], dim=-1)
    scores = (query_states @ key_states.transpose(2, 3)) * softmax_scale(config)
    mask = torch.ones(q_len, q_len, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(scores.masked_fill(mask, float("-inf")), dim=-1, dtype=torch.float32)
    out = (probs @ value_states).transpose(1, 2).reshape(bsz, q_len, H * vd)
    return out @ w[f"l{i}_o"]


def _topk_weight(scores, idx, renormalize, scaling):
    topk_weight = scores.gather(1, idx)
    if idx.shape[1] > 1 and renormalize:
        topk_weight = topk_weight / (topk_weight.sum(dim=-1, keepdim=True) + 1e-20)
    return topk_weight * scaling


def route(x: torch.Tensor, router: torch.Tensor, k: int, renormalize: bool = False,
          scaling: float = 1.0, dtype: torch.dtype = torch.float32):
    """``MoEGate`` (greedy): (top-k weights, top-k experts, float32 gate
    logits) of (N, d) rows, the logits' product computed in ``dtype``."""
    logits = (x.to(dtype) @ router.to(dtype)).float()
    scores = logits.softmax(dim=-1, dtype=torch.float32)
    _, topk_idx = torch.topk(scores, k=k, dim=-1, sorted=True)
    return _topk_weight(scores, topk_idx, renormalize, scaling), topk_idx, logits


def near_ties(logits: torch.Tensor, k: int, gap: float) -> torch.Tensor:
    """(N,) True where a row's k-th and (k+1)-th largest gate logits lie
    closer than ``gap``."""
    top = logits.topk(k + 1, dim=-1).values
    return (top[:, k - 1] - top[:, k]) < gap


def follow_routing(logits: torch.Tensor, own: torch.Tensor, theirs: torch.Tensor,
                   gap: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(experts (N, k), wrong (N,) bool): per row ``theirs`` where it holds
    k distinct experts, every expert whose logit lies more than ``gap``
    above the (k+1)-th largest, and none whose logit lies more than ``gap``
    below the k-th largest; else ``own``, and ``wrong`` True."""
    k = own.shape[1]
    top = logits.topk(k + 1, dim=-1).values
    sure_in = logits > top[:, k:k + 1] + gap
    sure_out = logits < top[:, k - 1:k] - gap
    taken = torch.zeros_like(logits, dtype=torch.bool).scatter_(1, theirs, True)
    ok = ((taken.sum(dim=1) == k) & ~(sure_in & ~taken).any(dim=1)
          & ~(sure_out & taken).any(dim=1))
    return torch.where(ok[:, None], theirs, own), ~ok


def _moe(w, i, x, config, experts_dtype, renormalize, shared, follow=None, gap=0.0,
         router_dtype=torch.float32):
    """The MoE layer over (N, d) rows: routed experts expert by expert over
    their routed rows, plus the shared experts. ``follow``: the (N, k)
    experts a program took, followed within the near-tie band ``gap``.
    Returns (out, gate logits, experts taken (N, k), rows routed wrongly
    (N,) bool)."""
    k = config["num_experts_per_tok"]
    renormalize = config.get("norm_topk_prob", False) if renormalize is None else renormalize
    scaling = config.get("routed_scaling_factor", 1.0)
    weights, idx, logits = route(x, w[f"l{i}_router"], k, renormalize, scaling, router_dtype)
    wrong = torch.zeros(len(x), dtype=torch.bool, device=x.device)
    if follow is not None:
        idx, wrong = follow_routing(logits, idx, follow, gap)
        weights = _topk_weight(logits.softmax(dim=-1, dtype=torch.float32), idx, renormalize,
                               scaling)
    out = torch.zeros_like(x)
    for e in range(config["n_routed_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        gate, up = w[f"l{i}_experts_gate_up"][e].chunk(2, dim=-1)
        y = _mlp(x[tok], gate, up, w[f"l{i}_experts_down"][e], experts_dtype)
        out.index_add_(0, tok, y * weights[tok, slot, None])
    if shared and config.get("n_shared_experts"):
        out = out + _mlp(x, w[f"l{i}_shared_gate"], w[f"l{i}_shared_up"],
                         w[f"l{i}_shared_down"])
    return out, logits, idx, wrong


@torch.no_grad()
def forward(weights: Dict[str, torch.Tensor], tokens: torch.Tensor, config: Dict,
            tie_gap: float = 0.0, follow=None, experts_dtype: torch.dtype = torch.float32,
            renormalize=None, shared: bool = True, router_dtype: torch.dtype = torch.float32):
    """(B, S) token ids -> ((B, S, V) float32 logits, (B, S) near-tie mask:
    True where some MoE layer's k-th and (k+1)-th gate logits lie closer
    than ``tie_gap``, (B, S) count of MoE layers at which ``follow`` lay
    outside the band, (B, S, MoE layers, k) experts taken). ``follow``: a
    program's routing in that layout, followed within the band ``tie_gap``
    (`follow_routing`), or None.
    ``router_dtype``, ``experts_dtype``, ``renormalize`` (None: the
    config's ``norm_topk_prob``) and ``shared`` are the precision controls'
    departures."""
    w, eps = weights, config["rms_norm_eps"]
    bsz, seq = tokens.shape
    k = config["num_experts_per_tok"]
    cos, sin = _cos_sin(config, seq, tokens.device)
    tied = torch.zeros(bsz * seq, dtype=torch.bool, device=tokens.device)
    wrong = torch.zeros(bsz * seq, dtype=torch.int64, device=tokens.device)
    taken = []
    h = w["embed"][tokens.long()]
    for i in range(config["num_hidden_layers"]):
        h = h + _attention(w, i, _rms_norm(h, w[f"l{i}_attn_norm"], eps), config, cos, sin)
        x = _rms_norm(h, w[f"l{i}_mlp_norm"], eps)
        if i < config["first_k_dense_replace"]:
            h = h + _mlp(x, w[f"l{i}_gate"], w[f"l{i}_up"], w[f"l{i}_down"])
        else:
            theirs = None
            if follow is not None:
                theirs = follow[:, :, i - config["first_k_dense_replace"]].reshape(bsz * seq, k)
            out, logits, idx, off = _moe(w, i, x.reshape(bsz * seq, -1), config,
                                         experts_dtype, renormalize, shared, theirs, tie_gap,
                                         router_dtype)
            h = h + out.view_as(h)
            tied |= near_ties(logits, k, tie_gap)
            wrong += off
            taken.append(idx.view(bsz, seq, k))
    experts = (torch.stack(taken, dim=2) if taken
               else torch.empty(bsz, seq, 0, k, dtype=torch.int64, device=tokens.device))
    return (_rms_norm(h, w["norm"], eps) @ w["head"], tied.view(bsz, seq),
            wrong.view(bsz, seq), experts)


def forward_blocks(weights: Dict[str, torch.Tensor], tokens: torch.Tensor, config: Dict,
                   block: int, follow=None, **kw) -> Iterator[Tuple[torch.Tensor, ...]]:
    """`forward` of ``block`` sequences at a time (``follow`` split alike),
    so that the whole batch's scores and logits need not fit at once."""
    for lo in range(0, tokens.shape[0], block):
        yield forward(weights, tokens[lo:lo + block], config,
                      follow=None if follow is None else follow[lo:lo + block], **kw)
