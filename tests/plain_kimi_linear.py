"""Kimi-Linear's forward pass in plain float32 PyTorch: the reference the
Kimi-Linear scoring cell's logits are held to.

It follows the published Kimi-Linear-48B-A3B configuration and the layer as
the Kimi Linear technical report and flash-linear-attention's
``KimiDeltaAttention`` describe it, written from those equations and not
from the program under test:

- RMSNorm (``rms_norm_eps``) before the token mixer, before the MLP and
  before the untied head; no biases.
- The token mixer of layer i (1-based lists of ``linear_attn_config``):
  - Kimi Delta Attention (``kda_layers``): q, k, v = SiLU(causal depthwise
    convolution of x @ W_q, x @ W_k, x @ W_v), each channel with its own
    filter of ``short_conv_kernel_size`` taps (written here as a sum of
    shifted products, zero before the start); q and k L2-normalised per head
    (eps 1e-6); the log-decay g = -exp(A_log[h]) * softplus(x @ F_a @ F_b +
    dt_bias) per head and channel; beta = sigmoid(x @ W_b) per head; then,
    token by token, batched over sequences and heads only, the state S (dk x
    dv) zero at the start:
    u_t = v_t - (Diag(exp(g_t)) S)^T k_t; S = Diag(exp(g_t)) S + beta_t k_t
    u_t^T; o_t = dk^-1/2 S^T q_t; and the output W_o (RMSNorm_head(o) * w *
    sigmoid(x @ G_a @ G_b)).
  - multi-head latent attention (``full_attn_layers``) without position
    encoding (``mla_use_nope``): queries per head [nope | pe], the latent
    c_kv RMS-normed and expanded into per-head k_nope and v, one k_pe shared
    by the heads, left unrotated; plain materialised causal attention, the
    softmax in float32, scale (nope + pe)^-1/2.
- The first ``first_k_dense_replace`` layers a dense SwiGLU MLP; the others
  DeepSeek-V3's ``noaux_tc`` router with one group: scores s =
  sigmoid(x @ W_r) over every published expert, the top k of s + b (b the
  selection bias), the weights s at those experts renormalised (sum + 1e-20)
  and times ``routed_scaling_factor``; each routed token's experts computed
  expert by expert over the rows routed to it, only for the experts of the
  held range ``experts_held`` (the chip's share), plus the shared experts
  once.

Departures, which the configuration file lists too: random weights, and
scoring only (no cache, no training path). It imports no part of the program
under test, uses no fused kernel, and runs its matrix products in full
float32 (TF32 off) unless the caller asks for TF32, which is how one
precision control is computed; the others are keywords of `forward`: the KDA
state rounded to bfloat16 after every token, the delta correction dropped
(u_t = v_t), the short convolution left out.

`near_ties` flags a token whose k-th and (k+1)-th selection scores (s + b)
lie closer than a gap in some MoE layer: there two float32 summation orders
may pick different experts, and one such pick moves that token's hidden
state, and through attention and the recurrence every later token's, far
more than rounding does. So `forward` can follow the routing a program
reports (``follow``) inside that band (`follow_routing`), counting each
token-layer where the report lies outside it. The weights are always the
reference's own scores at the experts taken.

Weights come as a dict, every matrix (in, out): ``embed`` (V, d), ``head``
(d, V), ``norm`` (d,), and per layer i ``l{i}_attn_norm``; for a KDA layer
``l{i}_kda_qkv`` (d, 3 H D: q's columns, then k's, then v's),
``l{i}_kda_conv`` (3 H D, K), ``l{i}_kda_f_a``, ``l{i}_kda_f_b``,
``l{i}_kda_A_log`` (H,), ``l{i}_kda_dt_bias`` (H D,), ``l{i}_kda_b``,
``l{i}_kda_g_a``, ``l{i}_kda_g_b``, ``l{i}_kda_o_norm`` (D,),
``l{i}_kda_o``; for an MLA layer ``l{i}_q``, ``l{i}_kv_a``,
``l{i}_kv_norm``, ``l{i}_kv_b``, ``l{i}_o``; then ``l{i}_mlp_norm``, and
``l{i}_gate`` / ``l{i}_up`` / ``l{i}_down`` (dense) or ``l{i}_router`` (d,
E), ``l{i}_router_bias`` (E,), ``l{i}_experts_gate_up`` (held, d, 2h: each
expert's gate, then its up), ``l{i}_experts_down`` (held, h, d) and
``l{i}_shared_gate`` / ``l{i}_shared_up`` / ``l{i}_shared_down``. This file
is kept identical in ``tests/plain_kimi_linear.py`` (the test suite's copy)
and ``portbench/reference/kimi_linear.py`` (the benchmark's).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

__all__ = ["follow_routing", "forward", "forward_blocks", "held_range", "matmul_precision",
           "near_ties", "route"]


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


def held_range(config: Dict) -> Tuple[int, Tuple[int, int]]:
    """(every expert the router scores: the published count, the experts
    held here [lo, hi))."""
    total = config.get("published", {}).get("num_experts", config["num_experts"])
    lo, hi = config.get("experts_held", (0, total))
    return total, (lo, hi)


def _rms_norm(x, weight, eps):
    variance = x.pow(2).mean(-1, keepdim=True)
    return weight * (x * torch.rsqrt(variance + eps))


def _mlp(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


# --- Kimi Delta Attention ---------------------------------------------------

def _causal_conv(x, filters, conv=True):
    """(B, S, C) through a causal depthwise convolution of (C, K) filters:
    out[t] = sum_j filters[:, j] * x[t - (K - 1) + j]; ``conv`` False leaves
    it out (a control)."""
    if not conv:
        return x
    taps = filters.shape[1]
    padded = F.pad(x, (0, 0, taps - 1, 0))
    out = torch.zeros_like(x)
    for j in range(taps):
        out = out + padded[:, j:j + x.shape[1]] * filters[:, j]
    return out


def _l2_normalize(x, eps=1e-6):
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + eps)


def _kda_recurrence(q, k, g, beta, v, delta=True, state_dtype=torch.float32):
    """(B, S, H, D) q, k, g, v and (B, S, H) beta -> o (B, S, H, D), token by
    token. ``delta`` False drops the delta correction (u_t = v_t);
    ``state_dtype`` rounds the state to it after every token."""
    bsz, seq, heads, dk = q.shape
    state = torch.zeros(bsz, heads, dk, v.shape[-1], dtype=q.dtype, device=q.device)
    out = torch.empty_like(v)
    for t in range(seq):
        decayed = torch.exp(g[:, t]).unsqueeze(-1) * state            # Diag(alpha) S
        k_t = k[:, t].unsqueeze(-1)                                    # (B, H, dk, 1)
        u = v[:, t] - (decayed * k_t).sum(dim=-2) if delta else v[:, t]
        state = decayed + beta[:, t, :, None, None] * (k_t * u.unsqueeze(-2))
        if state_dtype != torch.float32:
            state = state.to(state_dtype).float()
        out[:, t] = (state * q[:, t].unsqueeze(-1)).sum(dim=-2) * dk ** -0.5
    return out


def _kda(w, i, x, config, delta=True, state_dtype=torch.float32, conv=True):
    bsz, seq, _ = x.shape
    lac, eps = config["linear_attn_config"], config["rms_norm_eps"]
    heads, dim = lac["num_heads"], lac["head_dim"]
    width = heads * dim
    proj = x @ w[f"l{i}_kda_qkv"]
    filters = w[f"l{i}_kda_conv"]
    q, k, v = (F.silu(_causal_conv(proj[..., j * width:(j + 1) * width],
                                   filters[j * width:(j + 1) * width], conv))
               .view(bsz, seq, heads, dim) for j in range(3))
    q, k = _l2_normalize(q), _l2_normalize(k)
    decay = F.softplus(x @ w[f"l{i}_kda_f_a"] @ w[f"l{i}_kda_f_b"] + w[f"l{i}_kda_dt_bias"])
    g = -torch.exp(w[f"l{i}_kda_A_log"])[:, None] * decay.view(bsz, seq, heads, dim)
    beta = torch.sigmoid(x @ w[f"l{i}_kda_b"])
    o = _kda_recurrence(q, k, g, beta, v, delta, state_dtype)
    gate = (x @ w[f"l{i}_kda_g_a"] @ w[f"l{i}_kda_g_b"]).view(bsz, seq, heads, dim)
    o = _rms_norm(o, w[f"l{i}_kda_o_norm"], eps) * torch.sigmoid(gate)
    return o.reshape(bsz, seq, width) @ w[f"l{i}_kda_o"]


# --- MLA without position encoding ------------------------------------------

def _mla(w, i, x, config):
    bsz, q_len, _ = x.shape
    heads = config["num_attention_heads"]
    nope, pe, vd = config["qk_nope_head_dim"], config["qk_rope_head_dim"], config["v_head_dim"]
    lora = config["kv_lora_rank"]
    q = (x @ w[f"l{i}_q"]).view(bsz, q_len, heads, nope + pe).transpose(1, 2)
    compressed_kv, k_pe = torch.split(x @ w[f"l{i}_kv_a"], [lora, pe], dim=-1)
    k_pe = k_pe.view(bsz, q_len, 1, pe).transpose(1, 2)
    kv = (_rms_norm(compressed_kv, w[f"l{i}_kv_norm"], config["rms_norm_eps"])
          @ w[f"l{i}_kv_b"]).view(bsz, q_len, heads, nope + vd).transpose(1, 2)
    k_nope, value_states = torch.split(kv, [nope, vd], dim=-1)
    key_states = torch.cat([k_nope, k_pe.expand(bsz, heads, q_len, pe)], dim=-1)
    scores = (q @ key_states.transpose(2, 3)) * (nope + pe) ** -0.5
    mask = torch.ones(q_len, q_len, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(scores.masked_fill(mask, float("-inf")), dim=-1, dtype=torch.float32)
    out = (probs @ value_states).transpose(1, 2).reshape(bsz, q_len, heads * vd)
    return out @ w[f"l{i}_o"]


# --- the routed experts -----------------------------------------------------

def _weights_at(scores, idx, config):
    weight = scores.gather(1, idx)
    if config["moe_renormalize"]:
        weight = weight / (weight.sum(dim=-1, keepdim=True) + 1e-20)
    return weight * config["routed_scaling_factor"]


def route(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor, config: Dict):
    """(top-k weights, top-k experts, (N, E) selection scores s + b, (N, E)
    scores s) of (N, d) rows under the sigmoid rule."""
    scores = torch.sigmoid(x @ router)
    choice = scores + bias
    _, idx = torch.topk(choice, k=config["num_experts_per_token"], dim=-1, sorted=True)
    return _weights_at(scores, idx, config), idx, choice, scores


def near_ties(choice: torch.Tensor, k: int, gap: float) -> torch.Tensor:
    """(N,) True where a row's k-th and (k+1)-th selection scores lie closer
    than ``gap``."""
    top = choice.topk(k + 1, dim=-1).values
    return (top[:, k - 1] - top[:, k]) < gap


def follow_routing(choice: torch.Tensor, own: torch.Tensor, theirs: torch.Tensor,
                   gap: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(experts (N, k), wrong (N,) bool): per row ``theirs`` where it holds
    k distinct experts, every expert whose selection score lies more than
    ``gap`` above the (k+1)-th largest, and none whose score lies more than
    ``gap`` below the k-th largest; else ``own``, and ``wrong`` True."""
    k = own.shape[1]
    top = choice.topk(k + 1, dim=-1).values
    sure_in = choice > top[:, k:k + 1] + gap
    sure_out = choice < top[:, k - 1:k] - gap
    valid = (theirs >= 0) & (theirs < choice.shape[1])
    taken = torch.zeros_like(choice, dtype=torch.bool).scatter_(
        1, theirs.clamp(0, choice.shape[1] - 1), True)
    ok = (valid.all(dim=1) & (taken.sum(dim=1) == k) & ~(sure_in & ~taken).any(dim=1)
          & ~(sure_out & taken).any(dim=1))
    return torch.where(ok[:, None], theirs, own), ~ok


def _moe(w, i, x, config, follow=None, gap=0.0):
    """The MoE layer over (N, d) rows: the held experts over their routed
    rows, plus the shared experts. Returns (out, selection scores, experts
    taken (N, k), rows routed wrongly (N,) bool)."""
    weights, idx, choice, scores = route(x, w[f"l{i}_router"], w[f"l{i}_router_bias"], config)
    wrong = torch.zeros(len(x), dtype=torch.bool, device=x.device)
    if follow is not None:
        idx, wrong = follow_routing(choice, idx, follow, gap)
        weights = _weights_at(scores, idx, config)
    _, (lo, hi) = held_range(config)
    out = torch.zeros_like(x)
    for e in range(lo, hi):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        gate, up = w[f"l{i}_experts_gate_up"][e - lo].chunk(2, dim=-1)
        y = _mlp(x[tok], gate, up, w[f"l{i}_experts_down"][e - lo])
        out.index_add_(0, tok, y * weights[tok, slot, None])
    if config.get("num_shared_experts"):
        out = out + _mlp(x, w[f"l{i}_shared_gate"], w[f"l{i}_shared_up"],
                         w[f"l{i}_shared_down"])
    return out, choice, idx, wrong


@torch.no_grad()
def forward(weights: Dict[str, torch.Tensor], tokens: torch.Tensor, config: Dict,
            tie_gap: float = 0.0, follow=None, delta: bool = True,
            state_dtype: torch.dtype = torch.float32, conv: bool = True):
    """(B, S) token ids -> ((B, S, V) float32 logits, (B, S) near-tie mask:
    True where some MoE layer's k-th and (k+1)-th selection scores lie
    closer than ``tie_gap``, (B, S) count of MoE layers at which ``follow``
    lay outside the band, (B, S, MoE layers, k) experts taken). ``follow``:
    a program's routing in that layout, followed within the band
    ``tie_gap`` (`follow_routing`), or None. ``delta``, ``state_dtype`` and
    ``conv`` are the controls' departures in every KDA layer."""
    w, eps = weights, config["rms_norm_eps"]
    bsz, seq = tokens.shape
    k = config["num_experts_per_token"]
    dense = config["first_k_dense_replace"]
    kda_layers = {j - 1 for j in config["linear_attn_config"]["kda_layers"]}
    tied = torch.zeros(bsz * seq, dtype=torch.bool, device=tokens.device)
    wrong = torch.zeros(bsz * seq, dtype=torch.int64, device=tokens.device)
    taken = []
    h = w["embed"][tokens.long()]
    for i in range(config["num_hidden_layers"]):
        x = _rms_norm(h, w[f"l{i}_attn_norm"], eps)
        if i in kda_layers:
            h = h + _kda(w, i, x, config, delta, state_dtype, conv)
        else:
            h = h + _mla(w, i, x, config)
        x = _rms_norm(h, w[f"l{i}_mlp_norm"], eps)
        if i < dense:
            h = h + _mlp(x, w[f"l{i}_gate"], w[f"l{i}_up"], w[f"l{i}_down"])
            continue
        theirs = None if follow is None else follow[:, :, i - dense].reshape(bsz * seq, k)
        out, choice, idx, off = _moe(w, i, x.reshape(bsz * seq, -1), config, theirs, tie_gap)
        h = h + out.view_as(h)
        tied |= near_ties(choice, k, tie_gap)
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
