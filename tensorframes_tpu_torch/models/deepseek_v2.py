"""DeepSeek-V2 as an `nn.Module` for scoring: multi-head latent attention
and routed experts.

The forward pass of the published ``modeling_deepseek.py`` (DeepSeek-V2
and V2-Lite), for configurations without query compression
(``q_lora_rank`` null), built from the published ``config.json`` keys:

- RMSNorm (``rms_norm_eps``) before attention, before the MLP and before
  the untied output head; no biases.
- MLA: queries ``x @ q`` per head ``[nope ‖ pe]`` (``qk_nope_head_dim`` +
  ``qk_rope_head_dim``); ``x @ kv_a`` gives the latent ``c_kv``
  (``kv_lora_rank``) and one ``k_pe`` shared by every head; ``c_kv`` is
  RMS-normed and expanded by ``kv_b`` into per-head ``k_nope`` and ``v``
  (``v_head_dim``). RoPE rotates each pair (2i, 2i+1) of the ``pe``
  columns of q and k by position × ``inv_freq[i]``, YaRN-scaled
  (`yarn_inv_freq`); the rotary angles are computed in float64 and their
  cosines and sines rounded once to float32. The softmax scale is
  ``(nope + pe)^-1/2 · mscale²`` (`softmax_scale`).
- Attention is one causal `flash_attention` launch a layer over
  (B · heads, S, nope + pe): V is zero-padded from ``v_head_dim`` to the
  query width (zero columns of V give zero output columns, which are
  sliced off).
- The first ``first_k_dense_replace`` layers have a dense SwiGLU MLP of
  ``intermediate_size``; the others route each token to
  ``num_experts_per_tok`` of ``n_routed_experts`` SwiGLU experts of
  ``moe_intermediate_size`` (`moe.RoutedExperts`: softmax over every
  logit, greedy top k, ``norm_topk_prob``, ``routed_scaling_factor``) and
  add ``n_shared_experts`` shared experts, one SwiGLU of
  ``n_shared_experts · moe_intermediate_size``.

Weights are a dict of float32 tensors, every matrix laid out (in, out) so
that a product is ``x @ w``: ``embed`` (V, d), ``head`` (d, V), ``norm``
(d,), and per layer i ``l{i}_attn_norm`` (d,), ``l{i}_q`` (d, H·(nope+pe)),
``l{i}_kv_a`` (d, kv_lora_rank + pe), ``l{i}_kv_norm`` (kv_lora_rank,),
``l{i}_kv_b`` (kv_lora_rank, H·(nope+v)), ``l{i}_o`` (H·v, d),
``l{i}_mlp_norm`` (d,), then either ``l{i}_gate`` / ``l{i}_up`` (d, I) and
``l{i}_down`` (I, d) (dense), or ``l{i}_router`` (d, E), the stacked
``l{i}_experts_gate_up`` (E, d, 2h: each expert's gate, then its up) and
``l{i}_experts_down`` (E, h, d), and ``l{i}_shared_gate`` /
``l{i}_shared_up`` (d, s·h), ``l{i}_shared_down`` (s·h, d).
`weight_shapes` lists them. `DeepSeekV2LM` takes the dict from its caller
as it is (no copy): a 15.7B-parameter model is drawn on the card once.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention
from .moe import RoutedExperts

__all__ = ["DeepSeekV2LM", "mla_attention", "softmax_scale", "weight_shapes", "yarn_inv_freq"]


def _yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations: float, dim: int, base: float, positions: int) -> float:
    return dim * math.log(positions / (rotations * 2 * math.pi)) / (2 * math.log(base))


def yarn_inv_freq(config: Dict) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(float64 inverse frequencies of the ``qk_rope_head_dim / 2`` rotary
    pairs, the correction range (low, high)). Without ``rope_scaling`` the
    plain ``theta^(-2i/dim)``; under YaRN the interpolated frequencies
    ``freq_extra / factor`` below the ramp between the correction dims and
    the original ones above it."""
    dim, base = config["qk_rope_head_dim"], float(config["rope_theta"])
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    rs = config.get("rope_scaling")
    if not rs:
        return extra, (0, 0)
    if rs.get("type", rs.get("rope_type")) != "yarn":
        raise ValueError(f"rope_scaling type {rs.get('type')!r}: only yarn is supported")
    orig = rs["original_max_position_embeddings"]
    low = max(math.floor(_correction_dim(rs["beta_fast"], dim, base, orig)), 0)
    high = min(math.ceil(_correction_dim(rs["beta_slow"], dim, base, orig)), dim - 1)
    ramp = (torch.arange(dim // 2, dtype=torch.float64) - low) / max(high - low, 1e-3)
    keep = 1.0 - ramp.clamp(0, 1)  # 1 where the original frequency is kept
    return extra / rs["factor"] * (1 - keep) + extra * keep, (low, high)


def softmax_scale(config: Dict) -> float:
    """``(nope + pe)^-1/2``, times ``mscale(factor, mscale_all_dim)²`` under
    YaRN."""
    scale = (config["qk_nope_head_dim"] + config["qk_rope_head_dim"]) ** -0.5
    rs = config.get("rope_scaling")
    if rs and rs.get("mscale_all_dim"):
        scale *= _yarn_mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return scale


def _rope_factor(config: Dict) -> float:
    """YaRN's factor on the cosines and sines: mscale / mscale_all_dim."""
    rs = config.get("rope_scaling")
    if not rs:
        return 1.0
    f = rs["factor"]
    return _yarn_mscale(f, rs.get("mscale", 1)) / _yarn_mscale(f, rs.get("mscale_all_dim", 0))


# published keys whose other values select mechanisms this module lacks
_ONLY = {"hidden_act": "silu", "scoring_func": "softmax", "topk_method": "greedy",
         "moe_layer_freq": 1, "attention_bias": False}


def _widths(c: Dict) -> Dict[str, int]:
    if c.get("q_lora_rank"):
        raise ValueError("DeepSeekV2LM: query compression (q_lora_rank) is not supported")
    other = {k: c[k] for k, v in _ONLY.items() if k in c and c[k] != v}
    if other:
        raise ValueError(f"DeepSeekV2LM: unsupported settings {other} (supported: {_ONLY})")
    return dict(
        d=c["hidden_size"], v=c["vocab_size"], layers=c["num_hidden_layers"],
        heads=c["num_attention_heads"], nope=c["qk_nope_head_dim"], pe=c["qk_rope_head_dim"],
        vd=c["v_head_dim"], lora=c["kv_lora_rank"], inter=c["intermediate_size"],
        experts=c["n_routed_experts"], h=c["moe_intermediate_size"],
        shared=c["n_shared_experts"] or 0, dense=c["first_k_dense_replace"],
    )


def weight_shapes(config: Dict) -> Dict[str, Tuple[int, ...]]:
    """Every weight's name and shape, in the order the benchmark draws
    them (the module docstring has the layout)."""
    w = _widths(config)
    d, H = w["d"], w["heads"]
    out: Dict[str, Tuple[int, ...]] = {"embed": (w["v"], d)}
    for i in range(w["layers"]):
        out[f"l{i}_attn_norm"] = (d,)
        out[f"l{i}_q"] = (d, H * (w["nope"] + w["pe"]))
        out[f"l{i}_kv_a"] = (d, w["lora"] + w["pe"])
        out[f"l{i}_kv_norm"] = (w["lora"],)
        out[f"l{i}_kv_b"] = (w["lora"], H * (w["nope"] + w["vd"]))
        out[f"l{i}_o"] = (H * w["vd"], d)
        out[f"l{i}_mlp_norm"] = (d,)
        if i < w["dense"]:
            out[f"l{i}_gate"] = out[f"l{i}_up"] = (d, w["inter"])
            out[f"l{i}_down"] = (w["inter"], d)
        else:
            e, h, s = w["experts"], w["h"], w["shared"] * w["h"]
            out[f"l{i}_router"] = (d, e)
            out[f"l{i}_experts_gate_up"] = (e, d, 2 * h)
            out[f"l{i}_experts_down"] = (e, h, d)
            if s:
                out[f"l{i}_shared_gate"] = out[f"l{i}_shared_up"] = (d, s)
                out[f"l{i}_shared_down"] = (s, d)
    out["norm"] = (d,)
    out["head"] = (d, w["v"])
    return out


def _rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * g


def _swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor):
    return F.silu(x @ gate).mul_(x @ up) @ down


def _rotate_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Each pair (2i, 2i+1) of x's last dim rotated by the angle whose
    cosine and sine are ``cos[..., i]`` / ``sin[..., i]`` (S, pe/2), which
    broadcast over x's (..., S, pe) leading dims."""
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1).flatten(-2)


def mla_attention(p, i: int, x: torch.Tensor, w: Dict[str, int], eps: float, scale: float,
                  rope: Optional[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """Layer i's multi-head latent attention on normed (B, S, d) input ->
    (B, S, d), with the weights ``p`` and widths ``w`` of the module
    docstring: one causal `flash_attention` launch over (B · H, S, nope +
    pe), V zero-padded to that width. ``rope`` is the (cos, sin) of
    `_rotate_pairs` that rotates the ``pe`` columns of q and k_pe, or None
    to leave them as they are (Kimi-Linear's ``mla_use_nope``)."""
    B, S, _ = x.shape
    H, nope, pe, vd = w["heads"], w["nope"], w["pe"], w["vd"]
    dq = nope + pe
    q = (x @ p[f"l{i}_q"]).view(B, S, H, dq).transpose(1, 2)  # (B, H, S, dq)
    c_kv, k_pe = (x @ p[f"l{i}_kv_a"]).split([w["lora"], pe], dim=-1)
    kv = (_rms_norm(c_kv, p[f"l{i}_kv_norm"], eps) @ p[f"l{i}_kv_b"])
    kv = kv.view(B, S, H, nope + vd).transpose(1, 2)  # (B, H, S, nope + vd)
    qs = torch.empty(B, H, S, dq, device=x.device)
    qs[..., :nope] = q[..., :nope]
    qs[..., nope:] = q[..., nope:] if rope is None else _rotate_pairs(q[..., nope:], *rope)
    ks = torch.empty_like(qs)
    ks[..., :nope] = kv[..., :nope]
    ks[..., nope:] = (k_pe if rope is None else _rotate_pairs(k_pe, *rope)).unsqueeze(1)
    vs = torch.zeros_like(qs)
    vs[..., :vd] = kv[..., nope:]
    out = flash_attention(qs.view(B * H, S, dq), ks.view(B * H, S, dq),
                          vs.view(B * H, S, dq), causal=True, scale=scale)
    out = out.view(B, H, S, dq)[..., :vd].transpose(1, 2).reshape(B, S, H * vd)
    return out @ p[f"l{i}_o"]


class DeepSeekV2LM(nn.Module):
    """(B, S) int tokens -> (B, S, vocab) float32 logits of a DeepSeek-V2
    model. ``config`` is the published ``config.json`` as a dict;
    ``params`` the weight dict of the module docstring, used as it is (its
    tensors become the module's parameters without a copy)."""

    def __init__(self, config: Dict, params: Dict[str, torch.Tensor]):
        super().__init__()
        self.config = dict(config)
        self.w = self.widths(config)
        shapes = self.weight_shapes(config)
        missing = sorted(set(shapes) - set(params))
        wrong = {k: tuple(params[k].shape) for k in shapes
                 if k in params and tuple(params[k].shape) != shapes[k]}
        if missing or wrong:
            raise ValueError(f"{type(self).__name__}: weights missing {missing}, "
                             f"misshapen {wrong}")
        self.params = nn.ParameterDict(
            {k: nn.Parameter(params[k], requires_grad=False) for k in shapes})
        self.eps = config["rms_norm_eps"]
        self.scale = softmax_scale(config)
        self.experts = self.routed_experts(config)
        self.inv_freq, _ = yarn_inv_freq(config)
        self._rope: Dict[Tuple[int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}

    # what a model of this family reads from its configuration (a subclass of
    # another family overrides them): its widths, its weights, its expert layer
    widths = staticmethod(_widths)
    weight_shapes = staticmethod(weight_shapes)

    @staticmethod
    def routed_experts(config: Dict) -> RoutedExperts:
        return RoutedExperts(config["num_experts_per_tok"], bool(config.get("norm_topk_prob")),
                             float(config.get("routed_scaling_factor", 1.0)))

    def _cos_sin(self, seq: int, device: torch.device):
        """float32 cos and sin (S, pe/2) of position × inv_freq, times
        YaRN's factor, computed in float64 once per length and device."""
        key = (seq, device)
        if key not in self._rope:
            ang = torch.arange(seq, dtype=torch.float64)[:, None] * self.inv_freq[None]
            f = _rope_factor(self.config)
            self._rope[key] = tuple((t * f).float().to(device) for t in (ang.cos(), ang.sin()))
        return self._rope[key]

    def attention(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Layer i's MLA on normed (B, S, d) input -> (B, S, d)
        (`mla_attention`, the ``pe`` columns rotated)."""
        return mla_attention(self.params, i, x, self.w, self.eps, self.scale,
                             self._cos_sin(x.shape[1], x.device))

    def expert_weights(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer i's weights as `RoutedExperts` takes them."""
        p = self.params
        return {"router": p[f"l{i}_router"], "gate_up": p[f"l{i}_experts_gate_up"],
                "down": p[f"l{i}_experts_down"]}

    def shared_experts(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Layer i's shared experts on (N, d) normed rows (zero without any)."""
        p = self.params
        if f"l{i}_shared_gate" not in p:
            return torch.zeros_like(x)
        return _swiglu(x, p[f"l{i}_shared_gate"], p[f"l{i}_shared_up"], p[f"l{i}_shared_down"])

    def mlp(self, i: int, x: torch.Tensor):
        """Layer i's MLP on normed (B, S, d) input: (the dense SwiGLU, None),
        or (the routed experts plus the shared ones, the (B·S, k) experts
        each token was routed to)."""
        p = self.params
        if i < self.w["dense"]:
            return _swiglu(x, p[f"l{i}_gate"], p[f"l{i}_up"], p[f"l{i}_down"]), None
        flat = x.reshape(-1, x.shape[-1])
        routed, experts = self.experts(self.expert_weights(i), flat)
        return (routed + self.shared_experts(i, flat)).view_as(x), experts

    def forward(self, tokens: torch.Tensor, routing: bool = False):
        """(B, S) tokens -> (B, S, V) logits; with ``routing`` also the
        experts each token was routed to, (B, S, MoE layers, k) int64, in
        layer order (what a check needs to tell a near-tie from a fault)."""
        p = self.params
        h = p["embed"][tokens.long()]
        routes = []
        for i in range(self.w["layers"]):
            h = h + self.attention(i, _rms_norm(h, p[f"l{i}_attn_norm"], self.eps))
            out, experts = self.mlp(i, _rms_norm(h, p[f"l{i}_mlp_norm"], self.eps))
            h = h + out
            if routing and experts is not None:
                routes.append(experts)
        logits = _rms_norm(h, p["norm"], self.eps) @ p["head"]
        if not routing:
            return logits
        b, s = tokens.shape
        k = self.experts.top_k
        return logits, (torch.stack(routes, dim=1).view(b, s, len(routes), k) if routes
                        else torch.empty(b, s, 0, k, dtype=torch.int64, device=logits.device))
