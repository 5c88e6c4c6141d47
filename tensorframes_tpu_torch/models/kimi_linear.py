"""Kimi-Linear as an `nn.Module` for scoring: Kimi Delta Attention (KDA)
layers beside multi-head latent attention without RoPE, and sigmoid-routed
experts.

The forward pass of the published Kimi-Linear-48B-A3B (its ``config.json``
keys; the layer as the Kimi Linear technical report and
flash-linear-attention's ``KimiDeltaAttention`` describe it). The residual
stream is DeepSeek-V2's (`deepseek_v2.DeepSeekV2LM`, which this class
extends): RMSNorm (``rms_norm_eps``), the token mixer, RMSNorm, the MLP;
no biases; a final RMSNorm and an untied head. Each layer's token mixer is
taken from ``linear_attn_config``, whose lists are 1-based:

- a KDA layer (``kda_layers``), on normed x (S x d), H = ``num_heads``
  heads of D = ``head_dim`` channels (128, the kernel's width, on a card),
  K = ``short_conv_kernel_size``: q, k, v = SiLU(causal depthwise conv_K(x @ W)) of one product
  ``l{i}_kda_qkv`` (d, 3·H·D), each channel its own filter
  (``l{i}_kda_conv`` (3·H·D, K), no bias, zero before a sequence's start);
  q and k L2-normalised per head (eps 1e-6); the log-decay per head and
  channel g = -exp(A_log[h]) · softplus(x @ F_a @ F_b + dt_bias); beta =
  sigmoid(x @ W_b), one a head; the recurrence of `ops.kda` (one launch of
  ``csrc/kda.cu`` a layer on the card); then W_o · (RMSNorm_head(o) ⊙ w ⊙
  sigmoid(x @ G_a @ G_b)), the norm over each head's D channels.
- an MLA layer (``full_attn_layers``): `deepseek_v2.mla_attention` with the
  ``pe`` columns of q and k_pe left unrotated (``mla_use_nope``), softmax
  scale (nope + pe)^-1/2, one `flash_attention` launch a layer.

The first ``first_k_dense_replace`` layers have a dense SwiGLU MLP of
``intermediate_size``; the others route each token to
``num_experts_per_token`` SwiGLU experts of ``moe_intermediate_size``
(`moe.RoutedExperts`, the ``sigmoid`` rule: the top k of sigmoid(x @ W_r) +
the selection bias, weighted by the sigmoid, renormalised
(``moe_renormalize``), times ``routed_scaling_factor``) and add
``num_shared_experts`` shared experts. The router spans all the published
experts; the layer holds those of ``experts_held`` = [lo, hi) (by default
all of them): a chip's share of a deployment whose experts are divided over
chips. Where ``num_experts`` was cut to the share held, the configuration
gives the published count under ``published``.

Weights are a dict of float32 tensors, matrices laid out (in, out):
``embed`` (V, d), ``head`` (d, V), ``norm`` (d,), and per layer i
``l{i}_attn_norm`` (d,), then the KDA layer's ``l{i}_kda_qkv``,
``l{i}_kda_conv``, ``l{i}_kda_f_a`` (d, D), ``l{i}_kda_f_b`` (D, H·D),
``l{i}_kda_A_log`` (H,), ``l{i}_kda_dt_bias`` (H·D,), ``l{i}_kda_b`` (d,
H), ``l{i}_kda_g_a`` (d, D), ``l{i}_kda_g_b`` (D, H·D), ``l{i}_kda_o_norm``
(D,), ``l{i}_kda_o`` (H·D, d), or the MLA layer's weights of
`deepseek_v2.weight_shapes`; ``l{i}_mlp_norm`` (d,), then the dense MLP's,
or ``l{i}_router`` (d, E), ``l{i}_router_bias`` (E,), the held experts'
``l{i}_experts_gate_up`` (hi - lo, d, 2h) and ``l{i}_experts_down`` (hi -
lo, h, d), and the shared experts'. `weight_shapes` lists them.

Spans (`utils.telemetry`, kind ``stage``, timed on the card) hold the KDA
layer's own work and none of its products (cuBLAS's, as in every other
layer): ``kda.prep`` (the convolutions, SiLU, the L2 norms, the decay and
beta from their products), ``kda.core`` (the kernel), ``kda.out`` (the
output gate's sigmoid and the gated norm). Counters (`utils.profiling`):
``kda.layers``, ``kda.tokens`` (tokens through a KDA layer) and, from
`ops.kda`, ``kda.launches``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from ..ops.kda import kda
from ..utils import telemetry as _tele
from ..utils.profiling import count as _count
from .deepseek_v2 import DeepSeekV2LM, _rms_norm, mla_attention
from .moe import RoutedExperts

__all__ = ["KimiLinearLM", "layer_kinds", "routed_widths", "weight_shapes"]

_L2_EPS = 1e-6  # fla's l2norm: x / sqrt(sum x^2 + eps)

# published keys whose other values select mechanisms this module lacks
_ONLY = {"hidden_act": "silu", "moe_router_activation_func": "sigmoid", "moe_layer_freq": 1,
         "mla_use_nope": True, "num_expert_group": 1, "topk_group": 1,
         "tie_word_embeddings": False}


def layer_kinds(config: Dict) -> List[str]:
    """Each layer's token mixer, 0-based: "kda" or "mla", from the 1-based
    lists of ``linear_attn_config``, which must cover every layer once."""
    lac, n = config["linear_attn_config"], config["num_hidden_layers"]
    kinds = {i - 1: "kda" for i in lac["kda_layers"]}
    for i in lac["full_attn_layers"]:
        if i - 1 in kinds:
            raise ValueError(f"KimiLinearLM: layer {i} is both KDA and full attention")
        kinds[i - 1] = "mla"
    if sorted(kinds) != list(range(n)):
        raise ValueError(f"KimiLinearLM: linear_attn_config covers layers {sorted(kinds)} "
                         f"of {n} (0-based)")
    return [kinds[i] for i in range(n)]


def routed_widths(config: Dict) -> Tuple[int, Tuple[int, int]]:
    """(the router's width: the published expert count, the held range
    [lo, hi)). ``num_experts`` is how many are held here."""
    total = config.get("published", {}).get("num_experts", config["num_experts"])
    lo, hi = config.get("experts_held", (0, total))
    if not 0 <= lo < hi <= total or hi - lo != config["num_experts"]:
        raise ValueError(f"KimiLinearLM: experts_held {lo}..{hi} of {total} against "
                         f"num_experts {config['num_experts']}")
    return total, (lo, hi)


def _widths(c: Dict) -> Dict:
    other = {k: c[k] for k, v in _ONLY.items() if k in c and c[k] != v}
    if other or c.get("q_lora_rank") or c.get("rope_scaling"):
        raise ValueError(f"KimiLinearLM: unsupported settings {other} (supported: {_ONLY}, "
                         "no q_lora_rank, no rope_scaling)")
    lac = c["linear_attn_config"]
    total, held = routed_widths(c)
    return dict(
        d=c["hidden_size"], v=c["vocab_size"], layers=c["num_hidden_layers"],
        heads=c["num_attention_heads"], nope=c["qk_nope_head_dim"], pe=c["qk_rope_head_dim"],
        vd=c["v_head_dim"], lora=c["kv_lora_rank"], inter=c["intermediate_size"],
        experts=total, held=held, h=c["moe_intermediate_size"],
        shared=c["num_shared_experts"] or 0, dense=c["first_k_dense_replace"],
        kda_heads=lac["num_heads"], kda_dim=lac["head_dim"], conv=lac["short_conv_kernel_size"],
        kinds=layer_kinds(c),
    )


def weight_shapes(config: Dict) -> Dict[str, Tuple[int, ...]]:
    """Every weight's name and shape, in the order the benchmark draws
    them (the module docstring has the layout)."""
    w = _widths(config)
    d, H, D = w["d"], w["kda_heads"], w["kda_dim"]
    lo, hi = w["held"]
    out: Dict[str, Tuple[int, ...]] = {"embed": (w["v"], d)}
    for i, kind in enumerate(w["kinds"]):
        out[f"l{i}_attn_norm"] = (d,)
        if kind == "kda":
            out[f"l{i}_kda_qkv"] = (d, 3 * H * D)
            out[f"l{i}_kda_conv"] = (3 * H * D, w["conv"])
            out[f"l{i}_kda_f_a"] = out[f"l{i}_kda_g_a"] = (d, D)
            out[f"l{i}_kda_f_b"] = out[f"l{i}_kda_g_b"] = (D, H * D)
            out[f"l{i}_kda_A_log"] = (H,)
            out[f"l{i}_kda_dt_bias"] = (H * D,)
            out[f"l{i}_kda_b"] = (d, H)
            out[f"l{i}_kda_o_norm"] = (D,)
            out[f"l{i}_kda_o"] = (H * D, d)
        else:
            nh = w["heads"]
            out[f"l{i}_q"] = (d, nh * (w["nope"] + w["pe"]))
            out[f"l{i}_kv_a"] = (d, w["lora"] + w["pe"])
            out[f"l{i}_kv_norm"] = (w["lora"],)
            out[f"l{i}_kv_b"] = (w["lora"], nh * (w["nope"] + w["vd"]))
            out[f"l{i}_o"] = (nh * w["vd"], d)
        out[f"l{i}_mlp_norm"] = (d,)
        if i < w["dense"]:
            out[f"l{i}_gate"] = out[f"l{i}_up"] = (d, w["inter"])
            out[f"l{i}_down"] = (w["inter"], d)
        else:
            h, s = w["h"], w["shared"] * w["h"]
            out[f"l{i}_router"] = (d, w["experts"])
            out[f"l{i}_router_bias"] = (w["experts"],)
            out[f"l{i}_experts_gate_up"] = (hi - lo, d, 2 * h)
            out[f"l{i}_experts_down"] = (hi - lo, h, d)
            if s:
                out[f"l{i}_shared_gate"] = out[f"l{i}_shared_up"] = (d, s)
                out[f"l{i}_shared_down"] = (s, d)
    out["norm"] = (d,)
    out["head"] = (d, w["v"])
    return out


def _short_conv(x: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """Causal depthwise convolution of (B, S, C) with filters (C, K): y[t] =
    sum_j filters[:, j] * x[t - K + 1 + j], zero before the start."""
    taps = filters.shape[1]
    y = x * filters[:, taps - 1]
    for j in range(1, taps):
        y[:, j:].addcmul_(x[:, :-j], filters[:, taps - 1 - j])
    return y


class KimiLinearLM(DeepSeekV2LM):
    """(B, S) int tokens -> (B, S, vocab) float32 logits of a Kimi-Linear
    model; with ``routing`` also the experts each token was routed to at
    each MoE layer. ``config`` is the published ``config.json`` as a dict
    (with ``experts_held``, ``published`` where the experts were cut);
    ``params`` the weight dict of the module docstring, used as it is."""

    widths = staticmethod(_widths)
    weight_shapes = staticmethod(weight_shapes)

    @staticmethod
    def routed_experts(config: Dict) -> RoutedExperts:
        return RoutedExperts(config["num_experts_per_token"], bool(config["moe_renormalize"]),
                             float(config["routed_scaling_factor"]), scoring="sigmoid",
                             held=routed_widths(config)[1])

    def expert_weights(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer i's weights as `RoutedExperts` takes them, the selection
        bias with them."""
        return {**super().expert_weights(i), "bias": self.params[f"l{i}_router_bias"]}

    def attention(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Layer i's token mixer on normed (B, S, d) input -> (B, S, d)."""
        if self.w["kinds"][i] == "kda":
            return self.kda(i, x)
        return mla_attention(self.params, i, x, self.w, self.eps, self.scale, None)

    def kda(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Layer i's Kimi Delta Attention on normed (B, S, d) input -> (B,
        S, d) (module docstring)."""
        p, dev = self.params, x.device
        B, S, _ = x.shape
        H, D = self.w["kda_heads"], self.w["kda_dim"]
        # the layer's products stay outside its spans: they are cuBLAS's
        qkv = x @ p[f"l{i}_kda_qkv"]
        dt = (x @ p[f"l{i}_kda_f_a"]) @ p[f"l{i}_kda_f_b"]
        beta = x @ p[f"l{i}_kda_b"]
        gate = ((x @ p[f"l{i}_kda_g_a"]) @ p[f"l{i}_kda_g_b"]).view(B, S, H, D)
        with _tele.span("kda.prep", kind="stage", torch_device=dev, tokens=B * S):
            qkv = F.silu(_short_conv(qkv, p[f"l{i}_kda_conv"]))
            q, k, v = (t.view(B, S, H, D) for t in qkv.split(H * D, dim=-1))
            q, k = (t * torch.rsqrt(t.pow(2).sum(-1, keepdim=True) + _L2_EPS) for t in (q, k))
            g = F.softplus(dt + p[f"l{i}_kda_dt_bias"]).view(B, S, H, D)
            g.mul_(-p[f"l{i}_kda_A_log"].exp()[:, None])
            beta = torch.sigmoid(beta)
        with _tele.span("kda.core", kind="stage", torch_device=dev):
            o = kda(q, k, g, beta, v, scale=D ** -0.5)
        with _tele.span("kda.out", kind="stage", torch_device=dev):
            o = _rms_norm(o, p[f"l{i}_kda_o_norm"], self.eps).mul_(torch.sigmoid(gate))
        out = o.view(B, S, H * D) @ p[f"l{i}_kda_o"]
        _count("kda.layers")
        _count("kda.tokens", B * S)
        return out
