"""Transformer LM, forward only, as an `nn.Module`.

The PyTorch counterpart of `tensorframes_tpu/models/transformer.py`
(`TransformerLM.apply`): pre-LN blocks, learned positions, the output
projection tied to the embedding. The port scores a batch at once,
(B, S) int tokens -> (B, S, vocab) logits, and sends the attention of all
heads and the whole batch through one flash-attention launch per layer.

`from_jax_params` loads the JAX package's parameter dict (as numpy), so the
two models can be held against each other. Matching the JAX model: `gelu`
is its tanh approximation, layer-norm variance is the population variance,
``l{i}_ln1`` / ``l{i}_ln2`` are stacked (2, D) [gain; bias], positions are
``pos[:S]``. Training waits for a later slice.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.flash_attention import flash_attention

__all__ = ["TransformerLM"]


def _layer_norm(x, g, b, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


class TransformerLM(nn.Module):
    def __init__(
        self,
        vocab: int = 128,
        d_model: int = 64,
        n_heads: int = 4,
        n_layers: int = 2,
        max_seq: int = 1024,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        super().__init__()
        if d_model % n_heads:
            raise ValueError("d_model must divide n_heads")
        self.vocab, self.d_model = vocab, d_model
        self.n_heads, self.n_layers = n_heads, n_layers
        self.head_dim = d_model // n_heads
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)

        def init(shape, scale):
            return torch.randn(shape, generator=gen, dtype=torch.float32) * scale

        s = 1.0 / math.sqrt(d_model)
        p: Dict[str, torch.Tensor] = {
            "embed": init((vocab, d_model), 0.02),
            "pos": init((max_seq, d_model), 0.02),
            "ln_f_g": torch.ones(d_model, dtype=torch.float32),
            "ln_f_b": torch.zeros(d_model, dtype=torch.float32),
        }
        ln = torch.stack([torch.ones(d_model), torch.zeros(d_model)]).float()
        for i in range(n_layers):
            p[f"l{i}_qkv"] = init((d_model, 3 * d_model), s)
            p[f"l{i}_proj"] = init((d_model, d_model), s)
            p[f"l{i}_mlp_up"] = init((d_model, 4 * d_model), s)
            p[f"l{i}_mlp_down"] = init((4 * d_model, d_model), s)
            p[f"l{i}_ln1"] = ln.clone()
            p[f"l{i}_ln2"] = ln.clone()
        self.params = nn.ParameterDict(
            {k: nn.Parameter(v.to(dev), requires_grad=False) for k, v in p.items()}
        )

    @classmethod
    def from_jax_params(
        cls,
        params: Dict[str, np.ndarray],
        n_heads: int,
        device: DeviceLike = None,
    ) -> "TransformerLM":
        """A model holding the JAX package's parameters (``{name: array}``,
        e.g. ``{k: np.asarray(v) for k, v in jax_model.params.items()}``)."""
        vocab, d_model = params["embed"].shape
        n_layers = sum(1 for k in params if k.endswith("_qkv"))
        model = cls(
            vocab, d_model, n_heads, n_layers,
            max_seq=params["pos"].shape[0], device=device,
        )
        with torch.no_grad():
            for k, v in params.items():
                dst = model.params[k]
                if tuple(dst.shape) != tuple(np.shape(v)):
                    raise ValueError(
                        f"param {k!r}: shape {np.shape(v)}, expected {tuple(dst.shape)}"
                    )
                dst.copy_(torch.tensor(np.asarray(v, np.float32)))
        return model

    def forward(
        self,
        tokens: torch.Tensor,
        attention: Callable[..., torch.Tensor] = flash_attention,
    ) -> torch.Tensor:
        """tokens: (B, S) int -> logits (B, S, vocab). ``attention`` takes
        (B*H, S, hd) q, k, v and ``causal=True`` (default: the kernel)."""
        p = self.params
        B, S = tokens.shape
        H, hd = self.n_heads, self.head_dim
        h = p["embed"][tokens.long()] + p["pos"][:S]
        for i in range(self.n_layers):
            g1, b1 = p[f"l{i}_ln1"]
            qkv = _layer_norm(h, g1, b1) @ p[f"l{i}_qkv"]  # (B, S, 3D)
            # (B, S, 3, H, hd) -> three contiguous (B*H, S, hd)
            q, k, v = (
                t.reshape(B * H, S, hd)
                for t in qkv.reshape(B, S, 3, H, hd).permute(2, 0, 3, 1, 4).contiguous()
            )
            att = attention(q, k, v, causal=True)
            att = att.reshape(B, H, S, hd).transpose(1, 2).reshape(B, S, self.d_model)
            h = h + att @ p[f"l{i}_proj"]
            g2, b2 = p[f"l{i}_ln2"]
            x = _layer_norm(h, g2, b2)
            up = F.gelu(x @ p[f"l{i}_mlp_up"], approximate="tanh")
            h = h + up @ p[f"l{i}_mlp_down"]
        h = _layer_norm(h, p["ln_f_g"], p["ln_f_b"])
        return h @ p["embed"].T
