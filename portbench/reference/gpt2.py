"""GPT-2's forward pass in plain float32 PyTorch: the reference the scoring
cells' logits are held to.

It follows the published model (Radford et al. 2019; the Hugging Face
`GPT2LMHeadModel`): learned positions added to the token embedding,
pre-LN blocks of causal multi-head attention and a tanh-GELU MLP of width
4d, a final LayerNorm, logits from the tied embedding. Departures, which
the configuration file lists too: the qkv, projection and MLP products
carry no bias, and the weights are random. It imports no part of the
program under test, uses no fused attention kernel, and runs its matrix
products in full float32 (TF32 off) unless the caller asks for TF32,
which is how the precision control is computed.

Weights come as the benchmark's dict: ``embed`` (V, d), ``pos`` (P, d),
``ln_f_g`` / ``ln_f_b`` (d,), and per layer i ``l{i}_ln1`` / ``l{i}_ln2``
(2, d) [gain; bias], ``l{i}_qkv`` (d, 3d) with q, k, v side by side and
each split into heads of d / n_heads columns, ``l{i}_proj`` (d, d),
``l{i}_mlp_up`` (d, 4d), ``l{i}_mlp_down`` (4d, d).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator

import torch
import torch.nn.functional as F

__all__ = ["logits", "logits_blocks", "matmul_precision"]

_EPS = 1e-5  # GPT-2's layer_norm_epsilon


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


def _attention(x: torch.Tensor, w_qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    hd = d // n_heads
    q, k, v = (x @ w_qkv).split(d, dim=-1)
    q, k, v = (t.reshape(b, s, n_heads, hd).transpose(1, 2) for t in (q, k, v))
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(scores.masked_fill(mask, float("-inf")), dim=-1)
    return (probs @ v).transpose(1, 2).reshape(b, s, d)


@torch.no_grad()
def logits(weights: Dict[str, torch.Tensor], tokens: torch.Tensor, n_heads: int,
           n_layers: int) -> torch.Tensor:
    """(B, S) token ids -> (B, S, V) float32 logits."""
    s = tokens.shape[1]
    d = weights["embed"].shape[1]
    h = weights["embed"][tokens.long()] + weights["pos"][:s]
    for i in range(n_layers):
        g1, b1 = weights[f"l{i}_ln1"]
        h = h + _attention(F.layer_norm(h, (d,), g1, b1, _EPS), weights[f"l{i}_qkv"],
                           n_heads) @ weights[f"l{i}_proj"]
        g2, b2 = weights[f"l{i}_ln2"]
        up = F.layer_norm(h, (d,), g2, b2, _EPS) @ weights[f"l{i}_mlp_up"]
        h = h + F.gelu(up, approximate="tanh") @ weights[f"l{i}_mlp_down"]
    h = F.layer_norm(h, (d,), weights["ln_f_g"], weights["ln_f_b"], _EPS)
    return h @ weights["embed"].T


def logits_blocks(weights: Dict[str, torch.Tensor], tokens: torch.Tensor, n_heads: int,
                  n_layers: int, block: int) -> Iterator[torch.Tensor]:
    """`logits` of ``block`` sequences at a time, so that the whole batch's
    scores and logits need not fit at once."""
    for lo in range(0, tokens.shape[0], block):
        yield logits(weights, tokens[lo:lo + block], n_heads, n_layers)
