"""Attention without a kernel: `full_attention`, the training path's
attention.

The PyTorch counterpart of `tensorframes_tpu/parallel/ring.py::full_attention`,
the plain attention `TransformerLM` uses off the TPU and therefore the one
JAX differentiates when it trains (it has no gradient for its Pallas
kernel). The port's `TransformerLM.loss` / `train_step` use it, so autograd
differentiates plain torch ops; scoring keeps the CUDA kernel
(`ops.flash_attention`).

The port takes every head at once, ``(BH, S, hd)`` (the JAX function takes
one ``(S, hd)`` head under `vmap`). `ring_attention` and `seq_all_to_all`,
the sequence-parallel paths over a mesh, wait for the multi-GPU slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["full_attention"]


def full_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """softmax(Q K^T * scale) V over ``(..., S, hd)`` tensors, as the JAX
    function computes it: scores and softmax in float32, key > query set
    to -inf when ``causal``, the output cast back to q's dtype. ``scale``
    defaults to 1/sqrt(hd)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        n, m = scores.shape[-2:]
        mask = torch.arange(n, device=q.device)[:, None] >= torch.arange(m, device=q.device)[None, :]
        scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    return torch.matmul(w, v.float()).to(q.dtype)
