"""Mixture-of-Experts FFN as an `nn.Module`.

The PyTorch counterpart of `tensorframes_tpu/models/moe.py::MoEFFN`: a
token's output is the gate-weighted sum of its top-k experts' FFNs,
``gelu(x @ w1[e]) @ w2[e]`` with the tanh gelu `jax.nn.gelu` defaults to.
`apply` is the JAX package's single-device reference: every expert is
evaluated densely over every token and the routing weights, zero outside a
token's top k, combine them (``einsum("ne,end->nd")``). The expert products
are `torch.matmul` / `einsum`, as the JAX package computes them outside
any Pallas kernel.

`apply_ep` is the expert-parallel path over a mesh axis: the experts split
over the axis, the routing full on every shard, one `psum` of the shards'
outputs (`parallel.collectives`).

`from_jax_params` loads the JAX ``params`` dict (``gate`` (d, E), ``w1``
(E, d, h), ``w2`` (E, h, d), as numpy).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..parallel import collectives
from ..parallel.mesh import Mesh
from ..parallel.sharding import P, as_sharded

__all__ = ["MoEFFN"]


class MoEFFN(nn.Module):
    """Top-k gated expert FFNs: x -> sum_k gate_k * FFN_{e_k}(x). Float32
    weights are drawn from ``seed`` by torch's generator on ``device``,
    scaled as in the JAX model (1/sqrt(d_model) for ``gate`` and ``w1``,
    1/sqrt(d_hidden) for ``w2``)."""

    def __init__(
        self,
        d_model: int = 32,
        d_hidden: int = 64,
        num_experts: int = 8,
        top_k: int = 2,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k {top_k} must be in [1, num_experts={num_experts}]")
        self.d_model, self.d_hidden = d_model, d_hidden
        self.num_experts, self.top_k = num_experts, top_k
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)

        def init(shape, scale):
            w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
            return nn.Parameter(w.mul_(scale), requires_grad=False)

        s1, s2 = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_hidden)
        self.params = nn.ParameterDict({
            "gate": init((d_model, num_experts), s1),
            "w1": init((num_experts, d_model, d_hidden), s1),
            "w2": init((num_experts, d_hidden, d_model), s2),
        })

    @classmethod
    def from_jax_params(
        cls, params: Dict[str, np.ndarray], top_k: int = 2, device: DeviceLike = None
    ) -> "MoEFFN":
        """A model holding the JAX package's ``params`` (numpy arrays)."""
        e, d, h = np.shape(params["w1"])
        model = cls(d, h, e, top_k, device=device)
        with torch.no_grad():
            for k, dst in model.params.items():
                dst.copy_(torch.from_numpy(np.asarray(params[k], np.float32)))
        return model

    def _route(self, params, x: torch.Tensor) -> torch.Tensor:
        """Routing weights (tokens, experts): a softmax over each token's
        top-k gate logits, scattered into a dense matrix that is zero
        elsewhere, so each row sums to 1 over its k experts."""
        logits = x @ params["gate"]
        topv, topi = torch.topk(logits, self.top_k, dim=-1)
        return torch.zeros_like(logits).scatter_add(-1, topi, torch.softmax(topv, dim=-1))

    @staticmethod
    def _expert_ffn(w1: torch.Tensor, w2: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``gelu(x @ w1) @ w2`` for every expert at once: (E, N, d)."""
        return torch.matmul(F.gelu(torch.matmul(x, w1), approximate="tanh"), w2)

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        """(N, d_model) tokens -> (N, d_model): every expert evaluated
        densely, combined by the routing weights."""
        weights = self._route(params, x)
        outs = self._expert_ffn(params["w1"], params["w2"], x)
        return torch.einsum("ne,end->nd", weights, outs)

    def apply_ep(self, params, x: torch.Tensor, mesh: Mesh, axis: str = "model") -> torch.Tensor:
        """Expert-parallel `apply`: ``w1`` and ``w2`` split over ``axis``
        (each shard holds E / n experts; a `parallel.sharding.Sharded` laid
        out so is used as it is), the gate and the tokens on every shard,
        each shard's gate-weighted sum over its own experts, and one `psum`
        of those onto x's device."""
        n_shard = mesh.shape[axis]
        if self.num_experts % n_shard:
            raise ValueError(
                f"num_experts {self.num_experts} must divide the "
                f"{axis!r} axis size {n_shard}"
            )
        e_per = self.num_experts // n_shard
        w1 = as_sharded(params["w1"], mesh, P(axis))
        w2 = as_sharded(params["w2"], mesh, P(axis))
        local = []
        for shard, coord in enumerate(collectives.axis_groups(mesh, axis)[0]):
            dev = mesh.devices[coord]
            xs = x.to(dev)
            weights = self._route({"gate": params["gate"].to(dev)}, xs)  # full routing
            outs = self._expert_ffn(w1.shards[coord], w2.shards[coord], xs)
            local.append(torch.einsum(
                "ne,end->nd", weights[:, shard * e_per:(shard + 1) * e_per], outs
            ))
        return collectives.sum_to(local, x.device)  # the psum, onto x's device

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(self.params, x)
