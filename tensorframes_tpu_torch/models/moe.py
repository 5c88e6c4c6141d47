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

`RoutedExperts` is the sparse layer of the large open models (DeepSeek-V2's
routed experts): a softmax over the gate logits, the greedy top k, and each
expert's SwiGLU computed only on the rows routed to it (see its docstring).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..parallel import collectives
from ..parallel.mesh import Mesh
from ..parallel.sharding import P, as_sharded
from ..utils import telemetry as _tele
from ..utils.profiling import count as _count

__all__ = ["MoEFFN", "RoutedExperts", "route"]


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


def route(
    logits: torch.Tensor, top_k: int, norm_topk_prob: bool = False, scaling: float = 1.0,
    scoring: str = "softmax", bias: Optional[torch.Tensor] = None,
):
    """The greedy router on (N, E) float32 gate logits: ``(weights,
    experts)``, each (N, k), largest choice first. ``scoring`` "softmax"
    (DeepSeek-V2): a softmax over all E, and its top k. "sigmoid"
    (DeepSeek-V3's ``noaux_tc`` with one group, Kimi-Linear): each logit's
    sigmoid s, the experts chosen by the top k of s + ``bias`` (E,), the
    per-expert selection bias, and weighted by s alone. With
    ``norm_topk_prob`` the k weights are renormalised to sum to 1, then
    multiplied by ``scaling`` (``routed_scaling_factor``)."""
    if scoring == "softmax":
        weights, experts = torch.softmax(logits, dim=-1).topk(top_k, dim=-1)
    elif scoring == "sigmoid":
        scores = torch.sigmoid(logits)
        experts = (scores + bias).topk(top_k, dim=-1).indices
        weights = scores.gather(1, experts)
    else:
        raise ValueError(f"route: scoring {scoring!r} (softmax or sigmoid)")
    if norm_topk_prob:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights * scaling if scaling != 1.0 else weights, experts


class RoutedExperts:
    """Routed SwiGLU experts, computed sparsely: x -> sum over a token's
    top-k experts e of ``w_e * down_e(silu(x @ gate_e) * (x @ up_e))``.

    The weights come as a dict: ``router`` (d, E), ``gate_up`` (H, d, 2h),
    each held expert's gate and up side by side (gate first, as checkpoint
    loaders that fuse them lay them out), ``down`` (H, h, d), and with the
    ``sigmoid`` scoring ``bias`` (E,), the selection bias (`route`). The
    layer routes over all E experts and holds those of ``held`` = (lo, hi),
    H = hi - lo of them (by default all E): a chip's share of a layer whose
    experts are divided over chips. It computes the pairs routed to the
    experts it holds and leaves out the others' part of the result; without
    the exchange of expert parallelism, what the other chips would add is
    absent. Dispatch, for N tokens:

    - ``moe.route`` (a span timed on the card): the gate logits in float32,
      `route`, then the N * k (token, expert) pairs sorted by expert (a
      stable sort, so an expert's rows keep token order), the per-expert
      counts read on the host (one synchronisation a layer, counted
      ``moe.host_syncs``), and the rows of the held experts' pairs, one
      slice of the sorted pairs, gathered into one tensor.
    - ``moe.experts``: for each held expert with rows, its gate and up as
      one product of width 2h on its own contiguous slice of the gathered
      rows (an expert's ~200 rows leave most of the card idle in a product
      of width h), the SwiGLU once over all the rows, then each expert's
      down product on its slice, written in place into one output. No
      capacity limit: every held pair is computed once, no token is dropped
      and no expert sees a row not routed to it.
    - ``moe.combine``: the outputs put back in pair order (zero at the pairs
      of experts not held) and summed over each token's k pairs with their
      routing weights (a fixed order, no atomics).

    Returns the (N, d) output and the (N, k) experts each token was routed
    to, numbered 0..E-1. Counters (`utils.profiling`): ``moe.layers`` one a
    call, ``moe.routed_pairs`` the rows the experts computed (N * k where
    every expert is held), ``moe.foreign_pairs`` the pairs routed to experts
    not held (the two add up to N * k), ``moe.max_expert_rows`` the largest
    held expert's rows, ``moe.host_syncs``."""

    def __init__(self, top_k: int, norm_topk_prob: bool = False, scaling: float = 1.0,
                 scoring: str = "softmax", held: Optional[Tuple[int, int]] = None):
        self.top_k, self.norm_topk_prob, self.scaling = top_k, norm_topk_prob, scaling
        self.scoring, self.held = scoring, held

    def __call__(self, w: Dict[str, torch.Tensor], x: torch.Tensor):
        """(N, d) float32 tokens -> ((N, d) output, (N, k) experts)."""
        n, d = x.shape
        k, dev = self.top_k, x.device
        lo, hi = self.held or (0, w["router"].shape[1])
        if w["gate_up"].shape[0] != hi - lo or w["down"].shape[0] != hi - lo:
            raise ValueError(f"RoutedExperts: weights of {w['gate_up'].shape[0]} experts for "
                             f"the held range {lo}..{hi}")
        # the softmax rule takes the four arguments it always took
        scoring = () if self.scoring == "softmax" else (self.scoring, w["bias"])
        with _tele.span("moe.route", kind="stage", torch_device=dev, tokens=n):
            weights, experts = route(x @ w["router"], k, self.norm_topk_prob, self.scaling,
                                     *scoring)
            pairs = experts.reshape(-1)
            order = torch.argsort(pairs, stable=True)
            counts = torch.bincount(pairs, minlength=w["router"].shape[1]).tolist()
            _count("moe.host_syncs")
            first, held = sum(counts[:lo]), counts[lo:hi]
            computed = sum(held)
            order = order[first:first + computed]  # the held experts' pairs
            rows = x.index_select(0, order // k)
        with _tele.span("moe.experts", kind="stage", torch_device=dev):
            h = w["down"].shape[1]
            # per-expert views made at once: the loops index no stacked tensor
            gate_up, down = w["gate_up"].unbind(0), w["down"].unbind(0)
            slices, at = [], 0  # (held expert, first row, end) of each with rows
            for e, m in enumerate(held):
                if m:
                    slices.append((e, at, at + m))
                    at += m
            t = rows.new_empty(len(rows), 2 * h)
            for e, r0, r1 in slices:
                torch.mm(rows[r0:r1], gate_up[e], out=t[r0:r1])
            a = F.silu(t[:, :h]).mul_(t[:, h:])
            out = torch.empty_like(rows)
            for e, r0, r1 in slices:
                torch.mm(a[r0:r1], down[e], out=out[r0:r1])
        with _tele.span("moe.combine", kind="stage", torch_device=dev):
            # every pair's row written where every pair is held, else zeros
            fill = torch.empty if computed == n * k else torch.zeros
            y = fill(n * k, d, dtype=out.dtype, device=dev).index_copy_(0, order, out).view(n, k, d)
            y = torch.bmm(weights.unsqueeze(1), y).squeeze(1)
        _count("moe.layers")
        _count("moe.routed_pairs", computed)
        _count("moe.foreign_pairs", n * k - computed)
        _count("moe.max_expert_rows", max(held, default=0))
        return y, experts
