"""Sequence parallelism: ring attention, the Ulysses all-to-all, and the
plain attention the training path differentiates.

The PyTorch counterpart of `tensorframes_tpu/parallel/ring.py`.

`ring_attention` splits the sequence over one mesh axis; each shard keeps
its Q block and attends to the K/V blocks as they rotate around the ring
(`collectives.ppermute`), so after ``n`` steps every Q block has seen the
whole sequence. On CUDA shards each step is one launch of the flash kernel
that also returns the rows' log-sum-exps (`ops.flash_attention_lse`), and
the steps merge by them, ``o = sum_j exp(lse_j - LSE) o_j`` (plain PyTorch,
as the JAX package merges outside any Pallas kernel). On a causal ring a
K/V block from a later position is skipped, the diagonal step runs the
causal kernel and an earlier block the full one. On CPU shards, and always
in `ring_attention_reference`, each step is JAX's `_online_step` in plain,
differentiable PyTorch; the training paths use that
(`TransformerLM.loss(mesh=)`, `sharded_train_step_3d`), as the JAX package
differentiates its plain ring. `ring_attention` refuses a gradient on any
device, as `flash_attention` does.

`seq_all_to_all` moves a tensor's sharding from its sequence axis to its
head axis with one tiled all-to-all and returns the shards (a
`parallel.sharding.Sharded`): JAX returns a logical array that looks
unchanged, so the port shows the re-layout itself.

`full_attention` is the plain attention `TransformerLM.loss` /
`train_step` use without a mesh (the JAX package's off-TPU path).

The port takes batched ``(..., S, hd)`` tensors, every head at once; the
JAX functions take one ``(S, hd)`` head under `vmap`. The sequence length
must be divisible by the axis size, as in JAX.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import torch

from ..ops.flash_attention import _refuse_grad, flash_attention_lse
from . import collectives
from .mesh import Mesh
from .sharding import P, Sharded, as_sharded

__all__ = [
    "full_attention",
    "ring_attention",
    "ring_attention_reference",
    "seq_all_to_all",
]


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


def _online_step(q, k_blk, v_blk, m, l, o, scale, mask):
    """One blockwise online-softmax step, JAX's `_online_step`: q
    ``(..., Sq, d)``, the K/V block ``(..., Sk, d)``, the running max and
    denominator ``(..., Sq)``, the output ``(..., Sq, d)``; ``mask`` (Sq, Sk)
    True where a query attends, or None for all."""
    scores = torch.matmul(q, k_blk.transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    m_new = torch.maximum(m, scores.amax(dim=-1))
    # a fully masked row: exp(-inf - -inf) would be NaN; its weight is 0 anyway
    safe_m = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new), m_new)
    p = torch.exp(scores - safe_m[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    alpha = torch.where(torch.isneginf(m), torch.zeros_like(m), torch.exp(m - safe_m))
    return m_new, alpha * l + p.sum(dim=-1), alpha[..., None] * o + torch.matmul(p, v_blk)


def _merge(m, l, acc, o_j, lse_j):
    """Fold one step's normalised output ``o_j`` and log-sum-exps ``lse_j``
    into the running (max, denominator, weighted sum); a row whose lse is
    -inf weighs 0."""
    m_new = torch.maximum(m, lse_j)
    safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new), m_new)
    alpha = torch.where(torch.isneginf(m), torch.zeros_like(m), torch.exp(m - safe))
    beta = torch.where(torch.isneginf(lse_j), torch.zeros_like(lse_j), torch.exp(lse_j - safe))
    return m_new, alpha * l + beta, alpha[..., None] * acc + beta[..., None] * o_j


def _sees(i: int, src: int, sq: int, sk: int, causal: bool) -> str:
    """Which keys of block ``src`` the queries of block ``i`` see, from the
    block indices alone: "all", "none", or "some" (the causal diagonal)."""
    if not causal or (src + 1) * sk - 1 <= i * sq:
        return "all"
    if src * sk > (i + 1) * sq - 1:
        return "none"
    return "some"


def _step_mask(i: int, src: int, sq: int, sk: int, device) -> torch.Tensor:
    """The (Sq, Sk) causal mask of query block ``i`` against key block
    ``src``, True where a query sees a key."""
    q_pos = i * sq + torch.arange(sq, device=device)
    k_pos = src * sk + torch.arange(sk, device=device)
    return q_pos[:, None] >= k_pos[None, :]


def _ring(
    qs: Sequence[torch.Tensor],
    ks: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor],
    *,
    causal: bool,
    scale: float,
    kernel: bool,
) -> List[torch.Tensor]:
    """The ring over per-shard ``(..., S/n, d)`` blocks, shard i on its own
    device, in lockstep: at step t shard i holds K/V block ``(i - t) % n``
    and the blocks then move one shard on. With ``kernel`` each step is one
    `flash_attention_lse` launch merged by log-sum-exp (q, k, v of one
    shape), else JAX's plain `_online_step`. A step no query of the shard
    may see is skipped: it would leave the running state as it is."""
    n = len(qs)
    devices = [q.device for q in qs]
    sq, sk = qs[0].shape[-2], ks[0].shape[-2]
    perm = [(j, (j + 1) % n) for j in range(n)]
    q32 = [q.float() for q in qs]
    ks = [k.float() for k in ks]
    vs = [v.float() for v in vs]
    state = []
    for q in q32:
        rows = q.shape[:-1]
        state.append((
            torch.full(rows, -math.inf, device=q.device),
            torch.zeros(rows, device=q.device),
            torch.zeros_like(q),
        ))
    for t in range(n):
        for i in range(n):
            src = (i - t) % n
            sees = _sees(i, src, sq, sk, causal)
            if sees == "none":
                continue
            m, l, o = state[i]
            if kernel:
                # q, k and v of one shape: "some" is the diagonal, whose
                # mask is the kernel's own causal one
                o_j, lse_j = flash_attention_lse(
                    q32[i], ks[i], vs[i], causal=sees == "some", scale=scale
                )
                state[i] = _merge(m, l, o, o_j, lse_j)
            else:
                mask = None if sees == "all" else _step_mask(i, src, sq, sk, devices[i])
                state[i] = _online_step(q32[i], ks[i], vs[i], m, l, o, scale, mask)
        if t + 1 < n:
            ks = collectives.ppermute(ks, perm, devices)
            vs = collectives.ppermute(vs, perm, devices)
    out = []
    for q, (_, l, o) in zip(qs, state):
        l = torch.where(l == 0, torch.ones_like(l), l)  # fully masked rows
        out.append((o / l[..., None]).to(q.dtype))
    return out


def _shards(t: torch.Tensor, devices, what: str) -> List[torch.Tensor]:
    """``t`` cut along its sequence axis (-2) into one contiguous block a
    device."""
    n, s = len(devices), t.shape[-2]
    if s % n:
        raise ValueError(
            f"ring_attention: {what}'s sequence length {s} is not evenly divisible "
            f"by the {n} devices of the ring's mesh axis"
        )
    return [b.contiguous().to(d) for b, d in zip(torch.chunk(t, n, dim=-2), devices)]


def _ring_call(q, k, v, mesh, axis, causal, scale, kernel_ok: bool) -> torch.Tensor:
    devices = collectives.axis_devices(mesh, axis)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qs, ks, vs = (_shards(t, devices, w) for t, w in ((q, "q"), (k, "k"), (v, "v")))
    kernel = kernel_ok and devices[0].type == "cuda"
    out = _ring(qs, ks, vs, causal=causal, scale=scale, kernel=kernel)
    return torch.cat([o.to(q.device) for o in out], dim=-2)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    *,
    axis: str = "data",
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Ring attention over ``(..., S, hd)`` q, k, v with the sequence split
    over ``mesh``'s ``axis``; returns the full-length output on q's device.
    On a mesh of CUDA devices every step that is not wholly masked is one
    launch of the flash kernel (q, k, v of one shape); on the CPU the
    plain steps. Raises
    `AttentionGradientError` when autograd would need its gradient (train
    through `ring_attention_reference`)."""
    _refuse_grad(q, k, v, "ring_attention")
    return _ring_call(q, k, v, mesh, axis, causal, scale, kernel_ok=True)


def ring_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    *,
    axis: str = "data",
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The same ring with JAX's plain, differentiable `_online_step` on
    any device: what the gradient paths use."""
    return _ring_call(q, k, v, mesh, axis, causal, scale, kernel_ok=False)


def seq_all_to_all(
    x: Union[torch.Tensor, Sharded],
    mesh: Mesh,
    *,
    axis: str = "data",
    seq_axis: int,
    head_axis: int,
) -> Sharded:
    """Ulysses re-shard: move ``x``'s sharding over ``axis`` from
    ``seq_axis`` to ``head_axis`` with one tiled all-to-all. ``x`` is the
    global tensor, or a `Sharded` already split over ``seq_axis`` (as a
    previous call returns it); the result's shard i holds head block i over
    the whole sequence, so ``gather()`` equals ``x``. Both axis sizes must
    be divisible by the mesh axis size."""
    ndev = mesh.shape[axis]
    shape = x.shape
    if shape[seq_axis] % ndev or shape[head_axis] % ndev:
        raise ValueError(
            f"seq axis {shape[seq_axis]} and head axis {shape[head_axis]}"
            f" must divide mesh axis size {ndev}"
        )
    ndim = len(shape)
    seq_axis, head_axis = seq_axis % ndim, head_axis % ndim
    in_spec = [None] * ndim
    in_spec[seq_axis] = axis
    out_spec = [None] * ndim
    out_spec[head_axis] = axis
    xs = as_sharded(x, mesh, P(*in_spec))
    out = Sharded(mesh, P(*out_spec), shape, xs.shards.copy())
    for group in collectives.axis_groups(mesh, axis):
        moved = collectives.all_to_all(
            [xs.shards[c] for c in group], split_axis=head_axis, concat_axis=seq_axis
        )
        for c, t in zip(group, moved):
            out.shards[c] = t
    return out
