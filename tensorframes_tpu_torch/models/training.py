"""Optimizer-agnostic training steps.

The PyTorch counterpart of `tensorframes_tpu/models/training.py`.
`make_train_step` pairs any ``loss_fn(params, *batch)`` with an optimizer
into one step, ``step(params, opt_state, *batch) -> (params, opt_state,
loss)``, as the JAX package pairs it with an optax transformation.

The card has no optax, so ``tx`` is the PyTorch idiom: an optimizer
factory, a callable that takes the parameter tensors, such as
``functools.partial(torch.optim.Adam, lr=1e-3)``. `init_opt_state` builds
the optimizer over the parameters; it is the ``opt_state``. The step
updates the parameter tensors in place and returns the same containers.

``params`` is a pytree of tensors in the JAX package's layout: a dict (its
leaves in sorted-key order, as JAX flattens it), a list or tuple, or one
tensor. The models' own containers qualify (`MLP.params`,
`TransformerLM.params`). Leaves must be leaf tensors. Between steps they do
not require grad, so a scoring call builds no autograd graph; the step
turns gradients on for its own backward only (`value_and_grad`).
"""

from __future__ import annotations

from typing import Any, Callable, List, Mapping, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "init_opt_state", "make_train_step", "sgd_sharded", "tree_leaves", "value_and_grad",
]


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in JAX's order: dict values by sorted key,
    lists and tuples in order."""
    if isinstance(tree, (Mapping, torch.nn.ParameterDict)):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple, torch.nn.ParameterList)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def value_and_grad(
    loss_fn: Callable[..., torch.Tensor], params: Any, *batch
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``(loss, grads)`` of ``loss_fn(params, *batch)``, the grads in
    `tree_leaves` order (`jax.value_and_grad`). The leaves require grad
    for this call only; the loss comes back detached."""
    leaves = tree_leaves(params)
    before = [p.requires_grad for p in leaves]
    try:
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            loss = loss_fn(params, *batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p, r in zip(leaves, before):
            p.requires_grad_(r)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), grads


def sgd_(params: Any, grads: Sequence[torch.Tensor], lr: float) -> None:
    """``p <- p - lr * g`` in place over `tree_leaves(params)`, rounded as
    the JAX package's ``p - lr * g``."""
    with torch.no_grad():
        for p, g in zip(tree_leaves(params), grads):
            p.sub_(lr * g)


def sgd_sharded(loss_fn: Callable[[List[np.ndarray]], torch.Tensor], params: Sequence, lr: float):
    """One SGD step over sharded parameters (`parallel.sharding.Sharded`):
    each distinct block of each parameter becomes one autograd leaf on its
    home slot and is copied to every mesh slot that holds it;
    ``loss_fn(local)`` gets, for each parameter, a mesh-shaped object array
    of those per-slot copies and returns the global loss as one scalar.
    One backward then sums each block's gradient over its replicas (JAX's
    VMA psums), and ``block - lr * grad`` is laid out as before. Returns
    ``(new params, loss)``, the loss before the step, detached."""
    from ..parallel.sharding import Sharded

    with torch.enable_grad():
        leaves = [{h: p.shards[h].detach().requires_grad_(True) for h in p.homes()} for p in params]
        local = []
        for p, lv in zip(params, leaves):
            copies = np.empty(p.mesh.devices.shape, dtype=object)
            for c in p.coords():
                copies[c] = lv[p.home(c)].to(p.mesh.devices[c])
            local.append(copies)
        loss = loss_fn(local)
        flat = [t for lv in leaves for t in lv.values()]
        grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))
    new = []
    with torch.no_grad():
        for p, lv in zip(params, leaves):
            blocks = {}
            for h, t in lv.items():
                g = next(grads)
                blocks[h] = t.detach().clone() if g is None else t.detach() - lr * g
            new.append(Sharded.from_blocks(p.mesh, p.spec, p.shape, blocks))
    return new, loss.detach()


def init_opt_state(tx: Callable[..., torch.optim.Optimizer], params: Any):
    """The optimizer ``tx`` builds over the parameter tensors (optax's
    ``tx.init``). Its moment buffers are made on each parameter's device
    at the first step."""
    return tx(tree_leaves(params))


def make_train_step(
    loss_fn: Callable[..., torch.Tensor],
    tx: Callable[..., torch.optim.Optimizer],
    donate: bool = True,
) -> Callable[..., Tuple[Any, Any, torch.Tensor]]:
    """Build ``step(params, opt_state, *batch) -> (params, opt_state,
    loss)``: the loss and gradients of ``loss_fn(params, *batch)``, then
    one ``opt_state.step()``. ``tx`` is the optimizer factory
    `init_opt_state` was given. ``donate`` is accepted for the JAX
    package's signature and does nothing: torch updates the parameters
    and the optimizer's buffers in place already."""
    del tx, donate

    def step(params, opt_state: torch.optim.Optimizer, *batch):
        loss, grads = value_and_grad(loss_fn, params, *batch)
        for p, g in zip(tree_leaves(params), grads):
            p.grad = g
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        return params, opt_state, loss

    return step
