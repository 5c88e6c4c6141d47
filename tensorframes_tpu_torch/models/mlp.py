"""Dense MLP classifier as an `nn.Module`: scoring and training.

The PyTorch counterpart of `tensorframes_tpu/models/mlp.py` (`MLP.apply`,
`loss`, `train_step` and `scoring_graph`): ``sizes[0] -> ... -> sizes[-1]``
with ReLU hiddens. The model scores a batch directly (``model(x)`` gives
logits) or freezes its weights into a builder-DSL scoring graph for
`map_rows`/`map_blocks` (BASELINE config 3). `from_jax_params` loads the
JAX model's ``params`` (a list of ``(w, b)`` as numpy), so the two models
can be held against each other.

``params`` in `apply`, `loss` and `train_step` has the JAX layout, a list
of ``(w, b)``; `MLP.params` is the module's own. `train_step` is the JAX
package's plain SGD step, applied in place (see `models.training`).

Over a ``("data", "model")`` mesh (`parallel.mesh.mesh_2d`):
`param_specs` gives JAX's Megatron-style specs (even layers split columns,
odd layers rows), `shard_params` lays the parameters out by them
(`parallel.sharding.Sharded`), and `sharded_train_step` builds the step
that splits the rows of ``x`` and ``y`` over ``data`` and the features over
``model``, in lockstep over the mesh's slots: a column layer's output stays
split, a row layer's partial products meet in one `psum`. Its
``step(params, x, y) -> (params, loss)`` takes and returns sharded
parameters (global ones are laid out first) and computes what `train_step`
computes, in another summation order.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..graph import builder as dsl
from ..schema import ScalarType, Shape
from ..parallel import collectives
from ..parallel.mesh import Mesh
from ..parallel.sharding import P, PartitionSpec, as_sharded, shard
from .training import sgd_, sgd_sharded, value_and_grad

__all__ = ["MLP"]


class MLP(nn.Module):
    """Dense ``sizes[0] -> ... -> sizes[-1]`` classifier with ReLU hiddens.
    Weights are ``(fan_in, fan_out)`` and biases start at zero, as in the
    JAX model; the random draw is torch's, from ``seed``."""

    def __init__(
        self,
        sizes: Sequence[int],
        seed: int = 0,
        dtype: torch.dtype = torch.float32,
        device: DeviceLike = None,
    ):
        super().__init__()
        if len(sizes) < 2:
            raise ValueError("need at least input and output sizes")
        self.sizes = list(sizes)
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
            w = torch.randn((fan_in, fan_out), generator=gen, dtype=dtype)
            self.weights.append(
                nn.Parameter((w * math.sqrt(2.0 / fan_in)).to(dev), requires_grad=False)
            )
            self.biases.append(
                nn.Parameter(torch.zeros(fan_out, dtype=dtype, device=dev), requires_grad=False)
            )

    @classmethod
    def from_jax_params(
        cls, params: Sequence[Tuple[np.ndarray, np.ndarray]], device: DeviceLike = None
    ) -> "MLP":
        """The JAX model's ``params`` (``[(w, b), ...]``, numpy), copied."""
        ws = [np.asarray(w) for w, _ in params]
        model = cls([ws[0].shape[0]] + [w.shape[1] for w in ws], device=device)
        dev = resolve_device(device)
        with torch.no_grad():
            for i, (w, b) in enumerate(params):
                model.weights[i] = nn.Parameter(
                    torch.from_numpy(np.array(w)).to(dev), requires_grad=False
                )
                model.biases[i] = nn.Parameter(
                    torch.from_numpy(np.array(b)).to(dev), requires_grad=False
                )
        return model

    @property
    def params(self) -> List[Tuple[nn.Parameter, nn.Parameter]]:
        """The module's parameters in the JAX layout, ``[(w, b), ...]``."""
        return list(zip(self.weights, self.biases))

    def apply(self, params: Sequence[Tuple[torch.Tensor, torch.Tensor]], x: torch.Tensor) -> torch.Tensor:
        """Logits of a batch ``(n, sizes[0])`` under ``params``."""
        h = x
        n = len(params)
        for i, (w, b) in enumerate(params):
            h = h @ w + b
            if i < n - 1:
                h = torch.relu(h)
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits of a batch ``(n, sizes[0])`` (`MLP.apply`)."""
        return self.apply(self.params, x)

    def loss(self, params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Mean cross-entropy of the integer labels ``y`` under a float32
        log-softmax of the logits."""
        logp = torch.log_softmax(self.apply(params, x).float(), dim=-1)
        return -logp.gather(1, y.long()[:, None]).mean()

    def train_step(self, params, x: torch.Tensor, y: torch.Tensor, lr: float = 1e-2):
        """One SGD step, ``p <- p - lr * grad``, in place on ``params``
        (pass `MLP.params` to train the module). Returns ``(params,
        loss)``, the loss before the step."""
        loss, grads = value_and_grad(self.loss, params, x, y)
        sgd_(params, grads, lr)
        return params, loss

    def param_specs(self) -> List[Tuple[PartitionSpec, PartitionSpec]]:
        """Megatron-style TP, JAX's specs: even layers split their columns
        (and bias) over ``model``, odd layers their rows (bias replicated),
        so the activations alternate split / whole and each pair needs one
        psum."""
        specs = []
        for i in range(len(self.sizes) - 1):
            if i % 2 == 0:
                specs.append((P(None, "model"), P("model")))
            else:
                specs.append((P("model", None), P()))
        return specs

    def shard_params(self, params, mesh: Mesh):
        """``params`` laid out over ``mesh`` by `param_specs`."""
        return [
            (shard(w, mesh, ws), shard(b, mesh, bs))
            for (w, b), (ws, bs) in zip(params, self.param_specs())
        ]

    def sharded_train_step(self, mesh: Mesh, lr: float = 1e-2):
        """The SGD step with the rows of ``x`` / ``y`` split over ``data``
        and the features over ``model``: ``step(params, x, y) -> (params,
        loss)``, sharded parameters in and out. The loss is the global mean
        cross-entropy, on the mesh's first device."""
        specs = self.param_specs()
        n_data, n_model = mesh.shape["data"], mesh.shape["model"]
        n_layers = len(specs)

        def step(params, x, y):
            flat = [
                as_sharded(t, mesh, spec)
                for (w, b), (ws, bs) in zip(params, specs)
                for t, spec in ((w, ws), (b, bs))
            ]
            xs = shard(x, mesh, P("data", None))
            ys = shard(y, mesh, P("data"))

            def loss_fn(local):
                nll = []
                for d in range(n_data):
                    group = [(d, m) for m in range(n_model)]
                    hs = [xs.shards[c] for c in group]
                    split = False  # whether hs holds column blocks
                    for i in range(n_layers):
                        w, b = local[2 * i], local[2 * i + 1]
                        if i % 2 == 0:  # column layer: whole input, split output
                            hs = [h @ w[c] + b[c] for h, c in zip(hs, group)]
                            split = True
                        else:  # row layer: split input, partial products summed
                            sums = collectives.psum([h @ w[c] for h, c in zip(hs, group)])
                            hs = [s + b[c] for s, c in zip(sums, group)]
                            split = False
                        if i < n_layers - 1:
                            hs = [torch.relu(h) for h in hs]
                    home = mesh.devices[group[0]]
                    logits = torch.cat([h.to(home) for h in hs], dim=-1) if split else hs[0]
                    logp = torch.log_softmax(logits.float(), dim=-1)
                    labels = ys.shards[group[0]].long()
                    nll.append(-logp.gather(1, labels[:, None]).sum())
                return collectives.sum_to(nll, mesh.devices.flat[0]) / x.shape[0]

            new, loss = sgd_sharded(loss_fn, flat, lr)
            return [(new[2 * i], new[2 * i + 1]) for i in range(n_layers)], loss

        return step

    def scoring_graph(self, input_name: str = "features", block: bool = True) -> dsl.Tensor:
        """The weights frozen into a builder-DSL graph: Placeholder ->
        MatMul -> BiasAdd -> Relu -> ... -> Softmax, named ``probs``. With
        ``block=False`` the graph scores one row (a vector), lifted to
        ``1 x n`` for the products."""
        st = ScalarType.from_torch_dtype(self.weights[0].dtype)
        shape = Shape((None, self.sizes[0])) if block else Shape((self.sizes[0],))
        h = dsl.placeholder(st, shape, name=input_name)
        n = len(self.weights)
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            wc = dsl.constant(w.detach().cpu().numpy(), name=f"w{i}")
            bc = dsl.constant(b.detach().cpu().numpy(), name=f"b{i}")
            h = dsl.matmul(h if block else dsl.reshape(h, [1, -1]), wc)
            h = dsl._nary("BiasAdd", [h, bc])
            if i < n - 1:
                h = dsl.relu(h)
        if not block:
            h = dsl.reshape(h, [self.sizes[-1]])
        return dsl.softmax(h).named("probs")
