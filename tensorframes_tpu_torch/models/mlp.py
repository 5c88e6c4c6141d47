"""Dense MLP classifier, forward only, as an `nn.Module`.

The PyTorch counterpart of `tensorframes_tpu/models/mlp.py` (`MLP.apply`
and `MLP.scoring_graph`): ``sizes[0] -> ... -> sizes[-1]`` with ReLU
hiddens. The model scores a batch directly (``model(x)`` gives logits) or
freezes its weights into a builder-DSL scoring graph for
`map_rows`/`map_blocks` (BASELINE config 3). `from_jax_params` loads the
JAX model's ``params`` (a list of ``(w, b)`` as numpy), so the two models
can be held against each other. Training and the sharded step wait for a
later slice.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..graph import builder as dsl
from ..schema import ScalarType, Shape

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits of a batch ``(n, sizes[0])`` (`MLP.apply`)."""
        h = x
        n = len(self.weights)
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            h = h @ w + b
            if i < n - 1:
                h = torch.relu(h)
        return h

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
