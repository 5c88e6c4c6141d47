"""Transformer LM as an `nn.Module`: scoring and training.

The PyTorch counterpart of `tensorframes_tpu/models/transformer.py`
(`TransformerLM.apply`, `loss`, `train_step`): pre-LN blocks, learned
positions, the output projection tied to the embedding. The port scores a
batch at once, (B, S) int tokens -> (B, S, vocab) logits, and sends the
attention of all heads and the whole batch through one flash-attention
launch per layer.

Training differentiates the plain attention, `parallel.ring.full_attention`,
as the JAX package does off the TPU: the kernel has no backward (neither
has the TPU kernel, which JAX cannot differentiate), and `flash_attention`
raises when asked for a gradient. `loss` and `train_step` take the
parameter dict in the JAX layout; `TransformerLM.params` is the module's
own, and `train_step` updates it in place (see `models.training`).

With ``mesh=`` the attention is the ring over the mesh's ``data`` axis, as
in the JAX model: scoring (`apply`, `forward`) through `ring_attention`,
whose steps are launches of the flash kernel on the card, and `loss` /
`train_step` through the plain, differentiable `ring_attention_reference`.
`sharded_train_step_3d` is JAX's DP x SP x TP step over a ``("data",
"seq", "model")`` mesh, on the layout `device_layout` makes (qkv and proj
reshaped so their head axis can be split); `merge_layout` is its inverse.

`from_jax_params` loads the JAX package's parameter dict (as numpy), so the
two models can be held against each other. Matching the JAX model: `gelu`
is its tanh approximation, layer-norm variance is the population variance,
``l{i}_ln1`` / ``l{i}_ln2`` are stacked (2, D) [gain; bias], positions are
``pos[:S]``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.flash_attention import flash_attention
from ..parallel import collectives
from ..parallel.mesh import Mesh
from ..parallel.ring import _ring, full_attention, ring_attention, ring_attention_reference
from ..parallel.sharding import P, Sharded, as_sharded, shard
from .training import sgd_, sgd_sharded, value_and_grad

__all__ = ["TransformerLM"]


def _mesh_attention(mesh: Optional[Mesh], ring: Callable, single: Callable) -> Callable:
    """The attention of a call with or without a mesh: ``ring`` over the
    mesh's ``data`` axis (JAX's `ring_attention(..., mesh)` default), else
    ``single``."""
    if mesh is None:
        return single
    return lambda q, k, v, causal: ring(q, k, v, mesh, causal=causal)


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
        attention: Optional[Callable[..., torch.Tensor]] = None,
        mesh: Optional[Mesh] = None,
    ) -> torch.Tensor:
        """tokens: (B, S) int -> logits (B, S, vocab). ``attention`` takes
        (B*H, S, hd) q, k, v and ``causal=True`` (default: the kernel, or
        with ``mesh`` the ring over its ``data`` axis)."""
        return self.apply(self.params, tokens, attention, mesh)

    def loss(
        self,
        params: Dict[str, torch.Tensor],
        tokens: torch.Tensor,
        attention: Optional[Callable[..., torch.Tensor]] = None,
        mesh: Optional[Mesh] = None,
    ) -> torch.Tensor:
        """Next-token cross-entropy: position t predicts token t+1. Over a
        (S,) sequence as in JAX; over (B, S) the mean of the B sequences'
        losses (each has S - 1 targets, so it is the mean over all). The
        attention is `full_attention`, or with ``mesh`` the differentiable
        ring `ring_attention_reference` (S - 1 divisible by the axis)."""
        if attention is None:
            attention = _mesh_attention(mesh, ring_attention_reference, full_attention)
        elif mesh is not None:
            raise ValueError("pass attention= or mesh=, not both")
        t = tokens.long()
        if t.dim() == 1:
            t = t[None]
        logp = torch.log_softmax(self.apply(params, t[:, :-1], attention), dim=-1)
        return -logp.gather(-1, t[:, 1:, None]).mean()

    def train_step(
        self,
        params: Dict[str, torch.Tensor],
        tokens: torch.Tensor,
        lr: float = 1e-2,
        mesh: Optional[Mesh] = None,
    ):
        """One SGD step, ``p <- p - lr * grad``, in place on ``params``
        (pass `TransformerLM.params` to train the module). Returns
        ``(params, loss)``, the loss before the step."""
        loss, grads = value_and_grad(lambda p, t: self.loss(p, t, mesh=mesh), params, tokens)
        sgd_(params, grads, lr)
        return params, loss

    def apply(
        self,
        params: Dict[str, torch.Tensor],
        tokens: torch.Tensor,
        attention: Optional[Callable[..., torch.Tensor]] = None,
        mesh: Optional[Mesh] = None,
    ) -> torch.Tensor:
        """`forward` under ``params`` (a dict of the module's keys)."""
        if attention is None:
            attention = _mesh_attention(mesh, ring_attention, flash_attention)
        elif mesh is not None:
            raise ValueError("pass attention= or mesh=, not both")
        p = params
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

    # ------------------------------------------------------------------
    # The DP x SP x TP step over a ("data", "seq", "model") mesh: batch
    # over "data", sequence over "seq" (the ring), heads, FFN and vocab
    # over "model" (Megatron column and row splits with psum combines).
    # ------------------------------------------------------------------
    def _layout_table(self):
        """The one schema the layout views derive from, JAX's: rows of
        (flat name, "rep" | "shd", layout key, shape in the layout or None,
        flat shape or None, PartitionSpec)."""
        D, H, hd = self.d_model, self.n_heads, self.head_dim
        rows = [
            ("embed", "rep", "embed", None, None, P()),
            ("pos", "rep", "pos", None, None, P()),
            ("ln_f_g", "rep", "ln_f_g", None, None, P()),
            ("ln_f_b", "rep", "ln_f_b", None, None, P()),
        ]
        for i in range(self.n_layers):
            rows += [
                (f"l{i}_ln1", "rep", f"l{i}_ln1", None, None, P()),
                (f"l{i}_ln2", "rep", f"l{i}_ln2", None, None, P()),
                (f"l{i}_qkv", "shd", f"l{i}_qkv",
                 (D, 3, H, hd), (D, 3 * D), P(None, None, "model", None)),
                (f"l{i}_proj", "shd", f"l{i}_proj",
                 (H, hd, D), (D, D), P("model", None, None)),
                (f"l{i}_mlp_up", "shd", f"l{i}_up", None, None, P(None, "model")),
                (f"l{i}_mlp_down", "shd", f"l{i}_down", None, None, P("model", None)),
            ]
        return rows

    def device_layout(self, params) -> Dict[str, Dict[str, torch.Tensor]]:
        """``params`` re-laid out for `sharded_train_step_3d`: ``rep`` holds
        the replicated tensors, ``shd`` the model-split ones (qkv and proj
        reshaped so the head axis can be split)."""
        out: Dict[str, Dict[str, torch.Tensor]] = {"rep": {}, "shd": {}}
        for flat, kind, key, to_shape, _, _ in self._layout_table():
            v = params[flat]
            out[kind][key] = v if to_shape is None else v.reshape(to_shape)
        return out

    def merge_layout(self, layout) -> Dict[str, torch.Tensor]:
        """The inverse of `device_layout`: the flat parameter dict, each
        sharded leaf gathered on its mesh's first device."""
        p = {}
        for flat, kind, key, _, from_shape, _ in self._layout_table():
            v = layout[kind][key]
            if isinstance(v, Sharded):
                v = v.gather()
            p[flat] = v if from_shape is None else v.reshape(from_shape)
        return p

    def _layout_specs(self):
        out: Dict[str, Dict[str, object]] = {"rep": {}, "shd": {}}
        for _, kind, key, _, _, spec in self._layout_table():
            out[kind][key] = spec
        return out

    def sharded_train_step_3d(self, mesh: Mesh, lr: float = 1e-2):
        """One SGD step over a ``("data", "seq", "model")`` mesh:
        ``step(layout, tokens) -> (layout, loss)``.

        tokens: (batch, seq) ints, the batch split over ``data`` and the
        sequence over ``seq``; every position is consumed (position t
        predicts t + 1, the next token of a shard's last position comes
        from its right ring neighbour, and the final global position is
        masked out of the loss). The layout's leaves may be global tensors
        (`device_layout`) or the step's own sharded output. Gradients come
        from one backward of the global loss: a replicated parameter is one
        leaf copied to every slot and a model-split block one leaf copied
        across ``data`` x ``seq``, so autograd's sums are JAX's psums. The
        vocabulary of the tied output projection is split over ``model``,
        with the cross-entropy's pmax and psums over it.
        """
        D, H, hd, V = self.d_model, self.n_heads, self.head_dim, self.vocab
        n_data, n_seq, mp = mesh.shape["data"], mesh.shape["seq"], mesh.shape["model"]
        if H % mp or V % mp:
            raise ValueError(f"n_heads={H} and vocab={V} must divide model axis {mp}")
        v_per = V // mp
        scale = 1.0 / math.sqrt(hd)
        specs = self._layout_specs()
        names = [(kind, key) for kind in ("rep", "shd") for key in specs[kind]]
        coords = list(np.ndindex(*mesh.devices.shape))
        si, mi = mesh.axis_names.index("seq"), mesh.axis_names.index("model")
        seq_groups = collectives.axis_groups(mesh, "seq")
        model_groups = collectives.axis_groups(mesh, "model")
        # the loss's numerator summed over ("data", "seq") at model index 0
        loss_group = collectives.axis_groups(mesh, ("data", "seq"))[0]

        def step(layout, tokens):
            B, S = tokens.shape
            max_seq = layout["rep"]["pos"].shape[0]
            if B % n_data or S % n_seq:
                raise ValueError(
                    f"tokens {tuple(tokens.shape)} are not evenly divisible by the "
                    f"data axis {n_data} and the seq axis {n_seq}"
                )
            if S > max_seq:
                raise ValueError(
                    f"sequence length {S} exceeds max_seq {max_seq} (positions "
                    "past it do not exist)"
                )
            flat = [as_sharded(layout[kind][key], mesh, specs[kind][key]) for kind, key in names]
            toks = shard(tokens.long(), mesh, P("data", "seq"))
            sl = S // n_seq

            def loss_fn(local):
                prm = {name: arr for name, arr in zip(names, local)}

                def rep(key):
                    return prm[("rep", key)]

                def shd(key):
                    return prm[("shd", key)]

                def psum_model(parts):
                    out = {}
                    for g in model_groups:
                        out.update(zip(g, collectives.psum([parts[c] for c in g])))
                    return out

                h = {}
                for c in coords:
                    pos0 = c[si] * sl
                    h[c] = rep("embed")[c][toks.shards[c]] + rep("pos")[c][pos0:pos0 + sl][None]
                for i in range(self.n_layers):
                    qkv = {}
                    for c in coords:
                        g1, b1 = rep(f"l{i}_ln1")[c]
                        x = _layer_norm(h[c], g1, b1)
                        qkv[c] = torch.einsum("bsd,dchk->cbhsk", x, shd(f"l{i}_qkv")[c])
                    att = {}
                    for g in seq_groups:
                        att.update(zip(g, _ring(
                            [qkv[c][0] for c in g], [qkv[c][1] for c in g],
                            [qkv[c][2] for c in g], causal=True, scale=scale, kernel=False,
                        )))
                    proj = psum_model({
                        c: torch.einsum("bhsk,hkd->bsd", att[c], shd(f"l{i}_proj")[c])
                        for c in coords
                    })
                    ffn = {}
                    for c in coords:
                        h[c] = h[c] + proj[c]
                        g2, b2 = rep(f"l{i}_ln2")[c]
                        x = _layer_norm(h[c], g2, b2)
                        up = F.gelu(x @ shd(f"l{i}_up")[c], approximate="tanh")
                        ffn[c] = up @ shd(f"l{i}_down")[c]
                    ffn = psum_model(ffn)
                    for c in coords:
                        h[c] = h[c] + ffn[c]
                logits, tgt = {}, {}
                for c in coords:
                    hf = _layer_norm(h[c], rep("ln_f_g")[c], rep("ln_f_b")[c])
                    m = c[mi]
                    logits[c] = hf @ rep("embed")[c][m * v_per:(m + 1) * v_per].T
                # next-token targets: shift left; a shard's last column comes
                # from its right ring neighbour (the global last is masked)
                for g in seq_groups:
                    devs = [mesh.devices[c] for c in g]
                    nxt = collectives.ppermute(
                        [toks.shards[c][:, :1] for c in g],
                        [((j + 1) % n_seq, j) for j in range(n_seq)], devs,
                    )
                    for c, t in zip(g, nxt):
                        tgt[c] = torch.cat([toks.shards[c][:, 1:], t], dim=1)
                # cross-entropy over the vocabulary-split logits
                top, se, tl = {}, {}, {}
                for g in model_groups:
                    top.update(zip(g, collectives.pmax(
                        [logits[c].detach().amax(dim=-1) for c in g])))
                for c in coords:
                    se[c] = torch.exp(logits[c] - top[c][..., None]).sum(dim=-1)
                    idx = tgt[c] - c[mi] * v_per
                    in_rng = (idx >= 0) & (idx < v_per)
                    val = logits[c].gather(-1, idx.clamp(0, v_per - 1)[..., None])[..., 0]
                    tl[c] = torch.where(in_rng, val, torch.zeros_like(val))
                se, tl = psum_model(se), psum_model(tl)
                num = []
                for c in loss_group:
                    ll = tl[c] - top[c] - torch.log(se[c])
                    gpos = c[si] * sl + torch.arange(sl, device=ll.device)
                    w = (gpos < S - 1).to(ll.dtype)
                    num.append((ll * w[None]).sum())
                return -collectives.sum_to(num, mesh.devices.flat[0]) / (B * (S - 1))

            new, loss = sgd_sharded(loss_fn, flat, lr)
            out: Dict[str, Dict[str, Sharded]] = {"rep": {}, "shd": {}}
            for (kind, key), t in zip(names, new):
                out[kind][key] = t
            return out, loss

        return step
