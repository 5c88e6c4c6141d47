"""Scoring a token table with a Kimi-Linear model (KDA layers beside latent
attention without RoPE, a chip's share of sigmoid-routed experts):
``map_blocks`` of a plain function ``{"logits": ..., "experts": ...} =
model(tokens, routing=True)`` over a frame of sequences: the logits, and the
experts each token was routed to at each MoE layer (a (S, 26, 8) int64 cell
a sequence), which the check needs.

The configuration is the published ``config.json`` (Kimi-Linear keys) with
``num_experts`` cut to the experts held here (``experts_held``, the
published count under ``published``); the traffic gives the frame
(``sequences`` x ``seq_len`` token ids in ``blocks`` blocks), how many such
frames are held (``frames``; calls go round them), the warm-up calls, how
many calls of the window are checked (``check_calls``, a seeded sample),
the reference's block of sequences (``check_block``) and the near-tie band
of the selection scores within which the reference follows the program's
experts (``check_tie_gap``). Token ids follow a Zipf law over a permutation
of the vocabulary drawn from the seed (`fn_map_blocks_mla_moe.make_tokens`).
Weights are drawn on the device from the seed in the program's layout
(`make_weights`), views of one buffer, and handed to `KimiLinearLM` as its
weight dict; the reference draws them again after `release`.

``correct`` (`compare`): the logits of the sampled calls, as the timed path
returned them, against `portbench.reference.kimi_linear` in float32 with
TF32 off on the same tokens (its KDA token by token), the reference
following the program's experts inside the near-tie band of the selection
scores s + b and nowhere else. The numbers: the widest absolute gap over
every logit (``logits_max_abs_err``); token-layers whose reported experts
lie outside the band (``routing_wrong``); the share of tokens with a
near-tie at some MoE layer (``tied_token_share``); and how far the window's
``moe.routed_pairs`` + ``moe.foreign_pairs`` counters are from tokens x
``num_experts_per_token`` x MoE layers x calls (``routed_pairs_wrong``).
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Tuple

import torch

from portbench import yardstick_kda
from portbench.drivers.fn_map_blocks_mla_moe import make_tokens
from portbench.harness import Compared, derived_seed
from portbench.reference import kimi_linear as reference

_WEIGHTS = 0  # derived-seed stream of the weights (fn_map_blocks_mla_moe's)
_RING_ENTRIES = 1 << 16  # ~150 spans a call: a window's calls must all stay in the ring
_PAIR_COUNTERS = ("moe.routed_pairs", "moe.foreign_pairs")

__all__ = ["compare", "make_tokens", "make_weights", "moe_layers", "setup", "work"]


def _draw(name: str, t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """Fill weight ``name`` in place (the configuration's ``assumed``)."""
    if name.endswith("_A_log"):  # log U(1, 16) a head
        t.uniform_(1.0, 16.0, generator=gen).log_()
    elif name.endswith("_dt_bias"):  # softplus^-1 of exp U(log 1e-3, log 1e-1)
        t.uniform_(math.log(1e-3), math.log(1e-1), generator=gen).exp_()
        t.add_(torch.log(-torch.expm1(-t)))
    elif name.endswith("_router_bias"):
        t.normal_(0.0, 1e-3, generator=gen)
    elif name.endswith("_kda_conv"):  # Conv1d's default at 4 taps: U(-1/2, 1/2)
        bound = t.shape[1] ** -0.5
        t.uniform_(-bound, bound, generator=gen)
    elif t.dim() == 1:  # RMSNorm gains
        t.fill_(1.0)
    else:
        t.normal_(0.0, std, generator=gen)


def make_weights(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's weights from ``seed``, in the program's layout
    (`KimiLinearLM`'s ``weight_shapes``), views of one float32 buffer on
    ``device``, each drawn in turn from one generator: normal with std
    ``initializer_range`` for every matrix; RMSNorm gains 1; A_log, dt_bias,
    the selection bias and the convolutions' filters as the configuration's
    ``assumed`` says."""
    from tensorframes_tpu_torch.models.kimi_linear import weight_shapes

    shapes = weight_shapes(config)
    flat = torch.empty(sum(math.prod(s) for s in shapes.values()), dtype=torch.float32,
                       device=device)
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, _WEIGHTS))
    out, off = {}, 0
    for name, shape in shapes.items():
        t = out[name] = flat[off:off + math.prod(shape)].view(shape)
        _draw(name, t, config["initializer_range"], gen)
        off += t.numel()
    return out


def moe_layers(config: Dict) -> int:
    return config["num_hidden_layers"] - config["first_k_dense_replace"]


def work(config: Dict, traffic: Dict) -> Dict:
    """One call's work, counted from shapes."""
    seqs, seq, blocks = traffic["sequences"], traffic["seq_len"], traffic["blocks"]
    tokens = seqs * seq
    lac = config["linear_attn_config"]
    heads = config["num_attention_heads"]
    flops = yardstick_kda.flops_per_token(config, seq)
    return {
        "items": tokens,
        "model_flops": tokens * flops["total"],
        # the products alone: every part but the recurrence and the attention
        "gemm_flops": tokens * (flops["total"] - flops["kda_recurrence"]
                                - flops["mla_attention"]),
        "expert_flops_per_pair": yardstick_kda.expert_flops_per_pair(config),
        # every pair a call routes, held here or not
        "routed_pairs": tokens * config["num_experts_per_token"] * moe_layers(config),
        # one attention launch an MLA layer a block: (BH, S, scores' depth,
        # values' width, causal), launches
        "mla": [(seqs // blocks * heads, seq,
                 config["qk_nope_head_dim"] + config["qk_rope_head_dim"],
                 config["v_head_dim"], True),
                len(lac["full_attn_layers"]) * blocks],
        # one recurrence launch a KDA layer a block: (B, S, H, D), launches
        "kda": [(seqs // blocks, seq, lac["num_heads"], lac["head_dim"]),
                len(lac["kda_layers"]) * blocks],
    }


def _counters() -> Dict[str, float]:
    from tensorframes_tpu_torch.utils import profiling

    return {k: v for k, v in profiling.stats().items() if k.startswith(("moe.", "kda."))}


class _Cell:
    def __init__(self, ctx):
        # the model class first: a program without it fails here, before a
        # weight is drawn
        from tensorframes_tpu_torch.models import KimiLinearLM
        import tensorframes_tpu_torch as tft
        from tensorframes_tpu_torch.ops.flash_attention import flash_attention
        from tensorframes_tpu_torch.utils import telemetry

        self.ctx, self.tft, self._fa = ctx, tft, flash_attention
        cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
        if traffic["sequences"] % traffic["blocks"]:
            raise ValueError("blocks must divide the sequences")
        tft.config.update(telemetry_ring_entries=_RING_ENTRIES)
        telemetry.reset()
        self.model = KimiLinearLM(cfg, make_weights(cfg, ctx.seed, dev))
        self.frames = [
            tft.TensorFrame([tft.Column("tokens", make_tokens(cfg, traffic, ctx.seed, f, dev))])
            .repartition(traffic["blocks"])
            for f in range(traffic["frames"])
        ]
        self.work = work(cfg, traffic)
        self._rng = random.Random(derived_seed(ctx.seed, 7))
        self._kept: List = []  # (call index, frame, logits, experts), a reservoir
        self._seen = 0
        self._snaps: List[Dict[str, float]] = []

    def _score(self, tokens):
        logits, experts = self.model(tokens, routing=True)
        return {"logits": logits, "experts": experts}

    def call(self, i: int):
        return self.tft.map_blocks(self._score, self.frames[i % len(self.frames)],
                                   device=self.ctx.device)

    def keep(self, i: int, out) -> None:
        """A reservoir sample of ``check_calls`` of the window's calls."""
        k = self.ctx.traffic["check_calls"]
        item = (i, i % len(self.frames), out.column("logits").values,
                out.column("experts").values)
        self._seen += 1
        if len(self._kept) < k:
            self._kept.append(item)
        else:
            j = self._rng.randrange(self._seen)
            if j < k:
                self._kept[j] = item

    def counters(self) -> Dict[str, float]:
        """The attention kernel's launches by route and the ``moe.*`` and
        ``kda.*`` counters; each reading is kept, so that `check` can count
        the pairs routed between the window's first and last."""
        out = {f"flash_attention.{r}": n for r, n in self._fa.launches_by_route.items()}
        out.update(_counters())
        self._snaps.append(out)
        return out

    def release(self) -> None:
        del self.model, self.frames

    def check(self, limits: Dict[str, float]) -> List[Compared]:
        kept = [item[1:] for item in sorted(self._kept, key=lambda x: x[0])]
        self._kept.clear()
        before, after = (self._snaps[-2:] if len(self._snaps) >= 2 else ({}, {}))
        pairs = sum(after.get(c, 0) - before.get(c, 0) for c in _PAIR_COUNTERS)
        return compare(self.ctx.config, self.ctx.traffic, self.ctx.seed, self.ctx.device, kept,
                       limits, (pairs, self.work["routed_pairs"] * self._seen))


def compare(config: Dict, traffic: Dict, seed: int, device, kept: List,
            limits: Dict[str, float], routed: Tuple[float, float]) -> List[Compared]:
    """The check of a run: ``kept`` holds (frame, logits, experts) of each
    sampled call; every token's logits are held to the float32 reference
    (TF32 off) over that frame's tokens, computed again from the seed on
    ``device``, the reference following the reported experts inside the
    near-tie band ``check_tie_gap``. ``routed`` is (pairs the program's
    counters gave, held here or not, pairs the window's calls route)."""
    weights = make_weights(config, seed, device)
    k, layers = config["num_experts_per_token"], moe_layers(config)
    total, _ = reference.held_range(config)
    err, wrong, tied, tokens_seen = 0.0, 0, 0, 0
    for frame, got, experts in kept:
        tokens = make_tokens(config, traffic, seed, frame, device)
        if (tuple(got.shape) != (*tokens.shape, config["vocab_size"])
                or got.dtype != torch.float32 or tuple(experts.shape) != (*tokens.shape, layers, k)
                or bool(((experts < 0) | (experts >= total)).any())):
            err = math.inf
            continue
        lo = 0
        with reference.matmul_precision(tf32=False):
            for want, ties, off, _ in reference.forward_blocks(
                    weights, tokens, config, traffic["check_block"], follow=experts,
                    tie_gap=traffic["check_tie_gap"]):
                g = got[lo:lo + len(want)]
                lo += len(want)
                tied += int(ties.sum())
                wrong += int(off.sum())
                tokens_seen += ties.numel()
                gap = (g - want).abs().max()
                err = max(err, float(gap) if torch.isfinite(gap) else math.inf)
    del weights
    share = tied / tokens_seen if tokens_seen else 0.0
    pairs_wrong = abs(float(routed[0]) - float(routed[1]))
    values = {"logits_max_abs_err": err, "routing_wrong": float(wrong),
              "tied_token_share": share, "routed_pairs_wrong": pairs_wrong}
    return [Compared(n, v, limits[n], v <= limits[n]) for n, v in values.items()]


def setup(ctx) -> _Cell:
    return _Cell(ctx)
