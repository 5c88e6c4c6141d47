"""Scoring a token table with a DeepSeek-V2 model (latent attention, routed
experts): ``map_blocks`` of a plain function ``{"logits": ..., "experts":
...} = model(tokens, routing=True)`` over a frame of sequences: the logits,
and the experts each token was routed to at each MoE layer (a (S, 26, 6)
int64 cell a sequence, 0.6% of the logits' bytes), which the check needs.

The configuration is the published ``config.json`` (DeepSeek-V2 keys); the
traffic gives the frame (``sequences`` x ``seq_len`` token ids in
``blocks`` blocks), how many such frames are held (``frames``; calls go
round them), the warm-up calls, how many calls of the window are checked
(``check_calls``, a seeded sample), the reference's block of sequences
(``check_block``) and the near-tie band of the gate logits within which
the reference follows the program's experts (``check_tie_gap``). Token
ids follow a Zipf law (``zipf_exponent``) over a permutation of the
vocabulary drawn from the seed, as running text does:
identical tokens route alike, so the experts' loads are uneven. Weights
are drawn on the device from the seed (normal, std ``initializer_range``;
RMSNorm gains 1) in the program's layout, views of one buffer, and handed
to `DeepSeekV2LM` as its weight dict; the reference draws them again after
`release`.

``correct`` (`compare`): the logits of the sampled calls, as the timed path
returned them, against `portbench.reference.deepseek_v2` in float32 with
TF32 off on the same tokens. Routing has no tolerance, and a near-tie at the
top-k boundary (gate logits within ``check_tie_gap``) may go either way
under two float32 summation orders; one such pick moves that token's
logits, and through attention every later token's of its sequence, far more
than rounding does. So the reference follows the program's reported experts
inside the near-tie band and nowhere else (`reference.follow_routing`), and
the numbers are: the widest absolute gap over every logit
(``logits_max_abs_err``); token-layers whose reported experts lie outside
the band (``routing_wrong``); the share of tokens with a near-tie at some
MoE layer (``tied_token_share``); and how far the window's
``moe.routed_pairs`` counter is from tokens x ``num_experts_per_tok`` x MoE
layers x calls (``routed_pairs_wrong``).
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Tuple

import torch

from portbench import yardstick_moe
from portbench.harness import Compared, derived_seed
from portbench.reference import deepseek_v2 as reference

_WEIGHTS, _VOCAB, _TOKENS = 0, 1, 2  # derived-seed streams
_RING_ENTRIES = 1 << 16  # ~160 spans a call: a window's calls must all stay in the ring


def make_weights(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's weights from ``seed``, in the program's layout
    (`DeepSeekV2LM`'s ``weight_shapes``), views of one float32 buffer on
    ``device``: each matrix drawn in turn from one generator, normal with
    std ``initializer_range``; the RMSNorm gains 1."""
    from tensorframes_tpu_torch.models.deepseek_v2 import weight_shapes

    shapes = weight_shapes(config)
    flat = torch.empty(sum(math.prod(s) for s in shapes.values()), dtype=torch.float32,
                       device=device)
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, _WEIGHTS))
    out, off = {}, 0
    for name, shape in shapes.items():
        t = out[name] = flat[off:off + math.prod(shape)].view(shape)
        if len(shape) == 1:
            t.fill_(1.0)
        else:
            t.normal_(0.0, config["initializer_range"], generator=gen)
        off += t.numel()
    return out


def make_tokens(config: Dict, traffic: Dict, seed: int, frame: int, device) -> torch.Tensor:
    """Frame ``frame``'s token ids: ranks drawn from a Zipf law (P(r) ∝
    r^-``zipf_exponent``, r = 1..V, by the inverse of its float64 CDF),
    mapped through a permutation of the vocabulary drawn from ``seed``."""
    v = config["vocab_size"]
    perm = torch.randperm(v, generator=torch.Generator().manual_seed(
        derived_seed(seed, _VOCAB)))
    law = torch.arange(1, v + 1, dtype=torch.float64) ** -float(traffic["zipf_exponent"])
    cdf = (law.cumsum(0) / law.sum()).to(device)
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, _TOKENS, frame))
    u = torch.rand(traffic["sequences"] * traffic["seq_len"], generator=gen, device=device,
                   dtype=torch.float64)
    ranks = torch.searchsorted(cdf, u, right=True).clamp_(max=v - 1)
    return perm.to(device)[ranks].view(traffic["sequences"], traffic["seq_len"])


def moe_layers(config: Dict) -> int:
    return config["num_hidden_layers"] - config["first_k_dense_replace"]


def work(config: Dict, traffic: Dict) -> Dict:
    """One call's work, counted from shapes."""
    seqs, seq, blocks = traffic["sequences"], traffic["seq_len"], traffic["blocks"]
    tokens = seqs * seq
    heads = config["num_attention_heads"]
    return {
        "items": tokens,
        "model_flops": tokens * yardstick_moe.flops_per_token(config, seq)["total"],
        "expert_flops_per_pair": yardstick_moe.expert_flops_per_pair(config),
        "routed_pairs": tokens * config["num_experts_per_tok"] * moe_layers(config),
        # one attention launch a layer a block: (BH, S, scores' depth, values'
        # width, causal), launches
        "mla": [(seqs // blocks * heads, seq,
                 config["qk_nope_head_dim"] + config["qk_rope_head_dim"],
                 config["v_head_dim"], True),
                config["num_hidden_layers"] * blocks],
    }


def _moe_counters() -> Dict[str, float]:
    from tensorframes_tpu_torch.utils import profiling

    return {k: v for k, v in profiling.stats().items() if k.startswith("moe.")}


class _Cell:
    def __init__(self, ctx):
        # the model class first: a program without it fails here, before a
        # weight is drawn
        from tensorframes_tpu_torch.models import DeepSeekV2LM
        import tensorframes_tpu_torch as tft
        from tensorframes_tpu_torch.ops.flash_attention import flash_attention
        from tensorframes_tpu_torch.utils import telemetry

        self.ctx, self.tft, self._fa = ctx, tft, flash_attention
        cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
        if traffic["sequences"] % traffic["blocks"]:
            raise ValueError("blocks must divide the sequences")
        tft.config.update(telemetry_ring_entries=_RING_ENTRIES)
        telemetry.reset()
        self.model = DeepSeekV2LM(cfg, make_weights(cfg, ctx.seed, dev))
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
        """The attention kernel's launches by route and the ``moe.*``
        counters; each reading is kept, so that `check` can count the
        pairs routed between the window's first and last."""
        out = {f"flash_attention.{r}": n for r, n in self._fa.launches_by_route.items()}
        out.update(_moe_counters())
        self._snaps.append(out)
        return out

    def release(self) -> None:
        del self.model, self.frames

    def check(self, limits: Dict[str, float]) -> List[Compared]:
        kept = [item[1:] for item in sorted(self._kept, key=lambda x: x[0])]
        self._kept.clear()
        before, after = (self._snaps[-2:] if len(self._snaps) >= 2 else ({}, {}))
        pairs = after.get("moe.routed_pairs", 0) - before.get("moe.routed_pairs", 0)
        return compare(self.ctx.config, self.ctx.traffic, self.ctx.seed, self.ctx.device, kept,
                       limits, (pairs, self.work["routed_pairs"] * self._seen))


def compare(config: Dict, traffic: Dict, seed: int, device, kept: List,
            limits: Dict[str, float], routed: Tuple[float, float]) -> List[Compared]:
    """The check of a run: ``kept`` holds (frame, logits, experts) of each
    sampled call; every token's logits are held to the float32 reference
    (TF32 off) over that frame's tokens, computed again from the seed on
    ``device``, the reference following the reported experts inside the
    near-tie band ``check_tie_gap``. ``routed`` is (pairs the program's
    counter gave, pairs the window's calls need)."""
    weights = make_weights(config, seed, device)
    k, layers = config["num_experts_per_tok"], moe_layers(config)
    err, wrong, tied, tokens_seen = 0.0, 0, 0, 0
    for frame, got, experts in kept:
        tokens = make_tokens(config, traffic, seed, frame, device)
        if (tuple(got.shape) != (*tokens.shape, config["vocab_size"])
                or got.dtype != torch.float32 or tuple(experts.shape) != (*tokens.shape, layers, k)
                or bool(((experts < 0) | (experts >= config["n_routed_experts"])).any())):
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
