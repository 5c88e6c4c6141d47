"""Scoring a token table with a decoder LM: ``map_blocks`` of a plain
function ``{"logits": model(tokens)}`` over a frame of sequences.

The configuration gives the model's widths (Hugging Face GPT-2 keys); the
traffic gives the frame (``sequences`` x ``seq_len`` token ids in
``blocks`` blocks), how many such frames are held (``frames``; calls go
round them, so no call repeats the last one's input), the warm-up calls,
and how many calls of the window are checked (``check_calls``, a seeded
sample). Weights are drawn on the device from the seed with GPT-2's
initialisation law, in one call, and handed to the program as the
`TransformerLM`'s parameter dict; the reference draws them again.

``correct`` (`compare`): the logits of the sampled calls, as the timed
path returned them, against `portbench.reference.gpt2` in float32 with TF32 off on the
same tokens: the widest absolute gap over every logit
(``logits_max_abs_err``).
"""

from __future__ import annotations

import math
import random
from typing import Dict, List

import torch

from portbench import yardstick
from portbench.harness import Compared, derived_seed
from portbench.reference import gpt2 as reference

_WEIGHTS, _TOKENS = 0, 1  # derived-seed streams


def widths(config: Dict) -> Dict[str, int]:
    return dict(vocab=config["vocab_size"], d=config["n_embd"], heads=config["n_head"],
                layers=config["n_layer"], positions=config["n_positions"])


def make_weights(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's weights from ``seed``, drawn on ``device`` in one call:
    GPT-2's law (normal, std ``initializer_range``; positions 0.01; the
    residual outputs, proj and mlp_down, scaled by 1/sqrt(2 n_layer));
    LayerNorm gains 1 and biases 0. Views of one buffer, in the layout of
    `portbench.reference.gpt2`."""
    w = widths(config)
    v, d, n, p = w["vocab"], w["d"], w["layers"], w["positions"]
    std = config["initializer_range"]
    shapes = {"embed": ((v, d), std), "pos": ((p, d), 0.01)}
    for i in range(n):
        shapes[f"l{i}_qkv"] = ((d, 3 * d), std)
        shapes[f"l{i}_proj"] = ((d, d), std / math.sqrt(2 * n))
        shapes[f"l{i}_mlp_up"] = ((d, 4 * d), std)
        shapes[f"l{i}_mlp_down"] = ((4 * d, d), std / math.sqrt(2 * n))
    total = sum(math.prod(s) for s, _ in shapes.values())
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, _WEIGHTS))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, (shape, scale) in shapes.items():
        size = math.prod(shape)
        out[name] = flat[off:off + size].view(shape).mul_(scale)
        off += size
    ln = torch.stack([torch.ones(d, device=device), torch.zeros(d, device=device)])
    for i in range(n):
        out[f"l{i}_ln1"] = ln.clone()
        out[f"l{i}_ln2"] = ln.clone()
    out["ln_f_g"], out["ln_f_b"] = ln[0].clone(), ln[1].clone()
    return out


def make_tokens(config: Dict, traffic: Dict, seed: int, frame: int, device) -> torch.Tensor:
    """Frame ``frame``'s token ids, uniform over the vocabulary."""
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, _TOKENS, frame))
    return torch.randint(0, config["vocab_size"], (traffic["sequences"], traffic["seq_len"]),
                         generator=gen, device=device, dtype=torch.int64)


def work(config: Dict, traffic: Dict) -> Dict:
    """One call's work, counted from shapes."""
    w = widths(config)
    seqs, seq, blocks = traffic["sequences"], traffic["seq_len"], traffic["blocks"]
    tokens = seqs * seq
    per_token = yardstick.lm_flops_per_token(w["layers"], w["d"], w["vocab"], seq)
    return {
        "items": tokens,
        "model_flops": tokens * per_token,
        "gemm_flops": tokens * yardstick.lm_gemm_flops_per_token(w["layers"], w["d"], w["vocab"]),
        # one attention launch a layer a block: (BH, S, head_dim, causal), launches
        "attention": [(seqs // blocks * w["heads"], seq, w["d"] // w["heads"], True),
                      w["layers"] * blocks],
    }


class _Cell:
    def __init__(self, ctx):
        import tensorframes_tpu_torch as tft
        from tensorframes_tpu_torch.models import TransformerLM
        from tensorframes_tpu_torch.ops.flash_attention import flash_attention

        self.ctx, self.tft, self._fa = ctx, tft, flash_attention
        cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
        w = widths(cfg)
        if cfg["n_embd"] % cfg["n_head"] or traffic["sequences"] % traffic["blocks"]:
            raise ValueError("heads must divide n_embd and blocks the sequences")
        # the module with its parameter dict assigned: its own initialiser
        # would draw every weight on the host first
        model = TransformerLM(vocab=1, d_model=w["d"], n_heads=w["heads"], n_layers=0,
                              max_seq=1, device=dev)
        weights = make_weights(cfg, ctx.seed, dev)
        model.vocab, model.n_layers = w["vocab"], w["layers"]
        model.params = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(v, requires_grad=False) for k, v in weights.items()})
        self.model = model
        self.frames = [
            tft.TensorFrame([tft.Column("tokens", make_tokens(cfg, traffic, ctx.seed, f, dev))])
            .repartition(traffic["blocks"])
            for f in range(traffic["frames"])
        ]
        self.work = work(cfg, traffic)
        self._rng = random.Random(derived_seed(ctx.seed, 7))
        self._kept: List = []  # (call index, frame, logits), a reservoir
        self._seen = 0

    def _score(self, tokens):
        return {"logits": self.model(tokens)}

    def call(self, i: int):
        return self.tft.map_blocks(self._score, self.frames[i % len(self.frames)],
                                   device=self.ctx.device)

    def keep(self, i: int, out) -> None:
        """A reservoir sample of ``check_calls`` of the window's calls."""
        k = self.ctx.traffic["check_calls"]
        item = (i, i % len(self.frames), out.column("logits").values)
        self._seen += 1
        if len(self._kept) < k:
            self._kept.append(item)
        else:
            j = self._rng.randrange(self._seen)
            if j < k:
                self._kept[j] = item

    def counters(self) -> Dict[str, float]:
        return {f"flash_attention.{r}": n for r, n in self._fa.launches_by_route.items()}

    def release(self) -> None:
        del self.model, self.frames

    def check(self, limits: Dict[str, float]) -> List[Compared]:
        kept = [(frame, got) for _, frame, got in sorted(self._kept, key=lambda x: x[0])]
        self._kept.clear()
        return compare(self.ctx.config, self.ctx.traffic, self.ctx.seed, self.ctx.device, kept,
                       limits)


def compare(config: Dict, traffic: Dict, seed: int, device, kept: List,
            limits: Dict[str, float]) -> List[Compared]:
    """The check of a run: ``kept`` holds (frame, logits) of each sampled
    call, and every logit is held to the float32 reference (TF32 off) over
    that frame's tokens, computed again from the seed on ``device``."""
    w = widths(config)
    weights = make_weights(config, seed, device)
    err = 0.0
    for frame, got in kept:
        tokens = make_tokens(config, traffic, seed, frame, device)
        if tuple(got.shape) != (*tokens.shape, w["vocab"]) or got.dtype != torch.float32:
            err = math.inf
            continue
        lo = 0
        with reference.matmul_precision(tf32=False):
            for want in reference.logits_blocks(weights, tokens, w["heads"], w["layers"],
                                                traffic["check_block"]):
                gap = (got[lo:lo + len(want)] - want).abs().max()
                err = max(err, float(gap) if torch.isfinite(gap) else math.inf)
                lo += len(want)
    limit = limits["logits_max_abs_err"]
    return [Compared("logits_max_abs_err", err, limit, err <= limit)]


def setup(ctx) -> _Cell:
    return _Cell(ctx)
