"""Keyed mean and mean of squares: ``aggregate([m, q], group_by(frame,
"k"))`` with ``m = reduce_mean(v)`` and ``q = reduce_mean(v * v)`` over
axis 0, the variance being ``q - m**2`` (BASELINE config 4, the
reference's ``tfs.aggregate(x, df.groupBy("key"))``).

The configuration gives the rows a card holds (``rows_per_card`` rows of
``width`` float32 values and an int64 key among ``keys``, each row's drawn
uniformly); the traffic gives the blocks, how many frames are held
(``frames``: calls go round them, and each call groups anew, so no call is
served from an earlier one), and the warm-up calls. Rows are drawn on the
device from the seed, one generator a frame (and a rank).

``correct`` (`compare`): every call's key column, means and means of
squares, as the timed path returned them, against
`portbench.reference.keyed_meanvar` in float64 over the same rows:
``keys_wrong`` (calls whose keys are not the keys present, limit 0) and
``mean_rel_err`` (the widest relative gap of a mean or mean of square).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench import yardstick
from portbench.harness import Compared, derived_seed
from portbench.reference import keyed_meanvar as reference


def make_rows(config: Dict, seed: int, rank: int, frame: int, device):
    """(keys int64 (N,), values float32 (N, width)) of one frame of one
    rank: values uniform in [0, 1), keys uniform over ``keys``."""
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, rank, frame))
    n = config["rows_per_card"]
    values = torch.rand(n, config["width"], generator=gen, device=device)
    keys = torch.randint(0, config["keys"], (n,), generator=gen, device=device)
    return keys, values


def work(config: Dict, world: int) -> Dict:
    n = config["rows_per_card"]
    return {
        "items": n * world,
        # what one card's share of a call must move
        "bytes": yardstick.keyed_reduce_bytes(n, config["width"], 4, 8, config["keys"], 2),
    }


def reference_means(config: Dict, seed: int, frame: int, ranks: int, device):
    """(present keys, m, q) in float64 over frame ``frame`` of every rank,
    the rows drawn again from the seed on ``device``."""
    sums = reference.KeyedSums(config["keys"], config["width"], device)
    for r in range(ranks):
        keys, values = make_rows(config, seed, r, frame, device)
        reference.accumulate(sums, keys, values)
        del keys, values
    return reference.means(sums)


def compare(config: Dict, seed: int, device, kept: List, limits: Dict[str, float],
            ranks: int) -> List[Compared]:
    """The check of a run: ``kept`` holds (frame, keys, m, q) of each call,
    as NumPy arrays on the host, and every one is held to the float64
    reference over that frame of ``ranks`` ranks."""
    want = {f: reference_means(config, seed, f, ranks, device)
            for f in sorted({x[0] for x in kept})}
    wrong, err = 0, 0.0
    for f, k, m, q in kept:
        wk, wm, wq = want[f]
        if k.shape != tuple(wk.shape) or not (torch.from_numpy(k) == wk).all():
            wrong += 1
            continue
        for got, ref in ((m, wm), (q, wq)):
            gap = (torch.from_numpy(got).double() - ref).abs() / ref.abs()
            e = float(gap.max())
            err = max(err, e if e == e else float("inf"))
    if not kept:
        wrong = 1
    limit = limits["mean_rel_err"]
    return [Compared("keys_wrong", float(wrong), float(limits["keys_wrong"]),
                     wrong <= limits["keys_wrong"]),
            Compared("mean_rel_err", err, limit, err <= limit)]


class LocalCell:
    """One card's frames and graph, and the checks; the call is the
    subclass's or `aggregate`'s."""

    def __init__(self, ctx):
        import tensorframes_tpu_torch as tft

        self.ctx, self.tft = ctx, tft
        cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
        self.frames = []
        for f in range(traffic["frames"]):
            keys, values = make_rows(cfg, ctx.seed, ctx.rank, f, dev)
            self.frames.append(tft.TensorFrame([tft.Column("k", keys), tft.Column("v", values)])
                               .repartition(traffic["blocks"]))
        dsl, df = tft.dsl, self.frames[0]
        m = dsl.reduce_mean(dsl.block(df, "v", tf_name="m_input"), axes=[0]).named("m")
        q = dsl.reduce_mean(dsl.square(dsl.block(df, "v", tf_name="q_input")),
                            axes=[0]).named("q")
        self.fetches, self.feed = [m, q], {"m_input": "v", "q_input": "v"}
        self.work = work(cfg, ctx.world)
        self.kept: List = []  # (frame, keys, m, q) of every call of the window

    def grouped(self, i: int):
        return self.tft.group_by(self.frames[i % len(self.frames)], "k")

    def call(self, i: int):
        return self.tft.aggregate(self.fetches, self.grouped(i), feed_dict=self.feed,
                                  device=self.ctx.device)

    def keep(self, i: int, out) -> None:
        # copies: an output may be a view of a far larger buffer (a CUDA
        # `torch.unique` keeps its input's length of storage)
        self.kept.append((i % len(self.frames), *(out.column(c).values.clone()
                                                  for c in ("k", "m", "q"))))

    def counters(self) -> Dict[str, float]:
        return {}

    def release(self) -> None:
        del self.frames, self.fetches

    def host_kept(self) -> List:
        return [(f, k.cpu().numpy(), m.cpu().numpy(), q.cpu().numpy())
                for f, k, m, q in self.kept]

    def check(self, limits: Dict[str, float]) -> List[Compared]:
        kept = self.host_kept()
        self.kept.clear()
        return compare(self.ctx.config, self.ctx.seed, self.ctx.device, kept, limits, 1)


def setup(ctx) -> LocalCell:
    return LocalCell(ctx)
