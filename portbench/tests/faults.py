"""Faults planted under the timed path, each of which the check must
catch: the program's entry points replaced by broken versions."""

from __future__ import annotations

import torch


def _lm_altered():
    """One logit of every block changed where the model produces it."""
    from tensorframes_tpu_torch.models import TransformerLM

    orig = TransformerLM.apply

    def apply(self, *a, **kw):
        out = orig(self, *a, **kw)
        out[0, 0, 0] += 1.0
        return out

    TransformerLM.apply = apply


def _lm_half_batch():
    """Only the first half of a block's sequences scored; the rest copy it."""
    from tensorframes_tpu_torch.models import TransformerLM

    orig = TransformerLM.apply

    def apply(self, params, tokens, *a, **kw):
        half = max(1, tokens.shape[0] // 2)
        out = orig(self, params, tokens[:half], *a, **kw)
        return torch.cat([out] * (tokens.shape[0] // half) + [out[: tokens.shape[0] % half]])

    TransformerLM.apply = apply


def _half_rows(grouped):
    import tensorframes_tpu_torch as tft

    f = grouped.frame
    half = f.nrows // 2
    cols = [tft.Column(n, f.column(n).values[:half]) for n in f.columns]
    return tft.group_by(tft.TensorFrame(cols), *grouped.keys)


def _agg_half_batch():
    """The aggregate over the first half of the rows, the means taken over
    them."""
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch.parallel import multihost

    local, glob = tft.aggregate, multihost.aggregate_global
    tft.aggregate = lambda fetches, grouped, **kw: local(fetches, _half_rows(grouped), **kw)
    multihost.aggregate_global = lambda fetches, grouped, **kw: glob(
        fetches, _half_rows(grouped), **kw)


def _agg_altered():
    """One mean of every call changed where the aggregate produces it."""
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch.parallel import multihost

    def altered(verb):
        def call(*a, **kw):
            out = verb(*a, **kw)
            out.column("m").values[0, 0] += 1e-3
            return out
        return call

    tft.aggregate = altered(tft.aggregate)
    multihost.aggregate_global = altered(multihost.aggregate_global)


def _no_exchange():
    """Each rank's own aggregate returned: the exchange between cards left
    out."""
    import tensorframes_tpu_torch as tft
    from tensorframes_tpu_torch.parallel import multihost

    multihost.aggregate_global = lambda fetches, grouped, **kw: tft.aggregate(
        fetches, grouped, **kw)


FAULTS = {
    "lm_altered": _lm_altered,
    "lm_half_batch": _lm_half_batch,
    "agg_half_batch": _agg_half_batch,
    "agg_altered": _agg_altered,
    "no_exchange": _no_exchange,
}


def plant(name: str) -> None:
    if name:
        FAULTS[name]()
