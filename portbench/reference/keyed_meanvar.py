"""Keyed mean and mean of squares in plain float64 PyTorch: the reference
the aggregate cells are held to, and its bfloat16 control.

For every key present, ``m[k] = mean(v[i] for key[i] == k)`` and ``q[k] =
mean(v[i]**2 ...)``, column by column; the variance is ``q - m**2``. The
sums run over blocks of rows in float64 with `index_add_`, on whatever
device the rows lie, so a check over several hundred million rows needs
one block's float64 copy at a time. It imports no part of the program.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["KeyedSums", "accumulate", "means", "means_bf16"]


class KeyedSums:
    """Running float64 per-key row counts, sums and sums of squares."""

    def __init__(self, groups: int, width: int, device):
        self.count = torch.zeros(groups, dtype=torch.float64, device=device)
        self.s = torch.zeros(groups, width, dtype=torch.float64, device=device)
        self.sq = torch.zeros(groups, width, dtype=torch.float64, device=device)

    def add(self, other: "KeyedSums") -> None:
        self.count += other.count.to(self.count.device)
        self.s += other.s.to(self.s.device)
        self.sq += other.sq.to(self.sq.device)


def accumulate(sums: KeyedSums, keys: torch.Tensor, values: torch.Tensor,
               block_rows: int = 1 << 24) -> KeyedSums:
    """Add ``values`` (N, W) grouped by ``keys`` (N,) ints in [0, groups)."""
    for lo in range(0, keys.shape[0], block_rows):
        k = keys[lo:lo + block_rows].to(sums.count.device, torch.int64)
        v = values[lo:lo + block_rows].to(sums.s.device, torch.float64)
        sums.count.index_add_(0, k, torch.ones_like(k, dtype=torch.float64))
        sums.s.index_add_(0, k, v)
        sums.sq.index_add_(0, k, v * v)
    return sums


def means(sums: KeyedSums) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(present keys, m, q): the keys with rows, ascending, and their float64
    means and means of squares."""
    present = torch.nonzero(sums.count > 0).reshape(-1)
    n = sums.count[present].reshape(-1, 1)
    return present.cpu(), (sums.s[present] / n).cpu(), (sums.sq[present] / n).cpu()


def means_bf16(parts, groups: int, block_rows: int = 1 << 20):
    """The control: the same means computed in bfloat16. ``parts`` yields
    (keys, values) row sets. Values are rounded to bfloat16, each block's
    per-key sums are accumulated in float32 (as bfloat16 kernels do) and
    rounded to bfloat16, the block partials and the means are bfloat16.
    Returns (present keys, m, q) as float64 on the CPU."""
    bf = torch.bfloat16
    count = s = sq = None
    for keys, values in parts:
        width = values.shape[1]
        if count is None:
            count = torch.zeros(groups, dtype=torch.float64, device=values.device)
            s = torch.zeros(groups, width, dtype=bf, device=values.device)
            sq = torch.zeros(groups, width, dtype=bf, device=values.device)
        for lo in range(0, keys.shape[0], block_rows):
            k = keys[lo:lo + block_rows].to(torch.int64)
            v = values[lo:lo + block_rows].to(bf)
            count.index_add_(0, k, torch.ones_like(k, dtype=torch.float64))
            part = torch.zeros(groups, width, dtype=torch.float32, device=v.device)
            s += part.index_add(0, k, v.float()).to(bf)
            part.zero_()
            sq += part.index_add_(0, k, (v * v).float()).to(bf)
    present = torch.nonzero(count > 0).reshape(-1)
    n = count[present].to(bf).reshape(-1, 1)
    return (present.cpu(), (s[present] / n).double().cpu(), (sq[present] / n).double().cpu())
