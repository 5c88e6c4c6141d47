"""The keyed mean and mean of squares of `aggregate` over every rank's rows:
`parallel.multihost.aggregate_global`, one process a card, each holding its
own ``rows_per_card`` rows (drawn from the seed and its rank).

The run's process is rank 0; it starts the other ranks (`portbench.run`)
and prints the line. Ranks join through `multihost.initialize_distributed`
(NCCL on the card, gloo on the CPU). The window runs in lockstep: after
each call every rank synchronises its card, and one all-reduce of a stop
flag, whose value rank 0 sets when the window's time is up, ends the call
on every rank together, so a call ends when every rank has its result.

``correct``: every call's result on every rank, gathered to rank 0 after
the window, against the float64 reference over the rows of every rank,
which rank 0 draws again from the seed (see `aggregate`).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

from portbench.drivers import aggregate as _local
from portbench.harness import Compared

RANKS = True
_TIMEOUT_S = 300.0


class _Cell(_local.LocalCell):
    def __init__(self, ctx):
        from tensorframes_tpu_torch.parallel import multihost

        self.mh = multihost
        dev = ctx.device
        multihost.initialize_distributed(
            coordinator_address=f"127.0.0.1:{ctx.port}", num_processes=ctx.world,
            process_id=ctx.rank, device="cpu" if dev.type == "cpu" else None,
            timeout_s=_TIMEOUT_S)
        # the benchmark's own group for its flags and its gathers
        self.group = dist.new_group(backend="gloo")
        super().__init__(ctx)
        self._flag = torch.zeros(1, dtype=torch.int32, device=dev)

    def call(self, i: int):
        return self.mh.aggregate_global(self.fetches, self.grouped(i), feed_dict=self.feed,
                                        device=self.ctx.device)

    def agree(self, stop: bool) -> bool:
        """Rank 0's stop decision, once every rank has finished its call."""
        self._flag.fill_(int(stop) if self.ctx.rank == 0 else 0)
        dist.all_reduce(self._flag, op=dist.ReduceOp.MAX)
        return bool(self._flag.item())

    def gather(self, obj) -> List:
        """Every rank's ``obj`` on rank 0 (None elsewhere)."""
        out = [None] * self.ctx.world if self.ctx.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.group)
        return out

    def check(self, limits: Dict[str, float]) -> List[Compared]:
        every = self.gather(self.host_kept())
        self.kept.clear()
        result = []
        if self.ctx.rank == 0:
            kept = [x for rank_kept in every for x in rank_kept]
            result = _local.compare(self.ctx.config, self.ctx.seed, self.ctx.device, kept,
                                    limits, self.ctx.world)
        dist.barrier(group=self.group)
        dist.destroy_process_group()
        return result


def setup(ctx) -> _Cell:
    return _Cell(ctx)
