"""Deterministic fault injection at the ingest pipeline's stage seam.

The PyTorch counterpart of the stage half of
`tensorframes_tpu/testing/faults.py`: `inject_stage` installs a
`StageFaultPlan` on `ingest.pipeline.set_stage_fault_injector`, and every
attempt of the targeted stage draws a seeded verdict that may raise a
classified `InjectedFault` (``tfs_fault_class`` stamped, so
`runtime.faults.classify` needs no pattern matching) or wedge the stage
for ``delay_s`` (``fault="hang"``). Usage::

    from tensorframes_tpu_torch.testing import faults as chaos

    with chaos.inject_stage(stage="decode", nth=[1]) as plan:
        total = tft.reduce_blocks_stream(s, tft.stream_dataset(root))
    assert plan.injected == 1

Determinism: attempt ``ordinal`` fires when it is in ``nth``, or when
``random.Random(seed * PRIME + ordinal)`` draws under ``rate``. A retried
chunk is a new ordinal, so an ``nth`` fault fires once.

The executor-seam ``inject`` of the JAX module is not in the port yet.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from typing import Iterable, Optional, Sequence

from ..runtime import faults as _rt_faults

__all__ = ["InjectedFault", "StageFaultPlan", "inject_stage", "HANG"]

_PRIME = 1_000_003

# the fourth injectable "fault": not an error but a WEDGE — the stage
# sleeps ``delay_s`` before proceeding, cooperatively (it wakes at
# pipeline teardown, or raises at the ambient deadline)
HANG = "hang"
_FAULT_CLASSES = (
    _rt_faults.TRANSIENT, _rt_faults.RESOURCE, _rt_faults.DETERMINISTIC,
    HANG,
)


def _hang_sleep(delay_s: float, what: str) -> None:
    """The cooperative wedge: on an ingest worker thread, wait on the
    pipeline's cancel event (wakes at teardown); on a verb thread, sleep
    against the ambient CancelScope (raises `DeadlineExceeded` when the
    budget expires mid-sleep); with neither, a plain sleep."""
    from ..ingest.pipeline import current_cancel_event
    from ..runtime import deadline as _dl

    ev = current_cancel_event()
    if ev is not None:
        ev.wait(float(delay_s))
        return
    scope = _dl.current_scope()
    if scope is not None:
        scope.sleep(float(delay_s), what)
    else:
        time.sleep(float(delay_s))


class InjectedFault(RuntimeError):
    """A fault raised by the harness. Carries ``tfs_fault_class`` (what
    `runtime.faults.classify` honors first) plus the attempt ordinal and
    the stage name."""

    def __init__(self, message: str, fault_class: str, ordinal: int,
                 kind: str):
        super().__init__(message)
        self.tfs_fault_class = fault_class
        self.ordinal = ordinal
        self.kind = kind


class StageFaultPlan:
    """One active ingest-stage injection campaign. Ordinals count HOOK
    INVOCATIONS on the targeted stage (not chunk indices)."""

    def __init__(
        self,
        stage: Optional[str] = "decode",
        rate: float = 0.0,
        seed: int = 0,
        fault: str = _rt_faults.TRANSIENT,
        nth: Optional[Iterable[int]] = None,
        max_faults: Optional[int] = None,
        delay_s: float = 0.05,
    ):
        if fault not in _FAULT_CLASSES:
            raise ValueError(f"unknown fault class {fault!r}")
        self.stage = stage
        self.rate = float(rate)
        self.seed = int(seed)
        self.fault = fault
        self.delay_s = float(delay_s)
        self.nth = None if nth is None else {int(n) for n in nth}
        self.max_faults = max_faults
        self._lock = threading.Lock()
        self._ordinal = 0
        self.injected = 0
        self.attempts = 0
        self.faulted_ordinals: list = []

    def _hook(self, stage_name: str, item) -> None:
        if self.stage is not None and stage_name != self.stage:
            return
        with self._lock:
            ordinal = self._ordinal
            self._ordinal += 1
            self.attempts += 1
            if self.max_faults is not None and self.injected >= self.max_faults:
                return
        if self.nth is not None:
            fire = ordinal in self.nth
        elif self.rate > 0.0:
            fire = (
                random.Random(self.seed * _PRIME + ordinal).random()
                < self.rate
            )
        else:
            fire = False
        if not fire:
            return
        with self._lock:
            self.injected += 1
            self.faulted_ordinals.append(ordinal)
        if self.fault == HANG:
            _hang_sleep(
                self.delay_s,
                f"injected stage hang (stage={stage_name!r}, "
                f"attempt #{ordinal})",
            )
            return
        tag = {
            _rt_faults.TRANSIENT: "UNAVAILABLE: injected shard-read failure",
            _rt_faults.RESOURCE:
                "RESOURCE_EXHAUSTED: injected decode out of memory",
            _rt_faults.DETERMINISTIC: "injected corrupt shard",
        }[self.fault]
        raise InjectedFault(
            f"{tag} (stage={stage_name!r}, attempt #{ordinal})",
            self.fault, ordinal, stage_name,
        )


@contextlib.contextmanager
def inject_stage(
    stage: Optional[str] = "decode",
    rate: float = 0.0,
    seed: int = 0,
    fault: str = _rt_faults.TRANSIENT,
    nth: Optional[Sequence[int]] = None,
    max_faults: Optional[int] = None,
    delay_s: float = 0.05,
):
    """Install a `StageFaultPlan` on the ingest pipeline's stage seam for
    the enclosed block (``stage=None`` = all stages); yields the plan. One
    plan at a time — nesting raises."""
    from ..ingest import pipeline as _pipe

    if _pipe._stage_fault_injector is not None:
        raise RuntimeError(
            "an ingest-stage fault-injection plan is already active; "
            "nest-free by design (ordinal determinism)"
        )
    plan = StageFaultPlan(
        stage=stage, rate=rate, seed=seed, fault=fault, nth=nth,
        max_faults=max_faults, delay_s=delay_s,
    )
    _pipe.set_stage_fault_injector(plan._hook)
    try:
        yield plan
    finally:
        _pipe.set_stage_fault_injector(None)
