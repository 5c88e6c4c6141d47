"""Deterministic fault injection at the executor and ingest-stage seams.

The PyTorch counterpart of `tensorframes_tpu/testing/faults.py`.

`inject` installs a `FaultPlan` on `runtime.executor.set_fault_injector`:
every callable `Executor.cached` hands out is wrapped, and every call of
it (one block dispatch, a combine, a per-row call) draws a seeded verdict
that may raise a classified `InjectedFault` or wedge the dispatch for
``delay_s`` (``fault="hang"``, the stand-in for a stuck card that the
deadline and overload tests use). Filters compose: ``rate``/``nth``,
``kind`` (cache-kind prefix), ``program`` (graph-fingerprint prefix),
``device`` (the label, ``cuda:0`` / ``cpu:0``, of the first tensor
argument) and ``max_faults``::

    from tensorframes_tpu_torch.testing import faults as chaos

    with chaos.inject(nth=[0], fault="hang", delay_s=30.0):
        tft.map_blocks(z, df, timeout_s=0.5)   # DeadlineExceeded

`inject_stage` installs a
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
dispatch or chunk is a new ordinal, so an ``nth`` fault fires once. One
plan per seam at a time: nesting raises.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from typing import Iterable, Optional, Sequence

from ..runtime import executor as _exmod
from ..runtime import faults as _rt_faults

__all__ = [
    "InjectedFault", "FaultPlan", "inject",
    "StageFaultPlan", "inject_stage", "HANG",
]

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


def _args_device_label(args) -> Optional[str]:
    """``type:index`` of the first tensor argument's device."""
    import torch

    for a in args:
        if isinstance(a, torch.Tensor):
            return f"{a.device.type}:{a.device.index or 0}"
    return None


def _dispatch_device_label(key, args) -> Optional[str]:
    """``type:index`` of the device a cached program was built for (the
    executor key names it): the label the scheduler placed the dispatch
    on, also for CPU stand-ins (``torch.device("cpu", i)``), whose tensors
    all report the one CPU. Else the first tensor argument's."""
    import torch

    try:
        d = torch.device(key[-1])
        return f"{d.type}:{d.index or 0}"
    except Exception:
        return _args_device_label(args)


class FaultPlan:
    """One active executor-seam injection campaign (thread-safe dispatch
    counter and verdict bookkeeping)."""

    def __init__(
        self,
        rate: float = 0.0,
        seed: int = 0,
        fault: str = _rt_faults.TRANSIENT,
        nth: Optional[Iterable[int]] = None,
        kind: Optional[str] = None,
        program: Optional[str] = None,
        device: Optional[str] = None,
        max_faults: Optional[int] = None,
        delay_s: float = 0.05,
    ):
        if fault not in _FAULT_CLASSES:
            raise ValueError(f"unknown fault class {fault!r}")
        self.rate = float(rate)
        self.seed = int(seed)
        self.fault = fault
        self.delay_s = float(delay_s)
        self.nth = None if nth is None else {int(n) for n in nth}
        self.kind = kind
        self.program = program
        self.device = device
        self.max_faults = max_faults
        self._lock = threading.Lock()
        self._ordinal = 0
        self._fired: set = set()
        self.injected = 0
        self.dispatches = 0
        self.faulted_ordinals: list = []
        self.faulted_devices: list = []

    def _next_ordinal(self) -> int:
        with self._lock:
            o = self._ordinal
            self._ordinal += 1
            self.dispatches += 1
            return o

    def _ordinal_fires(self, ordinal: int) -> bool:
        if self.nth is not None:
            return ordinal in self.nth and ordinal not in self._fired
        if self.rate <= 0.0:
            return False
        return random.Random(self.seed * _PRIME + ordinal).random() < self.rate

    def _should_fire(self, ordinal: int, key, args) -> bool:
        if self.max_faults is not None and self.injected >= self.max_faults:
            return False
        if self.kind is not None and not str(key[0]).startswith(self.kind):
            return False
        if self.program is not None and not str(key[1]).startswith(
            self.program
        ):
            return False
        if not self._ordinal_fires(ordinal):
            return False
        if self.device is not None and _dispatch_device_label(key, args) != self.device:
            return False
        return True

    def _hook(self, fn, key):
        """The `Executor.cached` hook: wraps ``fn`` for this plan."""
        plan = self

        def wrapper(*args, **kwargs):
            ordinal = plan._next_ordinal()
            if plan._should_fire(ordinal, key, args):
                dev = _dispatch_device_label(key, args)
                with plan._lock:
                    plan._fired.add(ordinal)
                    plan.injected += 1
                    plan.faulted_ordinals.append(ordinal)
                    plan.faulted_devices.append(dev)
                if plan.fault == HANG:
                    # a wedge, not an error: sleep cooperatively (the
                    # verb's deadline raises mid-sleep), then dispatch
                    _hang_sleep(
                        plan.delay_s,
                        f"injected hang (dispatch #{ordinal}, "
                        f"kind={key[0]!r})",
                    )
                    return fn(*args, **kwargs)
                tag = {
                    _rt_faults.TRANSIENT: "UNAVAILABLE: injected device loss",
                    _rt_faults.RESOURCE:
                        "RESOURCE_EXHAUSTED: injected out of memory",
                    _rt_faults.DETERMINISTIC: "injected deterministic error",
                }[plan.fault]
                raise InjectedFault(
                    f"{tag} (dispatch #{ordinal}, kind={key[0]!r}"
                    f"{', device=' + dev if dev else ''})",
                    plan.fault, ordinal, str(key[0]),
                )
            return fn(*args, **kwargs)

        wrapper.__wrapped__ = fn
        return wrapper


@contextlib.contextmanager
def inject(
    rate: float = 0.0,
    seed: int = 0,
    fault: str = _rt_faults.TRANSIENT,
    nth: Optional[Sequence[int]] = None,
    kind: Optional[str] = None,
    program: Optional[str] = None,
    device: Optional[str] = None,
    max_faults: Optional[int] = None,
    delay_s: float = 0.05,
):
    """Install a `FaultPlan` on the executor seam for the enclosed block;
    yields the plan (``plan.injected`` / ``plan.dispatches`` /
    ``plan.faulted_ordinals``). One plan at a time: nesting raises, since
    two plans sharing one ordinal counter would change each other's
    draws."""
    if _exmod._fault_injector is not None:
        raise RuntimeError(
            "a fault-injection plan is already active; nest-free by "
            "design (ordinal determinism)"
        )
    plan = FaultPlan(
        rate=rate, seed=seed, fault=fault, nth=nth, kind=kind,
        program=program, device=device, max_faults=max_faults,
        delay_s=delay_s,
    )
    _exmod.set_fault_injector(plan._hook)
    try:
        yield plan
    finally:
        _exmod.set_fault_injector(None)


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
