"""Block placement over the cards, device failover, and the /healthz rows.

The PyTorch counterpart of `tensorframes_tpu/runtime/scheduler.py`.

- **Placement** (`plan`): blocks sorted by row count, largest first, each
  to the least-loaded device slot (LPT). Deterministic, so a rerun puts
  every block where it went before; zero-row blocks are left unassigned.
  The loop still runs in block order: placement decides where, not when.
- **Which devices** (`resolve`): ``mesh=`` owns its placement and wins;
  an explicit ``devices=`` list (card indices or devices) comes next; else
  ``config.block_scheduler``: ``"off"`` none, ``"on"`` every card (even
  one), ``"auto"`` and ``"global"`` every card when there are two or more.
  Devices whose failover circuit is open drop out of ``"auto"`` / ``"on"``.
- **One call's schedule** (`BlockSchedule`): the device of each item, read
  when the item dispatches (`device`, `put`, `bind`), so a retry after
  `evict` runs where the block was re-placed; the per-device
  ``device_dispatches`` ledger on the executor and the
  ``scheduler_queue_depth`` gauge; `progress` for the deadline stamps.
- **Failover** (`DeviceHealth`): a transient dispatch failure of a
  scheduled block opens its device's circuit for
  ``config.device_cooldown_s`` (doubling on repeats, at most 8x) and
  re-places the blocks not yet issued on the other devices (`evict`); the
  eviction is counted (``device_evictions``, the fault ledger's
  ``evictions``) and frozen by the flight recorder. After the cooldown one
  half-open probe may close the circuit. A one-device schedule has nowhere
  to go: the block retries in place and nothing is counted.
- **Health** (`health_overview`): one /healthz row per local device with
  its circuit state.

Devices are `torch.device` objects labelled ``type:index``
(`device_label`). The local devices are the CUDA cards; there is no CPU
fallback, so scheduling on a machine without a card raises. Tests stand in
for several devices with ``torch.device("cpu", i)``: the label keeps the
index (``cpu:i``) although tensors moved there land on the one CPU, so
labels are always read from the schedule, never from a tensor.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "BlockSchedule",
    "DeviceHealth",
    "device_health",
    "device_label",
    "global_device_set",
    "global_mode",
    "health_overview",
    "plan",
    "resolve",
    "schedule_for",
    "schedule_weights",
]

_MODES = ("auto", "on", "off", "global")


def device_label(dev) -> str:
    """``type:index`` of a `torch.device` (or a device string): the label
    dispatch spans, the executor's per-device ledgers and the circuit
    breaker key on. The CPU is ``cpu:0``."""
    d = torch.device(dev)
    return f"{d.type}:{d.index or 0}"


# ---------------------------------------------------------------------------
# device health: the failover circuit breaker
# ---------------------------------------------------------------------------


class DeviceHealth:
    """Per-device circuit breaker keyed by device label.

    *closed* (no entry) → a transient dispatch failure OPENS the circuit
    for ``config.device_cooldown_s`` (doubling on repeats, capped at 8x) →
    past the cooldown the next `usable` check makes it *half-open* and
    admits that caller as the one probe (later checks wait for its verdict,
    re-arming after another cooldown) → a successful dispatch closes it, a
    failure re-opens it with the doubled cooldown. Timestamps take an
    injectable ``now`` so tests need not sleep."""

    def __init__(self):
        self._lock = threading.Lock()
        self._states: Dict[str, Dict] = {}

    def mark_failure(self, label: str, now: Optional[float] = None) -> None:
        """A transient dispatch failure on ``label``: open (or re-open,
        with doubled cooldown) its circuit and count the eviction."""
        from .. import config as _config
        from ..utils import telemetry as _tele
        from ..utils.log import get_logger
        from . import faults as _faults

        now = time.monotonic() if now is None else now
        base = max(1e-3, float(_config.get().device_cooldown_s))
        with self._lock:
            st = self._states.get(label)
            if st is None:
                st = {"state": "open", "failures": 0, "cooldown": base,
                      "until": 0.0, "warned_pin": False}
                self._states[label] = st
            else:
                st["state"] = "open"
                st["cooldown"] = min(st["cooldown"] * 2.0, base * 8.0)
            st["failures"] += 1
            st["until"] = now + st["cooldown"]
            cooldown, failures = st["cooldown"], st["failures"]
        _faults.note_eviction()
        _tele.counter_inc("device_evictions", 1.0, device=label)
        get_logger("scheduler").warning(
            "device %s evicted after a transient dispatch failure; "
            "circuit open for %.1fs (half-open probe after cooldown)",
            label, cooldown,
        )
        try:
            # an eviction is an incident although no exception escapes
            # (the work re-places); captured after the lock is released
            from . import blackbox as _blackbox

            _blackbox.capture(
                "eviction",
                extra={"device": label, "failures": failures, "cooldown_s": cooldown},
            )
        except Exception:
            pass  # the recorder never breaks an eviction

    def mark_success(self, label: str) -> None:
        """A successful dispatch on ``label`` closes a half-open circuit.
        With no circuit tripped this is one dict check."""
        if not self._states:
            return
        with self._lock:
            st = self._states.get(label)
            if st is not None and st["state"] == "half-open":
                del self._states[label]

    def usable(self, label: str, now: Optional[float] = None) -> bool:
        """True when ``label`` may take dispatches: closed, or open past
        its cooldown (then half-open, admitting this caller as the one
        probe)."""
        if not self._states:
            return True
        now = time.monotonic() if now is None else now
        with self._lock:
            st = self._states.get(label)
            if st is None:
                return True
            if st["state"] == "open":
                if now >= st["until"]:
                    st["state"] = "half-open"
                    st["probe_rearm"] = now + st["cooldown"]
                    return True
                return False
            if now >= st.get("probe_rearm", 0.0):
                st["probe_rearm"] = now + st["cooldown"]
                return True
            return False

    def filter(self, devices: Sequence, now: Optional[float] = None) -> List:
        return [d for d in devices if self.usable(device_label(d), now)]

    def table(self) -> List[Dict]:
        """One row per circuit that is not closed (empty: all healthy)."""
        now = time.monotonic()
        with self._lock:
            return [
                {
                    "device": label,
                    "state": st["state"],
                    "failures": st["failures"],
                    "cooldown_s": round(st["cooldown"], 3),
                    "retry_in_s": round(max(0.0, st["until"] - now), 3),
                }
                for label, st in sorted(self._states.items())
            ]

    def warn_pinned(self, label: str) -> bool:
        """An explicit ``devices=`` pin opts out of failover; a pin onto a
        circuit-open device warns once an episode. True when it should."""
        with self._lock:
            st = self._states.get(label)
            if st is None or st["warned_pin"]:
                return False
            st["warned_pin"] = True
            return True

    def reset(self) -> None:
        with self._lock:
            self._states.clear()


_health = DeviceHealth()


def device_health() -> DeviceHealth:
    """The process-wide circuit breaker (one circuit a device label)."""
    return _health


def _health_devices() -> List[torch.device]:
    """The devices /healthz lists: the cards, or the CPU the callers of a
    machine without one pass (``device="cpu"``)."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu", 0)]


def _device_kind(d: torch.device) -> str:
    if d.type == "cuda":
        return torch.cuda.get_device_name(d.index or 0)
    return "cpu"


def health_overview() -> List[Dict]:
    """The /healthz rows: one per local device (label, kind, circuit
    state, failures, cooldown), then tripped circuits of devices that are
    not local (a test's CPU slots) so they stay visible."""
    by_label = {row["device"]: row for row in _health.table()}
    rows: List[Dict] = []
    seen = set()
    for d in _health_devices():
        lab = device_label(d)
        seen.add(lab)
        tripped = by_label.get(lab)
        rows.append({
            "device": lab,
            "device_kind": _device_kind(d),
            "state": tripped["state"] if tripped else "closed",
            "failures": tripped["failures"] if tripped else 0,
            "cooldown_s": tripped["cooldown_s"] if tripped else 0.0,
            "retry_in_s": tripped["retry_in_s"] if tripped else 0.0,
        })
    for lab, tripped in sorted(by_label.items()):
        if lab not in seen:
            rows.append({"device_kind": None, **tripped})
    return rows


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def plan(weights: Sequence[int], ndev: int) -> List[Optional[int]]:
    """Largest-first placement: item indices sorted by weight descending
    (ties: lower index first), each to the least-loaded slot (ties: lowest
    slot). One slot per item; zero-weight items get ``None``."""
    if ndev < 1:
        raise ValueError(f"plan needs >= 1 device, got {ndev}")
    order = sorted(range(len(weights)), key=lambda i: (-int(weights[i]), i))
    load = [0] * ndev
    out: List[Optional[int]] = [None] * len(weights)
    for i in order:
        w = int(weights[i])
        if w <= 0:
            continue
        slot = min(range(ndev), key=lambda s: (load[s], s))
        load[slot] += w
        out[i] = slot
    return out


def _local_devices() -> List[torch.device]:
    """The devices scheduling spreads over: every visible card. None at
    all raises, as `device.resolve_device(None)` does: the port never
    schedules onto the CPU unasked."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "block scheduling spreads blocks over the visible CUDA cards, "
            "and none is visible here (torch.cuda.device_count() is 0); "
            "pass device='cpu', or an explicit devices=[...] list"
        )
    return [torch.device("cuda", i) for i in range(n)]


def _local_count() -> int:
    """How many local devices there are (0 without a card)."""
    try:
        return len(_local_devices())
    except RuntimeError:
        return 0


def _normalize_devices(devices) -> Tuple:
    """An explicit ``devices=`` list: local card indices, devices or
    device strings. Empty is refused (None means "the config decides");
    a CUDA device that is not there raises."""
    from ..device import resolve_device

    devs = list(devices)
    if not devs:
        raise ValueError(
            "devices=[] is ambiguous; pass None (config decides) or "
            "disable with config.block_scheduler='off'"
        )
    local = None
    out = []
    for d in devs:
        if isinstance(d, (int, np.integer)):
            if local is None:
                local = _local_devices()
            if not 0 <= int(d) < len(local):
                raise ValueError(
                    f"devices: index {int(d)} out of range for "
                    f"{len(local)} local device(s)"
                )
            out.append(local[int(d)])
            continue
        dev = resolve_device(d)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            n = torch.cuda.device_count()
            if dev.index >= n:
                raise ValueError(
                    f"devices: {dev} is not a local card ({n} visible)"
                )
        out.append(dev)
    return tuple(out)


def global_mode() -> bool:
    """True under ``config.block_scheduler == "global"``: eligible verbs
    route through `globalframe`; the rest schedule as under "auto"."""
    from .. import config as _config

    return _config.get().block_scheduler == "global"


def global_device_set() -> List[torch.device]:
    """The devices a `GlobalFrame`'s data mesh spans: every local device
    whose circuit is closed. A shrunk set is logged, naming the evicted
    devices; with every circuit open the full set is used."""
    from ..utils.log import get_logger

    devs = _local_devices()
    healthy = _health.filter(devs)
    if not healthy:
        get_logger("scheduler").warning(
            "every local device's failover circuit is open; building "
            "the global-frame mesh over the full device set anyway"
        )
        return devs
    if len(healthy) < len(devs):
        get_logger("scheduler").warning(
            "global-frame mesh shrunk to %d of %d local device(s): "
            "%s circuit-open after transient failures",
            len(healthy), len(devs),
            ",".join(device_label(d) for d in devs if d not in healthy),
        )
    return healthy


def resolve(devices=None, executor=None, mesh=None) -> Optional[Tuple]:
    """The devices a verb call schedules its blocks over, or None when
    scheduling is off for it.

    ``mesh=`` wins (the mesh owns placement; with ``devices=`` it raises);
    an executor without ``supports_scheduling`` is never scheduled (with
    ``devices=`` that raises); an explicit ``devices=`` list wins over the
    config and bypasses failover (a pin onto an open circuit warns once);
    otherwise ``config.block_scheduler``: "off" none, "on" every local
    device, "auto" / "global" every local device when there are two or
    more. Open circuits drop out; with every circuit open the full set is
    used."""
    if mesh is not None:
        if devices is not None:
            raise ValueError(
                "devices= and mesh= are mutually exclusive; the mesh "
                "owns block placement"
            )
        return None
    supported = executor is None or getattr(executor, "supports_scheduling", False)
    if devices is not None:
        if not supported:
            raise ValueError(
                "devices= needs an executor that supports block "
                f"scheduling; {type(executor).__name__} does not"
            )
        devs = _normalize_devices(devices)
        for d in devs:
            lab = device_label(d)
            if not _health.usable(lab) and _health.warn_pinned(lab):
                from ..utils.log import get_logger

                get_logger("scheduler").warning(
                    "devices= pins dispatches to %s, whose failover "
                    "circuit is OPEN after transient failures; explicit "
                    "pins bypass device failover", lab,
                )
        return devs
    if not supported:
        return None
    from .. import config as _config

    mode = _config.get().block_scheduler
    if mode not in _MODES:
        raise ValueError(
            f"config.block_scheduler={mode!r} is not one of "
            "'auto' | 'on' | 'off' | 'global'"
        )
    if mode == "off":
        return None
    if mode in ("auto", "global") and _local_count() < 2:
        return None
    devs = _local_devices()
    healthy = _health.filter(devs)
    if not healthy:
        from ..utils.log import get_logger

        get_logger("scheduler").warning(
            "every local device's failover circuit is open; scheduling "
            "over the full device set anyway"
        )
        healthy = devs
    return tuple(healthy)


class BlockSchedule:
    """One verb call's placement: a device set and a slot per item.

    `device(i)` / `label(i)` read item ``i``'s slot when called, so a
    dispatch built after `evict` runs on the item's new device. `put`
    moves feeds there and accounts the dispatch; `bind` wraps a callable
    the same way. ``anchor_device()`` (slot 0) is where results converge."""

    __slots__ = (
        "devices", "labels", "assignment", "executor", "weights",
        "_issued", "_remaining", "_lock",
    )

    def __init__(self, devices: Tuple, assignment: List[Optional[int]],
                 executor=None, weights: Optional[Sequence[int]] = None):
        self.devices = tuple(devices)
        self.labels = tuple(device_label(d) for d in self.devices)
        self.assignment = list(assignment)
        self.executor = executor
        # per-item weights (rows): what `evict` re-places by; without
        # them failover re-places with unit weights
        self.weights = (
            [1 if s is not None else 0 for s in self.assignment]
            if weights is None else [int(w) for w in weights]
        )
        self._issued = [False] * len(self.assignment)
        self._remaining = [0] * len(self.devices)
        for s in self.assignment:
            if s is not None:
                self._remaining[s] += 1
        self._lock = threading.Lock()

    @property
    def ndev(self) -> int:
        return len(self.devices)

    def slot(self, i: int) -> Optional[int]:
        return self.assignment[i]

    def device(self, i: int):
        s = self.assignment[i]
        return None if s is None else self.devices[s]

    def label(self, i: int) -> Optional[str]:
        s = self.assignment[i]
        return None if s is None else self.labels[s]

    def anchor_device(self):
        """Where results converge (combines, concatenated outputs): slot
        0, always."""
        return self.devices[0]

    def put(self, i: int, feeds: Sequence) -> List:
        """Move ``feeds`` to item ``i``'s device (host arrays are copied
        once) and account the dispatch."""
        from ..frame import as_tensor

        s = self.assignment[i]
        if s is None:
            return list(feeds)
        dev = self.devices[s]
        out = [as_tensor(f, dev) for f in feeds]
        self._note_dispatch(i, s)
        _health.mark_success(self.labels[s])
        return out

    def bind(self, i: int, fn):
        """``fn`` for item ``i``: feeds moved to the item's device at call
        time, the dispatch accounted, and a success closing a half-open
        circuit."""

        def call(*feeds):
            from ..frame import as_tensor

            s = self.assignment[i]
            if s is None:
                return fn(*feeds)
            out = fn(*[as_tensor(f, self.devices[s]) for f in feeds])
            self._note_dispatch(i, s)
            _health.mark_success(self.labels[s])
            return out

        return call

    def progress(self) -> Dict[str, int]:
        """Planned, issued and unissued dispatches: what a
        `DeadlineExceeded` escaping a scheduled verb is stamped with."""
        with self._lock:
            planned = sum(1 for s in self.assignment if s is not None)
            issued = sum(
                1 for i, s in enumerate(self.assignment)
                if s is not None and self._issued[i]
            )
        return {"planned": planned, "issued": issued, "unissued": planned - issued}

    def evict(self, index: int) -> Optional[str]:
        """Failover after a transient failure of item ``index``: open its
        device's circuit and re-place every item not yet issued (``index``
        too) LPT over the other usable devices, on top of what the issued
        items put there. Returns the evicted label, or None (nothing
        counted, the retry runs in place) when the item is unscheduled or
        no other usable device exists."""
        s = self.assignment[index]
        if s is None:
            return None
        label = self.labels[s]
        with self._lock:
            alive = [t for t in range(self.ndev) if t != s and _health.usable(self.labels[t])]
        if not alive:
            return None
        _health.mark_failure(label)
        with self._lock:
            load = {t: 0 for t in alive}
            pending: List[int] = []
            for i, slot in enumerate(self.assignment):
                if slot is None:
                    continue
                if self._issued[i] and i != index:
                    if slot in load:
                        load[slot] += self.weights[i]
                else:
                    pending.append(i)
            pending.sort(key=lambda i: (-self.weights[i], i))
            for i in pending:
                t = min(alive, key=lambda a: (load[a], a))
                load[t] += max(1, self.weights[i])
                self.assignment[i] = t
            self._remaining = [0] * self.ndev
            for i, slot in enumerate(self.assignment):
                if slot is not None and not self._issued[i]:
                    self._remaining[slot] += 1
        return label

    def _note_dispatch(self, i: int, s: int) -> None:
        _bump(self.executor, "device_dispatches", self.labels[s], 1)
        from ..utils import telemetry as _tele

        with self._lock:
            self._issued[i] = True
            self._remaining[s] = max(0, self._remaining[s] - 1)
            depth = self._remaining[s]
        if _tele.enabled():
            # planned dispatches for this device not yet issued this call
            _tele.gauge_set("scheduler_queue_depth", depth, device=self.labels[s])


def _bump(ex, attr: str, label: str, n: int) -> None:
    """Add ``n`` to a per-device ledger dict on the executor, under its
    lock; executors without the ledger are skipped."""
    d = getattr(ex, attr, None)
    if d is None:
        return
    lock = getattr(ex, "_lock", None)
    if lock is not None:
        with lock:
            d[label] = d.get(label, 0) + n
    else:
        d[label] = d.get(label, 0) + n


def schedule_weights(
    weights: Sequence[int], devices=None, executor=None, mesh=None
) -> Optional[BlockSchedule]:
    """`resolve`, then `plan` ``weights`` over the devices; None when
    scheduling is off for this call."""
    devs = resolve(devices=devices, executor=executor, mesh=mesh)
    if devs is None:
        return None
    return BlockSchedule(devs, plan(weights, len(devs)), executor=executor, weights=weights)


def schedule_for(frame, devices=None, executor=None, mesh=None) -> Optional[BlockSchedule]:
    """`schedule_weights` over a frame's block sizes (one dispatch a
    non-empty block, weighted by rows)."""
    return schedule_weights(frame.block_sizes(), devices=devices, executor=executor, mesh=mesh)
