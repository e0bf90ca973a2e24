"""Deterministic fault injection — the port's own copy of
``repro/runtime/fault.py``.

Chaos testing a serving stack only proves something when the chaos is
reproducible: the same fault at the same engine step must yield the same
recovery and, because the engine is deterministic, the same tokens as an
uninterrupted run.  :class:`FaultInjector` is the hook
``runtime.engine.ServeEngine`` polls at three points of every tick:

  - ``"admission"`` — before the scheduler pops this tick's admissions;
  - ``"prefill"``   — after an admission's prefill computed but before its
                      slot insert (the prefill result is lost);
  - ``"decode"``    — after the decode chunk (or step) was launched but
                      before its tokens were read (the chunk's work is
                      lost).

A kill fires exactly once, at the first poll of the matching phase whose
engine clock has reached ``at_step``, by raising :class:`DeviceLoss` with
the dead device ids; the engine rolls back to its tick-start snapshot and
replays the tick.  ``delay_host`` instead inflates one host's recorded
step times so the ``runtime.straggler.StragglerDetector`` is what drives
recovery once its eviction streak fills.

``ReplicaFault`` is the router-level fault site (``runtime.router``): it
kills a whole replica at a router tick whose replica activity matches, and
the router drains, replays and optionally readmits it.
``parse_fault_spec`` reads the ``--inject-fault`` grammar; ``FaultSpec``
builds the injector (``kill:``/``delay:``) or the replica fault
(``replica:``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

PHASES = ("admission", "prefill", "decode")


class DeviceLoss(RuntimeError):
    """A device (or set of devices) died mid-tick; carries the lost device
    ids, deduplicated and sorted.  Raised by :meth:`FaultInjector.poll`,
    caught by the engine's ``step``, which recovers and replays the
    tick."""

    def __init__(self, lost: Sequence[int]):
        self.lost = tuple(sorted(set(int(d) for d in lost)))
        super().__init__(f"lost devices {list(self.lost)}")


@dataclasses.dataclass
class FaultInjector:
    """Deterministic chaos hook.

    ``kill_devices`` are device ids to kill at the first ``phase`` poll at
    or after engine step ``at_step``, once only (``fired_at`` records
    when).  ``delay_host`` multiplies the named host's step-time readings
    by ``delay_factor`` from ``at_step`` on, for as long as the trace runs
    (a persistent straggler), so the detector's eviction streak can
    fill."""

    kill_devices: Tuple[int, ...] = ()
    at_step: int = 0
    phase: str = "decode"
    delay_host: Optional[int] = None
    delay_factor: float = 8.0
    fired_at: Optional[int] = None

    def __post_init__(self):
        if self.phase not in PHASES:
            raise ValueError(f"unknown fault phase {self.phase!r} "
                             f"(known: {PHASES})")
        if self.at_step < 0:
            raise ValueError("at_step must be >= 0")

    @property
    def fired(self) -> bool:
        return self.fired_at is not None

    def poll(self, phase: str, clock: int) -> None:
        """Engine-side injection point; raises :class:`DeviceLoss` when the
        configured kill is due.  Never fires twice (the replay goes
        through the same polls)."""
        if (self.kill_devices and not self.fired and phase == self.phase
                and clock >= self.at_step):
            self.fired_at = int(clock)
            raise DeviceLoss(self.kill_devices)

    def host_delay(self, host: int, clock: int) -> float:
        """Multiplier for ``host``'s recorded step time at ``clock``."""
        if self.delay_host is not None and host == self.delay_host \
                and clock >= self.at_step:
            return self.delay_factor
        return 1.0


def device_id(device: Any) -> int:
    """A device's id: an int is its own (a mesh rank), else ``.id`` where
    the object has one, else a ``torch.device``'s index (the CPU, which
    has none, is device 0)."""
    if isinstance(device, int):
        return device
    idx = getattr(device, "id", None)
    if idx is None:
        idx = getattr(device, "index", None)
    return int(idx or 0)

REPLICA_STATES = ("prefill", "decode", "idle", "any")


@dataclasses.dataclass
class ReplicaFault:
    """Router-level fault site: kill a whole replica.

    Fires once, at the first router tick at or after ``at_step`` whose
    replica activity matches ``during`` (``"prefill"`` — the replica
    would admit work this tick; ``"decode"`` — it has running slots;
    ``"idle"`` — neither; ``"any"`` — unconditional).  The router drains
    the dead replica, replays its in-flight requests on survivors, and —
    when ``recover_after`` is set — readmits the replica that many ticks
    after the kill."""

    replica: int
    at_step: int = 0
    during: str = "any"
    recover_after: Optional[int] = None
    fired_at: Optional[int] = None

    def __post_init__(self):
        if self.during not in REPLICA_STATES:
            raise ValueError(f"unknown replica fault state {self.during!r} "
                             f"(known: {REPLICA_STATES})")
        if self.at_step < 0:
            raise ValueError("at_step must be >= 0")

    @property
    def fired(self) -> bool:
        return self.fired_at is not None

    def poll(self, replica: int, state: str, clock: int) -> bool:
        """Router-side injection point: True when this fault kills
        ``replica`` (whose current activity is ``state``) at router tick
        ``clock``.  Fires at most once."""
        if (not self.fired and replica == self.replica
                and clock >= self.at_step
                and (self.during == "any" or state == self.during)):
            self.fired_at = int(clock)
            return True
        return False


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Parsed ``--inject-fault`` flag.  ``build`` resolves the device
    *index* against the serving device list into the device *id* a
    :class:`FaultInjector` wants (negative indices count from the end): on
    a mesh the list is its ranks, so ``kill:<i>`` loses the rank at mesh
    position i and ``delay:<row>`` slows a data row;
    ``build_replica`` turns a ``replica:`` spec into the
    :class:`ReplicaFault` the router polls."""

    kind: str                   # "kill" | "delay" | "replica"
    index: int                  # device index (kill) / host row (delay)
                                # / replica index (replica)
    at_step: int
    phase: str = "decode"
    factor: float = 8.0
    recover: Optional[int] = None

    def build(self, devices: Sequence) -> FaultInjector:
        if self.kind == "kill":
            dev = list(devices)[self.index]
            return FaultInjector(kill_devices=(device_id(dev),),
                                 at_step=self.at_step, phase=self.phase)
        return FaultInjector(delay_host=self.index, at_step=self.at_step,
                             delay_factor=self.factor)

    def build_replica(self) -> ReplicaFault:
        if self.kind != "replica":
            raise ValueError(f"not a replica fault spec: {self.kind!r}")
        return ReplicaFault(replica=self.index, at_step=self.at_step,
                            during=self.phase, recover_after=self.recover)


def parse_fault_spec(spec: str) -> FaultSpec:
    """``kill:<dev>@<step>[:<phase>]``, ``delay:<host>@<step>[:<factor>]``,
    or ``replica:<i>@<step>[:<during>[:<recover>]]``.

    ``<dev>`` indexes the serving device list (negative counts from the
    end, so ``kill:-1@3`` kills the last device at engine step 3);
    ``<phase>`` is one of ``admission|prefill|decode`` (default decode);
    ``<factor>`` is the straggler slowdown multiplier (default 8).
    ``replica:`` faults are router-level: ``<i>`` is the replica index,
    ``<during>`` one of ``prefill|decode|idle|any`` (default any), and
    ``<recover>`` the tick count after which the replica rejoins the pool
    (default: stays dead).
    """
    kind, _, rest = spec.partition(":")
    if kind not in ("kill", "delay", "replica") or not rest:
        raise ValueError(f"fault spec {spec!r} is not "
                         "'kill:<dev>@<step>[:<phase>]', "
                         "'delay:<host>@<step>[:<factor>]', or "
                         "'replica:<i>@<step>[:<during>[:<recover>]]'")
    head, _, tail = rest.partition("@")
    if not tail:
        raise ValueError(f"fault spec {spec!r} is missing '@<step>'")
    try:
        index = int(head)
    except ValueError:
        raise ValueError(f"fault spec {spec!r}: bad index {head!r}")
    at, _, opt = tail.partition(":")
    try:
        step = int(at)
    except ValueError:
        raise ValueError(f"fault spec {spec!r}: bad step {at!r}")
    if step < 0:
        raise ValueError(f"fault spec {spec!r}: step must be >= 0")
    if kind == "kill":
        phase = opt or "decode"
        if phase not in PHASES:
            raise ValueError(f"fault spec {spec!r}: unknown phase "
                             f"{phase!r} (known: {PHASES})")
        return FaultSpec("kill", index, step, phase=phase)
    if kind == "replica":
        during, _, rec = opt.partition(":")
        during = during or "any"
        if during not in REPLICA_STATES:
            raise ValueError(f"fault spec {spec!r}: unknown replica state "
                             f"{during!r} (known: {REPLICA_STATES})")
        try:
            recover = int(rec) if rec else None
        except ValueError:
            raise ValueError(f"fault spec {spec!r}: bad recover {rec!r}")
        if recover is not None and recover <= 0:
            raise ValueError(f"fault spec {spec!r}: recover must be > 0")
        return FaultSpec("replica", index, step, phase=during,
                         recover=recover)
    try:
        factor = float(opt) if opt else 8.0
    except ValueError:
        raise ValueError(f"fault spec {spec!r}: bad factor {opt!r}")
    if factor <= 1.0:
        raise ValueError(f"fault spec {spec!r}: delay factor must be > 1")
    return FaultSpec("delay", index, step, factor=factor)
