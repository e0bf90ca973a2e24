"""Replica faults for the multi-replica router — the router's part of the
port's own copy of ``repro/runtime/fault.py``.

``ReplicaFault`` is the router-level fault site (``runtime.router``): it
kills a whole replica at a router tick whose replica activity matches, and
the router drains, replays and optionally readmits it.  ``parse_fault_spec``
reads the reference's ``--inject-fault`` grammar unchanged: ``replica:``
specs build a :class:`ReplicaFault`; ``kill:`` and ``delay:`` specs still
parse, but building them raises ``NotImplementedError``, because
engine-level injection, tick-start snapshots and straggler eviction are
not ported yet (ROADMAP 1.13).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

PHASES = ("admission", "prefill", "decode")

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
    """Parsed ``--inject-fault`` flag.  ``build_replica`` turns a
    ``replica:`` spec into the :class:`ReplicaFault` the router polls;
    ``build`` (device kills and straggler delays) is not ported yet."""

    kind: str                   # "kill" | "delay" | "replica"
    index: int                  # device index (kill) / host row (delay)
                                # / replica index (replica)
    at_step: int
    phase: str = "decode"
    factor: float = 8.0
    recover: Optional[int] = None

    def build(self, devices: Sequence = ()):
        raise NotImplementedError(
            f"{self.kind!r} fault specs are not ported yet (ROADMAP 1.13: "
            "engine-level fault injection, snapshots and straggler "
            "eviction); only 'replica:' specs are served")

    def build_replica(self) -> ReplicaFault:
        if self.kind != "replica":
            raise ValueError(f"not a replica fault spec: {self.kind!r}")
        return ReplicaFault(replica=self.index, at_step=self.at_step,
                            during=self.phase, recover_after=self.recover)


def parse_fault_spec(spec: str) -> FaultSpec:
    """``kill:<dev>@<step>[:<phase>]``, ``delay:<host>@<step>[:<factor>]``,
    or ``replica:<i>@<step>[:<during>[:<recover>]]``.

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
