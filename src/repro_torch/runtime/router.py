"""Multi-replica SLO-aware router — the port's own copy of
``repro/runtime/router.py``, pure host Python over the port's engines.

``RouterEngine`` fronts N ``ServeEngine`` replicas, which share one set
of weights on the device, behind the single submission API the engine
speaks (``add`` + ``step``/``run`` -> rid-keyed outputs).  Per router
tick it:

  1. moves arrived requests into the bounded EDF admission queue
     (``runtime.slo.AdmissionQueue`` — infeasible/overflow/expired work
     is shed deterministically, never backlogged without bound);
  2. fires any due replica-level faults (``runtime.fault.ReplicaFault``),
     drains the dead replica — in-flight requests are replayed from
     scratch on survivors (attribution ``RETRIED``) or promoted to their
     live hedge copy — and readmits recovered replicas with a fresh
     engine;
  3. steps the degradation ladder (``runtime.slo.DegradationLadder``)
     off queue pressure and applies its level to every live replica
     (chunk cap -> degraded Mode -> priority shed);
  4. dispatches feasible queue entries to the least-loaded live replica
     (ties to the lowest index) while any replica has a free slot;
  5. hedges stalled requests: no first token within ``hedge_after``
     ticks of dispatch re-dispatches the request to a second replica —
     greedy decode is deterministic and row-independent, so both copies
     produce the *same* token stream and whichever finishes first wins
     token-exactly while the loser is cancelled mid-flight
     (``ServeEngine.cancel``, a device write with no host sync);
  6. ticks every live replica (index order) and harvests completions.

Every decision is a pure function of (trace seed, tick counter): replica
choice is (load, index)-ordered, queue order is the EDF key, fault sites
fire by tick.  Token values never enter a decision, so the routing record
of a trace is the same at every model width.

Time is virtual: one router tick is one SLO "millisecond"
(``runtime.slo``).  TTFT/completion latencies are measured in router
ticks; inter-token latency uses the winning engine's own clock
(``RequestOutput.token_steps``), which advances one step per fused
decode row.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .engine import Attribution, Request
from .fault import ReplicaFault
from .slo import (AdmissionQueue, DegradationConfig, DegradationLadder,
                  ShedEvent)

# the queue depth that reads as pressure 1.0 to the degradation ladder
# when the admission queue is unbounded
TARGET_DEPTH = 8


@dataclasses.dataclass
class RouterOutput:
    """Router-side per-request record.  ``submit``/``dispatch``/
    ``first_token``/``finished`` are router ticks (-1 = not yet);
    ``token_steps`` is the winning engine's per-token clock (for
    inter-token latency); ``attribution`` says how the request was
    served (``runtime.engine.Attribution``)."""

    rid: int
    submit: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    token_steps: List[int] = dataclasses.field(default_factory=list)
    dispatch: int = -1
    first_token: int = -1
    finished: int = -1
    replica: int = -1
    attribution: Attribution = Attribution.NORMAL
    shed_reason: Optional[str] = None
    retries: int = 0
    hedged: bool = False


@dataclasses.dataclass
class ReplicaHandle:
    index: int
    engine: object            # ServeEngine
    up: bool = True
    rejoin_at: Optional[int] = None

    def state(self) -> str:
        """Tick-phase classification for replica fault sites: would the
        engine admit this tick ("prefill"), is it decoding ("decode"),
        or neither ("idle")."""
        eng = self.engine
        if eng.sched.would_admit(eng.clock):
            return "prefill"
        return "decode" if eng.sched.running else "idle"


@dataclasses.dataclass
class _Dispatch:
    """In-flight bookkeeping: where a request currently runs and the
    frozen deadline it was admitted under (absolute ticks)."""

    rid: int
    req: Request              # the dispatched copy (arrival=0)
    replica: int
    tick: int                 # dispatch tick (hedge timer base)
    deadline: Optional[int]
    hedge: Optional[int] = None


class RouterEngine:
    """SLO-aware multi-replica serving router (module docstring has the
    tick anatomy).  ``make_engine`` is called once per replica — and
    again when a killed replica rejoins, so recovery never trusts a dead
    engine's state.

    ``queue_bound=None`` is the unbounded baseline; ``hedge_after=None``
    disables hedging; ``degradation=None`` disables the ladder.
    """

    def __init__(self, make_engine: Callable[[], object],
                 num_replicas: int, *,
                 queue_bound: Optional[int] = None,
                 hedge_after: Optional[int] = None,
                 degradation: Optional[DegradationConfig] = None,
                 replica_faults: Sequence[ReplicaFault] = ()):
        if num_replicas < 1:
            raise ValueError("need at least one replica")
        if hedge_after is not None and hedge_after < 1:
            raise ValueError("hedge_after must be >= 1 tick")
        self._make_engine = make_engine
        self.replicas = [ReplicaHandle(i, make_engine())
                         for i in range(num_replicas)]
        self.queue = AdmissionQueue(queue_bound)
        self.hedge_after = hedge_after
        self.ladder = (DegradationLadder(degradation)
                       if degradation is not None else None)
        self.faults = list(replica_faults)
        self.clock = 0
        self.outputs: Dict[int, RouterOutput] = {}
        self._arrivals: List[Tuple[int, int, Request]] = []   # (arrival, rid)
        self._inflight: Dict[int, _Dispatch] = {}
        self.health_log: List[Dict] = []
        self.stats = {"submitted": 0, "dispatches": 0, "completed": 0,
                      "shed": 0, "retried": 0, "hedged": 0}

    # -- submission ---------------------------------------------------------

    def add(self, req: Request) -> None:
        if req.rid in self.outputs:
            raise ValueError(f"duplicate rid {req.rid}")
        heapq.heappush(self._arrivals, (req.arrival, req.rid, req))
        self.outputs[req.rid] = RouterOutput(rid=req.rid,
                                             submit=max(req.arrival, 0))
        self.stats["submitted"] += 1

    def has_work(self) -> bool:
        return bool(self._arrivals or self.queue.depth or self._inflight)

    @property
    def up_replicas(self) -> List[ReplicaHandle]:
        return [h for h in self.replicas if h.up]

    # -- tick ---------------------------------------------------------------

    def step(self) -> None:
        """One router tick (one virtual SLO millisecond)."""
        self._admit_arrivals()
        self._fire_faults()
        self._rejoin_recovered()
        self._apply_ladder()
        self._dispatch_queue()
        self._hedge_stalled()
        for h in self.up_replicas:
            if h.engine.sched.has_work():
                h.engine.step()
        self._harvest()
        self.clock += 1

    def run(self, requests: Sequence[Request] = ()
            ) -> Dict[int, RouterOutput]:
        """Drain: submit ``requests``, tick until every request finished
        or was shed, return rid -> RouterOutput."""
        for r in requests:
            self.add(r)
        while self.has_work():
            if not self.up_replicas and not any(
                    h.rejoin_at is not None for h in self.replicas):
                raise RuntimeError("no live replicas and no scheduled "
                                   "rejoin; queued work cannot complete")
            self.step()
        return self.outputs

    # -- tick phases --------------------------------------------------------

    def _admit_arrivals(self) -> None:
        while self._arrivals and self._arrivals[0][0] <= self.clock:
            _, _, req = heapq.heappop(self._arrivals)
            ev = self.queue.push(req, self.clock, self._bucket(req))
            if ev is not None:
                self._record_shed(ev)

    def _bucket(self, req: Request) -> Optional[int]:
        for h in self.replicas:         # replicas share one config; any
            if h.engine is not None:    # live engine's bucketing will do
                return h.engine.bucket_for(req.prompt_len)
        return None

    def _record_shed(self, ev: ShedEvent) -> None:
        out = self.outputs[ev.rid]
        out.attribution = Attribution.SHED
        out.shed_reason = ev.reason.value
        out.finished = -1
        self.stats["shed"] += 1
        # a displaced/expired entry may already have an in-flight record
        # (it cannot — sheds only happen pre-dispatch — but keep the
        # bookkeeping defensive and deterministic)
        self._inflight.pop(ev.rid, None)

    def _fire_faults(self) -> None:
        for fault in self.faults:
            h = self.replicas[fault.replica]
            if not h.up:
                continue
            if fault.poll(h.index, h.state(), self.clock):
                self._kill_replica(h, fault)

    def _kill_replica(self, h: ReplicaHandle, fault: ReplicaFault) -> None:
        h.up = False
        h.rejoin_at = (None if fault.recover_after is None
                       else self.clock + fault.recover_after)
        drained = sorted(rid for rid, rec in self._inflight.items()
                         if h.index in (rec.replica, rec.hedge))
        self.health_log.append({"tick": self.clock, "event": "kill",
                                "replica": h.index, "state": h.state(),
                                "drained": drained,
                                "rejoin_at": h.rejoin_at})
        for rid in drained:
            rec = self._inflight[rid]
            if rec.hedge is not None:
                # one copy survives: promote it (token streams are
                # identical, so nothing is lost)
                if rec.replica == h.index:
                    rec.replica, rec.hedge = rec.hedge, None
                else:
                    rec.hedge = None
                continue
            self._requeue(rec)
        # the dead engine's state is never trusted again; drop it so a
        # rejoin starts from a fresh make_engine() build
        h.engine = None

    def _requeue(self, rec: _Dispatch) -> None:
        """Replay a drained request from scratch: discard partial tokens
        (greedy replay regenerates the identical stream) and push it back
        through admission with its *original* absolute deadline."""
        out = self.outputs[rec.rid]
        out.tokens = []
        out.token_steps = []
        out.first_token = -1
        out.dispatch = -1
        out.replica = -1
        out.retries += 1
        if out.attribution in (Attribution.NORMAL, Attribution.HEDGED):
            out.attribution = Attribution.RETRIED
        self.stats["retried"] += 1
        del self._inflight[rec.rid]
        rel = (None if rec.deadline is None
               else rec.deadline - self.clock)
        req = dataclasses.replace(rec.req, deadline_ms=rel)
        ev = self.queue.push(req, self.clock, self._bucket(req))
        if ev is not None:
            self._record_shed(ev)

    def _rejoin_recovered(self) -> None:
        for h in self.replicas:
            if not h.up and h.rejoin_at is not None \
                    and self.clock >= h.rejoin_at:
                h.engine = self._make_engine()
                h.up = True
                h.rejoin_at = None
                self.health_log.append({"tick": self.clock,
                                        "event": "rejoin",
                                        "replica": h.index})

    def _apply_ladder(self) -> None:
        if self.ladder is None:
            return
        denom = self.queue.bound or TARGET_DEPTH
        level = self.ladder.update(self.queue.depth / denom, self.clock)
        cfg = self.ladder.cfg
        for h in self.up_replicas:
            eng = h.engine
            eng.chunk_cap = (max(cfg.min_chunk, eng.decode_chunk // 2)
                             if level >= 1 else None)
            eng.set_degraded(level >= 2)
        self.queue.shed_min_priority = (cfg.shed_min_priority
                                        if level >= 3 else None)

    def _dispatch_queue(self) -> None:
        while True:
            ready = [h for h in self.up_replicas
                     if h.engine.load < h.engine.num_slots]
            if not ready:
                return
            entry, expired = self.queue.pop(self.clock)
            for ev in expired:
                self._record_shed(ev)
            if entry is None:
                return
            h = min(ready, key=lambda h: (h.engine.load, h.index))
            self._dispatch_to(entry.req, h, deadline=entry.deadline)

    def _dispatch_to(self, req: Request, h: ReplicaHandle,
                     deadline: Optional[int],
                     hedge_of: Optional[_Dispatch] = None) -> None:
        copy = dataclasses.replace(req, arrival=0)
        h.engine.add(copy)
        self.stats["dispatches"] += 1
        if hedge_of is not None:
            hedge_of.hedge = h.index
            return
        out = self.outputs[req.rid]
        out.dispatch = self.clock
        out.replica = h.index
        self._inflight[req.rid] = _Dispatch(
            rid=req.rid, req=copy, replica=h.index, tick=self.clock,
            deadline=deadline)

    def _hedge_stalled(self) -> None:
        if self.hedge_after is None:
            return
        for rid in sorted(self._inflight):
            rec = self._inflight[rid]
            out = self.outputs[rid]
            if (rec.hedge is not None or out.first_token >= 0
                    or self.clock - rec.tick < self.hedge_after):
                continue
            spare = [h for h in self.up_replicas
                     if h.index != rec.replica
                     and h.engine.load < h.engine.num_slots]
            if not spare:
                continue
            h = min(spare, key=lambda h: (h.engine.load, h.index))
            self._dispatch_to(rec.req, h, deadline=rec.deadline,
                              hedge_of=rec)
            out.hedged = True
            if out.attribution == Attribution.NORMAL:
                out.attribution = Attribution.HEDGED
            self.stats["hedged"] += 1

    def _harvest(self) -> None:
        for rid in sorted(self._inflight):
            rec = self._inflight[rid]
            copies = [(rec.replica, False)]
            if rec.hedge is not None:
                copies.append((rec.hedge, True))
            winner = None
            for idx, is_hedge in copies:       # primary wins ties
                h = self.replicas[idx]
                if not h.up:
                    continue
                eo = h.engine.outputs.get(rid)
                if eo is None:
                    continue
                out = self.outputs[rid]
                if out.first_token < 0 and eo.tokens:
                    out.first_token = self.clock
                if eo.finished >= 0 and winner is None:
                    winner = (idx, eo)
            if winner is None:
                continue
            idx, eo = winner
            out = self.outputs[rid]
            out.tokens = list(eo.tokens)
            out.token_steps = list(eo.token_steps)
            out.finished = self.clock
            out.replica = idx
            loser = rec.hedge if idx == rec.replica else rec.replica
            if loser is not None and self.replicas[loser].up:
                eng = self.replicas[loser].engine
                eng.cancel(rid)
                eng.outputs.pop(rid, None)
            del self._inflight[rid]
            self.stats["completed"] += 1

    # -- reporting ----------------------------------------------------------

    @property
    def max_queue_depth(self) -> int:
        return self.queue.max_depth

    @property
    def shed_log(self) -> List[ShedEvent]:
        return self.queue.shed_log
