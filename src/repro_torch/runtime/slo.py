"""SLO-aware admission control and graceful degradation — the port's own
copy of ``repro/runtime/slo.py``, pure host Python with the same semantics.

Shared by the multi-replica router (``runtime.router``) and the serving
CLI's per-request SLO rows.  Every decision is a deterministic function of
the submitted trace, so routing replays exactly and the router rows of the
reference's serving benchmark are compared with ``==``.

Time is **virtual**: one router tick is one "millisecond" of the SLO clock
(``deadline_ms``/``ttft_deadline_ms`` on ``runtime.engine.Request`` count
ticks after arrival), so every admission and shed decision is replayable.

  - :class:`CostModel` — expected service steps for a request: its
    bucketed prefill (``ServeEngine.bucket_for`` shapes, amortized at
    ``prefill_tokens_per_step``) plus one decode step per generated token.
  - :class:`AdmissionQueue` — bounded earliest-deadline-first queue:
    infeasible work is shed at the door, a full queue sheds the worst
    entry by EDF order, and entries whose deadline expired while queued
    are shed at pop time, so nothing infeasible is ever dispatched.
  - :class:`DegradationLadder` — hysteresis ladder over a queue-pressure
    signal: level 1 shrinks the fused decode chunk, 2 forces the cheaper
    execution Mode (``ServeEngine.set_degraded``), 3 sheds the lowest
    priority class at admission; pressure clearing walks back up.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

# EDF key for "no deadline": sorts after every real deadline, so
# best-effort work only runs when nothing deadlined is waiting.
_NO_DEADLINE = float("inf")


class ShedReason(str, enum.Enum):
    """Why an admission decision dropped a request (deterministic,
    recorded on the request's output attribution)."""

    INFEASIBLE = "infeasible"    # cost model says the deadline cannot be met
    QUEUE_FULL = "queue_full"    # bounded queue preferred other work (EDF)
    EXPIRED = "expired"          # deadline passed while queued
    DEGRADED = "degraded"        # ladder level 3: priority class shed


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Expected service steps for a request — the admission feasibility
    input.  ``prefill_tokens_per_step`` amortizes the bucketed prefill
    (a 64-token bucket is one engine dispatch but costs more than a
    decode step); ``per_token_steps`` is 1.0 for the greedy engines
    (one fused-scan row per token)."""

    prefill_tokens_per_step: int = 64
    per_token_steps: float = 1.0

    def estimate(self, prompt_len: int, max_new_tokens: int,
                 bucket: Optional[int] = None) -> int:
        span = bucket if bucket is not None else prompt_len
        prefill = max(1, -(-span // self.prefill_tokens_per_step))
        return prefill + int(math.ceil(self.per_token_steps
                                       * max_new_tokens))


@dataclasses.dataclass
class ShedEvent:
    rid: int
    step: int
    reason: ShedReason
    priority: int
    deadline: Optional[int]      # absolute (ticks), None = best-effort


@dataclasses.dataclass
class _Entry:
    """Queued admission candidate.  ``deadline`` is absolute ticks (the
    request's relative ``deadline_ms`` resolved against its submit
    tick); ``cost`` is the frozen CostModel estimate."""

    key: Tuple[float, int, int]          # (deadline, priority, seq)
    rid: int
    req: object                          # runtime.engine.Request
    submit: int
    cost: int
    deadline: Optional[int]

    def __lt__(self, other: "_Entry") -> bool:
        return self.key < other.key


class AdmissionQueue:
    """Bounded earliest-deadline-first admission queue.

    ``bound=None`` is the unbounded baseline (never sheds for capacity —
    the failure mode the overload trace's unbounded row demonstrates).
    With a bound, the queue holds at most ``bound`` entries and every
    overflow sheds exactly one entry — the *worst* by EDF order (latest
    deadline, then lowest priority, then latest submission), which may be
    the incoming request itself.  Hence for a
    fixed push sequence the shed count is ``max(0, feasible - bound)``:
    deterministic, and monotone non-increasing in the bound.

    ``shed_min_priority`` is the degradation ladder's level-3 knob: when
    set, any pushed request with ``priority >= shed_min_priority`` is
    shed up front (priority 0 is the most important class).
    """

    def __init__(self, bound: Optional[int] = None):
        if bound is not None and bound < 1:
            raise ValueError("queue bound must be >= 1 (None = unbounded)")
        self.bound = bound
        self.cost_model = CostModel()
        self.shed_min_priority: Optional[int] = None
        self._heap: List[_Entry] = []
        self._seq = 0
        self.shed_log: List[ShedEvent] = []
        self.max_depth = 0

    @property
    def depth(self) -> int:
        return len(self._heap)

    def push(self, req, now: int,
             bucket: Optional[int] = None) -> Optional[ShedEvent]:
        """Offer ``req`` at tick ``now``.  Returns the ShedEvent if the
        request (or a displaced queue entry) was shed — a displaced
        entry's event carries *its* rid, and ``req`` is queued."""
        cost = self.cost_model.estimate(req.prompt_len, req.max_new_tokens,
                                        bucket)
        deadline = (None if req.deadline_ms is None
                    else now + int(req.deadline_ms))
        entry = _Entry(key=(_NO_DEADLINE if deadline is None else deadline,
                            req.priority, self._seq),
                       rid=req.rid, req=req, submit=now, cost=cost,
                       deadline=deadline)
        self._seq += 1
        if (self.shed_min_priority is not None
                and req.priority >= self.shed_min_priority):
            return self._log_shed(entry, now, ShedReason.DEGRADED)
        if deadline is not None and now + cost > deadline:
            return self._log_shed(entry, now, ShedReason.INFEASIBLE)
        if self.bound is not None and len(self._heap) >= self.bound:
            worst = max(self._heap)
            if entry.key >= worst.key:
                return self._log_shed(entry, now, ShedReason.QUEUE_FULL)
            self._heap.remove(worst)
            heapq.heapify(self._heap)
            heapq.heappush(self._heap, entry)
            self.max_depth = max(self.max_depth, len(self._heap))
            return self._log_shed(worst, now, ShedReason.QUEUE_FULL)
        heapq.heappush(self._heap, entry)
        self.max_depth = max(self.max_depth, len(self._heap))
        return None

    def pop(self, now: int) -> Tuple[Optional[_Entry], List[ShedEvent]]:
        """Earliest-deadline entry still feasible at ``now`` (its shed
        events are the entries whose deadline expired while queued — the
        dispatcher forwards them to the output log).  An admitted entry
        therefore always satisfies ``now + cost <= deadline``: deadline
        slack accounting never goes negative."""
        expired: List[ShedEvent] = []
        while self._heap:
            e = heapq.heappop(self._heap)
            if e.deadline is not None and now + e.cost > e.deadline:
                expired.append(self._log_shed(e, now, ShedReason.EXPIRED))
                continue
            return e, expired
        return None, expired

    def slack(self, entry: _Entry, now: int) -> Optional[int]:
        if entry.deadline is None:
            return None
        return entry.deadline - now - entry.cost

    def _log_shed(self, e: _Entry, now: int,
                  reason: ShedReason) -> ShedEvent:
        ev = ShedEvent(rid=e.rid, step=now, reason=reason,
                       priority=e.req.priority, deadline=e.deadline)
        self.shed_log.append(ev)
        return ev


# ---------------------------------------------------------------------------
# graceful degradation (the overload ladder)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DegradationConfig:
    """Hysteresis thresholds for the pressure ladder.  ``pressure`` is
    queue depth over the queue bound (or over ``router.TARGET_DEPTH``
    when unbounded); a level change needs ``patience`` consecutive ticks
    past the water mark, so one bursty tick never thrashes the Mode-keyed
    function sets (level 2 may swap the Mode)."""

    high_water: float = 0.75
    low_water: float = 0.25
    patience: int = 2
    max_level: int = 3
    min_chunk: int = 2           # level-1 floor for the fused decode chunk
    shed_min_priority: int = 1   # level 3 sheds priority >= this


class DegradationLadder:
    """Step replicas down a cost ladder under sustained pressure and back
    up when it clears.  Levels are cumulative:

      0  normal service
      1  halve the fused decode chunk (floor ``min_chunk``) — shorter
         host round-trips, so admissions drain the queue sooner
      2  force the cheaper execution Mode through the Mode thresholds
         (``ServeEngine.set_degraded``: b_threshold -> 0, so pruned
         weights run the Sparse.B kernels even in the dense-preferred
         regime)
      3  shed the lowest-priority class at admission

    ``update`` is a pure function of the pressure history — the ladder
    trajectory is part of the deterministic routing record."""

    def __init__(self, cfg: DegradationConfig = DegradationConfig()):
        self.cfg = cfg
        self.level = 0
        self._above = 0
        self._below = 0
        self.history: List[Tuple[int, int]] = []     # (tick, new level)

    def update(self, pressure: float, tick: int) -> int:
        c = self.cfg
        if pressure >= c.high_water:
            self._above += 1
            self._below = 0
            if self._above >= c.patience and self.level < c.max_level:
                self.level += 1
                self._above = 0
                self.history.append((tick, self.level))
        elif pressure <= c.low_water:
            self._below += 1
            self._above = 0
            if self._below >= c.patience and self.level > 0:
                self.level -= 1
                self._below = 0
                self.history.append((tick, self.level))
        else:
            self._above = self._below = 0
        return self.level


# ---------------------------------------------------------------------------
# latency / attainment reporting
# ---------------------------------------------------------------------------

def percentile(xs: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (deterministic, no interpolation): the
    smallest element >= q of the distribution.  None on empty input."""
    if not xs:
        return None
    s = sorted(xs)
    k = max(0, min(len(s) - 1, int(math.ceil(q / 100.0 * len(s))) - 1))
    return s[k]


def request_rows(outputs: Dict[int, object], reqs) -> List[Dict]:
    """Per-request SLO rows from served outputs.  Works for both output
    shapes: the router's ``RouterOutput`` (tick-based ``submit`` /
    ``first_token`` / ``finished``) and the single engine's
    ``RequestOutput`` (per-token engine-clock ``token_steps`` against the
    request's ``arrival``).  TTFT/completion are virtual ticks after
    arrival; ``attained`` is None when the request carries no deadline."""
    rows = []
    for r in sorted(reqs, key=lambda r: r.rid):
        o = outputs.get(r.rid)
        if o is None:
            continue
        attribution = getattr(o, "attribution", "normal")
        if getattr(o, "first_token", None) is not None:      # RouterOutput
            base = o.submit
            ttft = o.first_token - base if o.first_token >= 0 else None
            done = o.finished - base if o.finished >= 0 else None
        else:                                                # RequestOutput
            steps = getattr(o, "token_steps", [])
            ttft = steps[0] - r.arrival if steps else None
            done = (steps[-1] - r.arrival
                    if steps and getattr(o, "finished", -1) >= 0 else None)
        itl = _itl(getattr(o, "token_steps", []))
        attained = None
        if attribution == "shed":
            attained = False
        elif r.deadline_ms is not None or r.ttft_deadline_ms is not None:
            attained = done is not None
            if r.deadline_ms is not None:
                attained = attained and done <= r.deadline_ms
            if r.ttft_deadline_ms is not None:
                attained = attained and ttft is not None \
                    and ttft <= r.ttft_deadline_ms
        rows.append(dict(rid=r.rid, priority=r.priority,
                         ttft=ttft, completion=done,
                         deadline_ms=r.deadline_ms,
                         ttft_deadline_ms=r.ttft_deadline_ms,
                         itl_max=max(itl) if itl else None,
                         tokens=len(getattr(o, "tokens", [])),
                         attribution=str(getattr(attribution, "value",
                                                 attribution)),
                         attained=attained))
    return rows


def _itl(token_steps: Sequence[int]) -> List[int]:
    return [b - a for a, b in zip(token_steps, token_steps[1:])]


def latency_summary(rows: List[Dict]) -> Dict:
    """Aggregate p50/p99 TTFT, inter-token latency and SLO attainment
    over ``request_rows`` output — the fields the reference's serving
    benchmark records for its router rows, compared exactly."""
    ttfts = [r["ttft"] for r in rows if r["ttft"] is not None]
    itls = [r["itl_max"] for r in rows if r["itl_max"] is not None]
    gated = [r for r in rows if r["attained"] is not None]
    shed = sum(1 for r in rows if r["attribution"] == "shed")
    return {
        "requests": len(rows),
        "completed": sum(1 for r in rows if r["completion"] is not None),
        "shed": shed,
        "ttft_p50": percentile(ttfts, 50),
        "ttft_p99": percentile(ttfts, 99),
        "itl_p50": percentile(itls, 50),
        "itl_p99": percentile(itls, 99),
        "slo_attainment": (round(sum(1 for r in gated if r["attained"])
                                 / len(gated), 4) if gated else None),
    }
