"""Continuous-batching serving engine: the fixed or paged slot-pool KV
arena, FCFS scheduler and the fused or stepwise decode path — the
counterpart of ``repro/runtime/engine.py`` (single device).

A ``num_slots x cache_len`` cache arena is shared by all in-flight
requests; with ``ArenaConfig.page_size`` set it is a pool of pages
(``runtime/paging.py``) from which each admission reserves only what its
prompt + generation needs.  Each tick admits waiting requests into free
slots (prefilling each alone at a power-of-two bucketed prompt length and
writing its cache into the slot, or onto its pages, in place), then
advances every running slot by a fused chunk
of decode steps (``runtime.serve.make_decode_chunk_fn``) that keeps argmax,
token feedback and per-slot bookkeeping on the device.  One host transfer
per tick brings back the (chunk, B) token ring, the admissions' first tokens
and the two measurement scalars.  ``SchedConfig.fused=False`` keeps the
reference's stepwise baseline: one pooled decode step per tick, with a
host sync for every admission's first token and for every step's tokens.

The engine keeps a running measured activation sparsity (exact-zero
fraction of the live rows' decode logits), re-invokes
``core.hybrid.select_mode`` against the offline weight sparsity, and runs
every prefill and chunk under that mode's ``sparse_execution`` scope.
``greedy_generate`` is the parity oracle: decode is row-wise independent and
batch-invariant, so a request's tokens equal a batch-1 greedy run of the
same bucketed prompt.
"""
from __future__ import annotations

import copy
import dataclasses
import enum
import heapq
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..checkpoint import restore as ckpt_restore
from ..checkpoint import save as ckpt_save
from ..core.hybrid import SPARSE_THRESHOLD, select_mode
from ..core.spec import Mode
from ..kernels.griffin_spmm.ops import GriffinWeights
from ..models.common import sparse_execution
from ..models.registry import ModelApi
from ..optim.compression import quantize_rows
from ..sparsity.pruning import GEMM_WEIGHTS
from .config import EngineConfig
from .fault import DeviceLoss, FaultInjector
from .paging import PageAllocator, build_spec, paged_tree
from .serve import make_chunk_ladder, pad_prompt_batch
from .straggler import StragglerDetector

# Category knob handed to the sparse_execution scope when the measured
# activation sparsity selects an A-side mode and no declared value exists:
# the scope only consumes the category bit.
DEFAULT_DECLARED_A = 0.5

# Smallest prefill bucket: the bucket set is {8, 16, ..., cache_len}.
MIN_BUCKET = 8

# Pareto shape of ``synthetic_trace(length_dist="heavy")``'s generation
# lengths: the reference's default
HEAVY_ALPHA = 1.6

# Captures and disk saves whose seconds an armed engine keeps (the newest)
TIMING_WINDOW = 1024


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    """One generation request; ``arrival`` is the earliest engine step at
    which the scheduler may admit it; ``extras`` carries the model inputs
    that are not tokens (an encoder-decoder's ``"frames"``).

    ``priority``/``deadline_ms``/``ttft_deadline_ms`` are the SLO fields
    the multi-replica router's admission control consumes
    (``runtime.router``): priority 0 is the most important class,
    deadlines count virtual ticks after ``arrival`` (None = best-effort).
    A plain ``ServeEngine`` ignores all three."""

    rid: int
    tokens: np.ndarray
    max_new_tokens: int
    arrival: int = 0
    extras: Optional[Dict[str, np.ndarray]] = None
    priority: int = 0
    deadline_ms: Optional[int] = None
    ttft_deadline_ms: Optional[int] = None

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.tokens).shape[-1])

    def as_batch(self, device: torch.device,
                 bucket: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The batch-1 model input this request prefills with — also what
        oracle replays must feed.  ``bucket`` right-pads the prompt; each
        extra goes on the device in its own dtype with a leading 1."""
        toks = torch.as_tensor(np.asarray(self.tokens, np.int64).reshape(1, -1),
                               device=device)
        batch = {"tokens": toks}
        for k, v in (self.extras or {}).items():
            batch[k] = torch.as_tensor(np.asarray(v), device=device)[None]
        return pad_prompt_batch(batch, bucket)


class Attribution(str, enum.Enum):
    """How a request's output came to be: served normally, shed by
    admission control, replayed on a surviving replica after its first
    replica died, or won by a hedged duplicate.  Plain engine runs only
    produce ``NORMAL``; the router (``runtime.router``) stamps the
    rest."""

    NORMAL = "normal"
    SHED = "shed"
    RETRIED = "retried"
    HEDGED = "hedged"


@dataclasses.dataclass
class RequestOutput:
    rid: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    admitted: int = -1
    finished: int = -1
    token_steps: List[int] = dataclasses.field(default_factory=list)
    attribution: Attribution = Attribution.NORMAL
    shed_reason: Optional[str] = None


# ---------------------------------------------------------------------------
# scheduler (pure host bookkeeping)
# ---------------------------------------------------------------------------

class Scheduler:
    """FCFS slot scheduler.  ``policy="continuous"`` admits into freed slots
    every step (at most ``max_admissions_per_step``); ``"static"`` admits
    only when the pool has drained.  An arrival-ordered heap feeds a ready
    queue ordered by submission, so admission is amortized O(1)."""

    def __init__(self, num_slots: int, policy: str = "continuous",
                 max_admissions_per_step: int = 1):
        if num_slots < 1:
            raise ValueError("need at least one slot")
        if policy not in ("continuous", "static"):
            raise ValueError(f"unknown policy {policy!r}")
        self.num_slots = num_slots
        self.policy = policy
        self.max_admissions = max(1, max_admissions_per_step)
        self._seq = 0
        self._by_arrival: List[Tuple[int, int, Request]] = []
        self._ready: List[Tuple[int, Request]] = []
        self.running: Dict[int, Request] = {}
        self.remaining: Dict[int, int] = {}
        self.finished: List[int] = []
        self._free = list(range(num_slots - 1, -1, -1))   # pop() -> slot 0

    def add(self, req: Request) -> None:
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.rid}: max_new_tokens must be >=1")
        heapq.heappush(self._by_arrival, (req.arrival, self._seq, req))
        self._seq += 1

    @property
    def waiting_count(self) -> int:
        return len(self._by_arrival) + len(self._ready)

    def admissions(self, step: int,
                   gate: Optional[Callable[[Request], bool]] = None
                   ) -> List[Tuple[int, Request]]:
        """Pop the (slot, request) pairs to admit at ``step``: FCFS over the
        arrived requests, bounded by free slots and the admission budget.
        ``gate`` (the paged arena's page reservation) may veto the head
        request: it goes back to the front of the ready queue and admission
        stops, so FCFS order holds while the pool drains.  The gate is only
        asked when a slot and budget are available, so a True verdict (and
        the reservation it made) always commits."""
        while self._by_arrival and self._by_arrival[0][0] <= step:
            _, seq, req = heapq.heappop(self._by_arrival)
            heapq.heappush(self._ready, (seq, req))
        if self.policy == "static" and self.running:
            return []
        budget = (self.num_slots if self.policy == "static"
                  else self.max_admissions)
        out: List[Tuple[int, Request]] = []
        while self._free and self._ready and len(out) < budget:
            seq, req = heapq.heappop(self._ready)
            if gate is not None and not gate(req):
                heapq.heappush(self._ready, (seq, req))
                break
            slot = self._free.pop()
            self.running[slot] = req
            self.remaining[slot] = req.max_new_tokens
            out.append((slot, req))
        return out

    def emit(self, slot: int) -> bool:
        """Record one emitted token on ``slot``; frees the slot and returns
        True when that was the request's last token."""
        self.remaining[slot] -= 1
        if self.remaining[slot] > 0:
            return False
        req = self.running.pop(slot)
        del self.remaining[slot]
        self._free.append(slot)
        self.finished.append(req.rid)
        return True

    def would_admit(self, step: int) -> bool:
        """Non-mutating peek: would ``admissions(step)`` pop at least one
        request, page gate aside?  The router classifies a replica's tick
        phase with it (prefill vs decode vs idle) without disturbing the
        queues."""
        if not self._free:
            return False
        if self.policy == "static" and self.running:
            return False
        return bool(self._ready) or bool(
            self._by_arrival and self._by_arrival[0][0] <= step)

    def cancel_slot(self, slot: int) -> Request:
        """Free ``slot`` without crediting a finished request — the
        router's hedge-loser path.  The request is *not* appended to
        ``finished``."""
        req = self.running.pop(slot)
        del self.remaining[slot]
        self._free.append(slot)
        return req

    def remove_waiting(self, rid: int) -> bool:
        """Drop a not-yet-admitted request from the queues (the heaps are
        rebuilt: cancellation is rare and off the hot path).  Returns True
        when something was removed."""
        n0 = self.waiting_count
        self._by_arrival = [(a, s, r) for a, s, r in self._by_arrival
                            if r.rid != rid]
        heapq.heapify(self._by_arrival)
        self._ready = [(s, r) for s, r in self._ready if r.rid != rid]
        heapq.heapify(self._ready)
        return self.waiting_count < n0

    @property
    def active(self) -> List[int]:
        return sorted(self.running)

    def next_arrival(self) -> Optional[int]:
        """Arrival step of the earliest not-yet-arrived request."""
        return self._by_arrival[0][0] if self._by_arrival else None

    def deferred_ready(self) -> bool:
        """True when arrived requests still wait (admission budget spent)."""
        return bool(self._ready)

    def has_work(self) -> bool:
        return bool(self._by_arrival or self._ready or self.running)

    # -- snapshots ----------------------------------------------------------

    def state_dict(self) -> Dict:
        """JSON-serialisable snapshot of every queue, equal to the
        reference's for the same calls: it rides a disk snapshot's
        manifest (``checkpoint.read_manifest``), so a fresh process can
        rebuild the host side of an engine and resume the trace.  Token
        arrays become int lists, each extra ``[dtype, nested list]``
        (fp32 -> Python float -> fp32 is exact)."""
        def req(r: Request) -> Dict:
            d = {"rid": r.rid, "tokens": np.asarray(r.tokens).tolist(),
                 "max_new_tokens": r.max_new_tokens, "arrival": r.arrival,
                 "priority": r.priority, "deadline_ms": r.deadline_ms,
                 "ttft_deadline_ms": r.ttft_deadline_ms}
            if r.extras:
                d["extras"] = {k: [str(np.asarray(v).dtype),
                                   np.asarray(v).tolist()]
                               for k, v in r.extras.items()}
            return d
        return {"num_slots": self.num_slots, "policy": self.policy,
                "max_admissions": self.max_admissions, "seq": self._seq,
                "by_arrival": [[a, s, req(r)]
                               for a, s, r in sorted(self._by_arrival)],
                "ready": [[s, req(r)] for s, r in sorted(self._ready)],
                "running": {str(slot): req(r)
                            for slot, r in self.running.items()},
                "remaining": {str(s): int(n)
                              for s, n in self.remaining.items()},
                "finished": list(self.finished),
                "free": list(self._free)}

    @classmethod
    def from_state_dict(cls, d: Dict) -> "Scheduler":
        """Inverse of ``state_dict``: the exact queue state (heap entries,
        submission counter, free-slot stack), so admission order after a
        restore equals the uninterrupted run's."""
        def req(rd: Dict) -> Request:
            extras = {k: np.asarray(v, np.dtype(dt))
                      for k, (dt, v) in rd.get("extras", {}).items()} or None
            return Request(rid=rd["rid"],
                           tokens=np.asarray(rd["tokens"], np.int32),
                           max_new_tokens=rd["max_new_tokens"],
                           arrival=rd["arrival"], extras=extras,
                           priority=rd.get("priority", 0),
                           deadline_ms=rd.get("deadline_ms"),
                           ttft_deadline_ms=rd.get("ttft_deadline_ms"))
        sched = cls(d["num_slots"], d["policy"], d["max_admissions"])
        sched._seq = d["seq"]
        sched._by_arrival = [(a, s, req(r)) for a, s, r in d["by_arrival"]]
        heapq.heapify(sched._by_arrival)
        sched._ready = [(s, req(r)) for s, r in d["ready"]]
        heapq.heapify(sched._ready)
        sched.running = {int(k): req(r) for k, r in d["running"].items()}
        sched.remaining = {int(k): int(n)
                           for k, n in d["remaining"].items()}
        sched.finished = list(d["finished"])
        sched._free = list(d["free"])
        return sched


# ---------------------------------------------------------------------------
# arena plumbing
# ---------------------------------------------------------------------------

def _promote_arena(cache: Dict[str, torch.Tensor], num_slots: int
                   ) -> Dict[str, torch.Tensor]:
    """``init_cache``'s tree with scalar counters promoted to per-slot (B,)
    vectors — the decode paths' per-row position branch."""
    return {k: (torch.zeros((num_slots,), dtype=v.dtype, device=v.device)
                if v.dim() == 0 else v) for k, v in cache.items()}


def _batch_axes(api: ModelApi) -> Dict[str, int]:
    """Per-leaf batch-axis index of the cache (-1 for scalar counters),
    found by diffing the shapes ``init_cache`` gives for batch 2 and 1 on
    the ``meta`` device (nothing is allocated: xlstm-1.3b's state is 0.7
    GB a row)."""
    meta = torch.device("meta")
    two = api.init_cache(2, 1, device=meta)
    one = api.init_cache(1, 1, device=meta)
    axes = {}
    for key in two:
        diffs = [i for i, (a, b) in enumerate(zip(two[key].shape,
                                                  one[key].shape)) if a != b]
        if len(diffs) > 1 or (not diffs and two[key].dim()):
            raise ValueError(f"cache leaf {key!r} has no single batch axis")
        axes[key] = diffs[0] if diffs else -1
    return axes


def weight_sparsity(params: Any,
                    names: Sequence[str] = GEMM_WEIGHTS) -> float:
    """Mean sparsity of the weight GEMM leaves: ``GriffinWeights`` report
    ``1 - density``, plain leaves their exact zero fraction
    (:func:`zero_fraction`) — the B-side input to ``select_mode``.  Reads
    values back to the host; called at engine construction only."""
    vals: List[float] = []

    def walk(t, name=""):
        if isinstance(t, GriffinWeights):
            vals.append(1.0 - t.density)
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, k)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v, name)
        elif name in names and isinstance(t, torch.Tensor) and \
                t.dim() >= 2 and t.numel() and t.is_floating_point():
            vals.append(zero_fraction(t))

    walk(params)
    return float(np.mean(vals)) if vals else 0.0


def zero_fraction(t: torch.Tensor) -> float:
    """The exact fraction of zeros in ``t``, counted one (K, N) matrix of a
    stacked leaf at a time: comparing the whole stack at once would hold a
    mask and a float copy of it beside the weights (chameleon-34b's 17.3
    GB w_gate stack beside its 63.9 GiB of dense weights does not fit the
    card).  One host read a leaf."""
    zeros = torch.zeros((), dtype=torch.int64, device=t.device)
    for m in t.reshape(-1, *t.shape[-2:]):
        zeros += (m == 0).sum()
    return int(zeros) / t.numel()


# ---------------------------------------------------------------------------
# recovery snapshots
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EngineSnapshot:
    """Host-side copy of everything one engine tick can mutate, captured at
    tick start while recovery is armed.  ``device`` holds host copies of
    the arena (pools, page table and int8 scales included), the feedback
    tokens and the per-slot owed-token counters under the keys ``cache``,
    ``tokens`` and ``remaining``; the scheduler and outputs are deep
    copies.  Beside the reference's fields, the port keeps the state it
    adds: ``peak_active``.  The Mode-keyed function sets are not in it, as
    in the reference: a single-device recovery keeps the sets built before
    the loss (a set first built in the lost tick included), so the replay
    builds and counts in ``stats["retraces"]`` none of them again (a
    remesh drops them, ``MeshServeEngine._remesh``).  ``ckpt_step`` is set
    when the snapshot also went to disk (``FaultConfig.snapshot_dir``):
    recovery then reloads the device state through
    ``checkpoint.restore``.  ``paging`` is the paged arena's host state
    (allocator, slot -> pages map, finished slots awaiting reclamation)."""

    device: Dict[str, Any]
    sched: Scheduler
    outputs: Dict[int, RequestOutput]
    events_len: int
    clock: int
    mode: Mode
    a_measured: float
    since_measure: int
    mode_history: List[Tuple[int, Mode]]
    stats: Dict[str, int]
    prefill_buckets: set
    peak_active: int
    ckpt_step: Optional[int] = None
    paging: Optional[Dict] = None


def _cpu_tree(tree: Any) -> Any:
    """``tree`` (dicts, lists, compacted weights) with every tensor on the
    host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu")
    if isinstance(tree, GriffinWeights):
        return dataclasses.replace(tree, **{
            f.name: _cpu_tree(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _cpu_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu_tree(v) for v in tree)
    return tree


def _model_calls(stats: Dict[str, int]) -> int:
    return stats["prefill_calls"] + stats["decode_steps"]


def _leaf_pairs(dst: Dict[str, Any], src: Dict[str, Any]):
    """(dst, src) tensor pairs of two device-state trees of one layout
    (``cache``, ``tokens``, ``remaining``)."""
    for k, v in src["cache"].items():
        yield dst["cache"][k], v
    for k in ("tokens", "remaining"):
        yield dst[k], src[k]


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

class ServeEngine:
    """Continuous-batching driver over a ``ModelApi``, on the model's
    device.  Greedy decoding only (argmax), matching ``greedy_generate``.

    ``stats`` counts ``decode_steps``, ``prefill_calls``, ``emitted``,
    ``idle_steps``, ``retraces`` (function sets built, one per selected
    Mode), ``chunk_calls`` and ``host_syncs`` exactly as the reference
    engine does, so a trace gives the same counters on both.
    ``peak_active`` is the most slots held at once (after a tick's
    admissions).

    With ``ArenaConfig.page_size`` the arena is paged: ``cache_len`` rounds
    up to a page multiple, an admission reserves the pages its prompt +
    generation needs (head-of-line blocking when the pool is short), and a
    finished slot's pages return to the pool at the next tick's start.
    Page-table rows reach the card from pinned host rows without a stream
    sync, and are reset to DUMP by fills.  int8 pools quantize the
    prefilled rows per token (``quantize_rows``) and store the scales
    beside them.

    The router's hooks: ``chunk_cap`` caps the fused-chunk ladder
    (degradation level 1), ``set_degraded`` forces the cheaper Mode
    (level 2), ``cancel`` withdraws a request (the hedge loser) and
    ``load`` is the least-loaded dispatch signal.

    ``plan`` is a tuned kernel plan (``repro_torch.tuning``): a
    ``KernelPlan``, resolved by the model's family, or a ``FamilyPlan``.
    Only its Mode-selection thresholds act here (``_a_threshold``,
    ``_b_threshold``, default ``SPARSE_THRESHOLD``); its compaction rules
    were applied when the caller ran ``sparsify_params(plan=...)``.
    Thresholds change which kernels run, never what they compute.

    Failure handling arms when a ``fault_injector`` (``runtime.fault``), a
    ``straggler`` detector or ``FaultConfig.snapshot_dir`` is given: every
    tick first captures an :class:`EngineSnapshot` (one device-to-host
    copy of the arena, not counted in ``host_syncs``; with a snapshot
    directory also a ``checkpoint.save`` of it, the weights and the
    scheduler), and a ``DeviceLoss`` raised at one of the tick's three
    polls (admission, prefill, decode) rolls every host structure back,
    writes the device state back into the live tensors and replays the
    tick, which is deterministic, so the trace ends token-identical to
    an uninterrupted run.  One device has no survivors to remesh onto:
    recovery restarts in place (a mesh engine remeshes onto the survivors,
    ``runtime.mesh_serve``).  ``recoveries`` and ``recovery_log``
    record what happened; ``replayed_calls`` counts the model calls
    (prefills, decode steps) whose work a recovery threw away, which the
    replay makes again; ``capture_s``/``save_s`` hold the seconds of the
    last ``TIMING_WINDOW`` captures and disk saves (bounded, so a
    long-running armed engine does not grow), ``snapshot_bytes`` the
    device bytes one capture copies.  An unarmed engine captures
    nothing.
    """

    def __init__(self, api: ModelApi, params: Any,
                 config: Optional[EngineConfig] = None, plan: Any = None, *,
                 fault_injector: Optional[FaultInjector] = None,
                 straggler: Optional[StragglerDetector] = None):
        config = config or EngineConfig()
        fam = plan
        if plan is not None and hasattr(plan, "families"):
            fam = plan.family(api.cfg.family)
        self.plan = fam
        self._a_threshold = (fam.a_threshold if fam is not None
                             and fam.a_threshold is not None
                             else SPARSE_THRESHOLD)
        self._b_threshold = (fam.b_threshold if fam is not None
                             and fam.b_threshold is not None
                             else SPARSE_THRESHOLD)
        if config.arena.cache_len is None:
            raise ValueError("cache_len is required: set "
                             "ArenaConfig.cache_len")
        self.config = config
        self.api = api
        self.params = params
        self.device = api.device
        self.num_slots = config.arena.num_slots
        arena = config.arena
        self._paged, self.cache_len = build_spec(
            api, arena.num_slots, arena.cache_len, arena.page_size,
            arena.num_pages, arena.kv_dtype)
        self.decode_chunk = max(1, config.sched.decode_chunk)
        self.fused = config.sched.fused
        self.bucket_prompts = config.sched.bucket_prompts
        self.use_kernels = config.kernels.use_kernels
        self.a_declared = config.kernels.a_sparsity
        self.block_m = config.kernels.block_m
        self.measure_every = max(1, config.sched.measure_every)
        # router hooks (runtime.router), inert by default: ``chunk_cap``
        # caps the fused-chunk ladder (degradation level 1), ``degraded``
        # zeroes the B-side Mode threshold (level 2)
        self.chunk_cap: Optional[int] = None
        self.degraded = False
        self.spmd_kernels = config.kernels.spmd_kernels
        self.sched = Scheduler(self.num_slots, config.sched.policy,
                               config.sched.max_admissions_per_step)
        self._mode_fns: Dict[Mode, Tuple[Callable, ...]] = {}
        self.b_sparsity = self._weight_sparsity(params)
        self.a_measured = 0.0
        self.mode = self._select_mode()
        self.mode_history: List[Tuple[int, Mode]] = [(0, self.mode)]
        self.clock = 0
        self._since_measure = 0
        self.outputs: Dict[int, RequestOutput] = {}
        self.events: List[Tuple[int, int, int]] = []    # (step, rid, token)
        self.stats = {"decode_steps": 0, "prefill_calls": 0, "emitted": 0,
                      "idle_steps": 0, "retraces": 0, "chunk_calls": 0,
                      "host_syncs": 0}
        self.prefill_buckets: set = set()
        self.peak_active = 0
        window = api.cfg.window
        self._bucket_cap = min(self.cache_len, window or self.cache_len)
        self._axes = _batch_axes(api)
        # paged-arena host state: the page allocator, each slot's pages,
        # reservations made by this tick's admission gate, finished slots
        # whose pages return at the next tick's start, and the pinned host
        # rows their page-table rows are copied from.  A slot's row is
        # rewritten only when the slot is admitted again, after the host
        # has read that slot's tokens (a sync that the earlier copy
        # precedes), so no copy in flight ever reads a row being written.
        # A cancelled slot is no exception: every tick that admits ends in
        # a sync, and ``cancel`` runs only at tick boundaries, so its
        # slot's copy has landed before the slot can be admitted again.
        self._page_alloc = (PageAllocator(self._paged.num_pages)
                            if self._paged is not None else None)
        self._slot_pages: Dict[int, List[int]] = {}
        self._reserved_pages: Dict[int, List[int]] = {}
        self._dirty_slots: set = set()
        self._alloc_state()
        # failure handling: armed by any of these three
        self.faults = fault_injector
        self.straggler = straggler
        self.snapshot_dir = config.fault.snapshot_dir
        self.recoveries = 0
        self.recovery_log: List[Dict] = []
        self.replayed_calls = 0
        self.capture_s: deque = deque(maxlen=TIMING_WINDOW)
        self.save_s: deque = deque(maxlen=TIMING_WINDOW)
        self.snapshot_bytes = 0
        self._snapshot: Optional[EngineSnapshot] = None
        self._snap_host: Optional[Dict[str, Any]] = None
        self._evicted: set = set()
        self._params_host = self._host_params(params)

    def _alloc_state(self) -> None:
        """The zeroed device state of the slots this engine decodes: the
        arena, the feedback tokens, the owed-token counters, and the
        pinned page-table rows of a paged arena."""
        rows = self._rows_here()
        self.cache = self._arena()
        self._page_rows = (torch.zeros(
            (rows, self._paged.max_pages), dtype=torch.int32,
            pin_memory=self.device.type == "cuda")
            if self._paged is not None else None)
        self._tokens = torch.zeros((rows, 1), dtype=torch.int64,
                                   device=self.device)
        self._remaining = torch.zeros((rows,), dtype=torch.int32,
                                      device=self.device)

    def _arena(self) -> Dict[str, torch.Tensor]:
        """The zeroed device arena of the slots this engine decodes
        (:meth:`_rows_here`): ``init_cache``'s tree with counters
        promoted per slot, rewritten into pools and a page table when the
        arena is paged (built on the meta device, then allocated once)."""
        rows = self._rows_here()
        if self._paged is None:
            return _promote_arena(
                self.api.init_cache(rows, self.cache_len), rows)
        base = _promote_arena(self.api.init_cache(
            rows, self.cache_len, device=torch.device("meta")), rows)
        return {k: torch.zeros(v.shape, dtype=v.dtype, device=self.device)
                for k, v in paged_tree(base, rows, self._paged).items()}

    # -- hooks of a mesh-parallel engine (runtime.mesh_serve) ---------------
    # The single-device engine decodes every slot and reads its own device
    # values back; a mesh rank decodes its data row's slots and gathers the
    # rest at the same sync points, so every rank's host state stays equal.

    def _rows_here(self) -> int:
        """How many slots this engine's arena holds (all of them here)."""
        return self.num_slots

    def _cut(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """The part of arena leaf ``key`` (or of a prefilled cache's leaf,
        or its pages, in the same axis order) that this engine's arena
        holds: all of it here (a mesh rank holds its share of the head
        axes)."""
        return t

    def _slot_row(self, slot: int) -> Optional[int]:
        """The arena row of global ``slot``, or None where another rank's
        arena holds it."""
        return slot

    def _weight_sparsity(self, params: Any) -> float:
        return weight_sparsity(params)

    def _host_params(self, params: Any) -> Optional[Any]:
        """The host copy of the weights that recovery keeps: one device
        serves its weights as they are after a loss, so only disk
        snapshots need it."""
        return _cpu_tree(params) if self.snapshot_dir is not None else None

    def _fetch_tick(self, ring: torch.Tensor,
                    pending: Sequence[Tuple[int, Optional[torch.Tensor]]],
                    zf_num: torch.Tensor, zf_den: torch.Tensor
                    ) -> Tuple[np.ndarray, List[int], int, int]:
        """A fused tick's one host transfer: the (chunk, num_slots) token
        ring, the admissions' first tokens and the two measurement counts
        (exact-zero logits of the live rows, and their logits)."""
        parts = [ring.reshape(-1).double()]
        parts += [t.double() for _, t in pending]
        parts += [zf_num.double().reshape(1), zf_den.double().reshape(1)]
        host = torch.cat(parts).cpu().numpy()
        ring_h = host[:ring.numel()].reshape(ring.shape).astype(np.int64)
        first = [int(t) for t in host[ring.numel():ring.numel()
                                      + len(pending)]]
        return ring_h, first, int(host[-2]), int(host[-1])

    def _fetch_first(self, pending: Sequence[Tuple[int, Optional[
            torch.Tensor]]]) -> List[int]:
        """The admissions' first tokens, in one host transfer."""
        return [int(t) for t in torch.cat([t for _, t in pending]).tolist()]

    def _fetch_rows(self, toks: torch.Tensor) -> np.ndarray:
        """A stepwise decode step's (num_slots,) tokens on the host."""
        return toks.cpu().numpy()

    def _zero_counts(self, logits: torch.Tensor, rows: Sequence[int]
                     ) -> Tuple[int, int]:
        """(exact zeros, entries) of the logits of arena ``rows``: one host
        transfer."""
        live = logits[torch.as_tensor(rows, device=logits.device)]
        return int((live == 0).sum()), live.numel()

    # -- paged-arena bookkeeping --------------------------------------------

    def _page_gate(self, req: Request) -> bool:
        """Admission gate: reserve the physical pages covering prompt +
        generation before the scheduler commits the slot; on exhaustion
        the request stays at the head of the queue."""
        need = self._paged.pages_needed(req.prompt_len + req.max_new_tokens)
        ids = self._page_alloc.reserve(need)
        if ids is None:
            return False
        self._reserved_pages[req.rid] = ids
        return True

    def _admission_gate(self) -> Optional[Callable[[Request], bool]]:
        return self._page_gate if self._paged is not None else None

    def _flush_dirty(self) -> None:
        """Tick-start reclamation: finished slots' page-table rows point
        at DUMP again (so their garbage decode writes stop landing on
        reclaimable pages) and their pages return to the allocator, ready
        for this tick's admissions.  No page is copied."""
        if self._paged is None or not self._dirty_slots:
            return
        for slot in sorted(self._dirty_slots):
            row = self._slot_row(slot)
            if row is not None:
                self.cache["pages"][row].zero_()
            self._page_alloc.free(self._slot_pages.pop(slot, ()))
        self._dirty_slots.clear()

    # -- mode plumbing ------------------------------------------------------

    def _a_now(self) -> float:
        return (self.a_declared if self.a_declared is not None
                else self.a_measured)

    def _select_mode(self) -> Mode:
        return select_mode(self._a_now(), self.b_sparsity,
                           threshold=self._a_threshold,
                           b_threshold=(0.0 if self.degraded
                                        else self._b_threshold))

    def set_degraded(self, on: bool) -> None:
        """Degradation-ladder level 2: force the cheaper execution Mode —
        ``on`` zeroes the B-side threshold, so any pruned weight selects
        the Sparse.B kernels even below ``_b_threshold`` (dense
        weights stay dense: 0 > 0 is false).  Re-selects at once; a flip
        swaps the Mode-keyed function set like a measured flip."""
        if on == self.degraded:
            return
        self.degraded = on
        mode = self._select_mode()
        if mode != self.mode:
            self.mode = mode
            self.mode_history.append((self.clock, mode))

    def _scope(self):
        a_scope = 0.0
        if self.mode in (Mode.A, Mode.AB):
            a_scope = (self.a_declared if self.a_declared is not None
                       and self.a_declared > self._a_threshold
                       else DEFAULT_DECLARED_A)
        return sparse_execution(use_kernels=self.use_kernels,
                                a_sparsity=a_scope, block_m=self.block_m,
                                a_threshold=self._a_threshold,
                                spmd_mesh=self._spmd_mesh,
                                spmd_kernels=self.spmd_kernels)

    def _fns(self) -> Tuple[Callable, Callable, Callable]:
        """(prefill_fn, decode_fn, chunk_for) of the current Mode.  Eager
        PyTorch reads the scope on every call, so each Mode's set is built
        from the same functions; keying by Mode keeps the reference's
        bookkeeping."""
        fns = self._mode_fns.get(self.mode)
        if fns is None:
            cache_len = self.cache_len

            def prefill(params, batch):
                return self.api.prefill(params, batch, cache_len=cache_len)

            fns = (prefill, self.api.decode_step,
                   make_chunk_ladder(self.api, self.decode_chunk))
            self._mode_fns[self.mode] = fns
            self.stats["retraces"] += 1
        return fns

    def _measure(self, zero_frac: float) -> None:
        """Re-select the category from the measured exact-zero fraction of
        the live rows' logits; a flip takes effect from the next chunk (or
        step)."""
        self._since_measure = 0
        self.a_measured = float(zero_frac)
        mode = self._select_mode()
        if mode != self.mode:
            self.mode = mode
            self.mode_history.append((self.clock, mode))

    # -- request lifecycle --------------------------------------------------

    def add(self, req: Request) -> None:
        if req.prompt_len + req.max_new_tokens > self.cache_len:
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt_len} + gen "
                f"{req.max_new_tokens} exceeds cache_len {self.cache_len}")
        if self.api.cfg.is_encdec and (req.extras or {}).get("frames") is None:
            raise ValueError(f"request {req.rid}: enc-dec model needs "
                             "extras['frames']")
        self.sched.add(req)

    def bucket_for(self, prompt_len: int) -> Optional[int]:
        """Power-of-two prefill bucket (min ``MIN_BUCKET``), or None when it
        would overflow the usable cache window or bucketing is off."""
        if not self.bucket_prompts:
            return None
        b = MIN_BUCKET
        while b < prompt_len:
            b *= 2
        return b if b <= self._bucket_cap else None

    def _chunk_len(self, admitted_slots: frozenset = frozenset()) -> int:
        """Fused-chunk length: the largest power of two <= ``decode_chunk``
        that no live slot finishes inside and that does not overrun a known
        arrival (or a backlog) while a slot is free — the latter floored at
        ``decode_chunk / 4``.  Slots admitted this tick owe one step fewer
        (their prefill token is emitted from the chunk's sync).
        ``chunk_cap`` (degradation level 1) lowers the ladder's top."""
        cap = self.decode_chunk
        if self.chunk_cap is not None:
            cap = max(1, min(cap, self.chunk_cap))
        bound = min(self.sched.remaining[s] - (s in admitted_slots)
                    for s in self.sched.active)
        bound = max(1, bound)
        if self.sched._free and self.sched.policy == "continuous":
            floor = max(1, cap // 4)
            if self.sched.deferred_ready():
                bound = min(bound, floor)
            else:
                na = self.sched.next_arrival()
                if na is not None:
                    bound = min(bound, max(floor, na - self.clock))
        c = 1
        while c * 2 <= cap and c * 2 <= bound:
            c *= 2
        return c

    def _prefill(self, req: Request):
        prefill_fn = self._fns()[0]
        batch = req.as_batch(self.device, self.bucket_for(req.prompt_len))
        with self._scope():
            cache1, logits = prefill_fn(self.params, batch)
        self._count_prefill(req)
        return cache1, logits

    def _count_prefill(self, req: Request) -> None:
        """A prefill's host bookkeeping (its bucket, the counter), made on
        every rank of a mesh whichever rank computes it."""
        bucket = self.bucket_for(req.prompt_len)
        self.prefill_buckets.add(req.prompt_len if bucket is None
                                 else bucket)
        self.stats["prefill_calls"] += 1

    def _insert(self, slot: int, sub: Dict[str, torch.Tensor],
                logits: torch.Tensor, rem: int,
                page_ids: Sequence[int] = ()) -> torch.Tensor:
        """Admission, in place on the device: write the prefilled
        single-request cache into ``slot`` of the arena, seed the slot's
        feedback token from the prefill logits and its owed-token counter.
        On a paged arena the pageable leaves, cut into (stack, max_pages,
        page_size, ...) pages, are scattered onto ``page_ids`` (logical
        pages past them go to DUMP, so bucket padding is discarded) and the
        slot's page-table row is installed; no resident page is copied.
        Returns the (1,) first token, fetched with the next sync."""
        spec = self._paged
        if spec is not None:
            row = self._page_rows[slot]
            row.copy_(torch.from_numpy(spec.page_row(page_ids)))
            dev_row = self.cache["pages"][slot]
            dev_row.copy_(row, non_blocking=True)
            idx = dev_row.long()
            for key in spec.paged_keys:
                x = sub[key][:, 0]               # (stack, cache_len, ...)
                x = x.reshape(x.shape[0], spec.max_pages, spec.page_size,
                              *x.shape[2:])
                if spec.kv_dtype == "int8":
                    # a token's scale covers all its heads, held or not
                    x, scale = quantize_rows(x, 3)
                    self.cache[key + "_scale"][:, idx] = scale
                self.cache[key][:, idx] = self._cut(key, x).to(
                    self.cache[key].dtype)
        for key, ax in self._axes.items():
            if spec is not None and key in spec.paged_keys:
                continue
            if ax < 0:
                self.cache[key][slot] = sub[key].reshape(())
            else:
                self.cache[key].select(ax, slot).copy_(
                    self._cut(key, sub[key]).select(ax, 0))
        tok = torch.argmax(logits, dim=-1)                      # (1,)
        self._tokens[slot] = tok
        self._remaining[slot].fill_(rem)          # no host-to-device copy
        return tok

    def _emit(self, slot: int, token: int) -> None:
        req = self.sched.running[slot]
        out = self.outputs[req.rid]
        out.tokens.append(token)
        out.token_steps.append(self.clock)
        self.events.append((self.clock, req.rid, token))
        self.stats["emitted"] += 1
        if self.sched.emit(slot):
            out.finished = self.clock
            if self._paged is not None:
                # the pages stay owned while the slot may still take
                # garbage decode writes (until this chunk ends); the next
                # tick's _flush_dirty frees them before any admission
                self._dirty_slots.add(slot)

    def cancel(self, rid: int) -> bool:
        """Withdraw a request — the router's hedge-loser hook.  A running
        request's slot is freed and its owed-token counter zeroed on the
        device (a fill: no host sync, no transfer), so the live mask drops
        it and the chunk ladder stops waiting on it; on a paged arena its
        pages return at the next tick's start.  A waiting request just
        leaves the queues.  Call at tick boundaries only.  Returns False
        when ``rid`` is unknown or already finished."""
        for slot, req in sorted(self.sched.running.items()):
            if req.rid == rid:
                row = self._slot_row(slot)
                if row is not None:
                    self._remaining[row].fill_(0)
                self.sched.cancel_slot(slot)
                if self._paged is not None:
                    self._dirty_slots.add(slot)
                return True
        return self.sched.remove_waiting(rid)

    @property
    def load(self) -> int:
        """Requests this engine owns (running + queued) — the router's
        deterministic least-loaded dispatch signal."""
        return len(self.sched.running) + self.sched.waiting_count

    def step(self) -> List[Tuple[int, int, int]]:
        """One engine tick on the fused or the stepwise path
        (``SchedConfig.fused``).  Returns the tick's (step, rid, token)
        events.  While recovery is armed the tick starts with a snapshot,
        and a ``DeviceLoss`` inside it rolls back and replays the tick;
        the straggler detector then reads the tick's wall time."""
        t0 = time.perf_counter()
        if self._recovery_armed():
            self._snapshot = self._capture()
        impl = self._step_fused if self.fused else self._step_stepwise
        try:
            events = impl()
        except DeviceLoss as loss:
            self._recover(list(loss.lost), self._snapshot)
            events = impl()
        self._observe_hosts(time.perf_counter() - t0)
        return events

    def _admit(self) -> List[Tuple[int, Optional[torch.Tensor]]]:
        """This tick's admissions, after the finished slots' pages come
        home: each request is prefilled and written into its slot on the
        device.  Returns (slot, first token on the device) per admission
        (None where another mesh rank's arena holds the slot).  The
        admission fault poll comes before the pops, the prefill poll after
        each prefill and before its slot insert."""
        pending: List[Tuple[int, Optional[torch.Tensor]]] = []
        self._poll_fault("admission")
        self._flush_dirty()
        for slot, req in self.sched.admissions(self.clock,
                                               gate=self._admission_gate()):
            row = self._slot_row(slot)
            if row is None:
                self._fns()
                self._count_prefill(req)
            else:
                cache1, logits = self._prefill(req)
            self._poll_fault("prefill")
            ids = ()
            if self._paged is not None:
                ids = self._slot_pages[slot] = \
                    self._reserved_pages.pop(req.rid)
            tok = None if row is None else self._insert(
                row, cache1, logits, req.max_new_tokens - 1, ids)
            self.outputs[req.rid] = RequestOutput(req.rid,
                                                  admitted=self.clock)
            pending.append((slot, tok))
        self.peak_active = max(self.peak_active, len(self.sched.running))
        return pending

    def _step_fused(self) -> List[Tuple[int, int, int]]:
        """Admissions, then one fused chunk advancing every running slot,
        then the tick's single host transfer."""
        ev_start = len(self.events)
        pending = self._admit()
        admitted = frozenset(s for s, _ in pending)
        if self.sched.active and all(
                self.sched.remaining[s] - (s in admitted) <= 0
                for s in self.sched.active):
            # pure-admission tick: nothing owes a decode step, so fetch the
            # prefill tokens without running a dead chunk
            first = self._fetch_first(pending)
            self.stats["host_syncs"] += 1
            for (slot, _), tok in zip(pending, first):
                self._emit(slot, int(tok))
            self.clock += 1
        elif self.sched.active:
            chunk = self._chunk_len(admitted)
            chunk_fn = self._fns()[2](chunk)
            with self._scope():
                (self.cache, self._tokens, self._remaining, ring,
                 zf_num, zf_den) = chunk_fn(self.params, self.cache,
                                            self._tokens, self._remaining)
            self.stats["chunk_calls"] += 1
            self.stats["decode_steps"] += chunk
            self._poll_fault("decode")
            # the tick's one host transfer: ring, first tokens, measurement
            ring_h, first, zf_num_h, zf_den_h = self._fetch_tick(
                ring, pending, zf_num, zf_den)
            self.stats["host_syncs"] += 1
            # prefill-boundary emissions first: the chunk consumed these
            # tokens as its first feedback, so they precede the ring rows
            for (slot, _), tok in zip(pending, first):
                self._emit(slot, int(tok))
            for t in range(chunk):
                live = self.sched.active
                if not live:
                    break
                for slot in live:
                    self._emit(slot, int(ring_h[t, slot]))
                self.clock += 1
            self._since_measure += chunk
            if zf_den_h > 0 and self._since_measure >= self.measure_every:
                self._measure(zf_num_h / zf_den_h)
        else:
            if self.sched.waiting_count:
                self.stats["idle_steps"] += 1
            self.clock += 1
        return self.events[ev_start:]

    def _step_stepwise(self) -> List[Tuple[int, int, int]]:
        """The reference's per-step baseline (``fused=False``): admissions,
        each with a sync for its first token, then one pooled decode step
        with argmax on the device and one host transfer of the (B,) tokens;
        every ``measure_every`` steps one more sync measures the exact-zero
        fraction of the live rows' full logits.  Tokens equal the fused
        path's."""
        ev_start = len(self.events)
        for slot, tok in self._admit():
            self.stats["host_syncs"] += 1
            self._emit(slot, self._fetch_first([(slot, tok)])[0])
        active = self.sched.active
        if active:
            decode_fn = self._fns()[1]
            with self._scope():
                logits, self.cache = decode_fn(self.params, self.cache,
                                               self._tokens)
            self.stats["decode_steps"] += 1
            self._poll_fault("decode")
            toks = torch.argmax(logits, dim=-1)
            self._tokens.copy_(toks[:, None])
            host = self._fetch_rows(toks)
            self.stats["host_syncs"] += 1
            self._since_measure += 1
            if self._since_measure >= self.measure_every:
                zeros, total = self._zero_counts(
                    logits, [r for r in map(self._slot_row, active)
                             if r is not None])
                self._measure(zeros / total)
                self.stats["host_syncs"] += 1
            for slot in active:
                self._emit(slot, int(host[slot]))
        elif self.sched.waiting_count:
            self.stats["idle_steps"] += 1
        self.clock += 1
        return self.events[ev_start:]

    # -- failure handling ---------------------------------------------------

    def _recovery_armed(self) -> bool:
        return (self.faults is not None or self.straggler is not None
                or self.snapshot_dir is not None)

    def _poll_fault(self, phase: str) -> None:
        if self.faults is not None:
            self.faults.poll(phase, self.clock)

    def _device_tree(self) -> Dict[str, Any]:
        return {"cache": self.cache, "tokens": self._tokens,
                "remaining": self._remaining}

    def _paging_state(self) -> Dict:
        """JSON-serialisable snapshot of the paged host state, so a replay
        reproduces the exact page assignments."""
        return {"allocator": self._page_alloc.state_dict(),
                "slot_pages": {str(s): [int(i) for i in ids]
                               for s, ids in self._slot_pages.items()},
                "dirty": sorted(int(s) for s in self._dirty_slots)}

    def _restore_paging(self, state: Dict) -> None:
        self._page_alloc = PageAllocator.from_state_dict(state["allocator"])
        self._slot_pages = {int(s): [int(i) for i in ids]
                            for s, ids in state["slot_pages"].items()}
        self._dirty_slots = set(int(s) for s in state["dirty"])
        self._reserved_pages = {}

    def _capture(self) -> EngineSnapshot:
        """Tick-start snapshot.  The device state is copied, not referenced
        (the tick writes the arena, the tokens and the counters in place),
        into host buffers allocated once (pinned on the card) and reused
        by every capture: one stream sync per tick.  With a snapshot
        directory the copy, the weights (a host copy taken once) and the
        scheduler and paging state also go through ``checkpoint.save``
        (the newest two kept)."""
        t0 = time.perf_counter()
        live = self._device_tree()
        if self._snap_host is None:
            pin = self.device.type == "cuda"

            def buf(t):
                return torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
            self._snap_host = {"cache": {k: buf(v) for k, v in
                                         live["cache"].items()},
                               "tokens": buf(self._tokens),
                               "remaining": buf(self._remaining)}
            self.snapshot_bytes = sum(
                t.numel() * t.element_size()
                for t, _ in _leaf_pairs(self._snap_host, live))
        host = self._snap_host
        for dst, src in _leaf_pairs(host, live):
            dst.copy_(src, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        snap = EngineSnapshot(
            device=host, sched=copy.deepcopy(self.sched),
            outputs=copy.deepcopy(self.outputs),
            events_len=len(self.events), clock=self.clock, mode=self.mode,
            a_measured=self.a_measured, since_measure=self._since_measure,
            mode_history=list(self.mode_history), stats=dict(self.stats),
            prefill_buckets=set(self.prefill_buckets),
            peak_active=self.peak_active,
            paging=(self._paging_state() if self._paged is not None
                    else None))
        self.capture_s.append(time.perf_counter() - t0)
        if self.snapshot_dir is not None:
            t1 = time.perf_counter()
            extra = {"scheduler": self.sched.state_dict(),
                     "clock": self.clock, "mode": self.mode.value}
            if snap.paging is not None:
                extra["paging"] = snap.paging
            self._save_snapshot(host, extra)
            snap.ckpt_step = self.clock
            self.save_s.append(time.perf_counter() - t1)
        return snap

    def _save_snapshot(self, host: Dict[str, Any], extra: Dict) -> None:
        """One tick-start snapshot to disk: the device state and the
        weights' host copy (the newest two kept)."""
        ckpt_save(self.snapshot_dir, self.clock,
                  dict(host, params=self._params_host), keep=2, extra=extra)

    def _recover(self, lost: List[int],
                 snap: Optional[EngineSnapshot]) -> None:
        """A device loss: settle the lost tick's work on the stream (its
        pinned page-table rows included, before a replay rewrites them;
        not on a lost device), roll every host structure back to ``snap``,
        remesh (last, so a remesh may drop the function sets) and write
        the snapshot's device state back.  The caller replays from the
        snapshot's clock."""
        if snap is None:
            raise RuntimeError("device loss with no snapshot armed")
        if self.device.type == "cuda" and self._device_alive(lost):
            torch.cuda.synchronize(self.device)
        self.replayed_calls += _model_calls(self.stats) - \
            _model_calls(snap.stats)
        self.sched = copy.deepcopy(snap.sched)
        self.outputs = copy.deepcopy(snap.outputs)
        del self.events[snap.events_len:]
        self.clock = snap.clock
        self.mode = snap.mode
        self.a_measured = snap.a_measured
        self._since_measure = snap.since_measure
        self.mode_history = list(snap.mode_history)
        self.stats = dict(snap.stats)
        self.prefill_buckets = set(snap.prefill_buckets)
        self.peak_active = snap.peak_active
        if self._paged is not None:
            if snap.paging is None:
                raise RuntimeError("paged engine snapshot lacks paging state")
            self._restore_paging(snap.paging)
        self._remesh(lost)
        self._restore_device(snap)
        self.recoveries += 1
        self.recovery_log.append({"step": snap.clock, "lost": sorted(lost),
                                  "mesh": self._mesh_desc()})

    _spmd_mesh = None      # a mesh-parallel engine's mesh (more than 1x1)

    def _remesh(self, lost: List[int]) -> None:
        """One device has no mesh to shrink: recovery restarts in place
        (``MeshServeEngine`` remeshes onto the survivors)."""

    def _device_alive(self, lost: List[int]) -> bool:
        """Whether this engine's device outlived the loss (one device
        restarts in place on it)."""
        return True

    def _mesh_desc(self) -> str:
        return "unsharded"

    def _survivors_exist(self, lost: List[int]) -> bool:
        return True

    def _tick_seconds(self, dt: float) -> float:
        """The tick's wall seconds the straggler detector reads (a mesh
        agrees on one value over its ranks)."""
        return dt

    def _host_device_ids(self, host: int) -> List[int]:
        """Device ids owned by straggler host ``host``: the single-device
        engine has one host and nothing to evict onto, so evictions only
        reach the recovery log."""
        return []

    def _snapshot_state(self, snap: EngineSnapshot) -> Dict[str, Any]:
        """The snapshot's device-state tree: from disk through
        ``checkpoint.restore`` (on the host) when it was checkpointed,
        else the in-memory copy."""
        if snap.ckpt_step is None:
            return snap.device
        return ckpt_restore(self.snapshot_dir, self._device_tree(),
                            step=snap.ckpt_step, device="cpu")

    def _restore_device(self, snap: EngineSnapshot) -> None:
        """Write the snapshot's device state back into the live tensors,
        so every holder of them sees the rollback."""
        for dst, src in _leaf_pairs(self._device_tree(),
                                    self._snapshot_state(snap)):
            dst.copy_(src, non_blocking=True)

    def _observe_hosts(self, dt: float) -> None:
        """Feed per-host step times to the straggler detector (the
        injector's ``delay_host`` inflates one host's reading) and route
        its eviction verdict into the recovery path at the tick boundary,
        where the state is consistent: nothing is replayed."""
        if self.straggler is None:
            return
        dt = self._tick_seconds(dt)
        for h in range(self.straggler.num_hosts):
            f = (self.faults.host_delay(h, self.clock)
                 if self.faults is not None else 1.0)
            self.straggler.record(h, dt * f)
        self.straggler.observe()
        evict = [h for h in self.straggler.evictions()
                 if h not in self._evicted]
        if not evict:
            return
        self._evicted.update(evict)
        lost = sorted({d for h in evict for d in self._host_device_ids(h)})
        if not lost or not self._survivors_exist(lost):
            self.recovery_log.append({"step": self.clock, "evicted": evict,
                                      "lost": [], "mesh": self._mesh_desc()})
            return
        self._recover(lost, self._capture())

    def run(self, requests: Sequence[Request] = (),
            max_steps: Optional[int] = None) -> Dict[int, RequestOutput]:
        """Add ``requests`` and tick until every request finished (or
        ``max_steps``); returns rid -> RequestOutput."""
        for r in requests:
            self.add(r)
        steps = 0
        while self.sched.has_work():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self.outputs


def int8_logit_gap(api: ModelApi, params: Any, config: EngineConfig,
                   steps: int = 48, plen: int = 24) -> float:
    """Teacher-forced int8 against same-dtype paged decode, the twin of
    the reference benchmark's ``int8_logit_gap``: one ``plen``-token
    prompt (numpy seed 7) is prefilled into a one-slot paged arena of each
    page dtype (``config``'s cache_len, page_size and kernel fields) and
    decoded ``steps`` steps, the int8 run fed the same-dtype run's tokens.
    Returns max |logit difference| / max |same-dtype logit| over the
    prefill's and every step's logits."""
    prompt = np.random.default_rng(7).integers(1, api.cfg.vocab_size,
                                               (1, plen))
    req = Request(rid=0, tokens=prompt[0], max_new_tokens=steps + 1)

    def decode(kv_dtype: str, forced: Optional[torch.Tensor] = None):
        eng = ServeEngine(api, params, config.with_fields(
            num_slots=1, kv_dtype=kv_dtype, bucket_prompts=False))
        cache1, logits = eng._prefill(req)
        ids = eng._page_alloc.reserve(eng._paged.pages_needed(plen + steps))
        nxt = eng._insert(0, cache1, logits, steps, ids)[:, None]
        outs = [logits[0]]
        with eng._scope():
            for t in range(steps):
                if forced is not None:
                    nxt = forced[t].reshape(1, 1)
                logits, eng.cache = api.decode_step(params, eng.cache, nxt)
                outs.append(logits[0])
                nxt = torch.argmax(logits, dim=-1)[:, None]
        return torch.stack(outs).float()

    same = decode("fp32")
    int8 = decode("int8", forced=torch.argmax(same, dim=-1))
    return float((int8 - same).abs().max() / same.abs().max())


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

def synthetic_trace(cfg, *, num_requests: int, seed: int = 0,
                    prompt_lens: Sequence[int] = (8, 16, 24),
                    gen_lens: Sequence[int] = (4, 8, 16),
                    arrival_every: int = 0,
                    arrival_process: str = "fixed",
                    rate: float = 0.5, burst_rate: float = 4.0,
                    burst_switch: float = 0.15,
                    length_dist: str = "choice",
                    max_gen: Optional[int] = None,
                    priorities: Sequence[int] = (0,),
                    deadline_slack: Optional[float] = None,
                    ttft_deadline: Optional[int] = None) -> List[Request]:
    """Deterministic mixed prompt/gen-length request trace: the same
    ``np.random.default_rng`` draws, in the same order, as the reference's
    ``synthetic_trace``, so the traces are equal field by field.  Per
    request: the prompt length, the generation length, the tokens, an
    encoder-decoder's (enc_frames, d_model) fp32 frames, then (bursty
    only) the state flip and the exponential gap, then (only with more
    than one class) the priority.

    ``arrival_process="fixed"`` staggers arrivals (request i at step
    ``i * arrival_every``); ``"bursty"`` is a two-state Markov-modulated
    process: each request flips the calm/burst state with probability
    ``burst_switch``, then advances the arrival clock by an exponential
    gap at the state's rate (``rate`` / ``burst_rate`` requests per step).
    ``length_dist="heavy"`` replaces the uniform gen-length choice with a
    Pareto draw (shape ``HEAVY_ALPHA``) floored at ``min(gen_lens)`` and
    capped at ``max_gen`` (default ``8 * max(gen_lens)``): most requests
    stay short, stragglers make the tail.

    SLO fields: ``priorities`` draws each request's priority class,
    ``deadline_slack`` attaches a completion deadline proportional to the
    request's own expected service (slack x (gen + prefill share)), and
    ``ttft_deadline`` a flat first-token deadline.  The defaults attach
    nothing."""
    if arrival_process not in ("fixed", "bursty"):
        raise ValueError(f"unknown arrival process {arrival_process!r}")
    if length_dist not in ("choice", "heavy"):
        raise ValueError(f"unknown length distribution {length_dist!r}")
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    t, burst = 0, False
    for i in range(num_requests):
        plen = int(rng.choice(np.asarray(prompt_lens)))
        if length_dist == "heavy":
            gmin = int(min(gen_lens))
            cap = int(max_gen) if max_gen else 8 * int(max(gen_lens))
            glen = min(cap, max(1, int(gmin * (1.0
                                               + rng.pareto(HEAVY_ALPHA)))))
        else:
            glen = int(rng.choice(np.asarray(gen_lens)))
        toks = rng.integers(1, cfg.vocab_size, (plen,), dtype=np.int32)
        extras = None
        if cfg.is_encdec:
            extras = {"frames": rng.standard_normal(
                (cfg.enc_frames, cfg.d_model)).astype(np.float32)}
        if arrival_process == "bursty":
            if rng.random() < burst_switch:
                burst = not burst
            r = burst_rate if burst else rate
            t += int(round(rng.exponential(1.0 / max(r, 1e-6))))
            arrival = t
        else:
            arrival = i * arrival_every
        priority = (int(rng.choice(np.asarray(priorities)))
                    if len(priorities) > 1 else int(priorities[0]))
        deadline = None
        if deadline_slack is not None:
            deadline = int(np.ceil(deadline_slack
                                   * (glen + max(1, plen // 8))))
        reqs.append(Request(rid=i, tokens=toks, max_new_tokens=glen,
                            arrival=arrival, extras=extras,
                            priority=priority, deadline_ms=deadline,
                            ttft_deadline_ms=ttft_deadline))
    return reqs
