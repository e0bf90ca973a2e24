"""Mesh-parallel serving: the continuous-batching engine on a ("data",
"model") mesh of ranks — the counterpart of
``repro/runtime/mesh_serve.py``'s serving half.

Every rank runs a ``MeshServeEngine`` on its own device, under one
process per mesh position (``launch.mesh.run_ranks``).  The slot pool
splits over "data": data row d decodes the slots ``[d B / D, (d + 1) B /
D)`` and prefills the admissions into them.  The weights split over
"model": each rank holds its share of every weight GEMM
(``runtime.sharding.shard_params``: the output columns, or a compacted
weight's N tiles), runs the kernel's shard entry on it and gathers the
columns over its data row (``models.common.griffin_linear``), so every
model rank of a row computes the same activations and holds the row's
whole arena (the head-axis split of the arena is a spec here, not
applied).  No reduction is ever split, and each shard launches with the
whole weight's plan and route, so the tokens are the single-device
engine's.

The host side is the single-device engine's, untouched ("sharding is a
placement concern, not a scheduling one"), and must stay equal on every
rank: the scheduler, the owed-token mirror, the outputs, the stats and
the Mode.  So at each of the engine's sync points the rank gathers over
"data" what the other rows computed: the fused tick's (chunk, B) token
ring, the admissions' first tokens and the measured zero counts, as
integers, in one collective; a stepwise step's tokens and counts.  The
weight sparsity that selects the Mode is counted over the whole tree
before it is cut.  ``host_digest`` hashes the host state, so a run can
show the ranks agree.

Failure handling.  A ``DeviceLoss`` takes a rank's device, not its
process: every rank polls the same deterministic injector at the same
phase and clock, so all of them see the loss at one point of the tick,
roll back to their tick-start snapshot and remesh
(``launch.mesh.regroup``: ``elastic.plan_mesh`` over the survivors, the
model axis capped by ``FaultConfig.recovery_model_parallel``, default the
current one).  A straggler eviction (hosts are data rows; the ranks agree
on one tick time) does the same at a tick boundary, its row's ranks alive
but left out.  Where a row's state comes from: every model rank of a data
row holds the row's whole arena and copies it to the host at each tick
start, so a surviving rank of the row sends its tick-start copy to each
rank of the new mesh that takes over slots of the row, over the world's
gloo group, at the recovery only; the lost rank's copy is used only where
no survivor holds the row (one model rank a row).  With
``FaultConfig.snapshot_dir`` each row's first model rank also saves its
row's snapshot (``checkpoint.row_dir``, the first row the weights too),
and the new mesh restores from disk instead.  The weights come from the
whole host tree kept while recovery is armed, cut for the new mesh
(``elastic.reshard``).  Ranks the new mesh leaves out make no launch and
no allocation after the loss (the lost one none on its device at all)
and leave ``run`` with ``departed`` set; the others replay the tick on the
new mesh and finish the trace with the uninterrupted engine's tokens.  A
1x1 mesh is the single-device engine, and a loss there has no survivors.
"""
from __future__ import annotations

import hashlib
import json
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..checkpoint import restore as ckpt_restore
from ..checkpoint import row_dir
from ..checkpoint import save as ckpt_save
from ..kernels import launch_counts
from ..models.common import kernel_dispatch_counts
from ..models.registry import ModelApi
from .config import EngineConfig
from .elastic import reshard, surviving
from .engine import (EngineSnapshot, ServeEngine, _cpu_tree, _leaf_pairs,
                     _promote_arena, weight_sparsity)
from .paging import paged_tree
from .sharding import cache_spec, slot_home, slots_per_row


def cache_heads(api: ModelApi) -> int:
    """The head-axis extent of the model's cache leaves: what
    ``cache_spec(decode=True)`` matches to place "model" (the KV heads, or
    the heads of recurrent states); families whose cache head count
    differs match nothing."""
    cfg = api.cfg
    return int(getattr(cfg, "num_kv_heads", 0)
               or getattr(cfg, "num_heads", 0) or 0)


def serve_shardings(api: ModelApi, mesh, num_slots: int, cache_len: int, *,
                    paged=None) -> dict:
    """The serving layout's specs of the engine's arena, leaf by leaf
    (``cache_spec(decode=True)``; the paged pool and page table when
    ``paged``, the arena's ``PagedSpec``).  The parameter specs come leaf
    by leaf from ``sharding.param_spec``."""
    arena = _promote_arena(api.init_cache(num_slots, cache_len,
                                          device=torch.device("meta")),
                           num_slots)
    pset = frozenset()
    if paged is not None:
        arena = paged_tree(arena, num_slots, paged)
        pset = frozenset(paged.paged_keys)
    return {k: cache_spec(f"['{k}']", v, mesh, num_slots, decode=True,
                          heads=cache_heads(api), paged=pset)
            for k, v in arena.items()}


class LeftMesh(Exception):
    """Raised on a rank that a remesh leaves out, once it has handed over
    its rows: ``status`` is ``"lost"`` (its device is gone, or its row was
    evicted) or ``"dropped"`` (a survivor beyond the planned mesh)."""

    def __init__(self, status: str, step: int, mesh: str):
        super().__init__(f"{status} at step {step}; the mesh is now {mesh}")
        self.status, self.step, self.mesh = status, step, mesh


def _crc(t: torch.Tensor) -> int:
    return zlib.crc32(t.contiguous().view(torch.uint8).numpy())


class MeshServeEngine(ServeEngine):
    """``ServeEngine`` on one rank of a ("data", "model") mesh (see the
    module docstring).  ``params`` is the whole tree on this rank's device
    (or the host): the engine counts its weight sparsity, keeps a host
    copy of it while recovery is armed, then keeps only the rank's share
    on its device (``elastic.reshard``), so the caller may drop the tree.
    ``mesh`` is the rank's joined ``launch.mesh.Mesh`` (after a remesh,
    the survivors' mesh).  Needs ``arena.cache_len``; the slot count must
    split over the data rows.  ``prefills_here`` counts the prefills this
    rank computed (its data row's admissions), ``stats["prefill_calls"]``
    all of them.

    After a loss ``remesh_log`` holds each remesh's seconds (``regroup_s``,
    ``handover_s``, ``reshard_s``) and the rows handed over
    (``transfers``: row, sender, receiver, bytes and CRC-32 as this rank
    sent or received them); ``after_recovery`` the launch and dispatch
    counts, prefills, decode steps, emitted tokens and time at the end of
    the last recovery, ``at_loss`` the same counts at the last loss;
    ``departed`` (None while serving) the status and step of a rank the
    remesh left out, with the counts at the loss."""

    def __init__(self, api: ModelApi, params: Any, *, mesh,
                 config: Optional[EngineConfig] = None, plan: Any = None,
                 fault_injector=None, straggler=None):
        if tuple(mesh.axis_names) != ("data", "model"):
            raise ValueError(f"serving mesh needs axes ('data', 'model'), "
                             f"got {mesh.axis_names}")
        config = config or EngineConfig()
        if config.arena.cache_len is None:
            raise ValueError("MeshServeEngine needs arena.cache_len")
        armed = (fault_injector is not None or straggler is not None
                 or config.fault.snapshot_dir is not None)
        if mesh.device is not None and mesh.device.type != api.device.type:
            raise ValueError(f"the mesh's rank is on {mesh.device}, the "
                             f"model on {api.device}")
        self.mesh = mesh
        self._per_row = slots_per_row(mesh, config.arena.num_slots)
        if mesh.size > 1:
            self._spmd_mesh = mesh
        self._b_sparsity = weight_sparsity(params)
        self.prefills_here = 0
        self._recovery_mp = config.fault.recovery_model_parallel
        # the whole tree, kept before it is cut: a new mesh's shares
        self._whole = _cpu_tree(params) if armed else None
        self._pending: Optional[Tuple] = None
        self.at_loss: Optional[Dict] = None
        self.after_recovery: Optional[Dict] = None
        self.departed: Optional[Dict] = None
        self.remesh_log: List[Dict] = []
        self.run_started = self.run_ended = None     # run()'s clock
        super().__init__(api, reshard(params, mesh), config, plan=plan,
                         fault_injector=fault_injector, straggler=straggler)

    # -- hooks ---------------------------------------------------------------

    def _rows_here(self) -> int:
        return self._per_row

    def _slot_row(self, slot: int) -> Optional[int]:
        return slot_home(self.mesh, self.num_slots, slot)[1]

    def _weight_sparsity(self, params: Any) -> float:
        return self._b_sparsity

    def _prefill(self, req):
        self.prefills_here += 1
        return super()._prefill(req)

    def _owner(self, slot: int) -> int:
        return slot_home(self.mesh, self.num_slots, slot)[0]

    def _gather_rows(self, vec: torch.Tensor) -> np.ndarray:
        """(D, n) int64 on the host: ``vec`` from every data row, one
        collective and one host transfer."""
        return self.mesh.gather(vec.to(torch.int64), "data").cpu().numpy()

    def _firsts(self, pending, host: np.ndarray, at: int) -> List[int]:
        return [int(host[self._owner(slot), at + i])
                for i, (slot, _) in enumerate(pending)]

    def _local_firsts(self, pending) -> List[torch.Tensor]:
        zero = torch.zeros((1,), dtype=torch.int64, device=self.device)
        return [zero if t is None else t.reshape(1).to(torch.int64)
                for _, t in pending]

    def _fetch_tick(self, ring: torch.Tensor, pending,
                    zf_num: torch.Tensor, zf_den: torch.Tensor
                    ) -> Tuple[np.ndarray, List[int], int, int]:
        """The fused tick's one host transfer on a mesh: this row's (chunk,
        B / D) ring, its admissions' first tokens (zeros for the other
        rows') and its two counts, gathered over "data" as integers."""
        chunk, rows = ring.shape
        vec = torch.cat([ring.reshape(-1).to(torch.int64)]
                        + self._local_firsts(pending)
                        + [zf_num.reshape(1).to(torch.int64),
                           zf_den.reshape(1).to(torch.int64)])
        host = self._gather_rows(vec)
        ring_h = np.concatenate([h[:chunk * rows].reshape(chunk, rows)
                                 for h in host], axis=1)
        first = self._firsts(pending, host, chunk * rows)
        return ring_h, first, int(host[:, -2].sum()), int(host[:, -1].sum())

    def _fetch_first(self, pending) -> List[int]:
        host = self._gather_rows(torch.cat(self._local_firsts(pending)))
        return self._firsts(pending, host, 0)

    def _fetch_rows(self, toks: torch.Tensor) -> np.ndarray:
        return self._gather_rows(toks).reshape(-1)

    def _zero_counts(self, logits: torch.Tensor, rows: Sequence[int]
                     ) -> Tuple[int, int]:
        live = logits[torch.as_tensor(list(rows), dtype=torch.int64,
                                      device=logits.device)]
        vec = torch.stack([(live == 0).sum(),
                           torch.tensor(live.numel(), device=logits.device)])
        host = self._gather_rows(vec)
        return int(host[:, 0].sum()), int(host[:, 1].sum())

    def _mesh_desc(self) -> str:
        from ..launch.mesh import mesh_spec
        return mesh_spec(self.mesh)

    # -- failure handling ----------------------------------------------------

    def _host_params(self, params: Any) -> Optional[Any]:
        return self._whole

    def _device_alive(self, lost: List[int]) -> bool:
        return self.mesh.world_rank not in lost

    def _host_device_ids(self, host: int) -> List[int]:
        """Hosts are data rows: the world ranks of row ``host`` of the
        current mesh (none for a row beyond a shrunk mesh)."""
        return self.mesh.row_ranks(host) if host < self.mesh.data else []

    def _survivors_exist(self, lost: List[int]) -> bool:
        return bool(surviving(self.mesh.members, lost))

    def _tick_seconds(self, dt: float) -> float:
        """The slowest rank's tick seconds (a max over the mesh's host
        group), so every rank's detector reads the same times and evicts
        at the same tick."""
        if self.mesh.size == 1 or not self.mesh.groups:
            return dt
        import torch.distributed as dist
        t = torch.tensor([dt], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX,
                        group=self.mesh.groups["host"])
        return float(t[0])

    def _save_snapshot(self, host: Dict[str, Any], extra: Dict) -> None:
        """Each data row's first model rank saves its row's snapshot under
        ``checkpoint.row_dir``; the first row's carries the weights' host
        copy, the whole tree."""
        if self.mesh.index("model"):
            return
        row = self.mesh.index("data")
        state = dict(host, params=self._params_host) if row == 0 else host
        ckpt_save(row_dir(self.snapshot_dir, row), self.clock, state, keep=2,
                  extra=dict(extra, mesh=self._mesh_desc(), row=row))

    def _recover(self, lost: List[int],
                 snap: Optional[EngineSnapshot]) -> None:
        self.at_loss = {"launches": launch_counts(),
                         "dispatch": kernel_dispatch_counts(),
                         "t": time.perf_counter(),
                         "emitted": self.stats["emitted"]}
        super()._recover(lost, snap)
        self.after_recovery = {"launches": launch_counts(),
                               "dispatch": kernel_dispatch_counts(),
                               "prefills": self.prefills_here,
                               "decode_steps": self.stats["decode_steps"],
                               "emitted": self.stats["emitted"],
                               "t": time.perf_counter()}

    def _remesh(self, lost: List[int]) -> None:
        """Plan and form the survivors' mesh (``launch.mesh.regroup``, on
        every rank of the old mesh) and drop the function sets built for
        the old one; :meth:`_restore_device` moves the state onto it."""
        from ..launch.mesh import regroup
        t0 = time.perf_counter()
        old = self.mesh
        plan, new = regroup(old, lost, self._recovery_mp or old.model)
        self._mode_fns.clear()
        self._pending = (old, plan, new, lost, time.perf_counter() - t0)

    def _restore_device(self, snap: EngineSnapshot) -> None:
        """Hand the old rows' tick-start state to the ranks that take them
        over (:meth:`_handover`); then a rank the plan leaves out leaves
        (:class:`LeftMesh`), and a rank of the new mesh cuts its share of
        the weights from the whole host tree (read back from disk with
        snapshots on disk), allocates the arena of its new data row and
        writes the merged rows into it (:meth:`_merge`)."""
        old, plan, new, lost, regroup_s = self._pending
        self._pending = None
        t0 = time.perf_counter()
        rows, transfers = self._handover(old, plan, lost, snap)
        t1 = time.perf_counter()
        record = {"step": snap.clock, "mesh": plan.spec,
                  "regroup_s": regroup_s, "handover_s": t1 - t0,
                  "handover_bytes": sum(t["bytes"] for t in transfers),
                  "transfers": transfers}
        if new is None:
            self.remesh_log.append(record)
            raise LeftMesh("lost" if old.world_rank in lost else "dropped",
                           snap.clock, plan.spec)
        self.mesh = new
        self._spmd_mesh = new if new.size > 1 else None
        self._per_row = slots_per_row(new, self.num_slots)
        weights = self._params_host
        if snap.ckpt_step is not None:
            weights = ckpt_restore(row_dir(self.snapshot_dir, 0),
                                   {"params": weights}, step=snap.ckpt_step,
                                   device="cpu")["params"]
        # the old shares and arena go before the new ones are allocated
        self.params = self.cache = self._tokens = self._remaining = None
        self.params = reshard(weights, new)
        self._alloc_state()
        self._snap_host = None
        merged = self._merge(rows, old.data)
        for dst, src in _leaf_pairs(self._device_tree(), merged):
            dst.copy_(src, non_blocking=True)
        if snap.ckpt_step is not None and new.groups:
            # every reader is done before a row saves over its step
            import torch.distributed as dist
            dist.barrier(group=new.groups["host"])
        self.remesh_log.append(dict(record,
                                    reshard_s=time.perf_counter() - t1))

    def _handover(self, old, plan, lost: List[int], snap: EngineSnapshot
                  ) -> Tuple[Dict[int, Dict[str, Any]], List[Dict]]:
        """{old data row: its tick-start state on the host} for every row
        whose slots this rank's new data row takes over, and the transfers
        this rank made.  With snapshots on disk each row is read back
        (``checkpoint.restore``).  Else a row comes from this rank's own
        snapshot where it was in the row, or over the world's gloo group
        from the row's first surviving rank (its first rank where none
        survives); every rank of the old mesh walks the same list of
        (row, sender, receiver) in the same order, each send or receive
        made by its two ranks alone."""
        import torch.distributed as dist
        P = self.num_slots // old.data
        P2 = self.num_slots // plan.data
        need = {w: sorted({s // P for s in range((q // plan.model) * P2,
                                                 (q // plan.model + 1) * P2)})
                for q, w in enumerate(plan.devices)}
        me = old.world_rank
        mine = need.get(me, [])
        transfers: List[Dict] = []

        def record(r, src, dst, tree):
            leaves = [t for t, _ in _leaf_pairs(tree, tree)]
            transfers.append({
                "row": r, "src": src, "dst": dst,
                "bytes": sum(t.numel() * t.element_size() for t in leaves),
                "crc32": [_crc(t) for t in leaves]})

        if snap.ckpt_step is not None:
            rows = {r: ckpt_restore(row_dir(self.snapshot_dir, r),
                                    snap.device, step=snap.ckpt_step,
                                    device="cpu") for r in mine}
            for r, tree in rows.items():
                record(r, "disk", me, tree)
            return rows, transfers
        own = old.index("data")
        rows = {own: snap.device} if own in mine else {}
        for r in range(old.data):
            holders = old.row_ranks(r)
            src = ([w for w in holders if w not in lost] or holders)[0]
            for dst in plan.devices:
                if r not in need[dst] or dst in holders or me not in (src,
                                                                      dst):
                    continue
                if me == src:
                    tree = snap.device
                    for t, _ in _leaf_pairs(tree, tree):
                        dist.send(t, dst, group=old.world)
                else:
                    tree = {"cache": {k: torch.empty_like(v) for k, v in
                                      snap.device["cache"].items()},
                            "tokens": torch.empty_like(snap.device["tokens"]),
                            "remaining": torch.empty_like(
                                snap.device["remaining"])}
                    for t, _ in _leaf_pairs(tree, tree):
                        dist.recv(t, src, group=old.world)
                    rows[r] = tree
                record(r, src, dst, tree)
        return rows, transfers

    def _slot_axis(self, key: str) -> Optional[int]:
        """The slot axis of arena leaf ``key`` (None for a page pool)."""
        spec = self._paged
        if spec is not None:
            base = key[:-6] if key.endswith("_scale") else key
            if base in spec.paged_keys:
                return None
            if key == "pages":
                return 0
        return max(self._axes[key], 0)

    def _merge(self, rows: Dict[int, Dict[str, Any]], old_rows: int
               ) -> Dict[str, Any]:
        """The host state of this rank's new data row, from the old rows'
        states: each slot's entries from the old row that held the slot;
        each page of a pool from the old row whose slot owns the page (a
        row's pool is whole, but only its slots' pages were written there;
        pages no slot of this row owns are never read before an admission
        writes them)."""
        P = self.num_slots // old_rows
        P2 = self._per_row
        start = self.mesh.index("data") * P2
        home = {s: rows[s // P] for s in range(start, start + P2)}
        base = rows[min(rows)]

        def cut(get, ax):
            leaf = get(base)
            shape = list(leaf.shape)
            shape[ax] = P2
            out = torch.empty(shape, dtype=leaf.dtype)
            for j, s in enumerate(range(start, start + P2)):
                out.select(ax, j).copy_(get(home[s]).select(ax, s % P))
            return out

        cache = {}
        for key in base["cache"]:
            ax = self._slot_axis(key)
            if ax is not None:
                cache[key] = cut(lambda t, k=key: t["cache"][k], ax)
                continue
            pool = base["cache"][key].clone()
            for slot, ids in self._slot_pages.items():
                if slot in home and ids:
                    idx = torch.as_tensor(ids, dtype=torch.int64)
                    pool[:, idx] = home[slot]["cache"][key][:, idx]
            cache[key] = pool
        return {"cache": cache, "tokens": cut(lambda t: t["tokens"], 0),
                "remaining": cut(lambda t: t["remaining"], 0)}

    def run(self, requests=(), max_steps: Optional[int] = None):
        """``ServeEngine.run``; a rank that a remesh leaves out returns
        the outputs as they stood, with ``departed`` set."""
        self.run_started = time.perf_counter()
        try:
            return super().run(requests, max_steps)
        except LeftMesh as left:
            self.departed = {"status": left.status, "step": left.step,
                             "mesh": left.mesh, **self.at_loss}
            return self.outputs
        finally:
            self.run_ended = time.perf_counter()


def host_digest(engine: ServeEngine) -> str:
    """A hash of everything on the host that one engine tick can change:
    the scheduler, the outputs and events, the counters, the Mode and its
    measurement, and the paged arena's host state.  Equal on every rank of
    a mesh after every tick."""
    outs = {str(r): [o.tokens, o.admitted, o.finished, o.token_steps]
            for r, o in sorted(engine.outputs.items())}
    state = {"sched": engine.sched.state_dict(), "outputs": outs,
             "events": engine.events, "stats": engine.stats,
             "clock": engine.clock, "mode": engine.mode.value,
             "a_measured": repr(engine.a_measured),
             "since": engine._since_measure,
             "history": [[s, m.value] for s, m in engine.mode_history],
             "buckets": sorted(engine.prefill_buckets),
             "peak": engine.peak_active,
             "paging": (engine._paging_state() if engine._paged is not None
                        else None)}
    blob = json.dumps(state, sort_keys=True, default=int).encode()
    return hashlib.sha256(blob).hexdigest()
