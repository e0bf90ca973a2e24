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
model rank of a row computes the same activations.  The arena takes the
reference's decode layout (``cache_spec(decode=True,
heads=cache_heads(api))``): a leaf whose spec puts an axis on "model" (the
KV heads of ``k``/``v`` and their pools, whisper's cross ``xk``/``xv``, the
heads of xlstm's states) holds the rank's share of the heads
(``sharding.model_share``), every
other leaf (int8 scales, the page table, ``pos``, xlstm's stabiliser
``mm``, a single KV head) whole.  The admission prefill stays whole, as
the reference's does, and the admission cuts the rank's heads out of it
(an int8 row's scale is taken over all its heads first).  A decode step
runs attention, or the recurrent state, on the rank's heads alone and
gathers every model rank's heads over "model" before the output
projection (``common.head_share``/``gather_heads``): one more gather a
layer, two for whisper's self- and cross-attention.  Heads are batch-like
in every per-head product, no reduction is ever split, and each shard
launches with the whole weight's plan and route, so the tokens are the
single-device engine's.

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
but left out.  Where a row's state comes from: every rank copies its
share of its row's arena (and the row's counters) to the host at each
tick start.  A rank of the new mesh that takes over slots of a row needs
the old head shares its new share covers (the same share on a mesh of as
many model ranks; on a smaller model axis, 2x4 -> 2x2 or ``--remesh-model-
parallel 1``, it merges two or more): each comes from the old rank that
held it, its own snapshot where that is this rank, over the world's gloo
group where it survived, and from the lost rank's tick-start host copy
where it did not (its process lives on, :class:`LeftMesh`); an arena with
no split head axis is whole on every rank of its row, which any survivor
of the row sends.  With ``FaultConfig.snapshot_dir`` each rank also saves
its share (``checkpoint.row_dir(dir, row, share)``; share 0 alone, its
row's first rank, where the heads are not split; the first row's first
rank the weights too), so a row is whole on disk, and the new mesh restores the
shares it needs from disk instead.  The weights come from the
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
from .sharding import (cache_spec, model_axis, model_share, slot_home,
                       slots_per_row)


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


def _share_count(axes: Dict[str, Optional[int]], model: int) -> int:
    """How many head shares a data row's arena splits into under the
    layout ``axes`` (arena leaf -> the axis on "model"): the model ranks,
    or 1 where no leaf splits."""
    return model if any(a is not None for a in axes.values()) else 1


def _covered(share: int, new: int, old: int) -> List[int]:
    """The shares of ``old`` a row's heads split into that share
    ``share`` of ``new`` takes heads from."""
    return [j for j in range(old)
            if j * new < (share + 1) * old and (j + 1) * new > share * old]


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

    ``prefill_gathers`` counts the gathers over "model" this rank made in
    its prefills (the rest of ``mesh.gathers["model"]`` were its decode
    steps).

    After a loss ``remesh_log`` holds each remesh's seconds (``regroup_s``,
    ``handover_s``, ``reshard_s``) and the head shares of rows handed over
    (``transfers``: row, share, sender, receiver, bytes and CRC-32 as this
    rank sent or received them); ``after_recovery`` the launch and dispatch
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
        self.prefill_gathers = 0
        self._heads_ax: Dict[str, Optional[int]] = {}
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

    def _layout(self, mesh) -> Dict[str, Optional[int]]:
        """Arena leaf -> the axis its decode spec puts on "model" on
        ``mesh`` (None: whole)."""
        specs = serve_shardings(self.api, mesh, self.num_slots,
                                self.cache_len, paged=self._paged)
        return {k: model_axis(v) for k, v in specs.items()}

    def _arena(self) -> Dict[str, torch.Tensor]:
        """The data row's arena (``ServeEngine._arena``) with each leaf
        that the layout splits over "model" allocated as the rank's share
        alone: the shapes come from the meta device and each leaf is
        allocated at its share, so no device or host ever holds the row's
        whole arena.  A leaf that ``init_cache`` does not start at zero
        (xlstm's states, which have no length axis) is filled from a
        one-slot, length-1 ``init_cache`` expanded over the slots."""
        self._heads_ax = self._layout(self.mesh)
        if _share_count(self._heads_ax, self.mesh.model) == 1:
            return super()._arena()
        rows = self._rows_here()
        base = _promote_arena(self.api.init_cache(
            rows, self.cache_len, device=torch.device("meta")), rows)
        if self._paged is not None:
            base = paged_tree(base, rows, self._paged)
            init = {}
        else:
            init = _promote_arena(self.api.init_cache(
                1, 1, device=torch.device("cpu")), 1)
        out = {}
        for k, v in base.items():
            shape = model_share(v, self._heads_ax[k], self.mesh).shape
            out[k] = torch.zeros(shape, dtype=v.dtype, device=self.device)
            if k in init and init[k].any():
                one = model_share(init[k], self._heads_ax[k], self.mesh)
                out[k].copy_(one.to(self.device).expand(shape))
        return out

    def _cut(self, key: str, t: torch.Tensor) -> torch.Tensor:
        return model_share(t, self._heads_ax.get(key), self.mesh)

    def _weight_sparsity(self, params: Any) -> float:
        return self._b_sparsity

    def _prefill(self, req):
        self.prefills_here += 1
        g0 = self.mesh.gathers["model"]
        out = super()._prefill(req)
        self.prefill_gathers += self.mesh.gathers["model"] - g0
        return out

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
        """Model rank m of a row saves head share m of the row's snapshot
        under ``checkpoint.row_dir(dir, row, m)``: every rank where the
        heads are split, the row's first rank alone (share 0, the whole
        arena) where they are not; the first row's first rank adds the
        weights' host copy, the whole tree."""
        share = self.mesh.index("model")
        if share >= _share_count(self._heads_ax, self.mesh.model):
            return
        row = self.mesh.index("data")
        state = dict(host, params=self._params_host) \
            if row == 0 and share == 0 else host
        ckpt_save(row_dir(self.snapshot_dir, row, share), self.clock, state,
                  keep=2, extra=dict(extra, mesh=self._mesh_desc(), row=row,
                                     share=share))

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
        self._pending = (old, dict(self._heads_ax), plan, new, lost,
                         time.perf_counter() - t0)

    def _restore_device(self, snap: EngineSnapshot) -> None:
        """Hand the old rows' tick-start head shares to the ranks that
        take them over (:meth:`_handover`); then a rank the plan leaves
        out leaves (:class:`LeftMesh`), and a rank of the new mesh cuts its
        share of the weights from the whole host tree (read back from disk
        with snapshots on disk), allocates the arena of its new data row
        and head share and writes the old shares into it, each old row's
        put together (:meth:`_rows_from_shares`), then the rows merged
        (:meth:`_merge`)."""
        old, old_axes, plan, new, lost, regroup_s = self._pending
        self._pending = None
        t0 = time.perf_counter()
        shares, transfers = self._handover(old, old_axes, plan, lost, snap)
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
            weights = ckpt_restore(row_dir(self.snapshot_dir, 0, 0),
                                   {"params": weights}, step=snap.ckpt_step,
                                   device="cpu")["params"]
        # the old shares and arena go before the new ones are allocated
        self.params = self.cache = self._tokens = self._remaining = None
        self.params = reshard(weights, new)
        self._alloc_state()
        self._snap_host = None
        merged = self._merge(self._rows_from_shares(shares, old, old_axes),
                             old.data)
        for dst, src in _leaf_pairs(self._device_tree(), merged):
            dst.copy_(src, non_blocking=True)
        if snap.ckpt_step is not None and new.groups:
            # every reader is done before a row saves over its step
            import torch.distributed as dist
            dist.barrier(group=new.groups["host"])
        self.remesh_log.append(dict(record,
                                    reshard_s=time.perf_counter() - t1))

    def _handover(self, old, old_axes: Dict[str, Optional[int]], plan,
                  lost: List[int], snap: EngineSnapshot
                  ) -> Tuple[Dict[Tuple[int, int], Dict[str, Any]],
                             List[Dict]]:
        """{(old data row, head share): its tick-start state on the host}
        for every share of a row whose slots this rank's new data row takes
        over that its new head share covers (``old_axes``: the old
        layout), and the transfers this rank made.  With snapshots on disk
        each share is read back (``checkpoint.restore``).  Else a share
        comes from this rank's own snapshot where it held it, or over the
        world's gloo group from the rank that held it, where it survived,
        and from the lost holder's host copy where it did not (an arena
        with no split head axis: from the row's first surviving rank, its
        first rank where none survives); every rank of the old mesh walks
        the same list of (row, share, sender, receiver) in the same
        order, each send or receive made by its two ranks alone."""
        import torch.distributed as dist
        from ..launch.mesh import Mesh
        P = self.num_slots // old.data
        P2 = self.num_slots // plan.data
        s_old = _share_count(old_axes, old.model)
        s_new = _share_count(self._layout(Mesh(plan.data, plan.model)),
                             plan.model)
        need = {}
        for q, w in enumerate(plan.devices):
            d, m = divmod(q, plan.model)
            rows = sorted({s // P for s in range(d * P2, (d + 1) * P2)})
            js = _covered(m if s_new > 1 else 0, s_new, s_old)
            need[w] = [(r, j) for r in rows for j in js]

        def holders(r: int, j: int) -> List[int]:
            ranks = old.row_ranks(r)
            return [ranks[j]] if s_old > 1 else ranks

        me = old.world_rank
        mine = need.get(me, [])
        transfers: List[Dict] = []

        def record(r, j, src, dst, tree):
            leaves = [t for t, _ in _leaf_pairs(tree, tree)]
            transfers.append({
                "row": r, "share": j, "src": src, "dst": dst,
                "bytes": sum(t.numel() * t.element_size() for t in leaves),
                "crc32": [_crc(t) for t in leaves]})

        if snap.ckpt_step is not None:
            shares = {(r, j): ckpt_restore(
                row_dir(self.snapshot_dir, r, j), snap.device,
                step=snap.ckpt_step, device="cpu")
                for r, j in mine}
            for (r, j), tree in shares.items():
                record(r, j, "disk", me, tree)
            return shares, transfers
        shares = {key: snap.device for key in mine if me in holders(*key)}
        for r in range(old.data):
            for j in range(s_old):
                held = holders(r, j)
                src = ([w for w in held if w not in lost] or held)[0]
                for dst in plan.devices:
                    if (r, j) not in need[dst] or dst in held or \
                            me not in (src, dst):
                        continue
                    if me == src:
                        tree = snap.device
                        for t, _ in _leaf_pairs(tree, tree):
                            dist.send(t, dst, group=old.world)
                    else:
                        tree = {"cache": {k: torch.empty_like(v) for k, v
                                          in snap.device["cache"].items()},
                                "tokens": torch.empty_like(
                                    snap.device["tokens"]),
                                "remaining": torch.empty_like(
                                    snap.device["remaining"])}
                        for t, _ in _leaf_pairs(tree, tree):
                            dist.recv(t, src, group=old.world)
                        shares[(r, j)] = tree
                    record(r, j, src, dst, tree)
        return shares, transfers

    def _rows_from_shares(self, shares: Dict[Tuple[int, int],
                                             Dict[str, Any]], old,
                          old_axes: Dict[str, Optional[int]]
                          ) -> Dict[int, Dict[str, Any]]:
        """{old data row: its state on the host, cut to this rank's new
        head share}: each old row's shares (``old_axes``: the old layout,
        ``shares`` keyed (row, share)) joined along the head axis, in
        share order, and cut to the heads this rank's arena holds on the
        current mesh (all of them for a leaf the new layout keeps
        whole); the counters come from any share, each holds them
        whole."""
        s_old = _share_count(old_axes, old.model)
        out = {}
        for r in sorted({r for r, _ in shares}):
            js = sorted(j for rr, j in shares if rr == r)
            first = shares[(r, js[0])]
            cache = {}
            for key, leaf in first["cache"].items():
                ax_o = old_axes[key]
                offset, extent = 0, None
                if ax_o is not None:
                    n = leaf.shape[ax_o]
                    offset, extent = js[0] * n, s_old * n
                    leaf = torch.cat([shares[(r, j)]["cache"][key]
                                      for j in js], ax_o)
                cache[key] = model_share(leaf, self._heads_ax[key],
                                         self.mesh, offset=offset,
                                         extent=extent)
            out[r] = {"cache": cache, "tokens": first["tokens"],
                      "remaining": first["remaining"]}
        return out

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
