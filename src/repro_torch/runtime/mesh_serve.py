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

Remeshing after a device loss (the fault injector, the straggler
detector, snapshots) is ROADMAP 1.15b: an armed engine on a mesh larger
than 1x1 raises.  A 1x1 mesh is the single-device engine.
"""
from __future__ import annotations

import hashlib
import json
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.registry import ModelApi
from .config import EngineConfig
from .engine import ServeEngine, _promote_arena, weight_sparsity
from .paging import paged_tree
from .elastic import reshard
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


class MeshServeEngine(ServeEngine):
    """``ServeEngine`` on one rank of a ("data", "model") mesh (see the
    module docstring).  ``params`` is the whole tree on this rank's device
    (or the host): the engine counts its weight sparsity, then keeps only
    the rank's share on its device (``elastic.reshard``), so the caller may
    drop the tree.
    ``mesh`` is the rank's joined ``launch.mesh.Mesh``.  Needs
    ``arena.cache_len``; the slot count must split over the data rows.
    ``prefills_here`` counts the prefills this rank computed (its data
    row's admissions), ``stats["prefill_calls"]`` all of them."""

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
                 or config.fault.snapshot_dir is not None
                 or config.fault.recovery_model_parallel is not None)
        if mesh.size > 1 and armed:
            raise NotImplementedError(
                "failure handling on a mesh (remeshing onto survivors, "
                "stragglers, snapshots) is not ported yet (ROADMAP 1.15b)")
        if mesh.device is not None and mesh.device.type != api.device.type:
            raise ValueError(f"the mesh's rank is on {mesh.device}, the "
                             f"model on {api.device}")
        self.mesh = mesh
        self._per_row = slots_per_row(mesh, config.arena.num_slots)
        if mesh.size > 1:
            self._spmd_mesh = mesh
        self._b_sparsity = weight_sparsity(params)
        self.prefills_here = 0
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
