"""Design-space exploration (paper Section VI, Figures 5-7).

Enumerates each architecture family under the paper's MUX fan-in budgets
(<=8 for single-sparse, <=16 for dual), scores every point on its benchmark
category (speedup, power, area, effective TOPS/W and TOPS/mm^2) and extracts
the Pareto frontier.  Results are plain dict rows, written as CSV by the
benchmark drivers.

:func:`sweep` is the batched sweep driver: it scores a whole design list
through the stacked-config evaluation engine (one mask draw and one
vectorized scheduler pass per workload layer instead of one Python loop per
design) and memoizes finished rows in a content-hashed on-disk
:class:`ResultsCache`, so re-running a figure script only pays for design
points it has never seen.  :func:`score` is the single-design wrapper.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from .efficiency import efficiency, sparsity_tax
from .evaluate import MaskModel, DEFAULT_MASK_MODEL
from .hybrid import category_design_speedup, category_design_speedup_batched
from .overhead import power_area, structure
from .spec import (CoreConfig, HybridSpec, Mode, SparseSpec, sparse_a,
                   sparse_b, sparse_ab)
from .workloads import category_workloads

# Bump to force-invalidate cached sweep rows by hand.  Day to day this is
# unnecessary: fingerprints also include a digest of the model-defining
# module sources (see _model_digest), so editing the cycle model, cost
# model or workload tables cold-starts the cache automatically.
CACHE_VERSION = 1

# Version of the candidate-config / kernel-plan schema (the JAX package's
# tuning layer, DESIGN.md Section 12).  It is part of every sweep
# fingerprint: a schema bump (candidate fields gaining new semantics) must
# cold-start the cache, otherwise rows written under the old schema would
# be served verbatim to plan-era queries.
CONFIG_SCHEMA_VERSION = 2

# The port's own cache directory (ignored by git), apart from the JAX
# package's ``benchmarks/out/cache``: the digest below already keeps the two
# packages' keys apart, and separate directories keep their files apart too.
DEFAULT_CACHE_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
    os.pardir, "build", "repro_torch_dse_cache"))

_MODEL_DIGEST: Optional[str] = None


def _model_digest() -> str:
    """Digest of the source of every module a sweep row's value depends on.

    Hashing source is deliberately coarse: a comment-only edit also
    invalidates, which costs one cold run — far cheaper than a stale
    cache silently reproducing pre-edit results.  The port's own sources
    are hashed under its own name, so a port row never shares a key with
    one of the JAX package's.
    """
    global _MODEL_DIGEST
    if _MODEL_DIGEST is None:
        import inspect
        from . import (efficiency as _eff, evaluate as _ev, hybrid as _hy,
                       overhead as _ov, scheduler as _sc, spec as _sp,
                       workloads as _wl)
        src = __package__ + "".join(
            inspect.getsource(m) for m in (_sc, _ev, _hy, _ov, _eff, _sp, _wl))
        _MODEL_DIGEST = hashlib.sha256(src.encode()).hexdigest()[:16]
    return _MODEL_DIGEST


def enumerate_sparse_b(max_fanin: int = 8, max_db1: int = 8) -> List[SparseSpec]:
    """Sparse.B family with AMUX fan-in (1+db1)(1+db2) <= max_fanin."""
    out = []
    for db1 in range(1, max_db1 + 1):
        for db2 in range(0, max_fanin):
            if (1 + db1) * (1 + db2) > max_fanin:
                continue
            for db3 in (0, 1, 2):
                for sh in (False, True):
                    out.append(sparse_b(db1, db2, db3, shuffle=sh))
    return out


def enumerate_sparse_a(max_fanin: int = 8, max_da1: int = 4) -> List[SparseSpec]:
    """Sparse.A family with AMUX fan-in (1+da1)(1+da2)(1+da3) <= max_fanin."""
    out = []
    for da1 in range(1, max_da1 + 1):
        for da2 in (0, 1, 2):
            for da3 in (0, 1, 2):
                if (1 + da1) * (1 + da2) * (1 + da3) > max_fanin:
                    continue
                for sh in (False, True):
                    out.append(sparse_a(da1, da2, da3, shuffle=sh))
    return out


def enumerate_sparse_ab(max_fanin: int = 16) -> List[SparseSpec]:
    """Sparse.AB family with AMUX fan-in <= max_fanin.

    Section VI-C prunes da3 > 0 (it inflates AMUX fan-in, unlike db3) and
    da1 > 2 (larger da1 needs deeper BBUF); we enumerate the same region.
    """
    out = []
    for da1 in (1, 2):
        for db1 in (1, 2, 3, 4):
            L = (1 + da1) * (1 + db1)
            for da2 in (0, 1):
                for db2 in (0, 1):
                    fanin = 1 + (L - 1) * (1 + da2 + db2)
                    if fanin > max_fanin:
                        continue
                    for db3 in (0, 1, 2):
                        for sh in (False, True):
                            out.append(sparse_ab(da1, da2, 0, db1, db2, db3,
                                                 shuffle=sh))
    return out


def _spec_dict(spec: SparseSpec) -> Dict:
    return dataclasses.asdict(spec)


def design_fingerprint(design: Union[SparseSpec, HybridSpec], mode: Mode,
                       core: CoreConfig, seed: int,
                       mask_model: MaskModel, extra: Tuple = ()) -> str:
    """Content hash of everything that determines one sweep row.

    Two invocations with the same design point, category, core geometry,
    seed and mask-model calibration are guaranteed to produce the same row
    (the evaluation engine is deterministic), so the hash is a safe cache
    key across processes and sessions.
    """
    if isinstance(design, HybridSpec):
        dd = {"hybrid": design.name, "base": _spec_dict(design.base),
              "conf_a": _spec_dict(design.conf_a),
              "conf_b": _spec_dict(design.conf_b)}
    else:
        dd = _spec_dict(design)
    payload = {
        "v": CACHE_VERSION, "schema": CONFIG_SCHEMA_VERSION,
        "model": _model_digest(), "design": dd,
        "mode": mode.value, "core": dataclasses.asdict(core), "seed": seed,
        "mask_model": dataclasses.asdict(mask_model), "extra": list(extra),
    }
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


class ResultsCache:
    """Content-hashed on-disk cache of sweep rows (one JSON file per key).

    Keys come from :func:`design_fingerprint`; values are the plain dict
    rows :func:`sweep` produces.  Corrupt or unreadable entries are treated
    as misses, so a killed run can never poison a later one.  ``path``
    defaults to :data:`DEFAULT_CACHE_DIR`.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = DEFAULT_CACHE_DIR if path is None else path
        self.hits = 0
        self.misses = 0

    def _file(self, key: str) -> str:
        return os.path.join(self.path, key + ".json")

    def get(self, key: str) -> Optional[Dict]:
        try:
            with open(self._file(key)) as f:
                row = json.load(f)
            self.hits += 1
            return row
        except (OSError, ValueError):
            self.misses += 1
            return None

    def put(self, key: str, row: Dict) -> None:
        os.makedirs(self.path, exist_ok=True)
        tmp = self._file(key) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(row, f)
        os.replace(tmp, self._file(key))


def _row(design: Union[SparseSpec, HybridSpec], mode: Mode, sp: float,
         core: CoreConfig, dense_too: bool) -> Dict[str, float]:
    eff = efficiency(design, sp, core)
    name = design.name if isinstance(design, HybridSpec) else design.label()
    row = {
        "design": name, "mode": mode.value, "speedup": sp,
        "power_mw": eff.power_mw, "area_kum2": eff.area_kum2,
        "tops_w": eff.tops_w, "tops_mm2": eff.tops_mm2,
    }
    if dense_too:
        dense_eff = efficiency(design, 1.0, core)
        row["dense_tops_w"] = dense_eff.tops_w
        row["dense_tops_mm2"] = dense_eff.tops_mm2
    return row


def sweep(designs: Sequence[Union[SparseSpec, HybridSpec]], mode: Mode,
          core: CoreConfig = CoreConfig(), seed: int = 0,
          mask_model: MaskModel = DEFAULT_MASK_MODEL, dense_too: bool = True,
          cache: Optional[ResultsCache] = None) -> List[Dict[str, float]]:
    """Score a design list on one category through the batched engine.

    Cache hits are returned as-is; all misses are evaluated together in a
    single stacked-config pass (see
    :func:`repro_torch.core.hybrid.category_design_speedup_batched`) and
    written back to the cache.  Row order follows ``designs``.
    """
    rows: List[Optional[Dict]] = [None] * len(designs)
    miss_ix: List[int] = []
    keys: List[Optional[str]] = [None] * len(designs)
    for i, d in enumerate(designs):
        if cache is not None:
            keys[i] = design_fingerprint(d, mode, core, seed, mask_model,
                                         extra=("row", dense_too))
            row = cache.get(keys[i])
            if row is not None:
                rows[i] = row
                continue
        miss_ix.append(i)
    if miss_ix:
        wls = category_workloads(mode)
        sps = category_design_speedup_batched(
            [designs[i] for i in miss_ix], wls, core, seed=seed,
            mask_model=mask_model)
        for i, sp in zip(miss_ix, sps):
            rows[i] = _row(designs[i], mode, float(sp), core, dense_too)
            if cache is not None:
                cache.put(keys[i], rows[i])
    return rows  # type: ignore[return-value]


def score(design: Union[SparseSpec, HybridSpec], mode: Mode,
          core: CoreConfig = CoreConfig(), seed: int = 0,
          mask_model: MaskModel = DEFAULT_MASK_MODEL,
          dense_too: bool = True) -> Dict[str, float]:
    """One DSE row: speedup on the category + costs + efficiency.

    Single-design wrapper over :func:`sweep` (no cache); kept for API
    compatibility and as the scalar parity reference.
    """
    sp = category_design_speedup(design, category_workloads(mode), core,
                                 seed=seed, mask_model=mask_model)
    return _row(design, mode, sp, core, dense_too)


def pareto(rows: Sequence[Dict[str, float]], x: str, y: str
           ) -> List[Dict[str, float]]:
    """Rows not dominated in the (maximize x, maximize y) sense."""
    out = []
    for r in rows:
        if not any((o[x] >= r[x] and o[y] >= r[y] and
                    (o[x] > r[x] or o[y] > r[y])) for o in rows):
            out.append(r)
    return sorted(out, key=lambda r: -r[x])
