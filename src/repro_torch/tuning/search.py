"""Candidate enumeration + analytical scoring for the autotuner — the
counterpart of ``repro/tuning/search.py``.

A :class:`Candidate` is one point in the per-family execution design
space: compaction block granularity (``block_k`` x ``block_n``), balance
``unit``, accelerator MUX ``fanin`` budget, and the Mode-selection
``a_threshold``.  :func:`predict_scores` prices every candidate with the
two analytical halves of the repo:

  - the cycle-model DSE (``core.dse.sweep`` over the Sparse.B enumeration
    at the candidate's fan-in budget, through the content-hashed
    ``ResultsCache`` — re-scoring a budget the cache has seen is free);
  - a roofline prediction (``roofline.analysis``) of the decode-step GEMM
    cost from the *actual* pruned weights compacted at the candidate's
    granularity (``compaction_stats``), plus a per-grid-step cost that
    depends on the device the weights lie on (:func:`step_overhead_for`).

The predicted score only ranks a shortlist (:func:`shortlist`); the
winner is always picked from *measured* tok/s (``tuning.measure``,
:func:`select_best`) — predictions steer, measurements decide.

Weights are tensors on the serving device (bf16 on the card at full
width): the zero patterns are computed there with torch ops, and every
count equals the reference's numpy on the same values.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ..core.dse import ResultsCache, enumerate_sparse_b, sweep
from ..core.spec import Mode
from ..roofline.analysis import CostSample, roofline_terms
from ..sparsity.pruning import _BLOCKDIAG_PARENTS, GEMM_WEIGHTS
from .plan import FamilyPlan, GemmRule

# Per-grid-step cost (seconds) added to the roofline bound.  On the CPU
# each grid step is a step of the kernels' plain versions on the host: the
# reference's figure for its host-run (interpret) kernels, kept so both
# packages rank a CPU run alike.  On the card it is griffin_spmm's own cost
# per (N tile, compacted K block) step, fitted by chip_smoke.py's kernel
# phase ("griffin_spmm per grid step"): w_up (2048 x 8192, pruned 0.8 at
# 128 / unit 32), M = 4, bf16, compacted at 16 x 16 (32,768 steps, 0.035904
# ms) and at 128 x 128 (704 steps, 0.017024 ms), unit 8; delta ms over delta
# grid steps, on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit.
STEP_OVERHEAD_INTERPRET = 2e-4
STEP_OVERHEAD_HW = 5.888224239210169e-10

DEFAULT_THRESHOLDS = (0.05, 0.9)
DEFAULT_FANINS = (8, 4)


def step_overhead_for(device: torch.device) -> float:
    """The per-grid-step cost of the kernels on ``device``."""
    return (STEP_OVERHEAD_INTERPRET if torch.device(device).type == "cpu"
            else STEP_OVERHEAD_HW)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the per-family execution design space."""

    block_k: int
    block_n: int
    unit: int
    fanin: int
    a_threshold: float

    @property
    def name(self) -> str:
        thr = str(self.a_threshold).replace(".", "p")
        return (f"bk{self.block_k}_bn{self.block_n}_u{self.unit}"
                f"_f{self.fanin}_t{thr}")

    def family_plan(self, family: str, *, b_threshold: Optional[float] = None,
                    predicted: Optional[Dict[str, Any]] = None,
                    measured: Optional[Dict[str, Any]] = None) -> FamilyPlan:
        """The plan entry executing this candidate: one ``"*"`` rule
        steering every GEMM's compaction + the family thresholds."""
        rule = GemmRule(match="*", block_k=self.block_k,
                        block_n=self.block_n, unit=self.unit,
                        a_threshold=self.a_threshold)
        return FamilyPlan(family=family, rules=(rule,),
                          a_threshold=self.a_threshold,
                          b_threshold=b_threshold,
                          predicted=predicted or {}, measured=measured or {})


def gemm_leaves(params: Any, names: Sequence[str] = GEMM_WEIGHTS,
                min_dim: int = 32) -> Dict[str, torch.Tensor]:
    """Representative 2-D weight per GEMM name: the same trailing-name /
    min-dim / block-diagonal selection ``sparsity.sparsify_params``
    applies, with stacked leaves (layers) represented by their first slice
    (layers of a stack share shape and — post-pruning — the same target
    sparsity, so one slice prices them all).  The slices stay on the
    weights' device."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, name="", path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, k, path + (k,))
            return
        if isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v, name, path)
            return
        blockdiag = name in ("wq", "wk", "wv") and \
            any(p in _BLOCKDIAG_PARENTS for p in path)
        if name in names and not blockdiag and \
                isinstance(tree, torch.Tensor) and tree.dim() >= 2 \
                and tree.shape[-2] >= min_dim and tree.shape[-1] >= min_dim:
            w2 = tree.detach().reshape((-1,) + tuple(tree.shape[-2:]))
            if w2.shape[0] and name not in out:
                out[name] = w2[0]

    walk(params)
    return out


def enumerate_candidates(shapes: Mapping[str, Tuple[int, int]],
                         budget: int = 16, *,
                         thresholds: Sequence[float] = DEFAULT_THRESHOLDS,
                         fanins: Sequence[int] = DEFAULT_FANINS
                         ) -> List[Candidate]:
    """Deterministic candidate grid fitted to the family's actual GEMM
    dims, truncated to ``budget`` points.

    Block sizes are powers of two up to the smallest GEMM dim plus the
    "coarse" full-dim point.  Loop nesting orders the axes by how much
    they change the *measured* outcome — sizes innermost, then thresholds,
    then balance unit, then fan-in (which only scales the DSE half of the
    score) — so a small budget spans granularity and thresholds before
    doubling up on fan-ins.
    """
    min_k = min(s[0] for s in shapes.values())
    min_n = min(s[1] for s in shapes.values())
    dim = min(min_k, min_n)
    sizes = [s for s in (16, 32, 64, 128) if s <= dim]
    if dim not in sizes:
        sizes.append(dim)
    out: List[Candidate] = []
    seen = set()
    for fanin in fanins:
        for unit_kind in ("prune", "tile"):
            for thr in thresholds:
                for s in sizes:
                    unit = 8 if unit_kind == "prune" else s
                    c = Candidate(block_k=s, block_n=s, unit=min(unit, s),
                                  fanin=fanin, a_threshold=thr)
                    if c.name in seen:
                        continue
                    seen.add(c.name)
                    out.append(c)
                    if len(out) >= budget:
                        return out
    return out


def compaction_stats(w: torch.Tensor, block_k: int, block_n: int
                     ) -> Dict[str, float]:
    """Compaction of one pruned matrix at (block_k x block_n) granularity
    — the quantities the kernel's cost depends on, computed without
    building the compacted arrays.  Mirrors ``preprocess_weights`` minus
    the balance shuffle (balancing can only tighten ``max_cnt``, so this
    is a safe upper bound for prediction)."""
    k, n = w.shape
    bk, bn = min(block_k, k), min(block_n, n)
    pk, pn = -(-k // bk) * bk, -(-n // bn) * bn
    nz = torch.zeros((pk, pn), dtype=torch.bool, device=w.device)
    nz[:k, :n] = w != 0
    nb_k, nb_n = pk // bk, pn // bn
    blk_nz = nz.reshape(nb_k, bk, nb_n, bn).any(dim=3).any(dim=1)
    cnt = blk_nz.sum(dim=0)
    max_cnt = max(int(cnt.max()) if cnt.numel() else 0, 1)
    return {"nb_k": nb_k, "n_tiles": nb_n, "max_cnt": max_cnt,
            "pn": pn, "bk": bk, "bn": bn,
            "density": int(blk_nz.sum()) / blk_nz.numel()}


def _predicted_step(weights: Mapping[str, torch.Tensor], cand: Candidate,
                    batch: int, step_overhead: float) -> Dict[str, float]:
    """Roofline-bounded decode-step time (seconds) of the family's GEMMs
    compacted at the candidate granularity, plus the grid step term.
    Weights, activations and outputs count the weights' element size (4
    bytes on the fp32 leaves the reference counts, 2 for bf16 on the
    card), the int32 metadata 4."""
    flops = bytes_acc = 0.0
    grid = 0
    model_flops = 0.0
    for w in weights.values():
        st = compaction_stats(w, cand.block_k, cand.block_n)
        depth = st["max_cnt"] * st["bk"]
        flops += 2.0 * batch * depth * st["pn"]
        bytes_acc += float(w.element_size()) * (
            depth * st["pn"] + batch * w.shape[0] + batch * st["pn"]) + \
            4.0 * st["n_tiles"] * (st["max_cnt"] + 1)
        grid += st["n_tiles"] * st["max_cnt"]
        model_flops += 2.0 * batch * float(int(torch.count_nonzero(w)))
    terms = roofline_terms(CostSample(flops=flops, bytes_accessed=bytes_acc,
                                      coll={}), model_flops, chips=1)
    return {"bound_s": terms.bound_s, "grid_steps": grid,
            "predicted_s": terms.bound_s + grid * step_overhead}


def predict_scores(candidates: Sequence[Candidate],
                   weights: Mapping[str, torch.Tensor], *, batch: int = 4,
                   cache: Optional[ResultsCache] = None, seed: int = 0,
                   step_overhead: Optional[float] = None
                   ) -> List[Dict[str, Any]]:
    """Score candidates: cycle-model speedup at the fan-in budget (cached
    DSE sweep) divided by the roofline-predicted step time.
    ``step_overhead=None`` takes the cost of the device the weights lie on
    (:func:`step_overhead_for`).  Returns one row per candidate, input
    order preserved."""
    if step_overhead is None:
        step_overhead = step_overhead_for(
            next(iter(weights.values())).device)
    dse_best: Dict[int, float] = {}
    for fanin in sorted({c.fanin for c in candidates}):
        rows = sweep(enumerate_sparse_b(max_fanin=fanin), Mode.B,
                     seed=seed, cache=cache)
        dse_best[fanin] = max(r["speedup"] for r in rows)
    out = []
    for c in candidates:
        pred = _predicted_step(weights, c, batch, step_overhead)
        dse_sp = dse_best[c.fanin]
        out.append({"name": c.name, "candidate": c,
                    "dse_speedup": round(float(dse_sp), 4),
                    "grid_steps": int(pred["grid_steps"]),
                    "bound_s": pred["bound_s"],
                    "predicted_s": pred["predicted_s"],
                    "score": float(dse_sp) / pred["predicted_s"]})
    return out


def shortlist(scored: Sequence[Dict[str, Any]], k: int
              ) -> List[Dict[str, Any]]:
    """Top-k rows by predicted score; ties broken by name so the
    selection is a pure function of the score table."""
    return sorted(scored, key=lambda r: (-r["score"], r["name"]))[:k]


def select_best(measured: Mapping[str, float]) -> str:
    """Winner of the measured-tok/s validation round: highest tok/s, ties
    broken by name — deterministic given a frozen measurement table."""
    if not measured:
        raise ValueError("empty measurement table")
    return sorted(measured.items(), key=lambda kv: (-kv[1], kv[0]))[0][0]
