"""Griffin hybrid morphing (paper Section IV-B, Table III, Table VI).

A hybrid design is one physical core (the dual-sparse base determines the
silicon) that *morphs* per workload category: the 9-entry ABUF, BBUF, extra
adder tree and MUX network bought for dual sparsity are re-purposed as a
deeper single-sided window when only one tensor is sparse.  A plain dual
design instead *downgrades* (ignores the idle resources).

``select_mode`` is the runtime policy: given declared/measured tensor
sparsity it picks the execution mode.  The same policy drives both layers
of the port: the cycle model (this module's ``design_speedup``) and the
card's kernels — ``kernels.griffin_spmm.auto_matmul`` calls it per op,
``models.common`` per GEMM and the serving engine per tick.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import numpy as np

from .evaluate import (MaskModel, DEFAULT_MASK_MODEL, network_speedup,
                       network_speedup_batched, Workload)
from .spec import CoreConfig, HybridSpec, Mode, SparseSpec

# Sparsity below this threshold is not worth skipping (metadata/arbitration
# overheads would dominate); the paper treats ~<5% as dense.
SPARSE_THRESHOLD = 0.05


def select_mode(a_sparsity: float, b_sparsity: float,
                threshold: float = SPARSE_THRESHOLD,
                b_threshold: Optional[float] = None) -> Mode:
    """Pick the execution mode from declared/measured tensor sparsities.

    ``threshold`` gates the A side (and the B side too unless
    ``b_threshold`` overrides it separately).  The thresholds change
    *which* kernel runs, never what it computes — skipped blocks are
    exactly zero either way — so any threshold keeps greedy decode
    token-identical.
    """
    b_thr = threshold if b_threshold is None else b_threshold
    return Mode.of(a_sparsity > threshold, b_sparsity > b_thr)


def running_spec(design: Union[SparseSpec, HybridSpec], mode: Mode
                 ) -> SparseSpec:
    """The configuration the core actually runs for a model category."""
    if isinstance(design, HybridSpec):
        return design.spec_for(mode)
    return design.degrade_to(mode)


def design_speedup(design: Union[SparseSpec, HybridSpec], wl: Workload,
                   core: CoreConfig, seed: int = 0,
                   mode: Optional[Mode] = None,
                   mask_model: MaskModel = DEFAULT_MASK_MODEL) -> float:
    """Speedup of a (possibly hybrid) design on one workload."""
    mode = mode or wl.mode
    spec = running_spec(design, mode)
    return network_speedup(spec, wl, core, seed=seed, mode=mode,
                           mask_model=mask_model)


def category_design_speedup(design: Union[SparseSpec, HybridSpec],
                            workloads: Sequence[Workload], core: CoreConfig,
                            seed: int = 0, mode: Optional[Mode] = None,
                            mask_model: MaskModel = DEFAULT_MASK_MODEL
                            ) -> float:
    sp = [design_speedup(design, w, core, seed=seed + i, mode=mode,
                         mask_model=mask_model)
          for i, w in enumerate(workloads)]
    return float(np.exp(np.mean(np.log(sp))))


def category_design_speedup_batched(designs: Sequence[Union[SparseSpec,
                                                            HybridSpec]],
                                    workloads: Sequence[Workload],
                                    core: CoreConfig, seed: int = 0,
                                    mode: Optional[Mode] = None,
                                    mask_model: MaskModel = DEFAULT_MASK_MODEL
                                    ) -> np.ndarray:
    """Category speedups for a whole stack of (possibly hybrid) designs.

    Designs morph/degrade to their running spec per workload category, the
    resulting specs are deduplicated (two designs running the same config
    score identically), and the unique stack goes through the batched
    evaluation engine once per workload.  Bit-exact with per-design
    :func:`category_design_speedup` calls; this is the entry point
    :func:`repro_torch.core.dse.sweep` uses.
    """
    logs = np.zeros((len(workloads), len(designs)))
    for i, wl in enumerate(workloads):
        wl_mode = mode or wl.mode
        specs = [running_spec(d, wl_mode) for d in designs]
        uniq: list = []
        index: dict = {}
        inverse = np.empty(len(specs), dtype=np.int64)
        for j, sp in enumerate(specs):
            if sp not in index:
                index[sp] = len(uniq)
                uniq.append(sp)
            inverse[j] = index[sp]
        sp_u = network_speedup_batched(uniq, wl, core, seed=seed + i,
                                       mode=wl_mode, mask_model=mask_model)
        logs[i] = np.log(sp_u)[inverse]
    return np.exp(logs.mean(axis=0))
