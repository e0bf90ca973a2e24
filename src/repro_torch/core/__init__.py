"""Griffin core: the paper's contribution as a composable library — the
port's own numpy copy of the JAX package's ``core``, held equal to it by
``tests/test_torch_core.py``.

- spec:       parametric architecture definitions (borrowing distances)
- scheduler:  the cycle model (greedy on-the-fly + static packing bound);
              ``schedule_batched(..., backend="torch")`` runs the greedy
              schedule on the card (``kernels.batch_eval``)
- evaluate:   GEMM / network / category cycle evaluation
- functional: executes schedules numerically (exactness oracle)
- overhead:   Table II structures + calibrated 7nm power/area model
- efficiency: effective TOPS/W & TOPS/mm^2 (Definition V.1)
- dse:        design-space exploration (Figures 5-7)
- hybrid:     Griffin morphing (Section IV-B) and the runtime mode policy
- workloads:  Table IV benchmark networks as GEMM streams
"""
from .spec import (CoreConfig, HybridSpec, Mode, SparseSpec, DENSE_BASELINE,
                   GRIFFIN, PRESETS, SPARSE_A_STAR, SPARSE_AB_STAR,
                   SPARSE_B_STAR, sparse_a, sparse_ab, sparse_b)
from .evaluate import (GemmCycles, GemmShape, MaskModel, Workload,
                       gemm_cycles, gemm_cycles_batched, network_speedup,
                       network_speedup_batched, category_speedup,
                       category_speedup_batched)
from .hybrid import (category_design_speedup, category_design_speedup_batched,
                     design_speedup, running_spec, select_mode)
from .efficiency import Efficiency, efficiency, sparsity_tax
from .overhead import power_area, structure

__all__ = [
    "CoreConfig", "HybridSpec", "Mode", "SparseSpec", "DENSE_BASELINE",
    "GRIFFIN", "PRESETS", "SPARSE_A_STAR", "SPARSE_AB_STAR", "SPARSE_B_STAR",
    "sparse_a", "sparse_ab", "sparse_b", "GemmCycles", "GemmShape",
    "MaskModel", "Workload", "gemm_cycles", "gemm_cycles_batched",
    "network_speedup", "network_speedup_batched", "category_speedup",
    "category_speedup_batched", "category_design_speedup",
    "category_design_speedup_batched", "design_speedup", "running_spec",
    "select_mode", "Efficiency", "efficiency", "sparsity_tax", "power_area",
    "structure",
]
