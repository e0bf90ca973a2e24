from .pruning import (GEMM_WEIGHTS, PRUNE, PRUNE_FULL, PruneSchedule,
                      block_prune, init_sparse_params, magnitude_prune,
                      prune_for, sparsify_params, sparsity_of)

__all__ = ["GEMM_WEIGHTS", "PRUNE", "PRUNE_FULL", "PruneSchedule",
           "block_prune", "init_sparse_params", "magnitude_prune",
           "prune_for", "sparsify_params", "sparsity_of"]
