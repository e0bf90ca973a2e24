from .pruning import (GEMM_WEIGHTS, PRUNE, PRUNE_FULL, block_prune,
                      magnitude_prune, prune_for, sparsify_params,
                      sparsity_of)

__all__ = ["GEMM_WEIGHTS", "PRUNE", "PRUNE_FULL", "block_prune",
           "magnitude_prune", "prune_for", "sparsify_params", "sparsity_of"]
