from .pruning import (GEMM_WEIGHTS, block_prune, magnitude_prune,
                      sparsify_params, sparsity_of)

__all__ = ["GEMM_WEIGHTS", "block_prune", "magnitude_prune",
           "sparsify_params", "sparsity_of"]
