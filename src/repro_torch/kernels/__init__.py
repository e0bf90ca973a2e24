"""The port's hand-written CUDA kernels and their wrappers.

``dense_gemm`` (K1), ``griffin_spmm`` (K2) and ``sparse_a`` (K3) replace
the JAX package's Pallas TPU kernels of the same names; ``batch_eval`` its
``jax.vmap`` twin of the cycle model's schedule.  A wrapper given CPU
tensors runs its kernel's plain PyTorch version (``ref.py``); given CUDA
tensors it launches the kernel or raises.
"""
from .build import launch_counts, reset_launch_counts
from .dense_gemm.ops import dense_matmul
from .griffin_spmm.ops import (GriffinWeights, auto_matmul, balance_columns,
                               decompact_weights, griffin_matmul,
                               preprocess_weights, stack_weights)
from .sparse_a.ops import (ActivationMeta, compact_activations,
                           sparse_a_matmul)

__all__ = ["ActivationMeta", "GriffinWeights", "auto_matmul",
           "balance_columns", "compact_activations", "decompact_weights",
           "dense_matmul", "griffin_matmul", "launch_counts",
           "preprocess_weights", "reset_launch_counts", "sparse_a_matmul",
           "stack_weights"]
