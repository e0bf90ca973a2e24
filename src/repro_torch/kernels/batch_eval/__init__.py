"""The cycle model's greedy sliding-window schedule on the card: the port's
counterpart of the JAX package's ``kernels.batch_eval`` (a ``jax.vmap`` of
a per-tile ``lax.while_loop``), as the hand-written CUDA kernel
``csrc/batch_eval.cu``.

Select it with ``core.scheduler.schedule_batched(..., backend="torch")``
(one shared config, cycles only) or call :func:`schedule_cycles` directly.
"""
from .ops import MAX_UNROLL, schedule_cycles

__all__ = ["MAX_UNROLL", "schedule_cycles"]
