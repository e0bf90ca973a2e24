"""Runtime mode policy — the port's copy of ``repro.core.hybrid``'s
``select_mode`` and ``SPARSE_THRESHOLD`` (the cycle model stays in the JAX
package)."""
from __future__ import annotations

from typing import Optional

from .spec import Mode

# Sparsity below this threshold is not worth skipping (metadata/arbitration
# overheads would dominate); the paper treats ~<5% as dense.
SPARSE_THRESHOLD = 0.05


def select_mode(a_sparsity: float, b_sparsity: float,
                threshold: float = SPARSE_THRESHOLD,
                b_threshold: Optional[float] = None) -> Mode:
    """Pick the execution mode from declared/measured tensor sparsities.
    ``threshold`` gates the A side, and the B side too unless
    ``b_threshold`` sets it separately."""
    b_thr = threshold if b_threshold is None else b_threshold
    return Mode.of(a_sparsity > threshold, b_sparsity > b_thr)
