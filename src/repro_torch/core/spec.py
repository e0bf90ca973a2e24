"""Execution categories (paper Table I) — the port's copy of
``repro.core.spec.Mode``."""
from __future__ import annotations

import enum


class Mode(str, enum.Enum):
    """DNN model / execution category (paper Table I)."""

    DENSE = "dense"  # (dense, dense)
    A = "A"          # sparse activations only  -> Sparse.A
    B = "B"          # sparse weights only      -> Sparse.B
    AB = "AB"        # dual sparse              -> Sparse.AB

    @staticmethod
    def of(a_sparse: bool, b_sparse: bool) -> "Mode":
        if a_sparse and b_sparse:
            return Mode.AB
        if a_sparse:
            return Mode.A
        if b_sparse:
            return Mode.B
        return Mode.DENSE
