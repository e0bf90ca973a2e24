"""Sparsity measurement: the runtime inputs to Griffin's mode selection —
the counterpart of ``repro/sparsity/stats.py``."""
from __future__ import annotations

from typing import Dict

import torch

from ..checkpoint.checkpoint import keyed_leaves
from ..core.hybrid import select_mode
from ..core.spec import Mode
from .pruning import sparsity_of


def tensor_report(tree) -> Dict[str, float]:
    """Per-leaf zero fraction of a parameter tree, keyed by the leaf's
    path in the reference's key syntax (``['layers']['wq']``)."""
    return {path: float(sparsity_of(leaf))
            for path, leaf in keyed_leaves(tree)
            if isinstance(leaf, torch.Tensor)}


def model_mode(params, activations_sparsity: float = 0.0,
               threshold: float = 0.05) -> Mode:
    """Classify a model into the paper's four categories (Table I): the
    mean of the leaves' zero fractions is its weight sparsity."""
    vals = list(tensor_report(params).values())
    b_sparsity = sum(vals) / max(len(vals), 1)
    return select_mode(activations_sparsity, b_sparsity, threshold)


def activation_sparsity(fn, *args) -> float:
    """Zero fraction of a forward function's output (post-nonlinearity
    activations)."""
    return float(sparsity_of(fn(*args)))
