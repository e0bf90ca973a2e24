"""Weight pruning for the Griffin execution paths — the counterpart of
``repro/sparsity/pruning.py``.

``magnitude_prune`` zeroes elements, ``block_prune`` zeroes (block_k x unit)
blocks by L2 norm with the reference's ``norms >= thresh`` tie rule, and
``sparsify_params`` block-prunes the weight GEMM leaves of a parameter tree
and compacts them into ``GriffinWeights``.  Everything runs with torch ops on
the weights' own device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..kernels.griffin_spmm.ops import preprocess_weights, stack_weights


def magnitude_prune(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Zero the smallest-|w| fraction ``sparsity`` of entries."""
    if sparsity <= 0.0:
        return w
    k = max(1, int(round(w.numel() * (1.0 - sparsity))))
    thresh = torch.sort(w.abs().reshape(-1)).values[-k]
    return torch.where(w.abs() >= thresh, w, torch.zeros((), dtype=w.dtype,
                                                         device=w.device))


def block_prune(w: torch.Tensor, sparsity: float, block_k: int = 128,
                unit: int = 32) -> torch.Tensor:
    """Zero the lowest-L2 fraction ``sparsity`` of (block_k x unit) blocks.
    Shapes not divisible by the block are zero padded (the pad never
    changes block norms)."""
    if sparsity <= 0.0:
        return w
    k, n = w.shape
    pk, pn = -(-k // block_k) * block_k, -(-n // unit) * unit
    wp = w.new_zeros((pk, pn))
    wp[:k, :n] = w
    nb_k, nb_n = pk // block_k, pn // unit
    blocks = wp.reshape(nb_k, block_k, nb_n, unit)
    norms = torch.sqrt((blocks.float() ** 2).sum(dim=(1, 3)))
    nkeep = max(1, int(round(norms.numel() * (1.0 - sparsity))))
    thresh = torch.sort(norms.reshape(-1)).values[-nkeep]
    keep = (norms >= thresh)[:, None, :, None]
    # multiplying (not masking) keeps the reference's signed zeros
    return (blocks * keep).reshape(pk, pn)[:k, :n].to(w.dtype)


def sparsity_of(x: torch.Tensor) -> torch.Tensor:
    """Fraction of exact zeros (the quantity Table IV reports)."""
    return (x == 0).float().mean()


# Trailing param names of the weight GEMMs griffin_linear executes (the
# reference's list; the dense decoder uses the first seven).
GEMM_WEIGHTS: Tuple[str, ...] = (
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_ff1", "w_ff2",
    "wz", "wi", "wf", "head")

# Pruning granularity of the reduced configs (the reference's 16 x 16 /
# unit 8) and of full width (128 x 128 / unit 32, the defaults below): what
# the serving entry points and the autotuner prune at.  A tuned plan
# steers compaction only, so every candidate shares this zero pattern.
PRUNE: Dict[str, int] = dict(block_k=16, block_n=16, unit=8)
PRUNE_FULL: Dict[str, int] = dict(block_k=128, block_n=128, unit=32)


def prune_for(reduced: bool) -> Dict[str, int]:
    """The base pruning granularity of the reduced or full-width config."""
    return dict(PRUNE if reduced else PRUNE_FULL)


# Subtrees whose wq/wk/wv are per-head block-diagonal mats, not weight GEMMs
# (the reference's xlstm m_blocks).
_BLOCKDIAG_PARENTS: Tuple[str, ...] = ("m_blocks",)


def sparsify_params(params: Any, sparsity: float, *, block_k: int = 128,
                    block_n: int = 128, unit: Optional[int] = None,
                    names: Sequence[str] = GEMM_WEIGHTS,
                    min_dim: int = 32, balance: bool = True,
                    compact: bool = True, plan: Any = None) -> Any:
    """Block-prune the weight GEMM leaves of a parameter tree.

    With ``compact=True`` each pruned leaf becomes a ``GriffinWeights``
    (stacked leaves, with one leading axis or more, get a stacked one with
    the leaf's leading axes whose members share a padded grid depth); with
    ``compact=False`` the pruned weights stay plain tensors, the bit-exact
    dense twin of the compacted run.  Selection is by trailing
    param name and minimum GEMM dims, as in the reference.

    ``plan`` is a tuned family plan (``repro_torch.tuning.FamilyPlan``, or
    anything with its ``rule_for(name)``): a matching rule overrides the
    *compaction* granularity (block sizes and balance unit, clamped to the
    leaf's dims, the unit also to the block width) and stamps the rule's
    ``a_threshold`` on the compacted leaf (``GriffinWeights.a_thr``).
    Pruning stays at the call's ``block_k``/``unit``: a plan never moves a
    zero, so planned and default engines compute the same products.
    """

    def convert(w: torch.Tensor, name: str):
        bk = min(block_k, w.shape[-2])
        bn = min(block_n, w.shape[-1])
        un = min(unit or max(8, bn // 4), w.shape[-1])
        cbk, cbn, cun, thr = bk, bn, un, None
        rule = plan.rule_for(name) if plan is not None else None
        if rule is not None:
            cbk = min(rule.block_k or cbk, w.shape[-2])
            cbn = min(rule.block_n or cbn, w.shape[-1])
            cun = min(rule.unit or cun, cbn, w.shape[-1])
            thr = rule.a_threshold

        def pre(m):
            gw = preprocess_weights(m, block_k=cbk, block_n=cbn, unit=cun,
                                    balance=balance)
            return gw if thr is None else dataclasses.replace(gw, a_thr=thr)

        if w.dim() == 2:
            wp = block_prune(w, sparsity, bk, un)
            return pre(wp) if compact else wp
        lead = tuple(w.shape[:-2])
        flat = w.reshape((-1,) + tuple(w.shape[-2:]))
        if flat.shape[0] == 0:
            return w
        slices = [block_prune(flat[i], sparsity, bk, un)
                  for i in range(flat.shape[0])]
        if not compact:
            return torch.stack(slices).reshape(w.shape)
        gw = stack_weights([pre(s) for s in slices])
        if len(lead) == 1:
            return gw
        # e.g. the (groups, blocks) stacks of xlstm
        return dataclasses.replace(gw, **{
            f: t.reshape(lead + tuple(t.shape[1:]))
            for f in ("b_comp", "kidx", "cnt", "inv_perm", "perm")
            if (t := getattr(gw, f)) is not None})

    def walk(tree, name="", path=()):
        if isinstance(tree, dict):
            return {k: walk(v, k, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, name, path) for v in tree)
        blockdiag = name in ("wq", "wk", "wv") and \
            any(p in _BLOCKDIAG_PARENTS for p in path)
        if name in names and not blockdiag and \
                isinstance(tree, torch.Tensor) and tree.dim() >= 2 and \
                tree.shape[-2] >= min_dim and tree.shape[-1] >= min_dim:
            return convert(tree, name)
        return tree

    return walk(params)
