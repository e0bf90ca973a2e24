"""Weight pruning for the Griffin execution paths — the counterpart of
``repro/sparsity/pruning.py``.

``magnitude_prune`` zeroes elements, ``block_prune`` zeroes (block_k x unit)
blocks by L2 norm with the reference's ``norms >= thresh`` tie rule,
``PruneSchedule`` ramps the sparsity during training (the cubic schedule of
Zhu & Gupta, the paper's pruning reference), and ``sparsify_params``
block-prunes the weight GEMM leaves of a parameter tree
and compacts them into ``GriffinWeights``.  ``init_sparse_params`` gives
``sparsify_params(api.init(gen), ...)`` bit for bit without ever holding
the dense tree: mixtral-8x7b's 93 GB of bf16 weights do not fit the card,
its compacted ones do.  Everything runs with torch ops on the weights' own
device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.griffin_spmm.ops import (GriffinWeights, grid_depth,
                                        preprocess_weights, stack_weights)
from ..models.common import set_path


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


@dataclasses.dataclass(frozen=True)
class PruneSchedule:
    """Cubic sparsity ramp s(t) = s_f * (1 - (1 - t/T)^3) on [t0, t0+T]."""

    final_sparsity: float
    begin_step: int = 0
    ramp_steps: int = 1000
    block_k: int = 0          # 0 => unstructured magnitude pruning
    unit: int = 32

    def sparsity_at(self, step: int) -> float:
        """The ramp at ``step``, in float32 as the reference computes it
        (the cube as ``u * (u * u)``, its ``integer_pow``), so a
        milestone prunes exactly the reference's number of blocks."""
        one = np.float32(1.0)
        t = np.float32(step - self.begin_step) / \
            np.float32(max(self.ramp_steps, 1))
        t = min(max(t, np.float32(0.0)), one)
        u = one - t
        return float(np.float32(self.final_sparsity) * (one - u * (u * u)))

    def apply(self, w: torch.Tensor, step: int) -> torch.Tensor:
        """Prune ``w`` to the ramp's sparsity at ``step`` (host side,
        between train steps, at ramp milestones).  Stacked layer weights
        (L, ..., in, out) are pruned per layer."""
        s = self.sparsity_at(step)

        def fn(x):
            if not self.block_k:
                return magnitude_prune(x, s)
            return block_prune(x, s, min(self.block_k, x.shape[0]),
                               min(self.unit, x.shape[1]))

        if w.dim() == 2:
            return fn(w)
        flat = w.reshape((-1,) + tuple(w.shape[-2:]))
        return torch.stack([fn(x) for x in flat]).reshape(w.shape)


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
        g = _Granularity.of(tuple(w.shape[-2:]), name, block_k, block_n,
                            unit, plan, balance)
        if w.dim() == 2:
            wp = block_prune(w, sparsity, g.bk, g.un)
            return g.compact(wp) if compact else wp
        lead = tuple(w.shape[:-2])
        flat = w.reshape((-1,) + tuple(w.shape[-2:]))
        if flat.shape[0] == 0:
            return w
        slices = [block_prune(flat[i], sparsity, g.bk, g.un)
                  for i in range(flat.shape[0])]
        if not compact:
            return torch.stack(slices).reshape(w.shape)
        gw = stack_weights([g.compact(s) for s in slices])
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
        if isinstance(tree, torch.Tensor) and \
                _selected(path, tuple(tree.shape), names, min_dim):
            return convert(tree, name)
        return tree

    return walk(params)


def _selected(path: Tuple[str, ...], shape: Tuple[int, ...],
              names: Sequence[str], min_dim: int) -> bool:
    """Whether the leaf at ``path`` is a weight GEMM that the pruning
    takes: selected by trailing name and minimum GEMM dims, as in the
    reference, leaving out per-head block-diagonal mats."""
    name = path[-1] if path else ""
    blockdiag = name in ("wq", "wk", "wv") and \
        any(p in _BLOCKDIAG_PARENTS for p in path)
    return name in names and not blockdiag and len(shape) >= 2 and \
        shape[-2] >= min_dim and shape[-1] >= min_dim


@dataclasses.dataclass(frozen=True)
class _Granularity:
    """A leaf's pruning blocks (``bk`` x ``un``) and its compaction (the
    call's, or a plan rule's overriding blocks, unit and threshold)."""

    bk: int
    un: int
    cbk: int
    cbn: int
    cun: int
    thr: Optional[float]
    balance: bool

    @classmethod
    def of(cls, shape: Tuple[int, int], name: str, block_k: int,
           block_n: int, unit: Optional[int], plan: Any,
           balance: bool) -> "_Granularity":
        bk = min(block_k, shape[0])
        bn = min(block_n, shape[1])
        un = min(unit or max(8, bn // 4), shape[1])
        cbk, cbn, cun, thr = bk, bn, un, None
        rule = plan.rule_for(name) if plan is not None else None
        if rule is not None:
            cbk = min(rule.block_k or cbk, shape[0])
            cbn = min(rule.block_n or cbn, shape[1])
            cun = min(rule.unit or cun, cbn, shape[1])
            thr = rule.a_threshold
        return cls(bk, un, cbk, cbn, cun, thr, balance)

    def compact(self, m: torch.Tensor) -> GriffinWeights:
        gw = preprocess_weights(m, block_k=self.cbk, block_n=self.cbn,
                                unit=self.cun, balance=self.balance)
        return gw if self.thr is None else \
            dataclasses.replace(gw, a_thr=self.thr)

    def depth(self, m: torch.Tensor) -> int:
        return grid_depth(m, block_k=self.cbk, block_n=self.cbn,
                          unit=self.cun, balance=self.balance)


def init_sparse_params(api: Any, gen: torch.Generator, sparsity: float, *,
                       block_k: int = 128, block_n: int = 128,
                       unit: Optional[int] = None,
                       names: Sequence[str] = GEMM_WEIGHTS,
                       min_dim: int = 32, balance: bool = True,
                       plan: Any = None) -> Any:
    """``sparsify_params(api.init(gen), sparsity, ...)`` (compacted) bit
    for bit, built without the dense tree: the family's draw order
    (``api.draws``) is walked one matrix at a time, each pruned and
    compacted before the next is drawn.

    A stacked leaf's members share the grid depth of its deepest member,
    which is known only once every member is drawn, and holding the
    members until then would hold the leaf twice.  So each stacked leaf is
    drawn twice from a restarted generator: a first pass that only counts
    each member's depth (``grid_depth``), then, from the generator state
    saved before it, a second that compacts each member into the stack,
    allocated once at that depth, and frees it.  The generator ends where
    ``api.init`` leaves it.  Peak memory: the compacted tree plus one
    member's draw and its compaction."""
    if api.draws is None:
        raise NotImplementedError(
            f"family {api.cfg.family!r} has no streamed draw order; use "
            "sparsify_params(api.init(gen), ...)")
    dtype = getattr(torch, api.cfg.dtype)
    tree: Dict[str, Any] = {}
    for d in api.draws():
        if d.zeros or 0 in d.lead or not _selected(d.path, tuple(d.shape),
                                                    names, min_dim):
            set_path(tree, d.path, d.draw(gen, dtype))
            continue
        g = _Granularity.of(tuple(d.shape), d.path[-1], block_k, block_n,
                            unit, plan, balance)

        def pruned(w):
            return block_prune(w, sparsity, g.bk, g.un)

        if not d.lead:
            (_, w), = d.slices(gen, dtype)
            set_path(tree, d.path, g.compact(pruned(w)))
            continue
        state = gen.get_state()
        depth = max(g.depth(pruned(w)) for _, w in d.slices(gen, dtype))
        gen.set_state(state)
        stack = None
        for idx, w in d.slices(gen, dtype):
            gw = g.compact(pruned(w))
            del w
            if stack is None:
                stack = _empty_stack(gw, d.lead, depth)
            _put(stack, idx, gw)
        set_path(tree, d.path, stack)
    return tree


def _empty_stack(gw: GriffinWeights, lead: Tuple[int, ...],
                 depth: int) -> GriffinWeights:
    """A stacked ``GriffinWeights`` of ``lead`` members like ``gw`` at grid
    depth ``depth``, its tensors allocated and not filled."""
    nt, pn = gw.kidx.shape[0], gw.b_comp.shape[1]

    def new(shape, like):
        return None if like is None else like.new_empty(lead + shape)

    return GriffinWeights(
        b_comp=new((depth * gw.block_k, pn), gw.b_comp),
        kidx=new((nt, depth), gw.kidx), cnt=new((nt,), gw.cnt),
        inv_perm=new((pn,), gw.inv_perm), k=gw.k, n=gw.n,
        block_k=gw.block_k, block_n=gw.block_n, a_thr=gw.a_thr,
        perm=new((pn,), gw.perm))


def _put(stack: GriffinWeights, idx: Tuple[int, ...],
         gw: GriffinWeights) -> None:
    """Copy member ``gw`` into ``stack[idx]``, padded to the stack's depth
    as ``stack_weights`` pads: dead ``kidx`` entries clamp-repeat its last
    id, their ``b_comp`` rows are zero."""
    mc = gw.kidx.shape[1]
    rows = mc * gw.block_k
    stack.b_comp[idx][:rows] = gw.b_comp
    stack.b_comp[idx][rows:] = 0
    stack.kidx[idx][:, :mc] = gw.kidx
    stack.kidx[idx][:, mc:] = gw.kidx[:, -1:]
    stack.cnt[idx] = gw.cnt
    for f in ("inv_perm", "perm"):
        if getattr(stack, f) is not None:
            getattr(stack, f)[idx] = getattr(gw, f)
