"""Mixture-of-Experts FFN with capacity — the counterpart of
``repro/models/moe.py``: top-k routing, a sort-based scatter of the tokens
into a dense (E * C, D) expert buffer, the experts' SwiGLU GEMMs and a
gather back weighted by the routing probabilities.

Every expert runs its GEMMs on its ``C``-row buffer whether a token chose
it or not, as in the reference; in Mode.AB the dual Sparse.B kernel skips
every all-zero A block, so an expert no token chose reads no weights.

Batch invariance: the engine decodes several rows at once while its greedy
oracle decodes one, and their tokens must match bit for bit.  Each token's
routing is row-wise (softmax summed by ``common.tree_sum``, top-k by
repeated first-index argmax, so ties go to the lower expert as
``jax.lax.top_k`` breaks them); decode runs drop-free, so no token's output
depends on the others; the combine adds the k choices in the fixed order
k = 0, 1, ...  The per-expert counts are a ``scatter_add_`` into a fixed
(E + 1,) tensor, never ``torch.bincount``, which reads its length back to
the host.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import MoEConfig
from ..kernels.dense_gemm.ops import DenseShard
from ..kernels.griffin_spmm.ops import GriffinWeights
from .common import _EXEC_STACK, _dispatched, act_fn, griffin_linear, tree_sum


def expert_linear(xe: torch.Tensor, w) -> torch.Tensor:
    """Per-expert weight GEMM: xe (E, C, K) x w (E, K, N) -> (E, C, N).

    ``w`` may be a stacked ``GriffinWeights`` (leading expert axis), whose
    experts each run the Sparse.B kernel, or a plain stack: under a
    ``sparse_execution`` scope with kernels (or for a mesh rank's
    ``DenseShard``) each expert goes through ``griffin_linear`` too, else
    one batched product (the reference's
    einsum), promoted to the wider dtype."""
    if isinstance(w, GriffinWeights):
        return torch.stack([griffin_linear(xe[e], w[e])
                            for e in range(w.b_comp.shape[0])])
    if _EXEC_STACK[-1].use_kernels or isinstance(w, DenseShard):
        # a mesh rank's shard of the experts goes through griffin_linear's
        # gather per expert, with or without kernels
        return torch.stack([griffin_linear(xe[e], w[e])
                            for e in range(w.shape[0])])
    _dispatched("plain")
    dt = torch.promote_types(xe.dtype, w.dtype)
    return torch.einsum("eck,ekn->ecn", xe.to(dt), w.to(dt))


def top_k(p: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest entries of each row, in
    descending order, ties to the lower index (``jax.lax.top_k``'s rule):
    ``k`` passes of ``argmax``, which returns the first maximal index, each
    masking what it took.  Row-wise, so a row's choice never depends on
    the others.  The values are gathered from ``p`` itself (never from
    the masked copy), so a gradient reaches the chosen entries."""
    masked = p.detach().clone()
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(masked, dim=-1, keepdim=True)
        vals.append(p.gather(-1, i))
        idxs.append(i)
        masked.scatter_(-1, i, float("-inf"))
    return torch.cat(vals, -1), torch.cat(idxs, -1)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis, its sum a ``tree_sum``."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / tree_sum(e)[..., None]


def _count(e_flat: torch.Tensor, bins: int) -> torch.Tensor:
    """Occurrences of each value in [0, bins) of ``e_flat``, int64, with no
    read-back to the host."""
    counts = torch.zeros(bins, dtype=torch.int64, device=e_flat.device)
    return counts.scatter_add_(0, e_flat, torch.ones_like(e_flat))


def capacity(n: int, moe: MoEConfig, drop_free: bool) -> int:
    """The expert capacity ``C``: ``n`` drop-free, else the trained
    capacity ``int(n * capacity_factor * top_k / num_experts)``, at least
    1."""
    if drop_free:
        return n
    return max(1, int(n * moe.capacity_factor * moe.top_k
                      / moe.num_experts))


def route(p: Dict, x: torch.Tensor, moe: MoEConfig, drop_free: bool = False,
          valid: Optional[torch.Tensor] = None):
    """The routing of ``x`` (N, D): (probs (N, E) fp32, top_p (N, K) fp32
    renormalised, e_flat (N * K,), keep (N * K,) bool, slot (N * K,)
    int64, C).  Pad tokens (``valid`` False) route to the pseudo-expert E,
    take no capacity and are never kept."""
    N = x.shape[0]
    E, K = moe.num_experts, moe.top_k
    C = capacity(N, moe, drop_free or valid is not None)
    router = p["router"]
    if isinstance(router, GriffinWeights):
        gates = griffin_linear(x.float(), router)
    elif _EXEC_STACK[-1].use_kernels:
        # the router GEMM in fp32 end to end, so near-tied top-k choices
        # resolve as in the plain product below (the reference's upcast)
        gates = griffin_linear(x.float(), router.float())
    else:
        _dispatched("plain")
        gates = x.float() @ router.float()
    probs = _softmax(gates.float())
    top_p, top_e = top_k(probs, K)
    top_p = top_p / tree_sum(top_p).clamp(min=1e-9)[:, None]
    e_flat = top_e.reshape(N * K)
    valid_k = None if valid is None else \
        valid[:, None].expand(N, K).reshape(N * K)
    if valid_k is not None:
        e_flat = torch.where(valid_k, e_flat, E)
    # rank of each (token, k) pair among its expert's, in token order: the
    # inverse of a stable sort minus the expert's start
    order = torch.argsort(e_flat, stable=True)
    counts = _count(e_flat, E + 1)
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(N * K, device=x.device)
    ranks = ranks - starts[e_flat]
    keep = ranks < C
    if valid_k is not None:
        keep = keep & valid_k
    slot = torch.where(keep, e_flat * C + ranks,
                       torch.full_like(ranks, E * C))
    return probs, top_p, e_flat, keep, slot, C


def moe_ffn(p: Dict, x: torch.Tensor, moe: MoEConfig, act: str = "silu",
            drop_free: bool = False, valid: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (N, D) token major.  Returns (out (N, D), aux load-balance loss).

    ``drop_free=True`` (decode) sets the capacity to N, so no token is ever
    dropped and a token's output never depends on its co-batched rows;
    ``valid``, the (N,) right-pad mask of a bucketed prefill, runs
    drop-free too and keeps the pads out of every expert.  An exact-length
    prefill keeps the trained capacity, as in the reference."""
    N, D = x.shape
    E, K = moe.num_experts, moe.top_k
    probs, top_p, e_flat, keep, slot, C = route(p, x, moe, drop_free, valid)
    # kept slots are unique; dropped pairs all write the dump row E * C,
    # which is never read
    buf = x.new_zeros((E * C + 1, D))
    buf.index_copy_(0, slot, x[:, None].expand(N, K, D).reshape(N * K, D))
    xe = buf[:E * C].reshape(E, C, D)
    h = act_fn(act)(expert_linear(xe, p["w_gate"])) * \
        expert_linear(xe, p["w_up"])
    ye = expert_linear(h.to(x.dtype), p["w_down"])
    y_buf = torch.cat([ye.reshape(E * C, D), ye.new_zeros((1, D))])
    yk = y_buf[slot].reshape(N, K, D).float()
    w = (top_p * keep.reshape(N, K)).float()
    out = yk[:, 0] * w[:, 0, None]
    for k in range(1, K):
        out = out + yk[:, k] * w[:, k, None]
    # the Switch-style load-balance term (pads, routed to E, not counted)
    me = probs.mean(dim=0)
    fe = _count(e_flat, E + 1)[:E].float() / (N * K) * E
    aux = (me * fe).sum() * E
    return out.to(x.dtype), aux.float()
