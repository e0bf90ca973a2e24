"""Shared model components: the sparse execution scope, ``griffin_linear``
(the per-GEMM entry point of the substrate), norms, rope, the KV-slot and
paged KV writes, the paged view, the bucketed-prefill helpers and the
layer-stack helpers — the counterpart of ``repro/models/common.py`` for the
dense decoder, the xlstm family and the hybrid family.

Batch invariance: the serving engine decodes several rows at once while its
greedy oracle decodes one, and their tokens must match exactly.  Every
reduction on the decode path therefore goes through :func:`tree_sum`, a
fixed pairwise tree of elementwise adds whose order does not depend on the
batch size (PyTorch's own reductions pick a thread layout from the number of
rows, which changes the summation order); the GEMMs are the port's kernels,
whose k order is fixed per output element.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.hybrid import SPARSE_THRESHOLD, select_mode
from ..core.spec import Mode
from ..kernels.dense_gemm.ops import (DenseShard, dense_matmul,
                                      dense_matmul_shard)
from ..kernels.dense_gemm.ref import dense_matmul_ref
from ..kernels.griffin_spmm.ops import (GriffinShard, GriffinWeights,
                                        griffin_matmul, griffin_matmul_shard)
from ..kernels.griffin_spmm.ref import griffin_spmm_ref
from ..kernels.sparse_a.ops import (ActivationMeta, compact_activations,
                                    sparse_a_matmul, sparse_a_matmul_shard)
from ..optim.compression import dequantize_rows, quantize_rows


# ---------------------------------------------------------------------------
# sparse execution substrate
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SparseExecution:
    """Knobs for ``griffin_linear``.  ``use_kernels`` routes dense GEMMs
    through the kernels too (off: plain ``x @ w``); ``a_sparsity`` is the
    declared activation sparsity of the workload category; ``block_m`` is
    the M-tile height of Sparse.A's activation metadata.  PyTorch runs
    eagerly, so the scope is read on every call.

    ``spmd_mesh`` (a joined ``launch.mesh.Mesh`` of more than one rank)
    is the serving mesh whose model group the shards of a weight
    (``runtime.sharding.shard_params``) gather their columns over: each
    rank runs the kernel's shard entry on its columns, then the columns
    are gathered (and a compacted weight's balance shuffle undone).  A
    leaf that stays whole runs the whole kernel on every model rank.
    ``spmd_kernels=False`` (``--spmd-fallback``) replaces every kernel
    under the mesh by the decompaction / dense-product oracle, the parity
    baseline, on the same slices."""

    use_kernels: bool = False
    a_sparsity: float = 0.0
    block_m: int = 128
    a_threshold: float = SPARSE_THRESHOLD
    spmd_mesh: Optional[Any] = None
    spmd_kernels: bool = True


_EXEC_STACK = [SparseExecution()]


@contextlib.contextmanager
def sparse_execution(use_kernels: bool = True, a_sparsity: float = 0.0,
                     block_m: int = 128,
                     a_threshold: float = SPARSE_THRESHOLD,
                     spmd_mesh: Optional[Any] = None,
                     spmd_kernels: bool = True):
    """Scope under which ``griffin_linear`` dispatches to the kernels
    (mode per GEMM via ``core.hybrid.select_mode``)."""
    _EXEC_STACK.append(SparseExecution(use_kernels=use_kernels,
                                       a_sparsity=a_sparsity,
                                       block_m=block_m,
                                       a_threshold=a_threshold,
                                       spmd_mesh=spmd_mesh,
                                       spmd_kernels=spmd_kernels))
    try:
        yield _EXEC_STACK[-1]
    finally:
        _EXEC_STACK.pop()


# Dispatch telemetry, one bucket bump per GEMM call:
#   "kernel"      a kernel wrapper (which runs its plain version on CPU
#                 tensors), no mesh
#   "shard"       a kernel's shard entry on this rank's columns of a
#                 weight, then the gather over the mesh's model group
#   "replicated"  the whole kernel on every model rank (a leaf that stays
#                 whole under a mesh)
#   "spmd_oracle" the decompaction / dense-product oracle under a mesh
#                 (``spmd_kernels=False`` only)
#   "plain"       a plain ``x @ w`` (no kernel requested)
#   "dual"        GriffinWeights GEMMs whose Mode came out AB
# Unlike the reference, which counts at trace time and leaves plain
# single-device dots uncounted, eager calls are counted every time and
# "plain" counts every plain dot, so a run can show no GEMM bypassed the
# kernels.
KERNEL_DISPATCH: Dict[str, int] = {}


def reset_kernel_dispatch() -> None:
    KERNEL_DISPATCH.clear()


def kernel_dispatch_counts() -> Dict[str, int]:
    return dict(KERNEL_DISPATCH)


def _dispatched(bucket: str) -> None:
    KERNEL_DISPATCH[bucket] = KERNEL_DISPATCH.get(bucket, 0) + 1


def _mode_a(ctx: SparseExecution) -> bool:
    """Whether the scope sends a dense leaf through Sparse.A."""
    return ctx.use_kernels and select_mode(
        ctx.a_sparsity, 0.0, threshold=ctx.a_threshold) == Mode.A


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the contiguous (M, K) matrix ``griffin_linear`` multiplies:
    leading batch/sequence axes flattened into M."""
    return x.reshape(-1, x.shape[-1]).contiguous()


def shared_activation_meta(x: torch.Tensor, *ws
                           ) -> Optional[ActivationMeta]:
    """The Sparse.A metadata of ``x``, built once for the leaves ``ws``
    that all multiply it (``griffin_linear(x, w, meta=...)``), when the
    current scope sends one of them, a dense leaf, through Sparse.A; else
    None.  The metadata is a pure function of ``x``, so sharing it changes
    no bit of any output (the reference gets the sharing from XLA under
    ``jit``)."""
    ctx = _EXEC_STACK[-1]
    if not _mode_a(ctx) or all(isinstance(w, GriffinWeights) for w in ws):
        return None
    return compact_activations(_rows(x), block_m=ctx.block_m)


def griffin_linear(x: torch.Tensor, w,
                   meta: Optional[ActivationMeta] = None) -> torch.Tensor:
    """The weight GEMM of the model stack: ``x @ w`` morphed per call.

      GriffinWeights    -> griffin_spmm kernel (Sparse.B); dual when the
                           scope declares sparse activations (Sparse.AB)
      dense w           -> plain ``x @ w``, unless the scope sets
                           ``use_kernels``; then the sparse_a kernel
                           (runtime-compacted A) when it declares sparse
                           activations (Sparse.A), else dense_gemm
      a weight shard    -> the same kernel's shard entry on this rank's
                           columns, gathered over the scope's mesh

    Leading batch/sequence axes are flattened into the GEMM M axis.
    ``meta``: the Sparse.A metadata of ``x`` from
    :func:`shared_activation_meta`, used only where the leaf takes
    Sparse.A (None: built here).  The kernels have no backward, as in the
    reference: a kernel route raises where a gradient is wanted (grad
    mode on and ``x`` or the weight requiring grad), so a training step
    can never drop one; training takes the plain route.
    """
    ctx = _EXEC_STACK[-1]
    mesh = ctx.spmd_mesh
    spmd = mesh is not None and mesh.size > 1
    shard = isinstance(w, (GriffinShard, DenseShard))
    if shard and not spmd:
        raise ValueError("a weight shard needs its serving mesh in scope "
                         "(sparse_execution(spmd_mesh=...))")
    if isinstance(w, GriffinWeights) or ctx.use_kernels or shard:
        _no_grad_wanted(x, w)
    lead = x.shape[:-1]
    x2 = _rows(x)
    if isinstance(w, GriffinWeights):
        thr = w.a_thr if w.a_thr is not None else ctx.a_threshold
        dual = select_mode(ctx.a_sparsity, 1.0, threshold=thr) == Mode.AB
        if dual:
            _dispatched("dual")
        oracle = spmd and not ctx.spmd_kernels
        if shard:
            _dispatched("spmd_oracle" if oracle else "shard")
            local = dataclasses.replace(w, n=w.b_comp.shape[-1])
            out = _gather_cols(griffin_spmm_ref(x2, local) if oracle else
                               griffin_matmul_shard(x2, w, dual=dual), mesh)
            if w.gather_inv is not None:
                out = out.index_select(1, w.gather_inv)
            out = out[:, :w.n]
        elif oracle:
            _dispatched("spmd_oracle")
            out = griffin_spmm_ref(x2, w)
        else:
            _dispatched("replicated" if spmd else "kernel")
            out = griffin_matmul(x2, w, dual=dual)
        return out.reshape(*lead, w.n).to(x.dtype)
    if not ctx.use_kernels:
        _dispatched("plain")
        # promoted to the wider dtype, as jnp does (fp32 A, bf16 weight)
        dt = torch.promote_types(x.dtype, w.dtype)
        if shard:
            out = _gather_cols(x2.to(dt) @ w.local.to(dt), mesh)
            return out.reshape(*lead, w.n)
        return x.to(dt) @ w.to(dt)
    if spmd and not ctx.spmd_kernels:
        _dispatched("spmd_oracle")
        out = dense_matmul_ref(x2, w.local) if shard else \
            dense_matmul_ref(x2, w)
        if shard:
            out = _gather_cols(out, mesh)
    elif shard:
        _dispatched("shard")
        out = _gather_cols(
            sparse_a_matmul_shard(x2, w, block_m=ctx.block_m, meta=meta)
            if _mode_a(ctx) else dense_matmul_shard(x2, w), mesh)
    else:
        _dispatched("replicated" if spmd else "kernel")
        if _mode_a(ctx):
            out = sparse_a_matmul(x2, w, block_m=ctx.block_m, meta=meta)
        else:
            out = dense_matmul(x2, w)
    return out.reshape(*lead, w.shape[-1]).to(x.dtype)


def _gather_cols(local: torch.Tensor, mesh) -> torch.Tensor:
    """(M, S x n) from every model rank's (M, n) columns, in rank order:
    the one collective of a sharded GEMM (``Mesh.gather``)."""
    g = mesh.gather(local, "model", "gemm")             # (S, M, n)
    return g.permute(1, 0, 2).reshape(local.shape[0], -1)


def head_share(local: int, whole: int) -> Optional[slice]:
    """The heads a decode step computes when its arena holds ``local`` of
    a layer's ``whole`` heads: None where it holds them all, else the
    share a rank of the scope's serving mesh holds under the arena's
    decode layout (``runtime.sharding.model_share``), ``[m local, (m + 1)
    local)`` at the rank's model coordinate m.  Heads are batch-like in
    every per-head product, so a share computes its heads' bits as the
    whole does."""
    if local == whole:
        return None
    mesh = _EXEC_STACK[-1].spmd_mesh
    if mesh is None or local * mesh.model != whole:
        raise ValueError(f"an arena of {local} of {whole} heads needs the "
                         "serving mesh whose model ranks split them in "
                         "scope (sparse_execution(spmd_mesh=...))")
    m = mesh.index("model")
    return slice(m * local, (m + 1) * local)


def take_heads(t, heads: Optional[slice], dim: int):
    """``t``'s ``heads`` (:func:`head_share`) along ``dim``: ``t`` itself
    where ``heads`` is None."""
    if heads is None:
        return t
    return t.narrow(dim, heads.start, heads.stop - heads.start)


def gather_heads(o: torch.Tensor, dim: int) -> torch.Tensor:
    """Every model rank's heads of ``o`` along ``dim``, in rank order:
    the whole heads a share (:func:`head_share`) computed part of, over
    the scope's mesh (one ``Mesh.gather``)."""
    g = _EXEC_STACK[-1].spmd_mesh.gather(o, "model", "heads")
    return torch.cat(g.unbind(0), dim=dim)


def _no_grad_wanted(x: torch.Tensor, w) -> None:
    ws = [w.b_comp] if isinstance(w, GriffinWeights) else \
        [w.local] if isinstance(w, DenseShard) else [w]
    if torch.is_grad_enabled() and any(t.requires_grad for t in [x] + ws):
        raise RuntimeError(
            "griffin_linear: the kernels have no backward (as in the "
            "reference); a gradient is wanted here, so run the GEMM outside "
            "a kernel scope on dense weights")


# ---------------------------------------------------------------------------
# training: rematerialisation and per-layer views
# ---------------------------------------------------------------------------

# the weight GEMMs the "dots" policy saves: the reference's
# dots_with_no_batch_dims_saveable (attention's products are not matmuls
# here, and the experts' batched einsum is a batched dot, which it does not
# save either)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_fn(cfg, body: Callable) -> Callable:
    """``body`` under the configured rematerialisation (the reference's
    ``remat_fn``): with ``cfg.remat`` its activations are recomputed in
    the backward pass (``torch.utils.checkpoint``, non-reentrant), policy
    ``"dots"`` keeping the weight GEMMs' outputs.  The policy changes what
    is saved, never a value.  Only where a gradient can be wanted (grad
    mode on); else ``body`` runs as it is."""
    if not cfg.remat:
        return body

    def run(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        from torch.utils.checkpoint import (
            checkpoint, create_selective_checkpoint_contexts)
        kw = {}
        if cfg.remat_policy == "dots":
            kw["context_fn"] = lambda: \
                create_selective_checkpoint_contexts(_dots_policy)
        return checkpoint(body, *args, use_reentrant=False, **kw)

    return run


def unstack(stack: Any) -> list:
    """The per-layer views of a stacked (nested) parameter dict: one dict
    per index of the leading axis.  Each tensor leaf is split by one
    ``unbind``, so a gradient reaches the stacked leaf through a single
    node (indexing per layer would make one full-size gradient a layer);
    compacted leaves are indexed."""
    if isinstance(stack, dict):
        parts = {k: unstack(v) for k, v in stack.items()}
        n = len(next(iter(parts.values()))) if parts else 0
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    if isinstance(stack, GriffinWeights):
        return [stack[i] for i in range(stack.b_comp.shape[0])]
    return list(stack.unbind(0))


# ---------------------------------------------------------------------------
# batch-invariant building blocks
# ---------------------------------------------------------------------------

def tree_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` by a fixed pairwise tree of elementwise adds (the
    axis zero-padded to a power of two), so each output's summation order
    depends only on the length of ``dim`` — never on the other axes or the
    device's thread layout."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = F.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def dense_init(gen: torch.Generator, shape, in_dim: int, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """A normal draw from ``gen`` on its device, times ``scale`` (default
    1 / sqrt(in_dim)), in ``dtype`` (the reference's ``dense_init``
    scheme; the draws themselves differ from ``jax.random``'s)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(dtype)


@dataclasses.dataclass(frozen=True)
class Draw:
    """One leaf of a parameter tree drawn slice by slice: ``path`` names it
    in the tree, ``lead`` its stacked axes (layers, experts) and ``shape``
    each slice's matrix, a normal draw times ``scale`` (default 1 /
    sqrt(fan-in), the matrix's first axis), or zeros with ``zeros``.  A
    list of them is a draw order: :func:`init_from_draws` makes the tree
    from it, and ``sparsity.init_sparse_params`` makes the same draws in
    the same order and compacts each slice before it draws the next."""

    path: Tuple[str, ...]
    lead: Tuple[int, ...]
    shape: Tuple[int, ...]
    scale: Optional[float] = None
    zeros: bool = False

    def slices(self, gen: torch.Generator, dtype: torch.dtype):
        """(index, slice) over the leading axes in row-major order, each
        slice drawn from ``gen`` when it is needed."""
        for idx in itertools.product(*(range(n) for n in self.lead)):
            if self.zeros:
                yield idx, torch.zeros(self.shape, dtype=dtype,
                                       device=gen.device)
            else:
                yield idx, dense_init(gen, self.shape, self.shape[0], dtype,
                                      scale=self.scale)

    def draw(self, gen: torch.Generator, dtype: torch.dtype) -> torch.Tensor:
        """The whole leaf, allocated once and filled slice by slice, so no
        more than one slice's fp32 draw is held beside it."""
        leaf = torch.empty(self.lead + tuple(self.shape), dtype=dtype,
                           device=gen.device)
        for idx, w in self.slices(gen, dtype):
            leaf[idx] = w
        return leaf


def set_path(tree: Dict[str, Any], path: Tuple[str, ...], leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def init_from_draws(draws, gen: torch.Generator, dtype: torch.dtype
                    ) -> Dict[str, Any]:
    """The parameter tree of a draw order (:meth:`Draw.draw` each leaf)."""
    tree: Dict[str, Any] = {}
    for d in draws:
        set_path(tree, d.path, d.draw(gen, dtype))
    return tree


def _stack_trees(layers):
    """Stack the leaves of equally shaped (nested) dicts of tensors along a
    new leading axis.  Each leaf is popped from the layers as it is
    stacked, so at most one leaf is held twice (recurrentgemma-9b's
    groups are 16 GB of bf16)."""
    if isinstance(layers[0], dict):
        return {k: _stack_trees([lp.pop(k) for lp in layers])
                for k in list(layers[0])}
    return torch.stack(layers)


def stack_layers(init_one: Callable[[torch.Generator], Dict[str, Any]],
                 gen: torch.Generator, n: int) -> Dict[str, Any]:
    """Initialise ``n`` layers from ``gen`` in turn and stack each leaf
    along a new leading axis (the reference's ``stack_layers``; nesting it
    gives the xlstm family's (groups, blocks) stacks; a layer may be a
    nested dict, as the hybrid family's groups are).  ``n == 0`` gives
    empty-stacked leaves (the reduced hybrid's empty tail): one layer is
    drawn from a throwaway generator for its shapes, so ``gen``'s stream
    is not consumed."""
    if n < 0:
        raise ValueError(f"stack_layers needs n >= 0 layers, got {n}")
    if n == 0:
        return _empty_stack(init_one(
            torch.Generator(device=gen.device).manual_seed(0)))
    return _stack_trees([init_one(gen) for _ in range(n)])


def _empty_stack(tree):
    if isinstance(tree, dict):
        return {k: _empty_stack(v) for k, v in tree.items()}
    return tree.new_empty((0,) + tuple(tree.shape))


def stack_slice(stack: Dict[str, Any], *idx: int) -> Dict[str, Any]:
    """One layer's leaves of a stacked parameter dict: ``idx`` indexes the
    leading axes, e.g. (group, block) of an xlstm stack.  Compacted leaves
    slice the same way (``GriffinWeights.__getitem__``)."""
    return {name: leaf[idx] for name, leaf in stack.items()}


def write_kv_slot(cache: torch.Tensor, update: torch.Tensor,
                  slot: torch.Tensor) -> None:
    """Write a one-token K/V update into a (B, S, ...) cache at ``slot``,
    in place (the reference returns an updated copy).  ``slot`` is a scalar
    or a (B,) vector of per-row indices.  ``update``: (B, 1, ...)."""
    B = cache.shape[0]
    rows = torch.arange(B, device=cache.device)
    cache[rows, slot.long().expand(B)] = update[:, 0].to(cache.dtype)


def paged_slot(pages: torch.Tensor, pos: torch.Tensor, page_size: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where each row of a paged pool writes position ``pos``: the
    (physical page, offset) pair, both (B,) int64.  ``pages``: (B,
    max_pages) page table; ``pos``: scalar or (B,).  Positions wrap at
    ``max_pages * page_size``, so dead rows, whose positions keep
    advancing, stay in range; their table rows point at the DUMP page,
    which is never read.  Computed once per decode step and shared by
    every layer's K and V writes."""
    B, maxp = pages.shape
    slot = pos.long().expand(B) % (maxp * page_size)
    pid = pages.gather(1, (slot // page_size)[:, None])[:, 0].long()
    return pid, slot % page_size


def paged_write(pool: torch.Tensor, scale: Optional[torch.Tensor],
                slot: Tuple[torch.Tensor, torch.Tensor],
                update: torch.Tensor, heads: Optional[slice] = None
                ) -> None:
    """Write a one-token K/V update into a paged pool, in place (the
    reference's ``paged_write`` returns an updated copy).  ``pool``:
    (num_pages, page_size, ...); ``slot``: :func:`paged_slot`'s (page,
    offset) pair; ``update``: (B, 1, heads, hd).  With ``scale``
    (num_pages, page_size) the pool is int8: each row is quantized on the
    way in (``optim.compression.quantize_rows``) and its scale stored
    beside.  ``heads`` (:func:`head_share`): the pool holds those heads of
    the update; an int8 row's scale is still taken over all of them."""
    row = update[:, 0]
    if scale is None:
        pool[slot] = take_heads(row, heads, 1).to(pool.dtype)
        return
    q, s = quantize_rows(row, 1)
    pool[slot] = take_heads(q, heads, 1)
    scale[slot] = s


def paged_view(pool: torch.Tensor, scale: Optional[torch.Tensor],
               pages: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Gather each row's pages into a (B, max_pages * page_size, ...) view
    in ``dtype``: exactly the fixed arena's (B, cache_len, ...) shape, so
    ``decode_attention`` sees the same shapes and masks, and same-dtype
    paged decode equals the fixed arena bit for bit (masked entries add
    exact zeros).  int8 pools dequantize in fp32 through the per-token
    ``scale`` before the cast.  ``pages`` is an int64 (B, max_pages)
    table."""
    v = pool[pages]                      # (B, max_pages, page_size, ...)
    if scale is not None:
        v = dequantize_rows(v, scale[pages])
    return v.reshape(v.shape[0], -1, *v.shape[3:]).to(dtype)


def length_mask(lengths: torch.Tensor, seq_len: int) -> torch.Tensor:
    """(B,) true prompt lengths -> (B, S) bool validity mask."""
    return torch.arange(seq_len, device=lengths.device)[None, :] < \
        lengths[:, None]


def take_last(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-row last valid timestep of a right-padded (B, S, D) tensor."""
    rows = torch.arange(x.shape[0], device=x.device)
    return x[rows, (lengths - 1).long()]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    ms = tree_sum(x * x) / x.shape[-1]
    x = x * torch.rsqrt(ms + eps)[..., None]
    return (x * (1.0 + scale.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
         ) -> torch.Tensor:
    """Rotary embedding.  x: (..., seq, heads, head_dim), positions: (seq,)
    or broadcastable to (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    expo = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(1.0 / theta, expo)
    ang = positions.float()[..., None] * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {"silu": F.silu, "relu": F.relu,
            "gelu": lambda t: F.gelu(t, approximate="tanh"),
            "gelu_tanh": lambda t: F.gelu(t, approximate="tanh"),
            }[name]
