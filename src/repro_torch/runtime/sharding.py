"""The serving layout on a ("data", "model") mesh — the counterpart of
``repro/runtime/sharding.py``'s serving half.

A spec is a tuple with one entry per tensor axis: None (whole), a mesh
axis name, or a tuple of them (the data-parallel axes, where there are
several); ``()`` is a replicated leaf of rank <= 1, as the reference's
``P()``.  Specs are
computed by the reference's rules, path strings included (``"['layers']
['wq']"``, a compacted leaf's fields ``"['layers']['wq'].b_comp"``), so
they can be held against it leaf for leaf.

The serving layout shards output axes only: every GEMM weight puts its last
(output) axis on "model", embeddings their vocab axis, and no contraction
axis is ever split, so no reduction's order depends on the mesh.  The
arena's layout (:func:`cache_spec` with ``decode=True``) puts the slot axis
on the data axes and head axes on "model".

What a rank holds (:func:`shard_params`): the spec is applied to the leaves
that the models multiply through ``models.common.griffin_linear`` (the
weight GEMMs, ``APPLIED``): a compacted leaf becomes a ``GriffinShard`` of
its N tiles, a dense one a ``DenseShard`` of its columns; a leaf whose
split is uneven stays whole and runs the whole kernel on every model rank.
A tied embedding stays whole for the lookup, and its head (``embed.T``)
reads the rank's vocab rows in place (:class:`TiedEmbed`).  Other leaves
(norms, convolutions, per-head mats, the gates the recurrent blocks widen
first, the MoE router) stay whole.  The arena takes its decode layout:
each data row allocates its own contiguous run of slots (:func:`slot_home`;
a paged row its own pool beside the page table of its slots), and a leaf
whose spec puts an axis on "model" (the KV heads, the heads of recurrent
states) holds the rank's share of that axis (:func:`model_share`), every
other leaf whole.  The training layout (``fsdp=True``) is ROADMAP 1.18.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels.dense_gemm import ops as dense_ops
from ..kernels.dense_gemm.ops import DenseShard
from ..kernels.griffin_spmm import ops as spmm_ops
from ..kernels.griffin_spmm.ops import GriffinShard, GriffinWeights
from ..sparsity.pruning import GEMM_WEIGHTS

# parameter-name classification (the reference's)
_IN_OUT = ("wq", "wk", "wv", "w_gate", "w_up", "w_ff1", "w_x", "router",
           "head", "w_rg", "w_ig", "wz", "wi", "wf", "wo_gate")
_OUT_IN = ("wo", "w_down", "w_ff2", "w_out")
_REPLICATE = ("ln", "ln1", "ln2", "ln_x", "gn", "final_norm", "enc_norm",
              "lam", "qn", "kn")
# compacted-weight fields that always replicate: kidx holds global K-block
# ids and the metadata is tiny
_GRIFFIN_META = ("kidx", "cnt", "inv_perm")

# the leaves a rank holds a share of: the weight GEMMs griffin_linear runs
APPLIED = GEMM_WEIGHTS + ("w_x", "w_out")
# subtrees whose wq/wk/wv are per-head block-diagonal mats, not GEMMs
_BLOCKDIAG_PARENTS = ("m_blocks",)

Spec = Tuple[Any, ...]


def _training_layout() -> NotImplementedError:
    return NotImplementedError("the training layout (fsdp, expert "
                               "parallelism) is not ported yet (ROADMAP "
                               "1.18); the serving layout is fsdp=False")


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _dp_entry(mesh):
    """The spec entry of the data axes: the axis name where there is one
    (as ``PartitionSpec`` normalizes a 1-tuple), else the tuple."""
    dp = dp_axes(mesh)
    return dp[0] if len(dp) == 1 else dp


def _divides(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        out = 1
        for a in name:
            out *= mesh.shape[a]
        return out
    return mesh.shape[name]


def _name(path: str) -> str:
    return path.rstrip("']").split("'")[-1] if "'" in path else path


def param_spec(path: str, leaf, mesh, fsdp: bool = False) -> Spec:
    """The serving spec of one parameter leaf (``leaf`` anything with a
    ``.shape``), by trailing name and rank, as the reference's
    ``param_spec(serve=True)``: every GEMM weight's last (output) axis on
    "model", nothing on "data", embeddings on their vocab axis, compacted
    weights' ``b_comp`` on its padded N and their metadata whole.
    ``fsdp=True`` (the training layout) raises."""
    if fsdp:
        raise _training_layout()
    rank = len(leaf.shape)
    name = _name(path)
    child = name.rsplit(".", 1)[-1] if "." in name else ""
    if child in _GRIFFIN_META:
        return (None,) * rank
    if child == "b_comp":
        pname = _name(path[:path.rfind(".")])
        ax = "model" if pname in _IN_OUT + _OUT_IN else None
        return _checked((None,) * (rank - 1) + (ax,), leaf, mesh)
    if name in _REPLICATE or rank <= 1:
        return ()
    if name == "embed":
        spec = ("model", None)
    elif name == "conv":
        spec = (None, "model")
    elif name in ("rz", "ri", "rf", "ro") or (
            name in ("wq", "wk", "wv") and rank >= 3
            and leaf.shape[-1] == leaf.shape[-2]):
        spec = (None,) * (rank - 1) + ("model",)
    elif name in _IN_OUT or name in _OUT_IN:
        spec = (None,) * (rank - 1) + ("model",)
    else:
        spec = (None,) * rank
    return _checked(spec, leaf, mesh)


def _checked(spec: Spec, leaf, mesh) -> Spec:
    """Drop the axes whose dim the mesh axis does not divide."""
    out = []
    for dim, ax in zip(leaf.shape, spec):
        if ax is None:
            out.append(None)
            continue
        size = _axis_size(mesh, ax)
        out.append(ax if (dim >= size and dim % size == 0) else None)
    return tuple(out)


def cache_spec(path: str, leaf, mesh, batch: int, decode: bool = False,
               heads: int = 0, paged: frozenset = frozenset()) -> Spec:
    """The spec of one arena leaf, by the reference's rules.  ``decode``
    (the serving arena): the slot axis (the first of extent ``batch``) on
    the data axes, and the rightmost axis of extent ``heads`` before the
    last on "model"; paged pools put their page axis on the data axes and
    the page table stays whole.  Without ``decode`` (the long-context
    layout): the batch axis on the data axes, else the longest divisible
    one, and the longest remaining axis at least 8 x M wide on "model"."""
    dp = _dp_entry(mesh)
    dpn = _axis_size(mesh, dp_axes(mesh))
    mdl = mesh.shape.get("model", 1)
    shape = tuple(leaf.shape)
    spec: list = [None] * len(shape)
    if len(shape) == 0:
        return ()
    if paged and "'" in path:
        name = _name(path)
        if name == "pages":
            return tuple(spec)
        base = name[:-6] if name.endswith("_scale") else name
        if base in paged:
            if len(shape) >= 2 and _divides(shape[1], dpn):
                spec[1] = dp
            if decode and not name.endswith("_scale") and mdl > 1 \
                    and heads > 0 and _divides(heads, mdl):
                for i in range(len(shape) - 2, 1, -1):
                    if shape[i] == heads:
                        spec[i] = "model"
                        break
            return tuple(spec)
    placed_dp = None
    for i, d in enumerate(shape):
        if d == batch and _divides(d, dpn):
            spec[i] = dp
            placed_dp = i
            break
    if decode:
        if mdl > 1 and heads > 0 and _divides(heads, mdl):
            for i in range(len(shape) - 2, -1, -1):
                if i != placed_dp and shape[i] == heads:
                    spec[i] = "model"
                    break
        return tuple(spec)
    if placed_dp is None:
        cand = [(d, i) for i, d in enumerate(shape[:-1])
                if _divides(d, dpn) and d >= dpn]
        if cand:
            placed_dp = max(cand)[1]
            spec[placed_dp] = dp
    if mdl > 1:
        cand = [(d, i) for i, d in enumerate(shape)
                if i != placed_dp and spec[i] is None
                and _divides(d, mdl) and d >= 8 * mdl]
        if cand:
            spec[max(cand)[1]] = "model"
    return tuple(spec)


def model_axis(spec: Spec) -> Optional[int]:
    """The axis a spec puts on "model", or None."""
    return spec.index("model") if "model" in spec else None


def model_share(t: torch.Tensor, axis: Optional[int], mesh, *,
                offset: int = 0, extent: Optional[int] = None
                ) -> torch.Tensor:
    """This rank's share of an axis a spec puts on "model"
    (:func:`model_axis`): of the axis's extent n, the entries ``[m n / M,
    (m + 1) n / M)`` at the rank's model coordinate m of M, as a view of
    ``t``; ``t`` itself where ``axis`` is None.  ``t`` holds the entries
    ``[offset, offset + t.shape[axis])`` of an axis of ``extent`` (default:
    all of it), as the joined head shares of a smaller model axis do.  The
    arena allocates each leaf's share by it, an admission cuts the
    prefilled cache by it, and a remesh cuts a new share from old ones."""
    if axis is None:
        return t
    extent = t.shape[axis] if extent is None else extent
    n = extent // mesh.shape["model"]
    lo = mesh.index("model") * n - offset
    if lo < 0 or lo + n > t.shape[axis]:
        raise ValueError(f"share [{lo + offset}, {lo + offset + n}) is not "
                         f"within [{offset}, {offset + t.shape[axis]})")
    return t.narrow(axis, lo, n)


def spmm_shard_specs(axis: str = "model"):
    """``griffin_matmul_shard``'s operand specs (the kernel package's)."""
    return spmm_ops.shard_specs(axis)


def gemm_shard_specs(axis: str = "model"):
    """The dense-weight shard entries' operand specs."""
    from ..kernels.sparse_a.ops import shard_specs
    return shard_specs(axis)


def kernel_shardable(leaf, mesh, axis: str = "model") -> bool:
    """Whether this GEMM weight leaf (compacted, or a plain matrix) runs
    its kernel on shards over ``axis``: whole N tiles per shard for
    compacted weights, whole columns for dense ones (the reference's
    predicate)."""
    if axis not in mesh.axis_names:
        return False
    mp = mesh.shape[axis]
    if isinstance(leaf, GriffinWeights):
        return leaf.b_comp.dim() == 2 and spmm_ops.shardable(leaf, mp)
    return dense_ops.shardable(leaf, mp)


# ---------------------------------------------------------------------------
# applying the layout: one rank's share
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TiedEmbed:
    """A tied embedding on a rank of a serving mesh: the whole table for
    the token lookup (``embed[tokens]``), and its transpose, the tied head,
    as a ``DenseShard`` of the rank's vocab rows read in place
    (``embed.T``)."""

    table: torch.Tensor
    head: DenseShard

    def __getitem__(self, idx) -> torch.Tensor:
        return self.table[idx]

    @property
    def T(self) -> DenseShard:
        return self.head


def _cols(t: torch.Tensor, rank: int, shards: int) -> torch.Tensor:
    n = t.shape[-1] // shards
    return t[..., rank * n:(rank + 1) * n].contiguous()


def _griffin_share(gw: GriffinWeights, rank: int, shards: int
                   ) -> GriffinShard:
    tiles = gw.kidx.shape[-2]
    per = tiles // shards
    t0, t1 = rank * per, (rank + 1) * per
    return GriffinShard(
        b_comp=gw.b_comp[..., t0 * gw.block_n:t1 * gw.block_n].contiguous(),
        kidx=gw.kidx[..., t0:t1, :].contiguous(),
        cnt=gw.cnt[..., t0:t1].contiguous(), inv_perm=None, k=gw.k, n=gw.n,
        block_k=gw.block_k, block_n=gw.block_n, a_thr=gw.a_thr,
        gather_inv=(None if gw.inv_perm is None
                    else gw.inv_perm.long().contiguous()),
        n_tiles=tiles, shards=shards)


def _applied(path: Tuple[str, ...]) -> bool:
    name = path[-1] if path else ""
    blockdiag = name in ("wq", "wk", "wv") and \
        any(p in _BLOCKDIAG_PARENTS for p in path)
    return name in APPLIED and not blockdiag


def _keystr(path: Tuple[str, ...]) -> str:
    return "".join(f"['{k}']" for k in path)


def shard_params(params: Any, mesh, fsdp: bool = False) -> Any:
    """This rank's share of a parameter tree under the serving layout (see
    the module docstring): the shares are copies, so the caller may drop
    the whole tree after.  A mesh with one model rank returns the tree as
    it is.  ``fsdp=True`` (the training layout) raises."""
    if fsdp:
        raise _training_layout()
    shards = mesh.shape.get("model", 1)
    if shards == 1:
        return params
    rank = mesh.index("model")
    tied = isinstance(params, dict) and "embed" in params and \
        "head" not in params

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, path) for v in tree)
        key = _keystr(path)
        if isinstance(tree, GriffinWeights):
            spec = param_spec(key + ".b_comp", tree.b_comp, mesh)
            if _applied(path) and spec[-1] == "model" and \
                    spmm_ops.shardable(tree, shards):
                return _griffin_share(tree, rank, shards)
            return tree
        if not isinstance(tree, torch.Tensor):
            return tree
        if tied and path == ("embed",):
            if tree.shape[0] % shards:
                return tree
            rows = tree.shape[0] // shards
            head = tree[rank * rows:(rank + 1) * rows].T
            return TiedEmbed(tree, DenseShard(head, tree.shape[0], shards))
        if _applied(path) and tree.dim() >= 2 and \
                param_spec(key, tree, mesh)[-1:] == ("model",):
            return DenseShard(_cols(tree, rank, shards), tree.shape[-1],
                              shards)
        return tree

    return walk(params, ())


def param_specs(params: Any, mesh) -> Dict[str, Spec]:
    """The serving spec of every leaf of a parameter tree by its path (a
    compacted leaf's four tensor fields each under ``path.field``): the
    reference's ``shard_params(serve=True)`` as specs."""
    out: Dict[str, Spec] = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + f"['{k}']")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, path + f"[{i}]")
        elif isinstance(tree, GriffinWeights):
            for f in ("b_comp", "kidx", "cnt", "inv_perm"):
                t = getattr(tree, f)
                if t is not None:
                    out[f"{path}.{f}"] = param_spec(f"{path}.{f}", t, mesh)
        elif isinstance(tree, torch.Tensor):
            out[path] = param_spec(path, tree, mesh)

    walk(params, "")
    return out


def griffin_leaves(tree: Any) -> list:
    """The compacted leaves of a tree (shares included)."""
    if isinstance(tree, dict):
        return [g for v in tree.values() for g in griffin_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [g for v in tree for g in griffin_leaves(v)]
    return [tree] if isinstance(tree, GriffinWeights) else []


def sharded_leaves(tree: Any) -> int:
    """How many leaves of a rank's tree are shares (``DenseShard``,
    ``GriffinShard``, a ``TiedEmbed``'s head)."""
    if isinstance(tree, dict):
        return sum(sharded_leaves(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(sharded_leaves(v) for v in tree)
    return int(isinstance(tree, (DenseShard, GriffinShard, TiedEmbed)))


def slots_per_row(mesh, num_slots: int) -> int:
    """How many slots each data row decodes: the data axes split the slot
    axis into contiguous runs of ``num_slots / D``."""
    D = mesh.shape.get("data", 1)
    if num_slots % D:
        raise ValueError(f"{num_slots} slots do not split over {D} data "
                         "rows")
    return num_slots // D


def slot_home(mesh, num_slots: int, slot: int) -> Tuple[int, Optional[int]]:
    """(the data row whose arena holds global ``slot``, its row in this
    rank's arena, or None where another data row holds it)."""
    owner, row = divmod(slot, slots_per_row(mesh, num_slots))
    return owner, (row if owner == mesh.index("data") else None)


__all__ = ["APPLIED", "TiedEmbed", "cache_spec", "dp_axes",
           "gemm_shard_specs", "griffin_leaves", "kernel_shardable",
           "model_axis", "model_share", "param_spec", "param_specs",
           "shard_params", "sharded_leaves", "slot_home", "slots_per_row",
           "spmm_shard_specs"]

