"""Mesh serving in the port (``repro_torch.launch.mesh``,
``runtime.{elastic,sharding,mesh_serve}``, the kernels' shard entries):

* held against the JAX package function by function: ``plan_mesh_shape``,
  ``serve_mesh`` parsing, ``param_spec(serve=True)`` over every leaf of
  every family's reduced tree (dense and compacted, bridged leaf for
  leaf), ``cache_spec(decode=True)`` over every arena leaf (fixed and
  paged), the three ``shardable`` predicates and ``cache_heads``;
* the shard entries in one process: every rank's columns gathered (and
  the balance shuffle undone) equal the whole kernel's plain version, and
  the arguments each shard hands the C entry (plan, route, split) are the
  whole weight's at every leaf shape of the ten configs (the C entries
  stubbed, the tensors on the meta device);
* the arena's decode layout: each rank's arena, leaf by leaf, is the
  single-device arena cut to the reference's decode spec (its data row's
  slots, its share of the head axis) for every family on 1x2, 2x2 and
  2x4; one decode block on a rank's share of the KV heads (GQA), its
  attention gathered over the model ranks, equals the whole block bit
  for bit on the fixed, paged and int8-paged arenas, cache writes
  included;
* ranks under gloo on the host (``launch.mesh.run_ranks``, one torch
  thread each): ``MeshServeEngine`` against the port's unsharded engine on
  1x2, 2x1, 2x2 and 2x4 meshes (dense and compacted weights, chunk 1 and 3,
  the four Modes, the paged arena, the stepwise path, the oracle, four
  more families, the host-sync budget, a tuned plan), once on weights
  bridged from the JAX package against its ``ServeEngine``'s tokens; a
  rank that raises fails the run.

Every cell checks the tokens, the counters (``host_syncs`` among them),
the dispatch buckets (``shard``, never the oracle, unless the cell asks
for ``spmd_kernels=False``), that every rank's host-state digest is
equal, and that parameter leaves are really sharded.  Tolerances: the
plain versions are fp32 ``torch.matmul``, whose bits may depend on N, so
the shard entries' outputs are held within 1e-5 of the largest |output|;
tokens are held exactly.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.dense_gemm import ops as jax_dense_ops
from repro.kernels.griffin_spmm import ops as jax_spmm_ops
from repro.kernels.sparse_a import ops as jax_sparse_a_ops
from repro.models import build_model as jax_build_model
from repro.runtime import elastic as jax_elastic
from repro.runtime import sharding as jax_sharding
from repro.runtime.config import EngineConfig as JaxEngineConfig
from repro.runtime.engine import ServeEngine as JaxServeEngine
from repro.runtime.engine import synthetic_trace as jax_synthetic_trace
from repro.runtime.mesh_serve import _promoted_arena_shapes
from repro.runtime.mesh_serve import cache_heads as jax_cache_heads
from repro.runtime.paging import build_spec as jax_build_spec
from repro.runtime.paging import paged_tree as jax_paged_tree
from repro.sparsity import sparsify_params as jax_sparsify
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.dense_gemm import kernel as k1
from repro_torch.kernels.dense_gemm import ops as dense_ops
from repro_torch.kernels.dense_gemm.ops import (DenseShard, dense_matmul,
                                                dense_matmul_shard)
from repro_torch.kernels.griffin_spmm import kernel as k2
from repro_torch.kernels.griffin_spmm import ops as spmm_ops
from repro_torch.kernels.griffin_spmm.ops import (griffin_matmul,
                                                  griffin_matmul_shard,
                                                  preprocess_weights)
from repro_torch.kernels.sparse_a import kernel as k3
from repro_torch.kernels.sparse_a import ops as sparse_a_ops
from repro_torch.kernels.sparse_a.ops import (compact_activations,
                                              sparse_a_matmul,
                                              sparse_a_matmul_shard)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.runtime import elastic, sharding
from repro_torch.runtime.config import EngineConfig
from repro_torch.runtime.engine import (ServeEngine, _batch_axes,
                                        _promote_arena, synthetic_trace)
from repro_torch.runtime.mesh_serve import (MeshServeEngine, cache_heads,
                                            serve_shardings)
from repro_torch.runtime.paging import build_spec
from repro_torch.sparsity.pruning import block_prune
from repro_torch.tuning import FamilyPlan, GemmRule, KernelPlan
from torch_helpers import TwoPass

FAMILIES = ("llama3.2-1b", "mixtral-8x7b", "xlstm-1.3b", "recurrentgemma-9b",
            "whisper-large-v3", "chameleon-34b")
CONFIGS = ("llama3.2-1b", "stablelm-1.6b", "minitron-8b",
           "command-r-plus-104b", "chameleon-34b", "mixtral-8x7b",
           "llama4-scout-17b-a16e", "xlstm-1.3b", "recurrentgemma-9b",
           "whisper-large-v3")
PRUNE = dict(block_k=16, block_n=16, unit=8)
TOL = 1e-5              # relative to the largest |output| (fp32 plain)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _keystr(path) -> str:
    return jax.tree_util.keystr(path)


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


# ---------------------------------------------------------------------------
# held against the reference, function by function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(0, 17))
def test_plan_mesh_shape_matches_reference(n):
    for mp in range(0, 17):
        try:
            want = jax_elastic.plan_mesh_shape(n, mp)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e).split(",")[0]):
                elastic.plan_mesh_shape(n, mp)
            continue
        assert elastic.plan_mesh_shape(n, mp) == want, (n, mp)
        if n >= 1:
            planned = elastic.plan_mesh(n, mp)
            assert (planned.data, planned.model) == want
            assert planned.devices == list(range(want[0] * want[1]))
            assert planned.spec == f"{want[0]}x{want[1]}"


def test_plan_mesh_too_few_devices_and_surviving():
    with pytest.raises(ValueError, match="needs 4 devices"):
        elastic.plan_mesh(4, 2, devices=[0, 1, 2])
    assert elastic.surviving([0, 1, 2, 3], [1, 3]) == [0, 2]
    devs = [torch.device("cuda", i) for i in range(4)]
    assert elastic.surviving(devs, [0]) == devs[1:]


@pytest.mark.parametrize("bad", ["", "2", "2x", "x2", "ax2", "0x1",
                                 "2x2x2", "1x0"])
def test_serve_mesh_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError) as ours:
        tmesh.serve_mesh(bad)
    with pytest.raises(ValueError) as ref:
        from repro.launch.mesh import serve_mesh as jax_serve_mesh
        jax_serve_mesh(bad)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("spec", ["1x1", "2x2", "1x4", "4x1", "2x8"])
def test_serve_mesh_and_mesh_spec_are_inverse(spec):
    m = tmesh.serve_mesh(spec)
    assert m.axis_names == ("data", "model")
    assert tmesh.mesh_spec(m) == spec
    assert tmesh.chips(m) == m.size == int(spec[0]) * int(spec[2:])


_REF_TREES: dict = {}


def _ref_tree(arch: str, compact: bool):
    """The reference's reduced tree of ``arch``, pruned 0.6 and compacted
    with ``compact`` (16/16, unit 8), memoized."""
    key = (arch, compact)
    if key not in _REF_TREES:
        api = jax_build_model(jax_get_config(arch).reduced())
        params = api.init(jax.random.PRNGKey(0))
        if compact:
            params = jax_sparsify(params, 0.6, **PRUNE)
        _REF_TREES[key] = params
    return _REF_TREES[key]


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)],
                         ids=["2x2", "1x4", "4x1"])
@pytest.mark.parametrize("compact", [False, True],
                         ids=["dense", "compacted"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_param_spec_matches_reference(arch, compact, shape):
    """Every leaf of the reduced tree, dense and compacted (each compacted
    leaf's four fields), gets the reference's serving spec; the port's
    tree is the reference's, bridged."""
    jp = _ref_tree(arch, compact)
    mesh = tmesh.Mesh(*shape)
    want = {_keystr(p): tuple(jax_sharding.param_spec(
        _keystr(p), leaf, mesh, fsdp=False, serve=True))
        for p, leaf in _flat(jp)}
    got = sharding.param_specs(bridge.to_torch(jax.tree.map(np.asarray, jp)),
                               mesh)
    assert got == want
    if shape[1] > 1:
        assert any("model" in s for s in got.values())


def test_param_spec_serving_rules():
    """The reference's expected serving table (its tier-1 layout test):
    output axes only, embeddings on vocab, metadata whole; the training
    layout is ROADMAP 1.18."""
    mesh = tmesh.Mesh(2, 2)
    leaf = types.SimpleNamespace
    assert sharding.param_spec("['layers']['wq']", leaf(shape=(4, 64, 128)),
                               mesh) == (None, None, "model")
    assert sharding.param_spec("['layers']['wo']", leaf(shape=(4, 128, 64)),
                               mesh) == (None, None, "model")
    assert sharding.param_spec("['embed']", leaf(shape=(1000, 64)),
                               mesh) == ("model", None)
    assert sharding.param_spec("['ln1']", leaf(shape=(64,)), mesh) == ()
    for f in ("kidx", "cnt", "inv_perm"):
        assert sharding.param_spec(f"['layers']['wq'].{f}",
                                   leaf(shape=(8, 4)), mesh) == (None, None)
    assert sharding.param_spec("['layers']['wo'].b_comp",
                               leaf(shape=(64, 128)), mesh) == (None, "model")
    with pytest.raises(NotImplementedError, match="1.18"):
        sharding.param_spec("['wq']", leaf(shape=(64, 64)), mesh, fsdp=True)
    with pytest.raises(NotImplementedError, match="1.18"):
        sharding.shard_params({}, mesh, fsdp=True)


def test_cache_spec_decode_rules():
    """The reference's expected arena table: slots on "data", heads on
    "model", the last axis whole, a coincidental head-sized axis loses to
    the rightmost one."""
    mesh = tmesh.Mesh(2, 2)
    kv = types.SimpleNamespace(shape=(2, 4, 31, 4, 16))
    spec = sharding.cache_spec("['k']", kv, mesh, batch=4, decode=True,
                               heads=4)
    assert spec[1] == "data" and spec[3] == "model" and spec[4] is None
    assert sharding.cache_spec("['pos']", types.SimpleNamespace(shape=(4,)),
                               mesh, batch=4, decode=True,
                               heads=4)[0] == "data"
    assert sharding.cache_spec("['k']", kv, mesh, batch=4, decode=True,
                               heads=3)[3] is None
    eq = types.SimpleNamespace(shape=(2, 4, 8, 8, 16))
    spec_eq = sharding.cache_spec("['k']", eq, mesh, batch=4, decode=True,
                                  heads=8)
    assert spec_eq[3] == "model" and spec_eq[2] is None


def test_model_share_cuts_whole_and_joined_shares():
    """``model_share``: a rank's share of an axis, as a view, from the
    whole axis or from old shares joined along it (a remesh onto fewer
    model ranks), and a refusal where the joined part does not hold the
    share."""
    t = torch.arange(2 * 8 * 3).reshape(2, 8, 3)
    mesh = tmesh.Mesh(1, 4, rank=2)                  # heads [4, 6)
    got = sharding.model_share(t, 1, mesh)
    assert torch.equal(got, t[:, 4:6]) and got.data_ptr() == t[:, 4].data_ptr()
    assert sharding.model_share(t, None, mesh) is t
    joined = t[:, 4:8]                                # old shares 1 of 2
    assert torch.equal(sharding.model_share(joined, 1, mesh, offset=4,
                                            extent=8), t[:, 4:6])
    with pytest.raises(ValueError, match="not within"):
        sharding.model_share(t[:, 0:4], 1, mesh, offset=0, extent=8)


@pytest.mark.parametrize("paged", [None, 4], ids=["fixed", "paged"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_cache_spec_matches_reference(arch, paged):
    """Every leaf of the engine's arena (promoted counters; pools and page
    table when paged) gets the reference's decode spec on a 2x2 mesh, and
    ``cache_heads`` is the reference's."""
    mesh = tmesh.Mesh(2, 2)
    japi = jax_build_model(jax_get_config(arch).reduced())
    jspec, jlen = jax_build_spec(japi, 4, 24, paged)
    arena = _promoted_arena_shapes(japi, 4, jlen)
    pset = frozenset()
    if jspec is not None:
        arena = jax_paged_tree(arena, 4, jspec)
        pset = frozenset(jspec.paged_keys)
    want = {_keystr(p)[2:-2]: tuple(jax_sharding.cache_spec(
        _keystr(p), leaf, mesh, 4, decode=True,
        heads=jax_cache_heads(japi), paged=pset))
        for p, leaf in _flat(arena)}
    api = build_model(get_config(arch).reduced(), device="cpu")
    tspec, tlen = build_spec(api, 4, 24, paged)
    assert tlen == jlen
    assert cache_heads(api) == jax_cache_heads(japi)
    assert serve_shardings(api, mesh, 4, tlen, paged=tspec) == want


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_shardable_predicates_match_reference(shards):
    rng = np.random.default_rng(shards)
    mesh = tmesh.Mesh(1, shards)
    jmesh = types.SimpleNamespace(shape={"data": 1, "model": shards},
                                  axis_names=("data", "model"))
    for k, n in ((64, 96), (64, 64), (48, 40), (32, 128)):
        w = rng.standard_normal((k, n)).astype(np.float32)
        wp = np.asarray(block_prune(torch.from_numpy(w), 0.6, 16, 8))
        jgw = jax_spmm_ops.preprocess_weights(wp, **PRUNE)
        gw = bridge.to_torch(jgw)
        tw = torch.from_numpy(w)
        assert spmm_ops.shardable(gw, shards) == \
            jax_spmm_ops.shardable(jgw, shards)
        assert dense_ops.shardable(tw, shards) == \
            jax_dense_ops.shardable(w, shards)
        assert sparse_a_ops.shardable(tw, shards) == \
            jax_sparse_a_ops.shardable(w, shards)
        assert sharding.kernel_shardable(gw, mesh) == \
            jax_sharding.kernel_shardable(jgw, jmesh)
        assert sharding.kernel_shardable(tw, mesh) == \
            jax_sharding.kernel_shardable(w, jmesh)
    assert sharding.spmm_shard_specs() == tuple(
        tuple(tuple(p) for p in x) if isinstance(x, tuple) else tuple(x)
        for x in jax_sharding.spmm_shard_specs())
    assert sharding.gemm_shard_specs() == tuple(
        tuple(tuple(p) for p in x) if isinstance(x, tuple) else tuple(x)
        for x in jax_sharding.gemm_shard_specs())


# ---------------------------------------------------------------------------
# the shard entries, one process
# ---------------------------------------------------------------------------

def _close(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = float(want.abs().max()) or 1.0
    assert float((got - want).abs().max()) <= TOL * scale


def _a(rng, m: int, k: int) -> torch.Tensor:
    a = rng.standard_normal((m, k)).astype(np.float32)
    a[:, 16:32] = 0                      # a dead K block for Sparse.A/AB
    return torch.from_numpy(a)


@pytest.mark.parametrize("dual", [False, True], ids=["B", "AB"])
@pytest.mark.parametrize("balance", [False, True],
                         ids=["unbalanced", "balanced"])
@pytest.mark.parametrize("shards", [2, 4])
def test_griffin_shards_gather_to_the_whole_product(shards, balance, dual):
    rng = np.random.default_rng(shards)
    w = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    gw = preprocess_weights(block_prune(w, 0.6, 16, 8), balance=balance,
                            **PRUNE)
    assert (gw.inv_perm is not None) == balance
    a = _a(rng, 5, 64)
    parts = [griffin_matmul_shard(a, sharding._griffin_share(gw, r, shards),
                                  dual=dual) for r in range(shards)]
    out = torch.cat(parts, dim=1)
    if gw.inv_perm is not None:
        out = out.index_select(1, gw.inv_perm.long())
    _close(out[:, :gw.n], griffin_matmul(a, gw, dual=dual))
    with pytest.raises(TypeError, match="griffin_matmul_shard"):
        griffin_matmul(a, sharding._griffin_share(gw, 0, shards))


@pytest.mark.parametrize("shards", [2, 4])
def test_sparse_a_and_dense_shards_gather_to_the_whole_product(shards):
    rng = np.random.default_rng(10 + shards)
    w = torch.from_numpy(rng.standard_normal((64, 96)).astype(np.float32))
    a = _a(rng, 7, 64)
    meta = compact_activations(a, block_m=4, block_k=16)
    per = 96 // shards
    cols = [DenseShard(w[:, r * per:(r + 1) * per].contiguous(), 96, shards)
            for r in range(shards)]
    _close(torch.cat([sparse_a_matmul_shard(a, c, block_m=4, block_k=16,
                                            meta=meta) for c in cols], 1),
           sparse_a_matmul(a, w, block_m=4, block_k=16, meta=meta))
    _close(torch.cat([dense_matmul_shard(a, c) for c in cols], 1),
           dense_matmul(a, w))
    # the tied head: each rank's vocab rows of the table, read as embed.T
    emb = torch.from_numpy(rng.standard_normal((96, 64)).astype(np.float32))
    heads = [DenseShard(emb[r * per:(r + 1) * per].T, 96, shards)
             for r in range(shards)]
    _close(torch.cat([dense_matmul_shard(a, h) for h in heads], 1),
           dense_matmul(a, emb.T))
    _close(torch.cat([sparse_a_matmul_shard(a, h, block_m=4, block_k=16)
                      for h in heads], 1),
           sparse_a_matmul(a, emb.T, block_m=4, block_k=16))
    with pytest.raises(ValueError, match="shard"):
        dense_matmul_shard(a, DenseShard(w, 96, shards))


_SHAPES: dict = {}


def _leaf_shapes(arch: str):
    """The (K, N) of every weight GEMM leaf a rank shards at full width
    (``sharding.APPLIED``), from the reference's abstract init, and the
    tied head's (V, D) table when the config ties it."""
    if arch not in _SHAPES:
        api = jax_build_model(jax_get_config(arch))
        tree = jax.eval_shape(api.init, jax.random.PRNGKey(0))
        mats = set()
        for p, leaf in _flat(tree):
            keys = [getattr(k, "key", None) for k in p]
            if keys and sharding._applied(tuple(keys)) and \
                    len(leaf.shape) >= 2:
                mats.add(tuple(leaf.shape[-2:]))
        tied = "embed" in tree and "head" not in tree
        _SHAPES[arch] = (sorted(mats),
                         tuple(tree["embed"].shape) if tied else None)
    return _SHAPES[arch]


class _Stub:
    """Stands in for a kernel's C entry: records the arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def stubbed(monkeypatch):
    """The three C entries stubbed and the stream faked, so a launch's
    arguments can be read on the host (meta tensors: no memory)."""
    stubs = {"k1": _Stub(), "k2": _Stub(), "k3": _Stub()}
    monkeypatch.setattr(k1, "_fn", lambda: stubs["k1"])
    monkeypatch.setattr(k2, "_fn", lambda: stubs["k2"])
    monkeypatch.setattr(k3, "_fn", lambda symbol, argtypes: stubs["k3"])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    counts = kbuild.launch_counts()
    yield stubs
    for name, n in counts.items():
        kbuild._LAUNCHES[name] = n


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("arch", CONFIGS)
def test_shards_launch_with_the_whole_weights_plan(arch, stubbed):
    """At every GEMM leaf shape of the config at full width (128 x 128
    blocks; grid depths 1, a quarter and all K blocks) and 2 and 4
    shards: K2's shard launches with the whole weight's split, or with
    none (the CUDA-core route) where the whole weight's tensor-core block
    would not fit; K3's shard with the whole weight's route and split
    (row-major weights, and the tied head read as embed.T); K1's with the
    whole weight's route."""
    mats, table = _leaf_shapes(arch)
    bk = bn = 128
    for k, n in mats:
        tiles, nbk = -(-n // bn), -(-k // bk)
        for depth in sorted({1, max(1, nbk // 4), nbk}):
            for m, dtype in ((4, torch.bfloat16), (32, torch.bfloat16),
                             (4, torch.float32)):
                a = _meta(m, k, dtype=dtype)
                k2.griffin_spmm(a, _meta(depth * bk, tiles * bn),
                                _meta(tiles, depth, dtype=torch.int32),
                                _meta(tiles, dtype=torch.int32), None, n=n,
                                block_k=bk, block_n=bn, dual=False)
                whole = stubbed["k2"].calls[-1][17:20]
                full_route = k2.route(a, _meta(depth * bk, tiles * bn),
                                      _meta(tiles, depth, dtype=torch.int32),
                                      n=n, block_k=bk, block_n=bn).name
                for shards in (2, 4):
                    if tiles % shards:
                        continue
                    t = tiles // shards
                    k2.griffin_spmm(a, _meta(depth * bk, t * bn),
                                    _meta(t, depth, dtype=torch.int32),
                                    _meta(t, dtype=torch.int32), None,
                                    n=t * bn, block_k=bk, block_n=bn,
                                    dual=False, full=(n, tiles))
                    got = stubbed["k2"].calls[-1][17:20]
                    assert got == (whole if full_route == "tc"
                                   else (0, 0, 0)), (k, n, depth, shards)
        for dtype in (torch.bfloat16, torch.float32):
            a = _meta(4, k, dtype=dtype)
            whole3 = k3.route(a, _meta(k, n), bk)
            k1.dense_gemm(a, _meta(k, n))
            whole1 = stubbed["k1"].calls[-1][11]
            for shards in (2, 4):
                if n % shards:
                    continue
                b = _meta(k, n // shards)
                k3.sparse_a_gemm(a, b, _meta(1, -(-k // bk),
                                             dtype=torch.int32),
                                 _meta(1, dtype=torch.int32), block_m=128,
                                 block_k=bk, full_n=n)
                path, splits, cols, chunk = stubbed["k3"].calls[-1][17:21]
                assert (path, (splits, cols, chunk)) == \
                    (whole3[0], tuple(whole3[1] or (0, 0, 0)))
                k1.dense_gemm(a, b, full_n=n)
                assert stubbed["k1"].calls[-1][11] == whole1
    if table is not None:
        V, D = table
        emb = _meta(V, D)
        a = _meta(4, D)
        whole3 = k3.route(a, emb.T, bk)
        assert whole3[0] == k3.KMAJOR
        for shards in (2, 4):
            rows = V // shards
            head = emb[rows:2 * rows].T
            k3.sparse_a_gemm(a, head, _meta(1, -(-D // bk),
                                            dtype=torch.int32),
                             _meta(1, dtype=torch.int32), block_m=128,
                             block_k=bk, full_n=V)
            path, splits, cols, chunk = stubbed["k3"].calls[-1][17:21]
            assert (path, (splits, cols, chunk)) == (whole3[0],
                                                     tuple(whole3[1]))


def test_shard_params_cuts_columns_and_tiles():
    """A rank's share: the GEMM leaves' output columns (a compacted leaf's
    N tiles and the whole inverse shuffle), the tied head's vocab rows as
    embed.T, everything else whole; ``reshard`` is the same cut after a
    move; a one-model-rank mesh keeps the tree."""
    api = build_model(get_config("llama3.2-1b").reduced(), device="cpu")
    params = api.init(api.generator(0))
    from repro_torch.sparsity import sparsify_params
    comp = sparsify_params(params, 0.6, **PRUNE)
    mesh = tmesh.Mesh(1, 2, rank=1)
    share = sharding.shard_params(comp, mesh)
    wq = share["layers"]["wq"]
    full = comp["layers"]["wq"]
    half = full.kidx.shape[-2] // 2
    assert isinstance(wq, spmm_ops.GriffinShard)
    assert torch.equal(wq.kidx, full.kidx[:, half:])
    assert torch.equal(wq.b_comp, full.b_comp[..., half * 16:])
    assert torch.equal(wq.gather_inv, full.inv_perm.long())
    assert (wq.n, wq.n_tiles, wq.shards) == (full.n, 2 * half, 2)
    assert wq[0].gather_inv.shape == full.inv_perm[0].shape
    head = share["embed"].T
    V = params["embed"].shape[0]
    assert torch.equal(head.local, params["embed"][V // 2:].T)
    assert torch.equal(share["embed"][torch.tensor([0, V - 1])],
                       params["embed"][[0, V - 1]])
    assert share["final_norm"] is comp["final_norm"]
    dense = sharding.shard_params(params, mesh)["layers"]["w_up"]
    assert isinstance(dense, DenseShard) and dense.shape == \
        tuple(params["layers"]["w_up"].shape)
    assert torch.equal(dense.local, params["layers"]["w_up"][
        ..., params["layers"]["w_up"].shape[-1] // 2:])
    assert sharding.sharded_leaves(share) == 8
    moved = elastic.reshard(comp, mesh)
    assert torch.equal(moved["layers"]["wq"].b_comp, wq.b_comp)
    assert sharding.shard_params(comp, tmesh.Mesh(2, 1)) is comp


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_mesh_arena_holds_its_data_rows_slots(paged):
    """A rank's arena is its data row's contiguous run of slots
    (``sharding.slot_home``): the single-device arena cut on each leaf's
    slot axis (a paged row keeps its whole pool beside the page table of
    its slots), at the rank's share of the KV heads (model rank 1 of 2:
    heads 2 and 3 of 4); the engine's row and owner of every slot follow
    the same map."""
    api = build_model(get_config("llama3.2-1b").reduced(), device="cpu")
    params = api.init(api.generator(0))
    fields = dict(num_slots=4, cache_len=16)
    if paged:
        fields.update(page_size=4)
    conf = EngineConfig().with_fields(**fields)
    whole = ServeEngine(api, params, conf).cache
    mesh = tmesh.Mesh(2, 2, rank=3)
    eng = MeshServeEngine(api, params, mesh=mesh, config=conf)
    assert [sharding.slot_home(mesh, 4, s) for s in range(4)] == \
        [(0, None), (0, None), (1, 0), (1, 1)]
    assert [eng._slot_row(s) for s in range(4)] == [None, None, 0, 1]
    assert [eng._owner(s) for s in range(4)] == [0, 0, 1, 1]
    assert eng._rows_here() == sharding.slots_per_row(mesh, 4) == 2
    assert set(eng.cache) == set(whole)
    axes = _batch_axes(api)
    for key, leaf in whole.items():
        if key == "pages":
            want = leaf[2:]
        elif paged and key in ("k", "v"):
            want = leaf
        elif key in axes:
            want = leaf.narrow(axes[key], 2, 2) if axes[key] >= 0 \
                else leaf[2:]
        else:
            want = leaf
        if key in ("k", "v"):
            want = want.narrow(3, 2, 2)
        assert torch.equal(eng.cache[key], want), key
    with pytest.raises(ValueError, match="do not split"):
        sharding.slots_per_row(mesh, 3)


@pytest.mark.parametrize("paged", [None, 4], ids=["fixed", "paged"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 4)],
                         ids=["1x2", "2x2", "2x4"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_arena_holds_its_spec_share(arch, shape, paged):
    """Every rank's arena, leaf by leaf, is the single-device arena cut to
    the reference's decode spec of the whole arena (``cache_spec(decode=
    True, heads=cache_heads(api))``): its data row's slots on the axis the
    spec puts on "data" (a paged row's whole pool and its slots' page
    table rows, the port's own pool a row), its model rank's share of the
    axis the spec puts on "model" (the KV heads; whisper's cross K/V too;
    the heads of xlstm's states; recurrentgemma's single KV head and
    recurrent state stay whole), every other axis whole: shape, dtype and
    initial values."""
    D, M = shape
    mesh = tmesh.Mesh(D, M)
    japi = jax_build_model(jax_get_config(arch).reduced())
    jspec, jlen = jax_build_spec(japi, 4, 24, paged)
    arena = _promoted_arena_shapes(japi, 4, jlen)
    pset = frozenset()
    if jspec is not None:
        arena = jax_paged_tree(arena, 4, jspec)
        pset = frozenset(jspec.paged_keys)
    want = {_keystr(p)[2:-2]: tuple(jax_sharding.cache_spec(
        _keystr(p), leaf, mesh, 4, decode=True,
        heads=jax_cache_heads(japi), paged=pset))
        for p, leaf in _flat(arena)}
    pools = {k for k in want if k.removesuffix("_scale") in pset}
    api = build_model(get_config(arch).reduced(), device="cpu")
    params = api.init(api.generator(0))
    fields = dict(num_slots=4, cache_len=24)
    if paged:
        fields.update(page_size=paged)
    conf = EngineConfig().with_fields(**fields)
    whole = ServeEngine(api, params, conf).cache
    split = arch != "recurrentgemma-9b"
    assert any("model" in v for v in want.values()) == split
    for rank in range(D * M):
        eng = MeshServeEngine(api, params, config=conf,
                              mesh=tmesh.Mesh(D, M, rank=rank))
        d, m = divmod(rank, M)
        assert set(eng.cache) == set(whole) == set(want)
        for key, leaf in whole.items():
            for ax, name in enumerate(want[key]):
                if name == "model":
                    n = leaf.shape[ax] // M
                    leaf = leaf.narrow(ax, m * n, n)
                elif name == "data" and key not in pools:
                    leaf = leaf.narrow(ax, d * 4 // D, 4 // D)
            if key == "pages":
                leaf = leaf[d * 4 // D:(d + 1) * 4 // D]
            got = eng.cache[key]
            assert got.dtype == leaf.dtype and torch.equal(got, leaf), \
                (rank, key, tuple(got.shape), tuple(leaf.shape))


@pytest.mark.parametrize("arena", ["fixed", "paged", "paged_int8"])
@pytest.mark.parametrize("shards", [2, 4])
def test_decode_block_on_a_head_share_equals_the_whole(shards, arena):
    """One decode block of a GQA transformer (8 query heads on 4 KV heads,
    reduced llama widths, two rows at different positions) on each model
    rank's share of the KV heads: the rank writes the token's K and V into
    its share of the cache (int8: the whole row's scale, its heads'
    values), attends with its heads' queries, and gathers the attention
    output over the model ranks before ``wo``.  Every rank's block output
    equals the whole block's bit for bit, and so do its share of the
    cache and the scales."""
    from functools import partial

    from repro_torch.models import transformer as tr
    from repro_torch.models.common import (head_share, paged_slot,
                                           sparse_execution)
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              num_heads=8, num_kv_heads=4)
    api = build_model(cfg, device="cpu")
    lp = tr._layer(api.init(api.generator(0)), 0)
    gen = torch.Generator().manual_seed(5)
    B, S, KVH, hd = 2, 16, cfg.num_kv_heads, cfg.hd
    x = torch.randn(B, 1, cfg.d_model, generator=gen)
    pos = torch.tensor([6, 11], dtype=torch.int32)
    if arena == "fixed":
        cache = {k: torch.randn(B, S, KVH, hd, generator=gen)
                 for k in ("k", "v")}
    else:
        pages = torch.tensor([[3, 1, 0, 0], [2, 4, 5, 0]])
        dt = torch.int8 if arena == "paged_int8" else torch.float32
        cache = {k: (torch.randint(-127, 128, (6, 4, KVH, hd),
                                   generator=gen) if dt == torch.int8
                     else torch.randn(6, 4, KVH, hd, generator=gen)).to(dt)
                 for k in ("k", "v")}
        if dt == torch.int8:
            cache.update({f"{k}_scale": torch.rand(6, 4, generator=gen)
                          for k in ("k", "v")})
        slot = paged_slot(pages, pos, 4)

    def kv(c, heads):
        if arena == "fixed":
            return partial(tr._fixed_kv, pos, heads, c["k"], c["v"])
        return partial(tr._paged_kv, pages, slot, x.dtype, heads, c["k"],
                       c["v"], c.get("k_scale"), c.get("v_scale"))

    def block(c, heads):
        return tr.block_decode(cfg, lp, x, pos, kv(c, heads), pos, None,
                               heads)

    ref = {k: v.clone() for k, v in cache.items()}
    want = block(ref, None)
    n = KVH // shards
    rec: dict = {}
    for replay in (False, True):
        for m in range(shards):
            heads = slice(m * n, (m + 1) * n)
            mine = {k: (v.narrow(2, m * n, n).clone() if k in ("k", "v")
                        else v.clone()) for k, v in cache.items()}
            with sparse_execution(use_kernels=False, spmd_mesh=TwoPass(
                    m, shards, rec, replay)):
                got = block(mine, head_share(n, KVH))
            if replay:
                assert torch.equal(got, want), m
                for k, v in mine.items():
                    full = ref[k] if k.endswith("_scale") else \
                        ref[k].narrow(2, m * n, n)
                    assert torch.equal(v, full), (m, k)


# ---------------------------------------------------------------------------
# ranks under gloo on the host
# ---------------------------------------------------------------------------

TRACE = dict(requests=4, prompt_lens=(6, 10), gen_lens=(2, 4),
             arrival_every=1)
SYNC_TRACE = dict(requests=6, prompt_lens=(8, 12), gen_lens=(12, 16, 24),
                  arrival_every=1)


def _cell(arch="llama3.2-1b", sparsity=0.8, chunk=3, trace=TRACE,
          cache_len=16, **fields):
    fields = dict(dict(num_slots=4, cache_len=cache_len, decode_chunk=chunk,
                       use_kernels=True), **fields)
    return dict(arch=arch, reduced=True, sparsity=sparsity,
                config=EngineConfig().with_fields(**fields), **trace)


MATRIX = {f"{w}-chunk{c}": _cell(sparsity=s, chunk=c)
          for w, s in (("dense", 0.0), ("sparseB", 0.8)) for c in (1, 3)}
CELLS_2X2 = dict(
    MATRIX,
    **{"mode-A": _cell(sparsity=0.0, a_sparsity=0.9),
       "mode-AB": _cell(sparsity=0.8, a_sparsity=0.9),
       "paged": _cell(page_size=4, cache_len=24),
       "stepwise": _cell(chunk=1, fused=False),
       "oracle": _cell(spmd_kernels=False),
       "sync-budget": _cell(sparsity=0.0, chunk=8, trace=SYNC_TRACE,
                            cache_len=48)},
    **{f"family-{a}": _cell(arch=a, cache_len=24)
       for a in ("xlstm-1.3b", "whisper-large-v3", "mixtral-8x7b",
                 "recurrentgemma-9b")})
MODES = {"dense-chunk3": "dense", "mode-A": "A", "sparseB-chunk3": "B",
         "mode-AB": "AB"}
PLAN = FamilyPlan(family="dense", a_threshold=0.9,
                  rules=(GemmRule(match="*", block_k=64, block_n=16, unit=8,
                                  a_threshold=0.9),))


@pytest.fixture(scope="module")
def plan_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("plan") / "plan.json"
    KernelPlan(families={"dense": PLAN}).save(str(path))
    return str(path)


def _cells(spec: str, plan_file: str) -> dict:
    if spec == "2x2":
        return CELLS_2X2
    cells = dict(MATRIX)
    if spec == "1x2":
        cells["plan"] = _cell(plan=plan_file)
    return cells


_BRIDGED = {}


def _bridged():
    """Reduced llama3.2-1b from the reference (pruned 0.6, compacted),
    its ServeEngine's tokens on TRACE (interpret-mode kernels), and the
    weights bridged to the port."""
    if not _BRIDGED:
        cfg = jax_get_config("llama3.2-1b").reduced()
        jp = _ref_tree("llama3.2-1b", True)
        jconf = JaxEngineConfig().with_fields(
            num_slots=4, cache_len=16, decode_chunk=3, use_kernels=True,
            interpret=True)
        jeng = JaxServeEngine(jax_build_model(cfg), jp, config=jconf)
        outs = jeng.run(jax_synthetic_trace(
            cfg, num_requests=4, seed=1, prompt_lens=(6, 10),
            gen_lens=(2, 4), arrival_every=1))
        _BRIDGED.update(tokens={r: list(o.tokens) for r, o in outs.items()},
                        stats=dict(jeng.stats),
                        params=bridge.to_torch(jax.tree.map(np.asarray, jp)))
    return _BRIDGED


_RUNS: dict = {}


def _mesh_run(spec: str, plan_file: str):
    """One spawn of the mesh's ranks running every cell of it in turn, and
    the unsharded engine's run of each cell here (memoized per mesh)."""
    if spec not in _RUNS:
        cells = dict(_cells(spec, plan_file))
        if spec == "2x2":
            cells["bridged"] = dict(_cell(), params=_bridged()["params"])
        recs = launch_serve.mesh_cells_on(spec, list(cells.values()),
                                          device="cpu")
        refs = {name: launch_serve.serve(device="cpu", **kw)
                for name, kw in cells.items()}
        _RUNS[spec] = (spec, dict(zip(cells, recs)), refs)
    return _RUNS[spec]


@pytest.fixture(scope="module", params=["2x2", "1x2", "2x1", "2x4"])
def mesh_run(request, plan_file):
    return _mesh_run(request.param, plan_file)


@pytest.fixture(scope="module")
def mesh22(plan_file):
    return _mesh_run("2x2", plan_file)


def _check_cell(spec: str, name: str, recs, ref) -> None:
    eng = ref.engine
    D, M = map(int, spec.split("x"))
    want = {r: o.tokens for r, o in eng.outputs.items()}
    assert len(recs) == D * M
    assert len({r["digest"] for r in recs}) == 1, "host states differ"
    for rec in recs:
        assert rec["tokens"] == want, (spec, name, rec["rank"])
        assert rec["stats"] == eng.stats, (spec, name)
        assert rec["mode_history"] == [(c, m.value)
                                       for c, m in eng.mode_history]
        d = rec["dispatch"]
        hot = "spmd_oracle" if name == "oracle" else \
            "shard" if M > 1 else "replicated"
        assert d.get(hot, 0) > 0, (spec, name, d)
        for cold in ("shard", "spmd_oracle", "kernel"):
            if cold != hot:
                assert d.get(cold, 0) == 0, (spec, name, d)
        assert (rec["sharded_leaves"] > 0) == (M > 1)
        assert rec["backend"] == "gloo"


def test_mesh_matrix_cells(mesh_run):
    """1x2, 2x1, 2x2 and 2x4 x {dense, compacted} x chunk {1, 3}."""
    spec, recs, refs = mesh_run
    for name in MATRIX:
        _check_cell(spec, name, recs[name], refs[name])


@pytest.mark.parametrize("name", [n for n in CELLS_2X2 if n not in MATRIX])
def test_mesh_2x2_cells(mesh22, name):
    spec, recs, refs = mesh22
    _check_cell(spec, name, recs[name], refs[name])
    if name == "sync-budget":
        st = recs[name][0]["stats"]
        assert st["host_syncs"] / st["emitted"] <= 0.25


# the head gathers a decode step adds on a mesh with split heads, over
# those of the weight GEMMs: one a layer's attention (two, self and
# cross, for whisper), one an xlstm block, none for recurrentgemma (one
# KV head: its arena stays whole)
HEAD_GATHERS = {"llama3.2-1b": 2, "mixtral-8x7b": 2, "whisper-large-v3": 4,
                "xlstm-1.3b": 2, "recurrentgemma-9b": 0}


@pytest.mark.parametrize("arch", list(HEAD_GATHERS))
def test_mesh_2x2_head_gathers_per_decode_step(mesh22, arch):
    """Per family on 2x2: the gathers over "model" beyond one a sharded
    GEMM (its ``shard`` dispatches) are ``HEAD_GATHERS`` a decode step,
    and none a prefill; ``Mesh.sites`` books them to the heads and the
    rest to the GEMMs."""
    _, recs, _ = mesh22
    name = "sparseB-chunk3" if arch == "llama3.2-1b" else f"family-{arch}"
    assert sum(rec["prefills_here"] for rec in recs[name]) > 0
    for rec in recs[name]:
        mg, steps = rec["model_gathers"], rec["stats"]["decode_steps"]
        assert steps > 0
        assert sum(mg.values()) - rec["dispatch"]["shard"] == \
            HEAD_GATHERS[arch] * steps, (arch, mg, rec["dispatch"])
        sites = rec["gather_sites"]
        assert sites["gemm"]["n"] == rec["dispatch"]["shard"]
        assert sites.get("heads", {"n": 0})["n"] == \
            HEAD_GATHERS[arch] * steps


def test_mesh_2x2_every_mode(mesh22):
    """All four Modes at 2x2, each in its own cell, through the shard
    entries (Mode.A through sparse_a's, Mode.AB dual)."""
    _, recs, _ = mesh22
    for name, mode in MODES.items():
        assert [m for _, m in recs[name][0]["mode_history"]] == [mode]
    assert recs["mode-AB"][0]["dispatch"].get("dual", 0) > 0


def test_mesh_launches_and_gathers_per_model_call(mesh_run):
    """Each rank's gathers over "model": one a GEMM (2 layers x 7 + the
    tied head = 15 a prefill of reduced llama), and a decode step's one
    more a layer for the attention output of the rank's KV heads (17),
    none on a one-model-rank mesh; over "data": one a host sync; booked
    by call site (``Mesh.sites``), their ready seconds within their
    total.  Each rank's arena holds its data row's slots at its share of
    the heads."""
    spec, recs, _ = mesh_run
    D, M = map(int, spec.split("x"))
    cfg = get_config("llama3.2-1b").reduced()
    for rec in recs["sparseB-chunk3"]:
        mg, steps = rec["model_gathers"], rec["stats"]["decode_steps"]
        assert mg["prefill"] == (15 * rec["prefills_here"] if M > 1 else 0)
        assert mg["decode"] == (17 * steps if M > 1 else 0)
        assert rec["gathers"]["model"] == mg["prefill"] + mg["decode"]
        assert rec["gathers"]["data"] == (rec["stats"]["host_syncs"]
                                          if D > 1 else 0)
        want = {"gemm": 15 * (rec["prefills_here"] + steps),
                "heads": 2 * steps} if M > 1 else {}
        if D > 1:
            want["data"] = rec["gathers"]["data"]
        sites = rec["gather_sites"]
        assert {k: v["n"] for k, v in sites.items()} == want
        assert all(0 <= v["ready_s"] <= v["s"] for v in sites.values())
        kv = 2 * cfg.num_layers * (4 // D) * 16 * (cfg.num_kv_heads // M) \
            * cfg.hd * 4
        assert rec["arena_bytes"] == {"k": kv // 2, "v": kv // 2,
                                      "pos": 4 * (4 // D)}
    assert sum(r["prefills_here"] for r in recs["sparseB-chunk3"]) == \
        M * recs["sparseB-chunk3"][0]["stats"]["prefill_calls"]


def test_mesh_2x2_on_bridged_weights_gives_the_references_tokens(mesh22):
    """The reference's compacted weights, bridged, served by the port on a
    2x2 mesh: the reference ServeEngine's tokens and counters."""
    _, recs, _ = mesh22
    ref = _bridged()
    for rec in recs["bridged"]:
        assert rec["tokens"] == ref["tokens"]
        for key in ("emitted", "decode_steps", "chunk_calls",
                    "prefill_calls", "host_syncs"):
            assert rec["stats"][key] == ref["stats"][key], key
        assert rec["dispatch"].get("shard", 0) > 0


def test_plan_survives_mesh_shard_map(plan_file):
    """A tuned plan (block_n 16, threshold 0.9) served on a 1x2 mesh gives
    the same plan's unsharded tokens; every compacted share carries the
    plan's granularity and threshold."""
    spec, recs, refs = _mesh_run("1x2", plan_file)
    _check_cell(spec, "plan", recs["plan"], refs["plan"])
    for rec in recs["plan"]:
        assert rec["griffin_blocks"] == [(64, 16, 0.9)]
    assert refs["plan"].engine._a_threshold == 0.9


def test_mesh_1x1_is_the_single_device_engine():
    cfg = get_config("llama3.2-1b").reduced()
    api = build_model(cfg, device="cpu")
    from repro_torch.sparsity import sparsify_params
    params = sparsify_params(api.init(api.generator(0)), 0.6, **PRUNE)
    conf = EngineConfig().with_fields(num_slots=4, cache_len=16,
                                      decode_chunk=3, use_kernels=True)
    trace = dict(num_requests=4, seed=11, prompt_lens=(6, 10),
                 gen_lens=(2, 4), arrival_every=1)
    ref = ServeEngine(api, params, conf)
    want = {r: o.tokens for r, o in ref.run(synthetic_trace(cfg,
                                                            **trace)).items()}
    eng = MeshServeEngine(api, params, mesh=tmesh.serve_mesh("1x1"),
                          config=conf)
    assert eng._spmd_mesh is None
    assert eng.params["layers"]["wq"].b_comp is params["layers"]["wq"].b_comp
    got = {r: o.tokens for r, o in eng.run(synthetic_trace(cfg,
                                                           **trace)).items()}
    assert got == want and eng.stats == ref.stats


def test_mesh_engine_rejects_wrong_axes_missing_cache_len_and_faults():
    api = build_model(get_config("llama3.2-1b").reduced(), device="cpu")
    params = api.init(api.generator(0))
    conf = EngineConfig().with_fields(num_slots=2, cache_len=16)
    bad = dataclasses.replace(tmesh.serve_mesh("1x1"), axis_names=("x", "y"))
    with pytest.raises(ValueError, match="axes"):
        MeshServeEngine(api, params, mesh=bad, config=conf)
    with pytest.raises(ValueError, match="cache_len"):
        MeshServeEngine(api, params, mesh=tmesh.serve_mesh("1x1"),
                        config=EngineConfig())
    # armed on a mesh (remeshing, ROADMAP 1.15b): the engine keeps the
    # whole tree on the host for the survivors' shares and serves its own
    for armed, fields in ((dict(fault_injector=object()), {}),
                          (dict(straggler=object()), {}),
                          ({}, dict(snapshot_dir="s")),
                          ({}, dict(recovery_model_parallel=1))):
        eng = MeshServeEngine(api, params, mesh=tmesh.Mesh(2, 2, rank=3),
                              config=conf.with_fields(**fields), **armed)
        kept = None if "recovery_model_parallel" in fields else params
        if kept is None:
            assert eng._params_host is None
        else:
            # on the host the copy is the tree itself (no bytes copied)
            assert eng._params_host["layers"]["wq"].data_ptr() == \
                kept["layers"]["wq"].data_ptr()
        assert isinstance(eng.params["layers"]["wq"], DenseShard)
        assert eng._recovery_mp == fields.get("recovery_model_parallel")
    placed = dataclasses.replace(tmesh.serve_mesh("1x1"),
                                 device=torch.device("meta"))
    with pytest.raises(ValueError, match="the model on cpu"):
        MeshServeEngine(api, params, mesh=placed, config=conf)


def test_ranks_check_the_layout_and_a_failing_rank_fails_the_run():
    recs = tmesh.run_ranks(tmesh.check_ranks, tmesh.serve_mesh("2x2"),
                           device="cpu")
    assert [r["coords"] for r in recs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert {r["backend"] for r in recs} == {"gloo"}
    for spec in ("1x2", "2x2"):
        with pytest.raises(RuntimeError) as err:
            tmesh.run_ranks(tmesh.check_ranks, tmesh.serve_mesh(spec), 1,
                            device="cpu")
        first = str(err.value).split("-- rank ")[1]
        assert first.startswith("1:") and "failed on purpose" in first


def test_a_rank_whose_process_dies_fails_the_armed_run(tmp_path):
    """A process that dies is no device loss: with recovery armed (a kill
    due later, snapshots on disk), rank 2, the saver of data row 1's first
    head share, dies at its first snapshot (its share's directory is a
    file), and the run fails with rank 2's error first instead of
    remeshing."""
    snap = tmp_path / "snap"
    snap.mkdir()
    (snap / "row1-share0").write_text("not a directory")
    cell = _cell(inject="kill:-1@3:decode", snapshot_dir=str(snap))
    with pytest.raises(RuntimeError) as err:
        launch_serve.mesh_cells_on("2x2", [cell], device="cpu")
    first = str(err.value).split("-- rank ")[1]
    assert first.startswith("2:") and "row1" in first


@pytest.mark.parametrize("argv,want", [
    (["--mesh", "1x2", "--parity"], "parity OK"),
    (["--model-parallel", "2", "--spmd-fallback", "--parity"],
     "parity OK")], ids=["mesh-1x2", "model-parallel-2-oracle"])
def test_serve_cli_on_a_mesh(argv, want, capsys):
    launch_serve.main(["--reduced", "--device", "cpu", "--sparsity", "0.8",
                       "--use-kernels", "--requests", "4"] + argv)
    out = capsys.readouterr().out
    assert "mesh 1x2: gloo on the host" in out
    assert want in out and out.strip().splitlines()[-1].endswith("mesh 1x2")
    assert ("'spmd_oracle'" in out) == ("--spmd-fallback" in argv)


def test_serve_cli_remesh_flag_names_its_item(capsys):
    """The post-loss mesh's flag on the CLI: rank 3 of a 2x2 mesh lost at
    decode step 3, the survivors capped at one model rank form 2x1 (rank 2
    dropped), and the survivors' tokens pass the oracle."""
    launch_serve.main(["--reduced", "--device", "cpu", "--sparsity", "0.8",
                       "--use-kernels", "--requests", "4", "--mesh", "2x2",
                       "--inject-fault", "kill:-1@3:decode",
                       "--remesh-model-parallel", "1", "--parity"])
    out = capsys.readouterr().out
    assert "1 recoveries" in out and "final mesh 2x1" in out
    assert "rank 2 dropped, rank 3 lost" in out
    last = out.strip().splitlines()[-1]
    assert last.startswith("parity OK") and last.endswith("final mesh 2x1")
