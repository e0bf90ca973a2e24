"""The port's dense decoder (repro_torch.models) against the JAX package's
on reduced llama3.2-1b in fp32, dense and block-pruned-compacted (blocks
16/16, unit 8).  Both run the reference's own weights, bridged through
numpy.  Logits must agree within rtol 1e-4 / atol 1e-5 (summation orders
differ) and greedy tokens must be equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.common import sparse_execution as jax_scope
from repro.runtime.serve import greedy_generate as jax_greedy
from repro.sparsity import sparsify_params as jax_sparsify
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels.sparse_a import ops as sparse_a_ops
from repro_torch.models import build_model, common, transformer
from repro_torch.models.common import (kernel_dispatch_counts,
                                       reset_kernel_dispatch,
                                       sparse_execution, tree_sum)
from repro_torch.runtime.serve import greedy_generate

TOL = dict(rtol=1e-4, atol=1e-5)
PRUNE = dict(block_k=16, block_n=16, unit=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Eager torch ops at these sizes gain nothing from threads, and with
    pytest-xdist's parallel workers OpenMP's pools oversubscribe the cores
    (a test of seconds then takes minutes): one thread for the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=["dense", "compacted"])
def pair(request):
    """(jax api, jax params, port api, port params, compacted?)"""
    cfg = jax_get_config("llama3.2-1b").reduced()
    japi = jax_build_model(cfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    compacted = request.param == "compacted"
    if compacted:
        jparams = jax_sparsify(jparams, 0.6, **PRUNE)
    tapi = build_model(get_config("llama3.2-1b").reduced(), device="cpu")
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    return japi, jparams, tapi, tparams, compacted


def _scopes(compacted):
    """Factories of the (JAX, port) execution scopes for one run."""
    if not compacted:
        return (lambda: jax_scope(use_kernels=False),
                lambda: sparse_execution(use_kernels=False))
    return (lambda: jax_scope(use_kernels=True, interpret=True),
            lambda: sparse_execution(use_kernels=True))


def test_reduced_config_matches_reference():
    jcfg = jax_get_config("llama3.2-1b").reduced()
    tcfg = get_config("llama3.2-1b").reduced()
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "hd", "tie_embeddings", "act", "norm_eps",
              "rope_theta", "dtype", "window", "qk_norm", "kv_chunk"):
        assert getattr(jcfg, f) == getattr(tcfg, f), f
    full = get_config("llama3.2-1b")
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.d_ff, full.vocab_size, full.dtype, full.kv_chunk) == \
        (16, 2048, 32, 8, 8192, 128256, "bfloat16",
         jax_get_config("llama3.2-1b").kv_chunk)


@pytest.mark.parametrize("bucket", [None, 16])
def test_prefill_logits_and_cache_match(pair, bucket):
    japi, jparams, tapi, tparams, compacted = pair
    toks = np.random.RandomState(3).randint(1, 128, (2, 11)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks)}
    tbatch = {"tokens": torch.from_numpy(toks.astype(np.int64))}
    if bucket:
        jbatch = {"tokens": jnp.pad(jbatch["tokens"], ((0, 0), (0, 5))),
                  "lengths": jnp.full((2,), 11, jnp.int32)}
        tbatch = {"tokens": torch.nn.functional.pad(tbatch["tokens"], (0, 5)),
                  "lengths": torch.full((2,), 11, dtype=torch.int32)}
    js, ts = _scopes(compacted)
    with js():
        jcache, jlog = japi.prefill(jparams, jbatch, cache_len=24)
    with ts():
        tcache, tlog = tapi.prefill(tparams, tbatch, cache_len=24)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), **TOL)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


def test_prefill_over_kv_chunks_matches(pair):
    """A 40-token prompt in a 64-token bucket: with kv_chunk 16, prefill
    attention walks three (and, padded, four) KV chunks."""
    japi, jparams, tapi, tparams, compacted = pair
    toks = np.random.RandomState(8).randint(1, 128, (1, 40)).astype(np.int32)
    jbatch = {"tokens": jnp.pad(jnp.asarray(toks), ((0, 0), (0, 24))),
              "lengths": jnp.full((1,), 40, jnp.int32)}
    tbatch = {"tokens": torch.nn.functional.pad(
        torch.from_numpy(toks.astype(np.int64)), (0, 24)),
        "lengths": torch.full((1,), 40, dtype=torch.int32)}
    js, ts = _scopes(compacted)
    with js():
        jcache, jlog = japi.prefill(jparams, jbatch, cache_len=64)
    with ts():
        tcache, tlog = tapi.prefill(tparams, tbatch, cache_len=64)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), **TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_step_logits_match(pair, per_row):
    japi, jparams, tapi, tparams, compacted = pair
    rng = np.random.RandomState(4)
    toks = rng.randint(1, 128, (3, 7)).astype(np.int32)
    js, ts = _scopes(compacted)
    with js():
        jcache, _ = japi.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                 cache_len=16)
    tcache = {k: bridge.array_to_tensor(np.asarray(v))
              for k, v in jcache.items()}
    if per_row:
        pos = np.asarray([6, 3, 5], np.int32)
        jcache = dict(jcache, pos=jnp.asarray(pos))
        tcache["pos"] = torch.from_numpy(pos)
    nxt = rng.randint(1, 128, (3, 1)).astype(np.int32)
    for _ in range(2):
        with js():
            jlog, jcache = japi.decode_step(jparams, jcache, jnp.asarray(nxt))
        with ts():
            tlog, tcache = tapi.decode_step(tparams, tcache,
                                            torch.from_numpy(nxt).long())
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        nxt = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), **TOL)


def test_greedy_tokens_equal(pair):
    japi, jparams, tapi, tparams, compacted = pair
    toks = np.random.RandomState(5).randint(1, 128, (1, 9)).astype(np.int32)
    js, ts = _scopes(compacted)
    with js():
        want = jax_greedy(japi, jparams, {"tokens": jnp.asarray(toks)},
                          steps=6, cache_len=24, prompt_bucket=16)
    reset_kernel_dispatch()
    with ts():
        got = greedy_generate(tapi, tparams,
                              {"tokens": torch.from_numpy(toks).long()},
                              steps=6, cache_len=24, prompt_bucket=16)
    assert got.tolist() == np.asarray(want).tolist()
    counts = kernel_dispatch_counts()
    if compacted:
        # 7 GEMMs x 2 layers per call through griffin_spmm, plus the dense
        # unembedding, also a kernel call: nothing bypasses the kernels
        assert counts.get("plain", 0) == 0 and counts["kernel"] == 6 * 15
    else:
        assert counts.get("kernel", 0) == 0


def _prefill_both(pair, toks, jax_kw, port_kw):
    japi, jparams, tapi, tparams, _ = pair
    with jax_scope(**jax_kw):
        _, jlog = japi.prefill(jparams, {"tokens": jnp.asarray(toks)},
                               cache_len=24)
    reset_kernel_dispatch()
    with sparse_execution(**port_kw):
        _, tlog = tapi.prefill(tparams, {"tokens": torch.from_numpy(
            toks.astype(np.int64))}, cache_len=24)
    return jlog, tlog, kernel_dispatch_counts()


@pytest.mark.parametrize("rows", [1, 3])
def test_sparse_a_mode_not_ported(pair, rows):
    """A declared activation sparsity under a kernel scope: dense leaves
    take Sparse.A (the sparse_a kernel), compacted leaves dual griffin_spmm
    and the unembedding Sparse.A.  Prefill logits equal the reference's
    under the same scope.  (This scope raised while Sparse.A had no port;
    the test keeps its name.)"""
    compacted = pair[4]
    toks = np.random.RandomState(rows).randint(1, 128, (rows, 9)).astype(
        np.int32)
    jlog, tlog, counts = _prefill_both(
        pair, toks, dict(use_kernels=True, interpret=True, a_sparsity=0.5),
        dict(use_kernels=True, a_sparsity=0.5))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    # 7 GEMMs x 2 layers + the unembedding, all kernels; 14 of them dual
    # when the weights are compacted
    want = {"kernel": 15}
    if compacted:
        want["dual"] = 14
    assert counts == want


def count_meta_builds(monkeypatch):
    """A list that grows by one at every activation-metadata build, at the
    shared sites (``models.common``) and inside ``sparse_a_matmul``."""
    builds = []
    for mod in (common, sparse_a_ops):
        def counted(*args, _real=mod.compact_activations, **kw):
            builds.append(1)
            return _real(*args, **kw)
        monkeypatch.setattr(mod, "compact_activations", counted)
    return builds


def _prefill_and_decode(tapi, tparams, toks, steps=2):
    """Prefill then ``steps`` greedy decode steps under the Mode.A scope:
    the logits of each model call and the metadata builds of each."""
    logits = []
    with sparse_execution(use_kernels=True, a_sparsity=0.5):
        cache, log = tapi.prefill(tparams, {"tokens": torch.from_numpy(
            toks.astype(np.int64))}, cache_len=24)
        logits.append(log)
        for _ in range(steps):
            nxt = log.argmax(-1, keepdim=True)
            log, cache = tapi.decode_step(tparams, cache, nxt)
            logits.append(log)
    return logits


@pytest.mark.parametrize("rows", [1, 3])
def test_mode_a_builds_metadata_once_per_distinct_input(pair, rows,
                                                        monkeypatch):
    """Under Mode.A each model call builds the activation metadata once
    per distinct input: wq/wk/wv share one, w_gate/w_up another, wo and
    w_down one each, plus the unembedding: 4 L + 1 (9 at 2 layers), where
    every dense GEMM built its own (15).  With compacted weights only the
    dense unembedding takes Sparse.A: 1.  The logits are bit-equal to a
    run that shares nothing, and equal to the reference's."""
    japi, jparams, tapi, tparams, compacted = pair
    toks = np.random.RandomState(10 + rows).randint(1, 128, (rows, 9)) \
        .astype(np.int32)
    layers = tapi.cfg.num_layers
    builds = count_meta_builds(monkeypatch)
    shared = _prefill_and_decode(tapi, tparams, toks)
    assert len(builds) == 3 * (1 if compacted else 4 * layers + 1)
    builds.clear()
    monkeypatch.setattr(transformer, "shared_activation_meta",
                        lambda x, *ws: None)
    alone = _prefill_and_decode(tapi, tparams, toks)
    assert len(builds) == 3 * (1 if compacted else 7 * layers + 1)
    for a, b in zip(shared, alone):
        assert torch.equal(a, b)
    with jax_scope(use_kernels=True, interpret=True, a_sparsity=0.5):
        _, jlog = japi.prefill(jparams, {"tokens": jnp.asarray(toks)},
                               cache_len=24)
    np.testing.assert_allclose(shared[0].numpy(), np.asarray(jlog), **TOL)


def test_shared_meta_only_where_a_dense_leaf_takes_mode_a(pair):
    """The helper builds nothing outside a Mode.A kernel scope, and
    nothing for leaves that are all compacted."""
    _, _, _, tparams, compacted = pair
    x = torch.randn(2, 3, 64)
    w = tparams["layers"]["wq"][0]
    assert common.shared_activation_meta(x, w) is None
    with sparse_execution(use_kernels=True):
        assert common.shared_activation_meta(x, w) is None
    with sparse_execution(use_kernels=False, a_sparsity=0.5):
        assert common.shared_activation_meta(x, w) is None
    with sparse_execution(use_kernels=True, a_sparsity=0.5, block_m=8):
        meta = common.shared_activation_meta(x, w)
        if compacted:
            assert meta is None
        else:
            assert (meta.m, meta.k, meta.block_m) == (8, 64, 8)


def test_declared_a_sparsity_without_kernels_is_the_plain_dot(pair):
    """Without ``use_kernels`` a declared activation sparsity changes
    nothing for dense leaves: plain ``x @ w``, as in the reference."""
    compacted = pair[4]
    toks = np.random.RandomState(7).randint(1, 128, (2, 6)).astype(np.int32)
    jlog, tlog, counts = _prefill_both(
        pair, toks, dict(use_kernels=False, interpret=True, a_sparsity=0.5),
        dict(use_kernels=False, a_sparsity=0.5))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    assert counts["plain"] == (1 if compacted else 15)


@pytest.mark.parametrize("n", [1, 2, 5, 64, 100])
def test_tree_sum_is_batch_invariant(n):
    x = torch.from_numpy(np.random.RandomState(n).randn(6, n).astype(
        np.float32))
    full = tree_sum(x)
    rows = torch.stack([tree_sum(x[i:i + 1])[0] for i in range(6)])
    assert torch.equal(full, rows)
    np.testing.assert_allclose(full.numpy(), x.numpy().sum(-1), rtol=1e-5,
                               atol=1e-5)
