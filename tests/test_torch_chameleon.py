"""The vlm family on the port (chameleon-34b: the transformer backbone with
QK-norm, GQA 8:1, an untied head, its weights drawn in the streamed
build's order) against the JAX package's, on the reference's own weights
bridged through numpy and on inputs drawn with numpy from a seed.  The
reference runs as its own tests run it: on the CPU, its Pallas kernels in
interpret mode.  The VQ image tokenizer is a stub in both packages:
images arrive as token ids in the shared vocab.

The arch runs at its ``reduced()`` config (4 heads, 4 KV heads) and at a
narrow twin built the same way in both packages that keeps the source's
GQA ratio (8 heads, 1 KV head, head_dim 16), its QK-norm and its untied
head: the twin exists in these tests only.

Tolerances (those of ``tests/test_torch_dense_configs.py``): fp32 logits,
K/V caches and QK-norm outputs within rtol 1e-4 / atol 1e-5 (summation
orders differ); at bf16 the logits and the QK-norm outputs within relative
L2 2e-2; the fp32 loss within 1e-5 relative and each gradient leaf within
1e-4 relative L2 (``tests/test_torch_losses.py``); greedy and engine
tokens, counters, launch counts, dtypes and the compacted
``b_comp``/``kidx``/``cnt`` exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as jtf
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.common import rms_norm as jax_rms_norm
from repro.models.common import sparse_execution as jax_scope
from repro.runtime.config import ArenaConfig as JaxArenaConfig
from repro.runtime.config import EngineConfig as JaxEngineConfig
from repro.runtime.engine import ServeEngine as JaxServeEngine
from repro.runtime.engine import synthetic_trace as jax_synthetic_trace
from repro.runtime.serve import greedy_generate as jax_greedy
from repro.sparsity import sparsify_params as jax_sparsify
import chip_smoke
from repro_torch import bridge
from repro_torch.checkpoint import keyed_leaves
from repro_torch.configs import get_config
from repro_torch.kernels import GriffinWeights
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model, transformer
from repro_torch.models.common import (dense_init, kernel_dispatch_counts,
                                       reset_kernel_dispatch, rms_norm,
                                       sparse_execution)
from repro_torch.runtime.config import EngineConfig
from repro_torch.runtime.engine import ServeEngine, synthetic_trace
from repro_torch.runtime.serve import greedy_generate
from repro_torch.runtime.train import value_and_grad
from repro_torch.sparsity import PRUNE, init_sparse_params, sparsify_params
from repro_torch.tuning.measure import tuning_workload

ARCH = "chameleon-34b"
# the narrow twin's (heads, kv heads): the source's 8:1 GQA ratio at the
# reduced width and head_dim
TWIN = (8, 1)
VARIANTS = ("reduced", "twin")
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = 2e-2
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
# the reference engine test's trace (tests/test_engine.py _family_parity)
TRACE = dict(num_requests=3, seed=11, prompt_lens=(6, 10), gen_lens=(2, 4),
             arrival_every=1)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Eager torch ops at these sizes gain nothing from threads, and with
    pytest-xdist's parallel workers OpenMP's pools oversubscribe the cores
    (a test of seconds then takes minutes): one thread for the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(variant="reduced", dtype="float32"):
    """(reference config, port config) reduced, or the twin."""
    kw = dict(dtype=dtype)
    if variant == "twin":
        kw.update(num_heads=TWIN[0], num_kv_heads=TWIN[1])
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def _jitted(japi):
    """The reference's model API with prefill and decode under ``jax.jit``
    (eagerly, every call re-traces its layer scans)."""
    return dataclasses.replace(
        japi, prefill=jax.jit(japi.prefill, static_argnames=("cache_len",)),
        decode_step=jax.jit(japi.decode_step))


def _pair(variant="reduced", dtype="float32"):
    """(jax cfg, jax api, jax params, port cfg, port api, port params) on
    the reference's seed-0 weights, bridged."""
    jcfg, tcfg = _cfgs(variant, dtype)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    tapi = build_model(tcfg, device="cpu")
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    return jcfg, japi, jparams, tcfg, tapi, tparams


_PAIRS = {}


def _cached(variant="reduced"):
    if variant not in _PAIRS:
        _PAIRS[variant] = _pair(variant)
    return _PAIRS[variant]


@pytest.fixture(scope="module", params=VARIANTS)
def ref(request):
    return _cached(request.param)


def _tok(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _rel(got, want) -> float:
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _prompts(rng, B, S, vocab=128):
    return rng.integers(1, vocab, (B, S)).astype(np.int32)


def _assert_trees_equal(got, want, path=""):
    """Every leaf bit for bit, compacted leaves field by field."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            _assert_trees_equal(got[key], want[key], f"{path}/{key}")
        return
    if isinstance(want, GriffinWeights):
        assert isinstance(got, GriffinWeights), path
        for f in ("b_comp", "kidx", "cnt", "inv_perm", "perm"):
            g, w = getattr(got, f), getattr(want, f)
            assert (g is None and w is None) or torch.equal(g, w), (path, f)
        assert (got.k, got.n, got.block_k, got.block_n) == \
            (want.k, want.n, want.block_k, want.block_n), path
        return
    assert got.dtype == want.dtype and torch.equal(got, want), path


# ---------------------------------------------------------------------------
# config and size
# ---------------------------------------------------------------------------

FIELDS = ("family", "num_layers", "d_model", "num_heads", "num_kv_heads",
          "hd", "d_ff", "vocab_size", "window", "qk_norm", "tie_embeddings",
          "act", "norm_eps", "rope_theta", "dtype", "kv_chunk", "loss_chunk",
          "remat", "moe")


def test_config_and_reduced_match_reference():
    """Full and reduced configs carry the reference's fields; vlm with
    QK-norm, GQA 8:1 at head_dim 128 and an untied head; the twin keeps
    the ratio of heads to kv heads."""
    for jcfg, tcfg in ((jax_get_config(ARCH), get_config(ARCH)),
                       (jax_get_config(ARCH).reduced(),
                        get_config(ARCH).reduced())):
        for f in FIELDS:
            assert getattr(jcfg, f) == getattr(tcfg, f), f
    full = get_config(ARCH)
    assert (full.family, full.qk_norm, full.tie_embeddings) == \
        ("vlm", True, False)
    assert (full.num_heads // full.num_kv_heads, full.hd) == (8, 128)
    _, twin = _cfgs("twin")
    assert twin.num_heads // twin.num_kv_heads == 8 and twin.qk_norm


def test_full_width_parameter_counts_equal_the_reference():
    """``param_count`` and ``param_count_total`` (analytic, embeddings
    excluded: 33.22 B; with the embedding and the untied head 34.29 B,
    68.6 GB of bf16) equal the reference registry's at full width, and
    the draw order covers exactly those parameters, the norms' included
    (counted from the draws' shapes: nothing is allocated)."""
    cfg = get_config(ARCH)
    japi = jax_build_model(jax_get_config(ARCH))
    tapi = build_model(cfg, device="cpu")
    assert tapi.param_count() == japi.param_count() == \
        tapi.param_count_total() == japi.param_count_total()
    assert 33.2e9 < tapi.param_count_total() < 33.3e9
    drawn = {d.path: int(np.prod(d.lead + d.shape)) for d in tapi.draws()}
    norms = cfg.num_layers * (2 * cfg.d_model + 2 * cfg.hd) + cfg.d_model
    embeds = 2 * cfg.vocab_size * cfg.d_model
    assert sum(drawn.values()) == tapi.param_count_total() + norms + embeds
    assert 34.2e9 < sum(drawn.values()) < 34.3e9
    order = [d.path[-1] for d in tapi.draws()]
    assert order == ["embed", "final_norm", "ln1", "ln2", "qn", "kn", "wq",
                     "wk", "wv", "wo", "w_gate", "w_up", "w_down", "head"]


def test_build_model_defaults_to_the_card():
    cfg = get_config(ARCH)
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)
    api = build_model(cfg, device="cpu")
    assert api.draws is not None
    shape = api.init_cache(1, 64, device=torch.device("meta"))["k"].shape
    assert shape == (48, 1, 64, 8, 128)


def test_init_has_the_reference_layout(ref):
    """Seeded init (the draw order): every leaf of the reference's tree,
    ``qn``/``kn`` and the untied head among them, with its shape and
    dtype; the norm scales zero, as the reference's."""
    _, _, jparams, _, tapi, _ = ref
    own = tapi.init(tapi.generator(0))
    want = jax.tree.map(np.asarray, jparams)
    assert own["layers"]["qn"].shape == want["layers"]["qn"].shape

    def walk(a, b, path=""):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
            return
        assert tuple(a.shape) == b.shape, path
        assert str(a.dtype).split(".")[-1] == b.dtype.name, path

    walk(own, want)
    for name in ("ln1", "ln2", "qn", "kn"):
        assert not own["layers"][name].any()


# ---------------------------------------------------------------------------
# QK-norm alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qk_norm_matches_reference(dtype):
    """``rms_norm`` over head_dim of (B, S, H, hd) q and (B, S, KVH, hd) k
    with non-zero scales, as ``_qkv`` applies it: the output's dtype is
    the input's, its values within tolerance of the reference's."""
    rng = np.random.default_rng(0)
    for heads in (64, 8):
        x = rng.standard_normal((2, 5, heads, 128)).astype(np.float32) * 3
        scale = rng.standard_normal(128).astype(np.float32) * 0.1
        jx, js = jnp.asarray(x, dtype), jnp.asarray(scale, dtype)
        want = jax_rms_norm(jx, js, 1e-5)
        got = rms_norm(bridge.to_torch(np.asarray(jx)),
                       bridge.to_torch(np.asarray(js)), 1e-5)
        assert str(got.dtype).split(".")[-1] == want.dtype.name == dtype
        want32 = np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want32, **TOL)
        else:
            assert _rel(got.float(), want32) <= BF16_TOL


def test_qk_norm_runs_on_q_and_k_before_rope(monkeypatch):
    """In ``_qkv`` the norm takes q (B, S, H, hd) with ``qn`` and k (B, S,
    KVH, hd) with ``kn``, then rope takes each normed tensor, in that
    order, as in the reference's; without ``qk_norm`` no norm runs
    there."""
    seen = []
    real_norm, real_rope = transformer.rms_norm, transformer.rope

    def norm(x, w, eps):
        out = real_norm(x, w, eps)
        seen.append(("norm", tuple(x.shape), id(out)))
        return out

    def rope(x, pos, theta):
        seen.append(("rope", tuple(x.shape), id(x)))
        return real_rope(x, pos, theta)

    monkeypatch.setattr(transformer, "rms_norm", norm)
    monkeypatch.setattr(transformer, "rope", rope)
    _, tcfg = _cfgs("twin")
    rng = np.random.default_rng(1)
    p = {"wq": torch.from_numpy(rng.standard_normal((64, 128), np.float32)),
         "wk": torch.from_numpy(rng.standard_normal((64, 16), np.float32)),
         "wv": torch.from_numpy(rng.standard_normal((64, 16), np.float32)),
         "qn": torch.zeros(16), "kn": torch.zeros(16)}
    x = torch.from_numpy(rng.standard_normal((2, 3, 64), np.float32))
    transformer._qkv(tcfg, p, x, torch.arange(3))
    assert [(k, s) for k, s, _ in seen] == [
        ("norm", (2, 3, 8, 16)), ("norm", (2, 3, 1, 16)),
        ("rope", (2, 3, 8, 16)), ("rope", (2, 3, 1, 16))]
    assert seen[2][2] == seen[0][2] and seen[3][2] == seen[1][2]
    seen.clear()
    transformer._qkv(dataclasses.replace(tcfg, qk_norm=False), p, x,
                     torch.arange(3))
    assert [k for k, _, _ in seen] == ["rope", "rope"]


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bucket", [None, 16])
def test_prefill_and_decode_match_reference(ref, bucket):
    """Prefill (an exact-length batch, or a 16-token bucket with ragged
    true lengths 11 and 7) and three decode steps fed the reference's
    greedy tokens, the scales ``qn``/``kn`` (and the other norms) set
    non-zero so QK-norm is not the identity's scaling: logits and the K/V
    caches within tolerance, positions equal."""
    _, japi, jparams, _, tapi, _ = ref
    rng = np.random.default_rng(2)
    jparams = dict(jparams, layers=dict(jparams["layers"]))
    for name in ("qn", "kn", "ln1", "ln2"):
        leaf = jparams["layers"][name]
        jparams["layers"][name] = jnp.asarray(
            0.3 * rng.standard_normal(leaf.shape), leaf.dtype)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    japi = _jitted(japi)
    toks = _prompts(np.random.default_rng(3), 2, 11)
    jbatch, tbatch = {"tokens": jnp.asarray(toks)}, {"tokens": _tok(toks)}
    if bucket:
        lengths = np.asarray([11, 7], np.int32)
        toks = np.pad(toks, ((0, 0), (0, bucket - 11)))
        jbatch = {"tokens": jnp.asarray(toks),
                  "lengths": jnp.asarray(lengths)}
        tbatch = {"tokens": _tok(toks), "lengths": torch.from_numpy(lengths)}
    jcache, jlog = japi.prefill(jparams, jbatch, cache_len=24)
    tcache, tlog = tapi.prefill(tparams, tbatch, cache_len=24)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
        jlog, jcache = japi.decode_step(jparams, jcache, jnp.asarray(nxt))
        tlog, tcache = tapi.decode_step(tparams, tcache, _tok(nxt))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for key in ("k", "v"):
        assert tuple(tcache[key].shape) == np.shape(jcache[key])
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), **TOL)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


def test_greedy_tokens_equal_reference(ref):
    _, japi, jparams, _, tapi, tparams = ref
    toks = _prompts(np.random.default_rng(5), 1, 9)
    want = jax_greedy(_jitted(japi), jparams, {"tokens": jnp.asarray(toks)},
                      steps=6, cache_len=24, prompt_bucket=16)
    got = greedy_generate(tapi, tparams, {"tokens": _tok(toks)}, steps=6,
                          cache_len=24, prompt_bucket=16)
    assert got.tolist() == np.asarray(want).tolist()


# ---------------------------------------------------------------------------
# weights: compaction and the streamed build
# ---------------------------------------------------------------------------

def test_sparsify_params_compacts_bit_equal(ref):
    """The port's sparsify_params at 0.8 (the reduced granularity PRUNE,
    as the CLI prunes) on the reference's weights: 7 x L stacked
    ``GriffinWeights`` leaves and the untied head, each leaf's ``b_comp``,
    ``kidx``, ``cnt`` and ``inv_perm`` bit-equal to the reference's; wk
    and wv stay dense where they are narrower than the pruning's minimum
    (the twin's single kv head), and so do ``qn``/``kn``."""
    _, _, jparams, tcfg, _, tparams = ref
    want = jax.tree.map(np.asarray, jax_sparsify(jparams, 0.8, **PRUNE))
    got = sparsify_params(tparams, 0.8, **PRUNE)
    leaves = [("layers", n) for n in ("wq", "wk", "wv", "wo", "w_gate",
                                      "w_up", "w_down")] + [("head",)]
    compacted = 0
    for path in leaves:
        g, w = got, want
        for p in path:
            g, w = g[p], w[p]
        if not isinstance(g, GriffinWeights):
            assert path[-1] in ("wk", "wv") and \
                tcfg.num_kv_heads * tcfg.hd < 32
            np.testing.assert_array_equal(_bits(bridge.tensor_to_array(g)),
                                          _bits(w))
            continue
        compacted += 1
        for f in ("b_comp", "kidx", "cnt", "inv_perm"):
            np.testing.assert_array_equal(
                _bits(bridge.tensor_to_array(getattr(g, f))),
                _bits(getattr(w, f)))
        if path[0] == "layers":
            assert g.b_comp.shape[0] == tcfg.num_layers
    assert compacted == (8 if tcfg.num_kv_heads * tcfg.hd >= 32 else 6)
    for name in ("qn", "kn"):
        assert torch.equal(got["layers"][name], tparams["layers"][name])


def test_sparse_prefill_and_decode_match_reference(ref):
    """The reference's weights pruned and compacted at 0.6 (PRUNE), through
    the kernels' plain versions against the reference's interpret-mode
    kernels: a bucketed prefill and two decode steps within tolerance."""
    jcfg, _, jparams, _, tapi, _ = ref
    japi = jax_build_model(jcfg)            # traced under the scope
    jsp = jax_sparsify(jparams, 0.6, **PRUNE)
    tsp = bridge.to_torch(jax.tree.map(np.asarray, jsp))
    toks = np.pad(_prompts(np.random.default_rng(7), 2, 9), ((0, 0), (0, 7)))
    lengths = np.asarray([9, 5], np.int32)
    with jax_scope(use_kernels=True, interpret=True):
        jcache, jlog = japi.prefill(jsp, {"tokens": jnp.asarray(toks),
                                          "lengths": jnp.asarray(lengths)},
                                    cache_len=24)
    with sparse_execution(use_kernels=True):
        tcache, tlog = tapi.prefill(tsp, {"tokens": _tok(toks),
                                          "lengths": torch.from_numpy(
                                              lengths)}, cache_len=24)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    for _ in range(2):
        nxt = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
        with jax_scope(use_kernels=True, interpret=True):
            jlog, jcache = japi.decode_step(jsp, jcache, jnp.asarray(nxt))
        with sparse_execution(use_kernels=True):
            tlog, tcache = tapi.decode_step(tsp, tcache, _tok(nxt))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)


@pytest.mark.parametrize("variant,sparsity", [("reduced", 0.8),
                                              ("reduced", 0.6),
                                              ("twin", 0.8)])
def test_streamed_build_bit_equals_sparsify_of_init(variant, sparsity):
    """``init_sparse_params(api, gen, s, **PRUNE)`` equals
    ``sparsify_params(api.init(gen), s, **PRUNE)`` bit for bit, every
    leaf (the twin's dense wk/wv and the zero ``qn``/``kn`` included),
    and leaves the generator where ``init`` leaves it."""
    _, cfg = _cfgs(variant)
    api = build_model(cfg, device="cpu")
    g1, g2 = api.generator(0), api.generator(0)
    want = sparsify_params(api.init(g1), sparsity, **PRUNE)
    got = init_sparse_params(api, g2, sparsity, **PRUNE)
    _assert_trees_equal(got, want)
    assert torch.equal(g1.get_state(), g2.get_state())
    assert isinstance(got["layers"]["w_down"], GriffinWeights)
    assert got["layers"]["w_down"].b_comp.shape[0] == cfg.num_layers


def test_streamed_build_bit_equals_with_a_plan_at_a_deeper_grid():
    """A config whose layers reach different grid depths (so the stacks
    pad): d_ff 256 at 16 x 16 pruning, 0.7, without a plan and with a
    tuned plan's coarser compaction on w_down."""
    from repro_torch.tuning.plan import FamilyPlan, GemmRule
    cfg = dataclasses.replace(get_config(ARCH).reduced(), d_ff=256,
                              num_layers=3)
    api = build_model(cfg, device="cpu")
    plan = FamilyPlan(family="vlm", rules=(GemmRule(
        match="w_down", block_k=32, block_n=32, unit=8),))
    for p in (None, plan):
        want = sparsify_params(api.init(api.generator(1)), 0.7, plan=p,
                               **PRUNE)
        got = init_sparse_params(api, api.generator(1), 0.7, plan=p,
                                 **PRUNE)
        _assert_trees_equal(got, want)
    assert want["layers"]["w_down"].block_k == 32


def _parent_dense_init(cfg, gen):
    """The dense family's draw sequence as it was before the vlm family
    was ported: each stacked leaf drawn whole, in this order."""
    dt = getattr(torch, cfg.dtype)
    L, D, F = cfg.num_layers, cfg.d_model, cfg.d_ff
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    layers = {
        "ln1": torch.zeros((L, D), dtype=dt),
        "ln2": torch.zeros((L, D), dtype=dt),
        "wq": dense_init(gen, (L, D, H * hd), D, dt),
        "wk": dense_init(gen, (L, D, KVH * hd), D, dt),
        "wv": dense_init(gen, (L, D, KVH * hd), D, dt),
        "wo": dense_init(gen, (L, H * hd, D), H * hd, dt),
        "w_gate": dense_init(gen, (L, D, F), D, dt),
        "w_up": dense_init(gen, (L, D, F), D, dt),
        "w_down": dense_init(gen, (L, F, D), F, dt),
    }
    if cfg.qk_norm:
        layers["qn"] = torch.zeros((L, hd), dtype=dt)
        layers["kn"] = torch.zeros((L, hd), dtype=dt)
    params = {"embed": dense_init(gen, (cfg.vocab_size, D), cfg.vocab_size,
                                  dt, scale=1.0),
              "final_norm": torch.zeros((D,), dtype=dt), "layers": layers}
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, (D, cfg.vocab_size), D, dt)
    return params


@pytest.mark.parametrize("arch", ["llama3.2-1b", "stablelm-1.6b",
                                  "minitron-8b"])
def test_dense_family_init_bits_unchanged(arch):
    """The dense family keeps its stacked draws: ``init_params`` equals
    the parent's draw sequence bit for bit (reduced, fp32 and bf16, with
    and without QK-norm), and has no draw order; the vlm family's draws
    give other bits from the same seed."""
    for dtype in ("float32", "bfloat16"):
        for qk in (False, True):
            cfg = dataclasses.replace(get_config(arch).reduced(),
                                      dtype=dtype, qk_norm=qk)
            api = build_model(cfg, device="cpu")
            g1, g2 = api.generator(4), api.generator(4)
            _assert_trees_equal(api.init(g1), _parent_dense_init(cfg, g2))
            assert torch.equal(g1.get_state(), g2.get_state())
            assert api.draws is None
    cfg = get_config(arch).reduced()
    vlm = build_model(dataclasses.replace(cfg, family="vlm"), device="cpu")
    dense = build_model(cfg, device="cpu")
    assert not torch.equal(vlm.init(vlm.generator(4))["layers"]["wk"],
                           dense.init(dense.generator(4))["layers"]["wk"])


def test_weight_sparsity_compares_one_matrix_at_a_time():
    """The engine's B-side sparsity of a dense tree (Mode.A's) compares one
    (K, N) matrix of a stacked leaf with zero at a time, never the whole
    stack: at chameleon-34b's full width the stack's mask and its float
    copy beside the 63.9 GiB of dense weights ran the card out of memory.
    The value is the exact zero fraction, as before within fp32's
    rounding."""
    from torch.overrides import TorchFunctionMode
    from repro_torch.runtime.engine import weight_sparsity
    from repro_torch.sparsity import sparsity_of

    cfg = dataclasses.replace(get_config(ARCH).reduced(), num_layers=3)
    api = build_model(cfg, device="cpu")
    params = api.init(api.generator(0))
    params["layers"]["w_up"][1, :, :32] = 0
    params["head"][:8] = 0
    compared = []

    class Record(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in (torch.eq, torch.Tensor.eq, torch.Tensor.__eq__):
                compared.append(args[0].numel())
            return func(*args, **(kwargs or {}))

    with Record():
        got = weight_sparsity(params)
    largest = max(cfg.d_model * cfg.d_ff, cfg.d_model * cfg.vocab_size)
    assert compared and max(compared) <= largest
    leaves = [params["layers"][n] for n in ("wq", "wk", "wv", "wo",
                                            "w_gate", "w_up", "w_down")]
    leaves.append(params["head"])
    exact = [float((t == 0).sum()) / t.numel() for t in leaves]
    assert got == pytest.approx(float(np.mean(exact)), rel=1e-12)
    assert got == pytest.approx(
        float(np.mean([float(sparsity_of(t)) for t in leaves])), rel=1e-6)
    assert got > 0


# ---------------------------------------------------------------------------
# the bf16 dtype flow
# ---------------------------------------------------------------------------

def _dtype_spy(store, real, weight_arg=True):
    def f(x, w, *args, **kw):
        wd = w.b_comp.dtype if hasattr(w, "b_comp") else \
            getattr(w, "dtype", None)
        store.append((str(x.dtype).split(".")[-1],
                      str(wd).split(".")[-1] if weight_arg else "-"))
        return real(x, w, *args, **kw)
    return f


@pytest.mark.parametrize("variant", VARIANTS)
def test_every_gemm_and_norm_input_has_the_reference_dtype_at_bf16(
        variant, monkeypatch):
    """Reduced (and the twin) in bf16, pruned and compacted at 0.6, under
    the kernels: every GEMM of a prefill and a decode step takes the same
    (A, weight) dtypes in the same order as the reference's (all bf16: 7
    a layer and the untied head), every ``rms_norm`` (the layer norms and
    QK-norm) and every ``rope`` takes the reference's input dtypes, and
    the logits stay within relative L2 2e-2 of the reference's."""
    _, japi, jparams, _, tapi, _ = _pair(variant, dtype="bfloat16")
    # layers unrolled, so the spies see every layer (a scan traces its
    # body once)
    japi = jax_build_model(dataclasses.replace(japi.cfg, scan_layers=False))
    jsp = jax_sparsify(jparams, 0.6, **PRUNE)
    tsp = bridge.to_torch(jax.tree.map(np.asarray, jsp))
    seen = {(pkg, op): [] for pkg in ("jax", "torch")
            for op in ("gemm", "norm", "rope")}
    for pkg, mod in (("jax", jtf), ("torch", transformer)):
        monkeypatch.setattr(mod, "griffin_linear", _dtype_spy(
            seen[pkg, "gemm"], mod.griffin_linear))
        monkeypatch.setattr(mod, "rms_norm", _dtype_spy(
            seen[pkg, "norm"], mod.rms_norm))
        monkeypatch.setattr(mod, "rope", _dtype_spy(
            seen[pkg, "rope"], mod.rope, weight_arg=False))
    toks = _prompts(np.random.default_rng(8), 1, 12)
    with jax_scope(use_kernels=True, interpret=True):
        jcache, jlog = japi.prefill(jsp, {"tokens": jnp.asarray(toks)},
                                    cache_len=20)
    with sparse_execution(use_kernels=True):
        tcache, tlog = tapi.prefill(tsp, {"tokens": _tok(toks)},
                                    cache_len=20)
    gaps = [_rel(tlog, jlog.astype(jnp.float32))]
    nxt = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
    with jax_scope(use_kernels=True, interpret=True):
        jlog, _ = japi.decode_step(jsp, jcache, jnp.asarray(nxt))
    with sparse_execution(use_kernels=True):
        tlog, _ = tapi.decode_step(tsp, tcache, _tok(nxt))
    gaps.append(_rel(tlog, jlog.astype(jnp.float32)))
    for op in ("gemm", "norm", "rope"):
        assert seen["torch", op] == seen["jax", op], op
    L = tapi.cfg.num_layers
    assert set(seen["torch", "gemm"]) == {("bfloat16", "bfloat16")}
    assert len(seen["torch", "gemm"]) == 2 * (7 * L + 1)
    # per layer ln1, qn, kn, ln2, then the final norm, per model call
    assert set(seen["torch", "norm"]) == {("bfloat16", "bfloat16")}
    assert len(seen["torch", "norm"]) == 2 * (4 * L + 1)
    assert seen["torch", "rope"] == [("bfloat16", "-")] * (2 * 2 * L)
    assert tlog.dtype == torch.bfloat16
    assert max(gaps) <= BF16_TOL, gaps


# ---------------------------------------------------------------------------
# the serving engines
# ---------------------------------------------------------------------------

def _jax_engine(api, params, decode_chunk, page_size=None, fused=True,
                a_sparsity=None):
    conf = JaxEngineConfig(arena=JaxArenaConfig(
        num_slots=2, cache_len=16, page_size=page_size)).with_fields(
        decode_chunk=decode_chunk, fused=fused)
    if a_sparsity is not None:
        conf = conf.with_fields(use_kernels=True, interpret=True,
                                a_sparsity=a_sparsity)
    return JaxServeEngine(api, params, config=conf)


def _oracle_equal(eng, api, params, reqs, outs):
    for r in reqs:
        with eng._scope():
            want = greedy_generate(api, params, r.as_batch(eng.device),
                                   steps=r.max_new_tokens,
                                   cache_len=eng.cache_len,
                                   prompt_bucket=eng.bucket_for(
                                       r.prompt_len))
        assert outs[r.rid].tokens == want[0].tolist(), r.rid


ENGINES = {"fixed": ({}, None), "paged": (dict(page_size=4), None),
           "stepwise": (dict(fused=False), None), "mode_a": ({}, 0.5),
           "mode_ab": ({}, 0.5)}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_engine_equals_reference_and_oracle(engine):
    """The fixed, paged (4-token pages) and stepwise (fused off, one-step
    decode) engines on the reduced config, and the Mode.A (dense weights)
    and Mode.AB (compacted at 0.6) engines with declared activation
    sparsity 0.5 through the kernels' plain versions (the reference's in
    interpret mode): Mode, tokens and counters equal to the reference's
    engine of the same config, and every request equal to the port's
    batch-1 greedy oracle on the engine's bucket."""
    jcfg, japi, jparams, tcfg, tapi, tparams = _cached()
    kw, a_sparsity = ENGINES[engine]
    if engine == "mode_ab":
        jparams = jax_sparsify(jparams, 0.6, **PRUNE)
        tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    chunk = 1 if engine == "stepwise" else 3
    jeng = _jax_engine(japi if a_sparsity else _jitted(japi), jparams, chunk,
                       a_sparsity=a_sparsity, **kw)
    jouts = jeng.run(jax_synthetic_trace(jcfg, **TRACE))
    conf = EngineConfig().with_fields(num_slots=2, cache_len=16,
                                      decode_chunk=chunk, **kw)
    if a_sparsity is not None:
        conf = conf.with_fields(use_kernels=True, a_sparsity=a_sparsity)
    teng = ServeEngine(tapi, tparams, conf)
    assert (teng._paged is not None) == (engine == "paged")
    reqs = synthetic_trace(tcfg, **TRACE)
    touts = teng.run(reqs)
    assert teng.mode.value == jeng.mode.value == {
        "mode_a": "A", "mode_ab": "AB"}.get(engine, "dense")
    for key in ("emitted", "decode_steps", "prefill_calls", "host_syncs"):
        assert teng.stats[key] == jeng.stats[key], key
    for r in reqs:
        assert touts[r.rid].tokens == jouts[r.rid].tokens, r.rid
    _oracle_equal(teng, tapi, tparams, reqs, touts)


def _depth_true_cfg():
    """Full-width chameleon-34b's depth (48 layers) at the reduced width,
    QK-norm kept, in bf16: every GEMM of a full-width model call with its
    dtypes, at a size the CPU runs in seconds."""
    return dataclasses.replace(get_config(ARCH).reduced(), num_layers=48,
                               dtype="bfloat16")


@pytest.mark.parametrize("path", list(chip_smoke.VLM_PATHS))
def test_dispatch_per_model_call_equals_the_smokes_gates(path, monkeypatch):
    """Per model call of a depth-true model on the smoke path's arena, the
    GEMMs its launch gates count: 7 x 48 + 1 = 337 through griffin_spmm
    (weights from the streamed build, as launch.serve builds them), no
    dense_gemm (the head is untied and compacted); Mode.A (the dense
    weights of the same draw order) 337 through sparse_a with 4 x 48 + 1
    = 193 metadata builds (wq/wk/wv, wo, w_gate/w_up, w_down, then the
    head); no plain GEMM; the tokens equal the oracle's."""
    from repro_torch.kernels.sparse_a import ops as sparse_a_ops
    from repro_torch.models import common
    spec = chip_smoke.VLM_PATHS[path]
    builds = []
    for mod in (common, sparse_a_ops):
        def counted(*args, _real=mod.compact_activations, **kw):
            builds.append(1)
            return _real(*args, **kw)
        monkeypatch.setattr(mod, "compact_activations", counted)
    cfg = _depth_true_cfg()
    api = build_model(cfg, device="cpu")
    if spec["sparsity"]:
        params = init_sparse_params(api, api.generator(0), spec["sparsity"],
                                    **PRUNE)
    else:
        params = api.init(api.generator(0))
    conf = EngineConfig().with_fields(
        num_slots=2, cache_len=16, decode_chunk=4, use_kernels=True,
        a_sparsity=spec["a_sparsity"])
    eng = ServeEngine(api, params, conf)
    reqs = synthetic_trace(cfg, **TRACE)
    reset_kernel_dispatch()
    outs = eng.run(reqs)
    got = kernel_dispatch_counts()
    calls = eng.stats["prefill_calls"] + eng.stats["decode_steps"]
    launches = spec["launches"]
    assert eng.mode.value == spec["mode"]
    assert got == {"kernel": calls * (launches["griffin_spmm"]
                                      + launches["dense_gemm"]
                                      + launches["sparse_a"])}
    assert launches["dense_gemm"] == 0
    assert launches["griffin_spmm"] + launches["sparse_a"] == 7 * 48 + 1
    assert len(builds) == calls * launches["sparse_a_meta"]
    if spec["mode"] == "A":
        assert launches["sparse_a_meta"] == 4 * 48 + 1
    _oracle_equal(eng, api, params, reqs, outs)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def _batch(cfg, seed=0, B=2, S=16):
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(1, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    batch["labels"][0, :2] = -1
    return batch


@pytest.mark.parametrize("variant", VARIANTS)
def test_loss_and_grads_match_reference(variant):
    """The fp32 loss and every gradient leaf, ``qn`` and ``kn`` included
    (non-zero: QK-norm's scale enters as 1 + w), against the reference's
    ``value_and_grad`` on its own weights, remat on."""
    jcfg, japi, jparams, tcfg, _, tparams = _cached(variant)
    batch = _batch(jcfg)
    jl, jg = jax.jit(jax.value_and_grad(japi.loss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    jg = bridge.to_torch(jax.tree.map(np.asarray, jg))
    api = build_model(dataclasses.replace(tcfg, remat=True), device="cpu")
    tl, tg = value_and_grad(api.loss, tparams, bridge.to_torch(batch))
    assert abs(float(tl) - float(jl)) <= LOSS_TOL * abs(float(jl))
    got, want = list(keyed_leaves(tg)), list(keyed_leaves(jg))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype == torch.float32, path
        assert _rel(a, b.numpy()) <= GRAD_TOL, path
    for name in ("qn", "kn"):
        assert float(tg["layers"][name].abs().max()) > 0


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sparse_b", "mode_a", "paged"])
def test_serve_cli_reduced_parity(tmp_path, capsys, monkeypatch, mode):
    """``--arch chameleon-34b --reduced --device cpu --sparsity 0.8
    --use-kernels --parity`` ends in "parity OK" in Sparse.B, its weights
    from the streamed build; in Mode.A (``--sparsity 0`` and a config
    file declaring activation sparsity 0.5, dense weights of the same
    draw order, no streamed build); and on the paged arena."""
    used = []
    real = launch_serve.init_sparse_params
    monkeypatch.setattr(launch_serve, "init_sparse_params",
                        lambda *a, **k: used.append(1) or real(*a, **k))
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--sparsity",
            "0.8", "--use-kernels", "--parity", "--measure-every", "64"]
    if mode == "mode_a":
        conf = tmp_path / "engine.json"
        conf.write_text('{"kernels": {"use_kernels": true, '
                        '"a_sparsity": 0.5}}')
        argv[argv.index("0.8")] = "0"
        argv += ["--config", str(conf)]
    if mode == "paged":
        argv += ["--page-size", "4"]
    launch_serve.main(argv)
    out = capsys.readouterr().out
    assert used == ([] if mode == "mode_a" else [1])
    assert f"mode {'A' if mode == 'mode_a' else 'B'}" in out
    assert "parity OK: all 8 requests" in out
    assert ("paged, " in out) == (mode == "paged")


def test_serve_reuses_an_earlier_runs_weights(monkeypatch):
    """``launch.serve(params=...)`` serves an earlier run's weights as
    they are and builds nothing, as ``chip_smoke.py``'s later paths of a
    family do: Sparse.B's tokens, and the paged arena's, equal those of a
    run that built the weights, and a second build gives the same bits
    (what makes the reuse safe)."""
    config = EngineConfig().with_fields(num_slots=2, decode_chunk=4,
                                        use_kernels=True, measure_every=64)
    kw = dict(reduced=True, sparsity=0.8, seed=0, device="cpu",
              requests=4, prompt_lens=(6, 10), gen_lens=(2, 4))
    first = launch_serve.serve(ARCH, config=config, **kw)
    built = []
    for name in ("init_sparse_params", "sparsify_params"):
        real = getattr(launch_serve, name)
        monkeypatch.setattr(launch_serve, name, lambda *a, _r=real, **k:
                            built.append(1) or _r(*a, **k))
    for conf in (config, config.with_fields(page_size=4)):
        again = launch_serve.serve(ARCH, config=conf, params=first.params,
                                   **kw)
        assert again.params is first.params and built == []
        assert {r: o.tokens for r, o in again.engine.outputs.items()} == \
            {r: o.tokens for r, o in first.engine.outputs.items()}
    fresh = launch_serve.serve(ARCH, config=config, **kw).params
    assert built == [1]
    want = dict(keyed_leaves(first.params))
    got = dict(keyed_leaves(fresh))
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_tuning_workload_serves_vlm():
    cfg, api, params, cache_len, trace = tuning_workload(
        "vlm", reduced=True, device="cpu")
    assert cfg.family == "vlm" and cfg.name == "chameleon-34b-smoke"
    assert api.device.type == "cpu" and api.draws is not None
    assert cache_len == 27 and len(trace()) == 6
    assert params["layers"]["qn"].shape == (2, 16)
    assert params["layers"]["w_gate"].shape == (2, 64, 128)


def test_autotune_tunes_vlm_with_the_defaults_tokens(tmp_path, capsys):
    """``launch.autotune --families vlm`` runs the pipeline on reduced
    chameleon: every candidate's tokens equal the default's, and the plan
    has a vlm entry."""
    from repro_torch.launch import autotune as autotune_cli
    from repro_torch.tuning import load_plan
    out = tmp_path / "plan.json"
    autotune_cli.main(["--families", "vlm", "--reduced", "--device",
                       "cpu", "--budget", "4", "--shortlist", "2",
                       "--repeats", "1", "--out", str(out), "--cache-dir",
                       str(tmp_path / "dse")])
    text = capsys.readouterr().out
    assert "tokens identical to default" in text
    fam = load_plan(str(out)).family("vlm")
    assert fam is not None and fam.measured["winner"] in fam.predicted
