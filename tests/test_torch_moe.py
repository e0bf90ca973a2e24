"""The port's mixture-of-experts family (repro_torch.models.moe and the moe
branch of repro_torch.models.transformer) against the JAX package's on
reduced mixtral-8x7b (4 experts top-2, window 32) and reduced
llama4-scout-17b-a16e (4 experts top-1) in fp32 and, for the dtype flow,
in bf16, on the reference's own weights bridged through numpy and on
inputs drawn with numpy from a seed.  The reference runs as its own tests
run it: on the CPU, its Pallas kernels in interpret mode.

Tolerances: ``moe_ffn``'s and ``expert_linear``'s outputs and the logits
within relative L2 1e-5 (fp32; summation orders differ), the aux term
within relative 1e-6; the expert buffer (which token sits in which slot, so the
kept mask and the slot ids) bit-equal; at bf16 the logits within
relative L2 2e-2; greedy and engine tokens, dispatch counts, pruned and
compacted leaves and the streamed build exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
import repro.models.transformer as jtf
from repro.configs import get_config as jax_get_config
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.models import build_model as jax_build_model
from repro.models.common import sparse_execution as jax_scope
from repro.runtime.config import ArenaConfig as JaxArenaConfig
from repro.runtime.config import EngineConfig as JaxEngineConfig
from repro.runtime.engine import ServeEngine as JaxServeEngine
from repro.runtime.engine import synthetic_trace as jax_synthetic_trace
from repro.sparsity import sparsify_params as jax_sparsify
import chip_smoke
from repro_torch import bridge
from repro_torch.configs import MoEConfig, get_config
from repro_torch.kernels import GriffinWeights
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model, moe, transformer
from repro_torch.models.common import (kernel_dispatch_counts,
                                       reset_kernel_dispatch,
                                       sparse_execution)
from repro_torch.runtime.config import EngineConfig
from repro_torch.runtime.engine import ServeEngine, synthetic_trace
from repro_torch.runtime.paging import discover_paged_keys
from repro_torch.runtime.serve import greedy_generate
from repro_torch.sparsity import (GEMM_WEIGHTS, PRUNE, init_sparse_params,
                                  sparsify_params)
from repro_torch.tuning.measure import tuning_workload

ARCH = "mixtral-8x7b"
SCOUT = "llama4-scout-17b-a16e"
RTOL = 1e-5
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


def _jitted(japi):
    """The reference's model API with prefill and decode under ``jax.jit``
    (eagerly, every call re-traces its layer scans)."""
    return dataclasses.replace(
        japi, prefill=jax.jit(japi.prefill, static_argnames=("cache_len",)),
        decode_step=jax.jit(japi.decode_step))


def _pair(arch=ARCH, dtype="float32"):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype)
    japi = _jitted(jax_build_model(jcfg))
    jparams = japi.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    tapi = build_model(tcfg, device="cpu")
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    return jcfg, japi, jparams, tcfg, tapi, tparams


@pytest.fixture(scope="module")
def ref():
    """(jax cfg, jax api, jax params, port cfg, port api, port params) on
    the reference's seed-0 weights of reduced mixtral-8x7b."""
    return _pair()


@pytest.fixture(scope="module")
def sparse_ref(ref):
    """``ref`` with the reference's weights pruned and compacted at 0.6
    (PRUNE), bridged."""
    jcfg, japi, jparams, tcfg, tapi, _ = ref
    jsp = jax_sparsify(jparams, 0.6, **PRUNE)
    return jcfg, japi, jsp, tcfg, tapi, \
        bridge.to_torch(jax.tree.map(np.asarray, jsp))


def _rel(got, want) -> float:
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _close(got, want, tol=RTOL):
    assert got.shape == tuple(np.shape(want))
    assert _rel(got, want) <= tol


def _t(a):
    return torch.from_numpy(np.array(a))


def _tok(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [ARCH, SCOUT])
def test_config_and_reduced_match_reference(arch):
    for jcfg, tcfg in ((jax_get_config(arch), get_config(arch)),
                       (jax_get_config(arch).reduced(),
                        get_config(arch).reduced())):
        for f in ("family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "hd", "d_ff", "vocab_size", "window",
                  "act", "norm_eps", "rope_theta", "dtype", "kv_chunk",
                  "tie_embeddings"):
            assert getattr(jcfg, f) == getattr(tcfg, f), f
        assert dataclasses.asdict(jcfg.moe) == dataclasses.asdict(tcfg.moe)
    assert get_config(ARCH).reduced().moe == MoEConfig(4, 2)
    assert get_config(SCOUT).reduced().moe == MoEConfig(4, 1)
    assert get_config(ARCH).reduced().window == 32
    # the other families' reduced rule is unchanged
    assert get_config("llama3.2-1b").reduced().moe is None


@pytest.mark.parametrize("arch,experts_b", [(ARCH, (45.0e9, 45.2e9)),
                                            (SCOUT, (96.5e9, 96.7e9))])
def test_full_width_draw_order_counts_the_reference_parameters(arch,
                                                                experts_b):
    """The full-width draw order, counted without drawing: its GEMM
    leaves hold the reference registry's total (mixtral 46.4 B, of which
    45.1 B experts; with embed and head 46.7 B), each matrix one (layer)
    or (layer, expert) slice, in the order wq, wk, wv, wo, router, w_gate,
    w_up, w_down."""
    cfg = get_config(arch)
    draws = transformer.param_draws(cfg)
    size = {d.path[-1]: int(np.prod(d.lead + d.shape)) for d in draws}
    gemm = sum(v for k, v in size.items()
               if k in ("wq", "wk", "wv", "wo", "router", "w_gate", "w_up",
                        "w_down"))
    assert gemm == jax_build_model(jax_get_config(arch)).param_count_total()
    experts = size["w_gate"] + size["w_up"] + size["w_down"]
    assert experts_b[0] < experts < experts_b[1]
    order = [d.path[-1] for d in draws if len(d.shape) == 2]
    assert order == ["embed", "wq", "wk", "wv", "wo", "router", "w_gate",
                     "w_up", "w_down", "head"]
    E = cfg.moe.num_experts
    lead = {d.path[-1]: d.lead for d in draws}
    assert lead["w_down"] == (cfg.num_layers, E) and lead["wq"] == \
        (cfg.num_layers,) and lead["head"] == ()
    if arch == ARCH:
        assert 46.6e9 < sum(size.values()) < 46.8e9


def test_init_has_the_reference_layout(ref):
    _, _, jparams, _, tapi, _ = ref
    own = tapi.init(tapi.generator(0))
    want = jax.tree.map(np.asarray, jparams)

    def walk(a, b, path=""):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
            return
        assert tuple(a.shape) == b.shape, path
        assert str(a.dtype).split(".")[-1] == b.dtype.name, path

    walk(own, want)


# ---------------------------------------------------------------------------
# moe_ffn and expert_linear against the reference
# ---------------------------------------------------------------------------

def _moe_params(rng, D, F, E):
    return {"router": rng.standard_normal((D, E)).astype(np.float32) / 4,
            "w_gate": rng.standard_normal((E, D, F)).astype(np.float32)
            / np.sqrt(D),
            "w_up": rng.standard_normal((E, D, F)).astype(np.float32)
            / np.sqrt(D),
            "w_down": rng.standard_normal((E, F, D)).astype(np.float32)
            / np.sqrt(F)}


def _spy_buffers(monkeypatch, module, into):
    """Record the first ``expert_linear`` input of each ``moe_ffn`` call:
    the (E, C, D) expert buffer, which token sits in which slot."""
    real = module.expert_linear

    def spy(xe, w):
        if not into or into[-1] is None:
            into.append(np.array(xe) if not isinstance(xe, torch.Tensor)
                        else xe.detach().numpy().copy())
        return real(xe, w)

    monkeypatch.setattr(module, "expert_linear", spy)


@pytest.mark.parametrize("case", ["trained", "drop_free", "valid"])
@pytest.mark.parametrize("E,K", [(4, 2), (4, 1), (8, 2)])
def test_moe_ffn_matches_reference(monkeypatch, E, K, case):
    """At the trained capacity (an N at which the reference drops), drop
    free, and with a right-pad mask: the expert buffer bit-equal to the
    reference's (so the kept mask and every slot id), the output within
    tolerance, the aux term within relative 1e-6; and the port's kept
    mask and slot ids place each token where the buffer holds it."""
    rng = np.random.default_rng(100 * E + 10 * K + len(case))
    N, D, F = 24, 32, 48
    p = _moe_params(rng, D, F, E)
    x = rng.standard_normal((N, D)).astype(np.float32)
    # a shared feature that the router weighs toward expert 0, so that
    # expert overflows its trained capacity
    x[:, 0] = 2.0
    p["router"][0, 0] = 1.5
    valid = None
    if case == "valid":
        valid = np.arange(N) < 17
    jcfg, tcfg = JaxMoEConfig(E, K), MoEConfig(E, K)
    kw = dict(drop_free=case == "drop_free")
    jbuf, tbuf = [], []
    _spy_buffers(monkeypatch, jmoe, jbuf)
    _spy_buffers(monkeypatch, moe, tbuf)
    jout, jaux = jmoe.moe_ffn(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              jcfg, **kw, valid=None if valid is None
                              else jnp.asarray(valid))
    tp = {k: _t(v) for k, v in p.items()}
    tx = _t(x)
    tvalid = None if valid is None else _t(valid)
    tout, taux = moe.moe_ffn(tp, tx, tcfg, **kw, valid=tvalid)
    np.testing.assert_array_equal(tbuf[0], jbuf[0])
    _close(tout, jout)
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    _, _, e_flat, keep, slot, C = moe.route(tp, tx, tcfg, valid=tvalid,
                                            **kw)
    assert C == jbuf[0].shape[1]
    flat = tbuf[0].reshape(E * C, D)
    rows = np.repeat(np.arange(N), K)
    for j in np.flatnonzero(keep.numpy()):
        np.testing.assert_array_equal(flat[int(slot[j])], x[rows[j]])
    dropped = ~keep.numpy()
    assert (slot.numpy()[dropped] == E * C).all()
    if valid is not None:
        assert not keep.numpy()[np.repeat(~valid, K)].any()
        assert keep.numpy()[np.repeat(valid, K)].all()
    elif case == "trained":
        assert dropped.any()                  # the reference drops here
        assert (flat.any(1).sum()) == keep.sum().item()
    else:
        assert keep.all()


def test_top_k_breaks_ties_toward_the_lower_index():
    p = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                      [0.5, 0.2, 0.1, 0.2]])
    vals, idx = moe.top_k(p, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(p.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    # a row's choice does not depend on the other rows
    for r in range(3):
        assert torch.equal(moe.top_k(p[r:r + 1], 2)[1], idx[r:r + 1])


@pytest.mark.parametrize("stacked", ["compacted", "plain"])
def test_expert_linear_matches_reference(stacked):
    """On the reference's stacked ``GriffinWeights`` (pruned 0.6 at 16 x
    16 / unit 8) bridged through ``repro_torch.bridge``, and on a plain
    stack under the kernels' scope, against the reference's
    ``expert_linear`` (its Pallas kernels in interpret mode)."""
    rng = np.random.default_rng(3)
    E, C, D, F = 4, 6, 64, 96
    w = rng.standard_normal((E, D, F)).astype(np.float32)
    xe = rng.standard_normal((E, C, D)).astype(np.float32)
    jw = jnp.asarray(w)
    if stacked == "compacted":
        jw = jax_sparsify({"w_up": jw}, 0.6, **PRUNE)["w_up"]
    tw = bridge.to_torch(jax.tree.map(np.asarray, jw))
    assert isinstance(tw, GriffinWeights) == (stacked == "compacted")
    with jax_scope(use_kernels=True, interpret=True):
        want = jmoe.expert_linear(jnp.asarray(xe), jw)
    with sparse_execution(use_kernels=True):
        reset_kernel_dispatch()
        got = moe.expert_linear(_t(xe), tw)
        assert kernel_dispatch_counts() == {"kernel": E}
    _close(got, want)
    # the plain route: one batched product, counted as plain
    reset_kernel_dispatch()
    plain = moe.expert_linear(_t(xe), _t(w))
    assert kernel_dispatch_counts() == {"plain": 1}
    _close(plain, jnp.einsum("eck,ekn->ecn", jnp.asarray(xe), jnp.asarray(w)))


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

def _prompts(rng, B, S, vocab=128):
    return rng.integers(1, vocab, (B, S)).astype(np.int32)


def _prefill_decode(japi, jparams, tapi, tparams, toks, lengths, cache_len,
                    steps=3, scope=None):
    """Prefill then ``steps`` greedy decode steps through both packages
    (the port's greedy feedback taken from the reference's logits), the
    logits of every call compared."""
    batch = {"tokens": jnp.asarray(toks)}
    tbatch = {"tokens": _tok(toks)}
    if lengths is not None:
        batch["lengths"] = jnp.asarray(lengths, jnp.int32)
        tbatch["lengths"] = torch.tensor(lengths, dtype=torch.int32)
    jctx = jax_scope(use_kernels=True, interpret=True) if scope else None
    tctx = sparse_execution(use_kernels=True) if scope else None
    if jctx:
        with jctx:
            jcache, jlog = japi.prefill(jparams, batch, cache_len=cache_len)
    else:
        jcache, jlog = japi.prefill(jparams, batch, cache_len=cache_len)
    if tctx:
        with tctx:
            tcache, tlog = tapi.prefill(tparams, tbatch, cache_len=cache_len)
    else:
        tcache, tlog = tapi.prefill(tparams, tbatch, cache_len=cache_len)
    gaps = [_rel(tlog, jlog)]
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(jlog, -1))[:, None].astype(np.int32)
        if jctx:
            with jax_scope(use_kernels=True, interpret=True):
                jlog, jcache = japi.decode_step(jparams, jcache,
                                                jnp.asarray(tok))
            with sparse_execution(use_kernels=True):
                tlog, tcache = tapi.decode_step(tparams, tcache, _tok(tok))
        else:
            jlog, jcache = japi.decode_step(jparams, jcache, jnp.asarray(tok))
            tlog, tcache = tapi.decode_step(tparams, tcache, _tok(tok))
        gaps.append(_rel(tlog, jlog))
    return gaps, tcache, jcache


@pytest.mark.parametrize("S,lengths", [(10, None), (16, (16, 11)),
                                       (40, None)],
                         ids=["exact", "bucketed", "past_window"])
def test_prefill_and_decode_match_reference(ref, S, lengths):
    """Prefill logits and three decode steps' logits within tolerance of
    the reference's: an exact-length prompt (trained capacity), a
    right-padded bucket with true lengths (drop-free), and a 40-token
    prompt past the 32-token window with cache_len 48 > window (the cache
    keeps the last window, rolled; decode writes slot pos % 32, through
    the wrap); the rolling cache bit-equal in shape and within tolerance
    in value."""
    _, japi, jparams, _, tapi, tparams = ref
    toks = _prompts(np.random.default_rng(S), 2, S)
    cache_len = 48 if S == 40 else 24
    gaps, tcache, jcache = _prefill_decode(japi, jparams, tapi, tparams,
                                           toks, lengths, cache_len)
    assert max(gaps) <= RTOL, gaps
    assert tuple(tcache["k"].shape) == np.shape(jcache["k"])
    _close(tcache["k"], jcache["k"])
    if S == 40:
        assert tcache["k"].shape[2] == 32


@pytest.mark.parametrize("arch", [ARCH, SCOUT])
def test_sparse_prefill_and_decode_match_reference(arch):
    """The reference's weights pruned and compacted at 0.6 (PRUNE), through
    the kernels' plain versions against the reference's interpret-mode
    kernels: prefill (exact and bucketed) and decode logits within
    tolerance; mixtral top-2 and llama4-scout top-1."""
    _, japi, jparams, _, tapi, _ = _pair(arch)
    japi = jax_build_model(japi.cfg)            # traced under the scope
    jsp = jax_sparsify(jparams, 0.6, **PRUNE)
    tsp = bridge.to_torch(jax.tree.map(np.asarray, jsp))
    rng = np.random.default_rng(7)
    for S, lengths in ((9, None), (16, (16, 5))):
        gaps, _, _ = _prefill_decode(japi, jsp, tapi, tsp,
                                     _prompts(rng, 2, S), lengths, 24,
                                     steps=2, scope=True)
        assert max(gaps) <= RTOL, (S, gaps)


def test_greedy_tokens_equal_reference(ref):
    from repro.runtime.serve import greedy_generate as jax_greedy
    _, japi, jparams, _, tapi, tparams = ref
    toks = _prompts(np.random.default_rng(5), 1, 9)
    want = jax_greedy(japi, jparams, {"tokens": jnp.asarray(toks)},
                      steps=6, cache_len=20)
    got = greedy_generate(tapi, tparams, {"tokens": _tok(toks)}, steps=6,
                          cache_len=20)
    assert got.tolist() == np.asarray(want).tolist()


def test_every_gemm_input_has_the_reference_dtype_at_bf16(monkeypatch):
    """Reduced mixtral in bf16, pruned and compacted at 0.6, under the
    kernels: every GEMM of a prefill and a decode step takes the same
    (A, weight) dtypes in the same order as the reference's (the router
    fp32 against its weight upcast, every other GEMM bf16), and the
    logits stay within relative L2 2e-2 of the reference's."""
    _, japi, jparams, _, tapi, _ = _pair(dtype="bfloat16")
    # layers unrolled, so the spy sees every layer's GEMMs (a scan traces
    # its body once)
    japi = jax_build_model(dataclasses.replace(japi.cfg, scan_layers=False))
    jsp = jax_sparsify(jparams, 0.6, **PRUNE)
    tsp = bridge.to_torch(jax.tree.map(np.asarray, jsp))
    seen = {"jax": [], "torch": []}

    def spy(store, real):
        def f(x, w, **kw):
            wd = w.b_comp.dtype if hasattr(w, "b_comp") else w.dtype
            store.append((str(x.dtype).split(".")[-1],
                          str(wd).split(".")[-1]))
            return real(x, w, **kw)
        return f

    for mod in (jmoe, jtf):
        monkeypatch.setattr(mod, "griffin_linear",
                            spy(seen["jax"], mod.griffin_linear))
    for mod in (moe, transformer):
        monkeypatch.setattr(mod, "griffin_linear",
                            spy(seen["torch"], mod.griffin_linear))
    toks = _prompts(np.random.default_rng(8), 1, 12)
    gaps, _, _ = _prefill_decode(japi, jsp, tapi, tsp, toks, None, 20,
                                 steps=1, scope=True)
    assert seen["torch"] == seen["jax"]
    pair = {("float32", "float32"), ("bfloat16", "bfloat16")}
    assert set(seen["torch"]) == pair
    # per call: 2 layers x (4 + 3 x 4 experts) + head bf16, 2 routers fp32
    assert seen["torch"].count(("float32", "float32")) == 2 * 2
    assert len(seen["torch"]) == 2 * (2 * (4 + 1 + 12) + 1)
    assert max(gaps) <= 2e-2, gaps


# ---------------------------------------------------------------------------
# pruning, the streamed build, the bridge
# ---------------------------------------------------------------------------

def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(want, GriffinWeights):
        assert isinstance(got, GriffinWeights), path
        for f in ("b_comp", "kidx", "cnt", "inv_perm", "perm"):
            g, w = getattr(got, f), getattr(want, f)
            assert (g is None) == (w is None), (path, f)
            if w is not None:
                assert g.dtype == w.dtype and torch.equal(g, w), (path, f)
        assert (got.k, got.n, got.block_k, got.block_n, got.a_thr) == \
            (want.k, want.n, want.block_k, want.block_n, want.a_thr)
        return
    assert got.dtype == want.dtype and torch.equal(got, want), path


@pytest.mark.parametrize("arch,sparsity", [(ARCH, 0.8), (ARCH, 0.6),
                                           (SCOUT, 0.8)])
def test_streamed_build_bit_equals_sparsify_of_init(arch, sparsity):
    """``init_sparse_params(api, gen, s, **PRUNE)`` equals
    ``sparsify_params(api.init(gen), s, **PRUNE)`` bit for bit, every
    leaf, and leaves the generator where ``init`` leaves it; (L, E)
    stacks keep their two-axis lead."""
    cfg = get_config(arch).reduced()
    api = build_model(cfg, device="cpu")
    g1, g2 = api.generator(0), api.generator(0)
    want = sparsify_params(api.init(g1), sparsity, **PRUNE)
    got = init_sparse_params(api, g2, sparsity, **PRUNE)
    _assert_trees_equal(got, want)
    assert torch.equal(g1.get_state(), g2.get_state())
    gw = got["layers"]["moe"]["w_down"]
    assert gw.b_comp.shape[:2] == (2, 4) and gw.kidx.shape[:2] == (2, 4)
    assert isinstance(got["layers"]["moe"]["router"], torch.Tensor)


def test_streamed_build_bit_equals_at_a_deeper_grid():
    """A config whose members reach different grid depths (so the stack
    pads): d_ff 256 at 16 x 16 pruning, 0.7, and a tuned plan's coarser
    compaction on w_down."""
    from repro_torch.tuning.plan import FamilyPlan, GemmRule
    cfg = dataclasses.replace(get_config(ARCH).reduced(), d_ff=256)
    api = build_model(cfg, device="cpu")
    plan = FamilyPlan(family="moe", rules=(GemmRule(
        match="w_down", block_k=32, block_n=32, unit=8),))
    for p in (None, plan):
        want = sparsify_params(api.init(api.generator(1)), 0.7, plan=p,
                               **PRUNE)
        got = init_sparse_params(api, api.generator(1), 0.7, plan=p,
                                 **PRUNE)
        _assert_trees_equal(got, want)
    depths = {int(c.max()) for c in want["layers"]["moe"]["w_down"].cnt}
    assert want["layers"]["moe"]["w_down"].block_k == 32
    assert len(depths) >= 1


def test_streamed_build_needs_a_draw_order():
    api = build_model(get_config("llama3.2-1b").reduced(), device="cpu")
    with pytest.raises(NotImplementedError, match="streamed draw order"):
        init_sparse_params(api, api.generator(0), 0.8, **PRUNE)


@pytest.mark.parametrize("compact", [False, True])
def test_sparsify_params_on_expert_stacks(ref, compact):
    """The port's sparsify_params on the reference's weights equals the
    reference's bit for bit: (L, E)-stacked ``GriffinWeights`` for the
    expert leaves, the router dense (not a GEMM_WEIGHTS name)."""
    _, _, jparams, _, _, tparams = ref
    assert "router" not in GEMM_WEIGHTS
    want = jax.tree.map(np.asarray, jax_sparsify(jparams, 0.8,
                                                 compact=compact, **PRUNE))
    got = sparsify_params(tparams, 0.8, compact=compact, **PRUNE)
    for name in ("w_gate", "w_up", "w_down"):
        leaf, jl = got["layers"]["moe"][name], want["layers"]["moe"][name]
        assert isinstance(leaf, GriffinWeights) == compact
        if compact:
            assert leaf.b_comp.shape[:2] == (2, 4)
            for f in ("b_comp", "kidx", "cnt", "inv_perm"):
                np.testing.assert_array_equal(
                    _bits(bridge.tensor_to_array(getattr(leaf, f))),
                    _bits(getattr(jl, f)))
        else:
            np.testing.assert_array_equal(_bits(bridge.tensor_to_array(leaf)),
                                          _bits(jl))
    assert torch.equal(got["layers"]["moe"]["router"],
                       tparams["layers"]["moe"]["router"])


def test_bridge_round_trips_the_moe_subtree(sparse_ref):
    _, _, jsp, _, _, tsp = sparse_ref
    back = bridge.to_numpy(tsp)
    want = jax.tree.map(np.asarray, jsp)
    for name in ("w_gate", "w_up", "w_down"):
        gw, jgw = back["layers"]["moe"][name], want["layers"]["moe"][name]
        assert np.asarray(gw.b_comp).shape[:2] == (2, 4)
        for f in ("b_comp", "kidx", "cnt", "inv_perm"):
            np.testing.assert_array_equal(_bits(getattr(gw, f)),
                                          _bits(getattr(jgw, f)))
    np.testing.assert_array_equal(back["layers"]["moe"]["router"],
                                  want["layers"]["moe"]["router"])


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

def _jax_engine(api, params, sparse, decode_chunk, page_size=None,
                cache_len=16, fused=True, a_sparsity=0.0):
    conf = JaxEngineConfig(arena=JaxArenaConfig(
        num_slots=2, cache_len=cache_len, page_size=page_size)).with_fields(
        decode_chunk=decode_chunk, fused=fused)
    if sparse:
        conf = conf.with_fields(use_kernels=True, interpret=True,
                                a_sparsity=a_sparsity)
    return JaxServeEngine(api, params, config=conf)


def _port_engine(api, params, sparse, decode_chunk, page_size=None,
                 cache_len=16, **kw):
    conf = EngineConfig().with_fields(num_slots=2, cache_len=cache_len,
                                      decode_chunk=decode_chunk,
                                      page_size=page_size,
                                      use_kernels=sparse, **kw)
    return ServeEngine(api, params, conf)


def _oracle_equal(eng, api, params, reqs, outs):
    for r in reqs:
        with eng._scope():
            want = greedy_generate(api, params, r.as_batch(eng.device),
                                   steps=r.max_new_tokens,
                                   cache_len=eng.cache_len,
                                   prompt_bucket=eng.bucket_for(
                                       r.prompt_len))
        assert outs[r.rid].tokens == want[0].tolist(), r.rid


@pytest.mark.parametrize("engine", ["fixed", "paged", "stepwise", "mode_ab"])
def test_engine_equals_reference_and_oracle(ref, sparse_ref, engine):
    """The fixed, paged (4-token pages, cache_len 16 <= window 32), stepwise
    (fused off, one-step decode) and Mode.AB (compacted at 0.6, declared
    activation sparsity 0.5) engines: tokens and counters equal to the
    reference's engine of the same config, and every request equal to
    the port's batch-1 greedy oracle on the engine's bucket."""
    jcfg, japi, jparams, tcfg, tapi, tparams = ref
    kw, jkw, sparse = {}, {}, False
    if engine == "paged":
        kw = jkw = dict(page_size=4)
    if engine == "stepwise":
        kw = jkw = dict(fused=False)
    if engine == "mode_ab":
        _, _, jparams, _, _, tparams = sparse_ref
        japi = jax_build_model(jcfg)
        sparse = True
        kw, jkw = dict(a_sparsity=0.5), dict(a_sparsity=0.5)
    chunk = 1 if engine == "stepwise" else 3
    jeng = _jax_engine(japi, jparams, sparse, chunk, **jkw)
    jouts = jeng.run(jax_synthetic_trace(jcfg, **TRACE))
    teng = _port_engine(tapi, tparams, sparse, chunk, **kw)
    if engine == "paged":
        assert teng._paged is not None and teng._paged.paged_keys == \
            ("k", "v")
    reqs = synthetic_trace(tcfg, **TRACE)
    touts = teng.run(reqs)
    assert teng.mode.value == jeng.mode.value == \
        ("AB" if engine == "mode_ab" else "dense")
    for key in ("emitted", "decode_steps", "prefill_calls", "host_syncs"):
        assert teng.stats[key] == jeng.stats[key], key
    for r in reqs:
        assert touts[r.rid].tokens == jouts[r.rid].tokens, r.rid
    _oracle_equal(teng, tapi, tparams, reqs, touts)


def test_sparse_b_engine_launches_per_model_call(sparse_ref, monkeypatch):
    """Sparse.B at reduced size through KERNEL_DISPATCH: per model call
    griffin_spmm L x (4 + 3 E) + 1 = 33 (wq, wk, wv, wo, 4 experts' three
    leaves, the head) and the router through dense_gemm L = 2 times; the
    engine's tokens equal the oracle's."""
    _, _, _, tcfg, tapi, tsp = sparse_ref
    from repro_torch.models import common
    seen = []
    real = common.dense_matmul

    def spy(a, w):
        seen.append((a.dtype, tuple(w.shape)))
        return real(a, w)

    monkeypatch.setattr(common, "dense_matmul", spy)
    eng = _port_engine(tapi, tsp, True, 3)
    reqs = synthetic_trace(tcfg, **TRACE)
    reset_kernel_dispatch()
    outs = eng.run(reqs)
    calls = eng.stats["prefill_calls"] + eng.stats["decode_steps"]
    assert eng.mode.value == "B"
    assert kernel_dispatch_counts() == {"kernel": calls * (33 + 2)}
    assert seen == [(torch.float32, (64, 4))] * (2 * calls)
    _oracle_equal(eng, tapi, tsp, reqs, outs)


def test_paging_stays_on_only_within_the_window(ref):
    """cache_len 16 <= window 32 pages k/v; cache_len 64 > window pins the
    rolling cache at the window, so no leaf tracks cache_len and paging
    degrades whole to the fixed arena, as in the reference; its tokens
    equal the fixed arena's."""
    jcfg, japi, jparams, tcfg, tapi, tparams = ref
    from repro.runtime.paging import discover_paged_keys as jax_discover
    assert discover_paged_keys(tapi, 16) == jax_discover(japi, 16) == \
        ("k", "v")
    paged = _port_engine(tapi, tparams, False, 3, page_size=4, cache_len=64)
    assert paged._paged is None and paged.cache["k"].shape[2] == 32
    fixed = _port_engine(tapi, tparams, False, 3, cache_len=64)
    pouts = paged.run(synthetic_trace(tcfg, **TRACE))
    fouts = fixed.run(synthetic_trace(tcfg, **TRACE))
    for rid, o in fouts.items():
        assert pouts[rid].tokens == o.tokens


def _depth_true_cfg():
    """Full-width mixtral-8x7b's depth (32 layers) and its 8 experts top-2
    at the reduced width, in bf16: every GEMM of a full-width model call
    with its dtypes, at a size the CPU runs in seconds."""
    return dataclasses.replace(get_config(ARCH).reduced(), num_layers=32,
                               moe=MoEConfig(8, 2), dtype="bfloat16")


@pytest.mark.parametrize("path", ["moe_sparse_b", "moe_mode_ab"])
def test_dispatch_per_model_call_equals_the_smokes_gates(path, monkeypatch):
    """Per model call of a depth-true model, the GEMMs the smoke's launch
    gates count: 32 x (4 + 3 x 8) + 1 = 897 compacted leaves through
    griffin_spmm (all dual in Mode.AB), the 32 routers (fp32 A against the
    upcast fp32 weight) through dense_gemm, or in Mode.AB through sparse_a
    with one metadata build each; no plain GEMM."""
    from repro_torch.models import common
    from repro_torch.kernels.sparse_a import ops as sparse_a_ops
    spec = chip_smoke.MOE_PATHS[path]
    builds = []
    for mod in (common, sparse_a_ops):
        def counted(*args, _real=mod.compact_activations, **kw):
            builds.append(1)
            return _real(*args, **kw)
        monkeypatch.setattr(mod, "compact_activations", counted)
    cfg = _depth_true_cfg()
    api = build_model(cfg, device="cpu")
    params = init_sparse_params(api, api.generator(0), spec["sparsity"],
                                **PRUNE)
    conf = EngineConfig().with_fields(num_slots=2, cache_len=16,
                                      decode_chunk=4, use_kernels=True,
                                      a_sparsity=spec["a_sparsity"])
    eng = ServeEngine(api, params, conf)
    reset_kernel_dispatch()
    eng.run(synthetic_trace(cfg, **TRACE))
    got = kernel_dispatch_counts()
    calls = eng.stats["prefill_calls"] + eng.stats["decode_steps"]
    launches = spec["launches"]
    assert eng.mode.value == spec["mode"]
    want = {"kernel": calls * (launches["griffin_spmm"]
                               + launches["dense_gemm"]
                               + launches["sparse_a"])}
    if spec["dual"]:
        want["dual"] = calls * spec["dual"]
    assert got == want
    assert launches["griffin_spmm"] == 32 * (4 + 3 * 8) + 1
    mode_ab = path == "moe_mode_ab"
    assert launches["dense_gemm"] == (0 if mode_ab else 32)
    assert launches["sparse_a"] == launches["sparse_a_meta"] == \
        (32 if mode_ab else 0)
    assert len(builds) == calls * launches["sparse_a_meta"]


def test_mode_ab_skips_experts_no_token_chose():
    """In Mode.AB an expert that no token chose gets an all-zero buffer:
    a decode step of 2 rows top-2 of 8 experts leaves at least 4 experts
    empty, whose three GEMMs' A are all zero (what dual griffin_spmm skips
    whole on the card)."""
    cfg = _depth_true_cfg()
    rng = np.random.default_rng(4)
    p = _moe_params(rng, 64, 128, 8)
    tp = {k: _t(v) for k, v in p.items()}
    x = _t(rng.standard_normal((2, 64)).astype(np.float32))
    zero = []
    real = moe.expert_linear

    def spy(xe, w):
        zero.append(int((~xe.reshape(xe.shape[0], -1).any(1)).sum()))
        return real(xe, w)

    moe.expert_linear, saved = spy, moe.expert_linear
    try:
        moe.moe_ffn(tp, x, cfg.moe, drop_free=True)
    finally:
        moe.expert_linear = saved
    assert zero[0] >= 4 and zero == [zero[0]] * 3


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_build_model_defaults_to_the_card():
    cfg = get_config(ARCH)
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)
    api = build_model(cfg, device="cpu")
    assert api.device.type == "cpu" and api.draws is not None
    assert api.init_cache(1, 5000, device=torch.device("meta"))["k"].shape \
        == (32, 1, 4096, 8, 128)


@pytest.mark.parametrize("mode", ["sparse_b", "mode_ab", "paged"])
def test_serve_cli_reduced_parity(tmp_path, capsys, monkeypatch, mode):
    """``--arch mixtral-8x7b --reduced --device cpu --sparsity 0.8
    --use-kernels --parity`` ends in "parity OK" in Sparse.B, in Mode.AB
    (a config file declaring activation sparsity 0.5) and on the paged
    arena, its weights built by the streamed build."""
    from repro_torch import sparsity
    used = []
    real = sparsity.init_sparse_params
    monkeypatch.setattr(launch_serve, "init_sparse_params",
                        lambda *a, **k: used.append(1) or real(*a, **k))
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--sparsity",
            "0.8", "--use-kernels", "--parity", "--measure-every", "64"]
    if mode == "mode_ab":
        conf = tmp_path / "engine.json"
        conf.write_text('{"kernels": {"use_kernels": true, '
                        '"a_sparsity": 0.5}}')
        argv += ["--config", str(conf)]
    if mode == "paged":
        # cache_len 49 rounded to 52 > window 32 would degrade paging, so
        # the trace's prompts stay short
        argv += ["--page-size", "4", "--prompt-lens", "6,10", "--gen-lens",
                 "4,8"]
    launch_serve.main(argv)
    out = capsys.readouterr().out
    assert used == [1]
    assert f"mode {'AB' if mode == 'mode_ab' else 'B'}" in out
    assert "parity OK: all 8 requests" in out
    assert ("paged, " in out) == (mode == "paged")


def test_tuning_workload_serves_moe():
    cfg, api, params, cache_len, trace = tuning_workload(
        "moe", reduced=True, device="cpu")
    assert cfg.family == "moe" and api.device.type == "cpu"
    assert cfg.name == "mixtral-8x7b-smoke"
    assert cache_len == 27 and len(trace()) == 6
    assert params["layers"]["moe"]["w_gate"].shape == (2, 4, 64, 128)


def test_autotune_tunes_moe_with_the_defaults_tokens(tmp_path, capsys):
    """``launch.autotune --families moe`` runs the pipeline on reduced
    mixtral: every candidate's tokens equal the default's, and the plan
    has a moe entry."""
    from repro_torch.launch import autotune as autotune_cli
    from repro_torch.tuning import load_plan
    out = tmp_path / "plan.json"
    autotune_cli.main(["--families", "moe", "--reduced", "--device",
                       "cpu", "--budget", "4", "--shortlist", "2",
                       "--repeats", "1", "--out", str(out), "--cache-dir",
                       str(tmp_path / "dse")])
    text = capsys.readouterr().out
    assert "tokens identical to default" in text
    fam = load_plan(str(out)).family("moe")
    assert fam is not None and fam.measured["winner"] in fam.predicted
