"""The port's audio family (repro_torch.models.whisper) against the JAX
package's on reduced whisper-large-v3 (2 encoder + 2 decoder layers,
d_model 64, 4 heads of 16, d_ff 128, 8 frames) in fp32 and, for the dtype
flow, in bf16, on the reference's own weights bridged through numpy and
on inputs drawn with numpy from a seed.

Tolerances: encoder outputs, caches and logits within rtol 1e-5 / atol
1e-5 (fp32; the attention's and the norms' sums run in other orders); at
bf16 prefill and decode logits within relative L2 2e-2 of the
reference's (the MLPs' bf16 ``gelu`` rounds apart between jax and torch);
the sinusoids, pruned and compacted leaves, the trace, engine and greedy
tokens and the dispatch counts exact.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jattn
import repro.models.whisper as jw
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.optim.compression import quantize_rows as jax_quantize_rows
from repro.runtime.config import ArenaConfig as JaxArenaConfig
from repro.runtime.config import EngineConfig as JaxEngineConfig
from repro.runtime.engine import ServeEngine as JaxServeEngine
from repro.runtime.engine import synthetic_trace as jax_synthetic_trace
from repro.runtime.paging import discover_paged_keys as jax_discover
from repro.sparsity import sparsify_params as jax_sparsify
import chip_smoke
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import GriffinWeights
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention, build_model, whisper
from repro_torch.models.common import (kernel_dispatch_counts,
                                       reset_kernel_dispatch,
                                       sparse_execution)
from repro_torch.runtime.config import EngineConfig
from repro_torch.runtime.engine import (Request, ServeEngine,
                                        synthetic_trace, weight_sparsity)
from repro_torch.runtime.paging import discover_paged_keys
from repro_torch.runtime.serve import greedy_generate
from repro_torch.sparsity import (GEMM_WEIGHTS, PRUNE, prune_for,
                                  sparsify_params)
from repro_torch.tuning.measure import tuning_workload

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "whisper-large-v3"
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
    """The reference's model API with prefill and decode under
    ``jax.jit`` (eagerly, every call re-traces its layer scans)."""
    return dataclasses.replace(
        japi, prefill=jax.jit(japi.prefill, static_argnames=("cache_len",)),
        decode_step=jax.jit(japi.decode_step))


def _pair(dtype="float32"):
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), dtype=dtype)
    japi = _jitted(jax_build_model(jcfg))
    jparams = japi.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype)
    tapi = build_model(tcfg, device="cpu")
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    return jcfg, japi, jparams, tcfg, tapi, tparams


@pytest.fixture(scope="module")
def ref():
    """(jax cfg, jax api, jax params, port cfg, port api, port params) on
    the reference's seed-0 weights."""
    return _pair()


@pytest.fixture(scope="module")
def ref_bf16():
    return _pair("bfloat16")


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel_l2(got, want):
    g, w = _f32(got), _f32(want)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _inputs(rng, B, S, F=8, D=64, vocab=128):
    toks = rng.integers(1, vocab, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, F, D)).astype(np.float32)
    return toks, frames


def _jbatch(toks, frames, lengths=None):
    b = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    if lengths is not None:
        b["lengths"] = jnp.asarray(lengths, jnp.int32)
    return b


def _tbatch(toks, frames, lengths=None):
    b = {"tokens": torch.from_numpy(toks.astype(np.int64)),
         "frames": torch.from_numpy(frames)}
    if lengths is not None:
        b["lengths"] = torch.tensor(lengths, dtype=torch.int32)
    return b


def _tok(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------

def test_config_and_reduced_match_reference():
    fields = ("family", "num_layers", "encoder_layers", "enc_frames",
              "d_model", "num_heads", "num_kv_heads", "d_ff", "vocab_size",
              "hd", "act", "norm_eps", "rope_theta", "dtype", "kv_chunk",
              "is_encdec", "tie_embeddings")
    for jcfg, tcfg in ((jax_get_config(ARCH), get_config(ARCH)),
                       (jax_get_config(ARCH).reduced(),
                        get_config(ARCH).reduced())):
        for f in fields:
            assert getattr(tcfg, f) == getattr(jcfg, f), f
    full = get_config(ARCH)
    assert (full.encoder_layers, full.num_layers, full.enc_frames) == \
        (32, 32, 1500)
    assert not get_config("llama3.2-1b").is_encdec


def test_parameter_count_of_full_width():
    """The draw order's leaves at full width: the reference registry's
    analytic count (1.47 B in the layers' GEMMs) plus the 51866 x 1280
    embedding and head, about 1.60 B parameters (3.2 GB of bf16)."""
    cfg = get_config(ARCH)
    draws = whisper.param_draws(cfg)
    gemm = sum(math.prod(d.lead + d.shape) for d in draws
               if not d.zeros and d.path[-1] in GEMM_WEIGHTS
               and d.path[-1] != "head")
    assert gemm == jax_build_model(jax_get_config(ARCH)).param_count()
    total = sum(math.prod(d.lead + d.shape) for d in draws)
    assert 1.59e9 < total < 1.61e9
    assert total - gemm - 2 * 51866 * 1280 == (2 * 32 * 2 + 2) * 1280 + \
        32 * 1280


def test_param_tree_has_the_reference_shapes(ref):
    _, _, jparams, tcfg, tapi, _ = ref
    mine = tapi.init(tapi.generator(0))
    want = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), jparams)
    got = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)[6:]),
                       mine)
    assert got == want
    assert float(mine["embed"].float().std()) > 0.9
    assert torch.equal(mine["enc_layers"]["ln1"],
                       torch.zeros((2, 64)))


@pytest.mark.parametrize("F,D", [(8, 64), (1500, 1280)])
def test_sinusoid_is_bit_equal(F, D):
    got = whisper._sinusoid(F, D, torch.device("cpu"))
    want = np.asarray(jw._sinusoid(F, D))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_encode_matches_reference(ref):
    jcfg, _, jparams, tcfg, _, tparams = ref
    _, frames = _inputs(np.random.default_rng(1), 2, 1)
    want = jw.encode(jcfg, jparams, jnp.asarray(frames))
    got = whisper.encode(tcfg, tparams, torch.from_numpy(frames))
    assert got.dtype == torch.float32 and got.shape == (2, 8, 64)
    _close(got, want)


@pytest.mark.parametrize("Sq,Sk,chunk", [(8, 40, 16), (40, 40, 16),
                                         (1500, 1500, 512)])
def test_non_causal_attention_over_a_ragged_tail(Sq, Sk, chunk):
    """Bidirectional attention whose KV length is no multiple of the chunk
    (40 = 2 x 16 + 8; full width's 1500 = 2 x 512 + 476, at 2 heads):
    the padded keys of the last chunk are masked, as in the reference."""
    rng = np.random.default_rng(Sk + Sq)
    q = rng.standard_normal((1, Sq, 2, 16)).astype(np.float32)
    k = rng.standard_normal((1, Sk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, Sk, 2, 16)).astype(np.float32)
    want = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=False, kv_chunk=chunk)
    got = attention.attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=False,
                              kv_chunk=chunk)
    _close(got, want)


@pytest.mark.parametrize("lengths", [None, (10, 7)])
def test_prefill_matches_reference(ref, lengths):
    """Prefill logits and every cache leaf (self K/V padded to the cache
    length, cross K/V over the frames, the per-row positions of a
    bucketed prompt) within tolerance of the reference's."""
    jcfg, japi, jparams, tcfg, tapi, tparams = ref
    toks, frames = _inputs(np.random.default_rng(2), 2, 10)
    jc, jl = japi.prefill(jparams, _jbatch(toks, frames, lengths),
                          cache_len=16)
    tc, tl = tapi.prefill(tparams, _tbatch(toks, frames, lengths),
                          cache_len=16)
    _close(tl, jl)
    assert set(tc) == set(jc)
    for key in ("k", "v", "xk", "xv"):
        assert tuple(tc[key].shape) == jc[key].shape
        _close(tc[key], jc[key])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def _paged(cache, page_size, int8, quantize):
    """A fixed (L, B, S, H, hd) cache's k/v rewritten onto pages: row b's
    logical page j on physical page 1 + b * max_pages + j (page 0 is the
    DUMP page), int8 with per-token scales when ``int8``."""
    k = np.asarray(cache["k"])
    L, B, S, H, hd = k.shape
    maxp = S // page_size
    pages = (1 + np.arange(B)[:, None] * maxp
             + np.arange(maxp)[None]).astype(np.int32)
    out = {key: np.asarray(v) for key, v in cache.items()}
    for key in ("k", "v"):
        x = np.asarray(cache[key]).reshape(L, B * maxp, page_size, H, hd)
        pool = np.zeros((L, 1 + B * maxp, page_size, H, hd), x.dtype)
        pool[:, 1:] = x
        if int8:
            q, s = quantize(jnp.asarray(pool), 3)
            out[key], out[key + "_scale"] = np.asarray(q), np.asarray(s)
        else:
            out[key] = pool
    out["pages"] = pages
    return out


@pytest.mark.parametrize("arena", ["fixed", "paged", "paged_int8"])
def test_decode_steps_match_reference(ref, arena):
    """Four decode steps with per-row positions from one prefill on the
    fixed arena, on pages and on int8 pages (the seven-leaf branch): the
    logits and the self K/V written within tolerance of the reference's,
    the cross K/V untouched."""
    jcfg, japi, jparams, tcfg, tapi, tparams = ref
    rng = np.random.default_rng(4)
    toks, frames = _inputs(rng, 2, 10)
    jc, _ = japi.prefill(jparams, _jbatch(toks, frames, (10, 6)),
                         cache_len=16)
    if arena != "fixed":
        jc = _paged(jc, 4, arena == "paged_int8", jax_quantize_rows)
    tc = bridge.to_torch(jax.tree.map(np.asarray, jc))
    jc = jax.tree.map(jnp.asarray, jc)
    xk = tc["xk"].clone()
    feed = rng.integers(1, 128, (2, 4))
    for t in range(4):
        jl, jc = japi.decode_step(jparams, jc, jnp.asarray(feed[:, t:t + 1]))
        tl, tc = tapi.decode_step(tparams, tc, _tok(feed[:, t:t + 1]))
        _close(tl, jl)
    for key in ("k", "v") + (("k_scale", "v_scale") if arena == "paged_int8"
                             else ()):
        if arena == "paged_int8" and key in ("k", "v"):
            diff = np.abs(tc[key].numpy().astype(np.int32)
                          - np.asarray(jc[key]).astype(np.int32))
            assert diff.max() <= 1
            continue
        _close(tc[key], jc[key])
    assert torch.equal(tc["xk"], xk)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


# ---------------------------------------------------------------------------
# the bf16 dtype flow
# ---------------------------------------------------------------------------

def test_every_gemm_input_has_the_reference_dtype_at_bf16(ref_bf16,
                                                          monkeypatch):
    """At bf16 weights with fp32 frames, every ``griffin_linear`` call of
    a prefill and a decode step takes its input in the reference's dtype:
    the prefill's fp32 inputs are the encoder's six GEMMs and the cross
    ``wk``/``wv`` per layer (7 with 64 columns and 1 with 128 per encoder
    and decoder layer pair), the rest bf16; the sequence of (input dtype,
    weight dtype, weight shape) triples equals the reference's."""
    _, japi, jparams, _, tapi, tparams = ref_bf16
    japi = jax_build_model(japi.cfg)            # traced here, not cached
    seen = {"jax": [], "torch": []}

    def spy(side, real):
        def f(x, w, **kw):
            seen[side].append((str(x.dtype).split(".")[-1],
                               str(w.dtype).split(".")[-1],
                               tuple(w.shape[-2:])))
            return real(x, w, **kw)
        return f

    monkeypatch.setattr(jw, "griffin_linear", spy("jax", jw.griffin_linear))
    monkeypatch.setattr(whisper, "griffin_linear",
                        spy("torch", whisper.griffin_linear))
    toks, frames = _inputs(np.random.default_rng(3), 1, 8)
    jcache, _ = japi.prefill(jparams, _jbatch(toks, frames))
    tcache, _ = tapi.prefill(tparams, _tbatch(toks, frames))
    prefill = list(seen["torch"])
    # the reference's layer scans trace each body once; the port loops
    assert len(prefill) == 2 * 6 + 2 * 10 + 1
    assert set(prefill) == set(seen["jax"])
    f32 = [s for s in prefill if s[0] == "float32"]
    assert len(f32) == 2 * 8
    assert sum(s[2][0] == 64 for s in f32) == 14
    assert sum(s[2][0] == 128 for s in f32) == 2
    assert all(s[1] == "bfloat16" for s in prefill)
    seen["jax"].clear()
    seen["torch"].clear()
    japi.decode_step(jparams, jcache, jnp.asarray(toks[:, :1]))
    tapi.decode_step(tparams, tcache, _tok(toks[:, :1]))
    assert len(seen["torch"]) == 2 * 8 + 1
    assert {s[0] for s in seen["torch"]} == {"bfloat16"}
    assert set(seen["torch"]) == set(seen["jax"])


@pytest.mark.parametrize("S", [8, 13])
def test_bf16_prefill_and_decode_logits_match_reference(ref_bf16, S):
    """Prefill logits and 6 decode steps' logits at bf16 within relative
    L2 2e-2 of the reference's; the prefill's cross K/V fp32 in both."""
    _, japi, jparams, _, tapi, tparams = ref_bf16
    rng = np.random.default_rng(5)
    toks, frames = _inputs(rng, 2, S)
    jcache, jlog = japi.prefill(jparams, _jbatch(toks, frames),
                                cache_len=24)
    tcache, tlog = tapi.prefill(tparams, _tbatch(toks, frames), cache_len=24)
    assert tcache["xk"].dtype == torch.float32 == \
        bridge.array_to_tensor(np.asarray(jcache["xk"])).dtype
    assert tcache["k"].dtype == tlog.dtype == torch.bfloat16
    gaps = [_rel_l2(tlog, jlog), _rel_l2(tcache["xk"], jcache["xk"])]
    feed = rng.integers(1, 128, (2, 6))
    for t in range(6):
        jlog, jcache = japi.decode_step(jparams, jcache,
                                        jnp.asarray(feed[:, t:t + 1]))
        tlog, tcache = tapi.decode_step(tparams, tcache,
                                        _tok(feed[:, t:t + 1]))
        gaps.append(_rel_l2(tlog, jlog))
    assert max(gaps) <= 2e-2, gaps


def test_bf16_arena_holds_the_cross_kv_in_bf16(ref_bf16):
    """The engine's admission casts the prefill's fp32 cross K/V into its
    bf16 arena, as the reference's does (``sl.astype(pl.dtype)``): the
    arena row equals the prefill's cast bit for bit, and equals the
    reference engine's arena within one bf16 rounding."""
    jcfg, japi, jparams, tcfg, tapi, tparams = ref_bf16
    conf = EngineConfig().with_fields(num_slots=2, cache_len=16,
                                      decode_chunk=1)
    eng = ServeEngine(tapi, tparams, conf)
    assert eng.cache["xk"].dtype == torch.bfloat16
    req = synthetic_trace(tcfg, **TRACE)[0]
    req.max_new_tokens = 2
    eng.add(req)
    eng.step()
    cache1, _ = eng._prefill(req)
    assert cache1["xk"].dtype == torch.float32
    assert torch.equal(eng.cache["xk"][:, 0],
                       cache1["xk"][:, 0].to(torch.bfloat16))
    jeng = JaxServeEngine(japi, jparams, config=JaxEngineConfig(
        arena=JaxArenaConfig(num_slots=2, cache_len=16)).with_fields(
        decode_chunk=1))
    jreq = jax_synthetic_trace(jcfg, **TRACE)[0]
    jreq.max_new_tokens = 2
    jeng.add(jreq)
    jeng.step()
    assert str(jeng.cache["xk"].dtype) == "bfloat16"
    assert _rel_l2(eng.cache["xk"][:, 0], jeng.cache["xk"][:, 0]) <= 1e-2


# ---------------------------------------------------------------------------
# pruning and the bridge on the two stacks
# ---------------------------------------------------------------------------

def _bits(x):
    a = bridge.tensor_to_array(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    return a.view(np.uint8)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("compact", [False, True])
def test_sparsify_params_on_both_stacks(ref, compact):
    """The encoder's 6 GEMM leaves a layer, the decoder's 10 and the head
    pruned and compacted as the reference does: ``kidx``/``cnt``/
    ``b_comp``/``inv_perm`` bit for bit, the embedding and the norm scales
    left as they are."""
    _, _, jparams, _, _, tparams = ref
    want = dict(_leaves(jax.tree.map(
        np.asarray, jax_sparsify(jparams, 0.8, compact=compact, **PRUNE))))
    got = dict(_leaves(sparsify_params(tparams, 0.8, compact=compact,
                                       **PRUNE)))
    assert set(got) == set(want)
    compacted = set()
    for path, leaf in got.items():
        jl = want[path]
        if isinstance(leaf, GriffinWeights):
            compacted.add(path)
            for f in ("b_comp", "kidx", "cnt", "inv_perm"):
                np.testing.assert_array_equal(_bits(getattr(leaf, f)),
                                              _bits(getattr(jl, f)))
            assert (leaf.k, leaf.n, leaf.block_k, leaf.block_n) == \
                (jl.k, jl.n, jl.block_k, jl.block_n)
        else:
            np.testing.assert_array_equal(_bits(leaf), _bits(jl),
                                          str(path))
    gemms = {p for p in got if p[-1] in GEMM_WEIGHTS}
    assert len(gemms) == 6 + 10 + 1
    assert compacted == (gemms if compact else set())


def test_weight_sparsity_counts_both_stacks(ref):
    from repro.runtime.engine import weight_sparsity as jax_weight_sparsity
    _, _, jparams, _, _, tparams = ref
    sp = jax_sparsify(jparams, 0.6, **PRUNE)
    got = sparsify_params(tparams, 0.6, **PRUNE)
    assert weight_sparsity(got) == pytest.approx(jax_weight_sparsity(sp),
                                                  abs=1e-12)


# ---------------------------------------------------------------------------
# requests, traces and the serving engine
# ---------------------------------------------------------------------------

def test_synthetic_trace_equals_reference():
    """Tokens, frames (fp32, bit for bit), lengths and arrivals of the
    reference's trace, reduced and at full width's 1500 x 1280 frames."""
    for jcfg, tcfg in ((jax_get_config(ARCH).reduced(),
                        get_config(ARCH).reduced()),
                       (jax_get_config(ARCH), get_config(ARCH))):
        kw = dict(TRACE, num_requests=2) if tcfg.enc_frames > 8 else TRACE
        want = jax_synthetic_trace(jcfg, **kw)
        got = synthetic_trace(tcfg, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g.rid, g.max_new_tokens, g.arrival) == \
                (w.rid, w.max_new_tokens, w.arrival)
            np.testing.assert_array_equal(g.tokens, w.tokens)
            assert set(g.extras) == set(w.extras) == {"frames"}
            assert g.extras["frames"].dtype == np.float32
            assert g.extras["frames"].shape == (tcfg.enc_frames,
                                                tcfg.d_model)
            np.testing.assert_array_equal(g.extras["frames"],
                                          w.extras["frames"])
    # a decoder-only family draws no frames, so its trace is unchanged
    assert synthetic_trace(get_config("llama3.2-1b").reduced(),
                           **TRACE)[0].extras is None


def test_as_batch_puts_the_frames_on_the_device_with_a_leading_one():
    req = synthetic_trace(get_config(ARCH).reduced(), **TRACE)[0]
    batch = req.as_batch(torch.device("cpu"), 8)
    assert batch["frames"].shape == (1, 8, 64)
    assert batch["frames"].dtype == torch.float32
    assert batch["tokens"].shape == (1, 8)
    assert int(batch["lengths"][0]) == req.prompt_len


def test_engine_refuses_a_frameless_request(ref):
    _, _, _, _, tapi, tparams = ref
    eng = ServeEngine(tapi, tparams, EngineConfig().with_fields(
        num_slots=1, cache_len=8))
    with pytest.raises(ValueError, match="frames"):
        eng.add(Request(rid=1, tokens=np.zeros((2,), np.int32),
                        max_new_tokens=2))
    eng.add(Request(rid=2, tokens=np.zeros((2,), np.int32),
                    max_new_tokens=2,
                    extras={"frames": np.zeros((8, 64), np.float32)}))
    with pytest.raises(ValueError, match="cache_len"):
        eng.add(Request(rid=3, tokens=np.zeros((6,), np.int32),
                        max_new_tokens=4,
                        extras={"frames": np.zeros((8, 64), np.float32)}))


def test_cross_attention_stays_fixed(ref):
    """xk/xv (encoder K/V) are written once at admission and never grow:
    they are not pageable (the reference's
    ``test_whisper_cross_attention_stays_fixed``), and a paged arena keeps
    them beside the k/v pools."""
    _, japi, _, _, tapi, tparams = ref
    assert discover_paged_keys(tapi, 16) == jax_discover(japi, 16) == \
        ("k", "v")
    assert "xk" not in discover_paged_keys(tapi, 16)
    eng = ServeEngine(tapi, tparams, EngineConfig().with_fields(
        num_slots=2, cache_len=16, page_size=4))
    assert eng._paged.paged_keys == ("k", "v")
    assert eng.cache["k"].shape == (2, 9, 4, 4, 16)
    assert eng.cache["xk"].shape == (2, 2, 8, 4, 16)


def _jax_engine(api, params, sparse, decode_chunk, page_size=None,
                cache_len=16, fused=True):
    conf = JaxEngineConfig(arena=JaxArenaConfig(
        num_slots=2, cache_len=cache_len, page_size=page_size)).with_fields(
        decode_chunk=decode_chunk, fused=fused)
    if sparse:
        conf = conf.with_fields(use_kernels=True, interpret=True)
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


@pytest.mark.parametrize("engine", ["fixed", "fixed_chunk1", "sparse",
                                    "paged", "stepwise"])
def test_engine_equals_reference_and_oracle(ref, engine):
    """The port's twin of ``test_engine_parity_dense_fast[whisper]``, of
    its sparse sweep (PRUNE, 0.6), of the paged arena and of the stepwise
    tick: tokens and stats equal to the reference engine's, and every
    request equal to the port's batch-1 greedy oracle on the same
    bucket."""
    jcfg, japi, jparams, tcfg, tapi, _ = ref
    sparse = engine == "sparse"
    if sparse:
        jparams = jax_sparsify(jparams, 0.6, **PRUNE)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    chunk = 1 if engine in ("fixed_chunk1", "stepwise") else 3
    page = 4 if engine == "paged" else None
    fused = engine != "stepwise"
    jeng = _jax_engine(japi, jparams, sparse, chunk, page_size=page,
                       fused=fused)
    jouts = jeng.run(jax_synthetic_trace(jcfg, **TRACE))
    teng = _port_engine(tapi, tparams, sparse, chunk, page_size=page,
                        fused=fused)
    assert (teng._paged is not None) == (page is not None)
    reqs = synthetic_trace(tcfg, **TRACE)
    touts = teng.run(reqs)
    assert teng.mode.value == jeng.mode.value == ("B" if sparse else "dense")
    for key in ("emitted", "decode_steps", "prefill_calls", "chunk_calls",
                "host_syncs"):
        assert teng.stats[key] == jeng.stats[key], key
    for r in reqs:
        assert touts[r.rid].tokens == jouts[r.rid].tokens, r.rid
    _oracle_equal(teng, tapi, tparams, reqs, touts)


def test_paged_int8_pages_serve_whisper(ref):
    """int8 pages on the decoder's k/v beside the fixed cross K/V: every
    request served, its tokens equal to a one-slot int8 engine serving
    it alone."""
    _, _, _, tcfg, tapi, tparams = ref
    eng = _port_engine(tapi, tparams, False, 3, page_size=4,
                       kv_dtype="int8")
    assert eng.cache["k"].dtype == torch.int8 and "k_scale" in eng.cache
    assert eng.cache["xk"].dtype == torch.float32
    reqs = synthetic_trace(tcfg, **TRACE)
    outs = eng.run(reqs)
    alone = ServeEngine(tapi, tparams, eng.config.with_fields(num_slots=1))
    aouts = alone.run(synthetic_trace(tcfg, **TRACE))
    for r in reqs:
        assert len(outs[r.rid].tokens) == r.max_new_tokens
        assert outs[r.rid].tokens == aouts[r.rid].tokens


def test_mode_ab_logits_match_reference(ref):
    """Reduced whisper in Mode.AB (compacted at 0.6, declared activation
    sparsity 0.5) through the kernels' plain versions: the prefill logits
    within tolerance of the reference's under the same scope."""
    from repro.models.common import sparse_execution as jax_scope
    _, japi, jparams, _, tapi, _ = ref
    japi = jax_build_model(japi.cfg)            # traced under the scope
    jparams = jax_sparsify(jparams, 0.6, **PRUNE)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    toks, frames = _inputs(np.random.default_rng(12), 2, 8)
    reset_kernel_dispatch()
    with sparse_execution(use_kernels=True, a_sparsity=0.5):
        _, got = tapi.prefill(tparams, _tbatch(toks, frames))
    assert kernel_dispatch_counts() == {"kernel": 33, "dual": 33}
    with jax_scope(use_kernels=True, interpret=True, a_sparsity=0.5):
        _, want = japi.prefill(jparams, _jbatch(toks, frames))
    _close(got, want)


def _depth_true_cfg():
    """Full-width whisper-large-v3's depth (32 encoder and 32 decoder
    layers) at the reduced width, in bf16: every GEMM of a full-width
    model call with its dtypes, at a size the CPU runs in seconds."""
    return dataclasses.replace(get_config(ARCH).reduced(), num_layers=32,
                               encoder_layers=32, dtype="bfloat16")


@pytest.mark.parametrize("path", ["whisper_sparse_b", "whisper_mode_ab"])
def test_dispatch_per_model_call_equals_the_smokes_gates(path, monkeypatch):
    """Per prefill and per decode step of a depth-true model: the GEMMs
    the smoke's launch gates count.  Every GEMM leaf is compacted, so all
    go through griffin_spmm: a prefill 513 (the encoder's 32 x 6, the
    decoder's 32 x 10, the head), 256 of them fp32 A (the encoder's and
    the cross wk/wv), a decode step 257 (32 x 8 and the head), all bf16;
    Mode.AB makes every one dual; nothing goes through dense_gemm or
    sparse_a, and no plain GEMM runs."""
    spec = chip_smoke.WHISPER_PATHS[path]
    a_dtypes = []
    real = whisper.griffin_linear

    def spy(x, w, **kw):
        assert isinstance(w, GriffinWeights)
        a_dtypes.append(x.dtype)
        return real(x, w, **kw)

    monkeypatch.setattr(whisper, "griffin_linear", spy)
    cfg = _depth_true_cfg()
    api = build_model(cfg, device="cpu")
    params = sparsify_params(api.init(api.generator(0)), spec["sparsity"],
                             **PRUNE)
    conf = EngineConfig().with_fields(num_slots=2, cache_len=16,
                                      decode_chunk=4, use_kernels=True,
                                      a_sparsity=spec["a_sparsity"])
    eng = ServeEngine(api, params, conf)
    reset_kernel_dispatch()
    eng.run(synthetic_trace(cfg, **TRACE))
    got = kernel_dispatch_counts()
    pre, dec = eng.stats["prefill_calls"], eng.stats["decode_steps"]
    launches = dict(spec["launches"])
    (p_k2, d_k2), (p_f32, d_f32) = launches.pop("griffin_spmm"), \
        spec["fp32_a"]
    assert (p_k2, d_k2) == (32 * 6 + 32 * 10 + 1, 32 * 8 + 1)
    assert (p_f32, d_f32) == (32 * 8, 0)
    assert eng.mode.value == spec["mode"]
    want = {"kernel": pre * p_k2 + dec * d_k2}
    if spec["dual"]:
        want["dual"] = want["kernel"]
    assert got == want
    assert a_dtypes.count(torch.float32) == pre * p_f32 + dec * d_f32
    assert not any(launches.values())
    assert spec["dual"] == (spec["launches"]["griffin_spmm"]
                            if spec["dual"] else 0)


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
    meta = api.init_cache(1, 8, device=torch.device("meta"))
    assert meta["k"].shape == (32, 1, 8, 20, 64)
    assert meta["xk"].shape == (32, 1, 1500, 20, 64)
    assert meta["xk"].dtype == torch.bfloat16


@pytest.mark.parametrize("mode", ["sparse_b", "mode_ab", "paged"])
def test_serve_cli_reduced_parity(tmp_path, capsys, mode):
    """``--arch whisper-large-v3 --reduced --device cpu --sparsity 0.8
    --use-kernels --parity`` ends in "parity OK" in Sparse.B, in Mode.AB
    (a config file declaring activation sparsity 0.5) and on the paged
    arena (``--page-size 4``)."""
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--sparsity",
            "0.8", "--use-kernels", "--parity", "--measure-every", "64"]
    if mode == "mode_ab":
        conf = tmp_path / "engine.json"
        conf.write_text('{"kernels": {"use_kernels": true, '
                        '"a_sparsity": 0.5}}')
        argv += ["--config", str(conf)]
    if mode == "paged":
        argv += ["--page-size", "4"]
    launch_serve.main(argv)
    out = capsys.readouterr().out
    assert f"mode {'AB' if mode == 'mode_ab' else 'B'}" in out
    assert "parity OK: all 8 requests" in out
    assert ("paged, " in out) == (mode == "paged")


def test_launch_builds_the_dense_draw_then_sparsifies():
    """``launch.serve``'s build for the audio family: the dense draw, then
    ``sparsify_params`` at the reduced granularity (the family has no
    streamed build)."""
    api = build_model(get_config(ARCH).reduced(), device="cpu")
    assert api.draws is None
    run = launch_serve.serve(ARCH, reduced=True, device="cpu", requests=2,
                             config=EngineConfig().with_fields(
                                 use_kernels=True))
    want = sparsify_params(api.init(api.generator(0)), 0.8,
                           **prune_for(True))
    want = dict(_leaves(want))
    for path, leaf in _leaves(run.params):
        w = want[path]
        if isinstance(leaf, GriffinWeights):
            assert torch.equal(leaf.b_comp, w.b_comp), path
        else:
            assert torch.equal(leaf, w), path
    assert all(len(o.tokens) for o in run.engine.outputs.values())


def test_tuning_workload_serves_audio():
    cfg, api, params, cache_len, trace = tuning_workload(
        "audio", reduced=True, device="cpu")
    assert cfg.family == "audio" and api.device.type == "cpu"
    assert cache_len == 27 and len(trace()) == 6
    assert trace()[0].extras["frames"].shape == (8, 64)
    assert params["enc_layers"]["attn"]["wq"].shape == (2, 64, 64)
    cfg, api, params, cache_len, trace = tuning_workload(
        "vlm", reduced=True, device="cpu")
    assert (cfg.family, cfg.qk_norm, api.device.type) == ("vlm", True, "cpu")
    assert params["layers"]["qn"].shape == params["layers"]["kn"].shape == \
        (2, 16)


def test_autotune_cli_tunes_audio_and_serve_reads_its_plan(tmp_path,
                                                           capsys):
    """``launch.autotune --families audio`` runs the pipeline on the
    reduced whisper and writes a plan with an audio entry, which reloads
    and which ``launch.serve --arch whisper-large-v3 --plan`` applies with
    the default's tokens ("parity OK")."""
    from repro_torch.launch import autotune as autotune_cli
    from repro_torch.tuning import load_plan
    out = tmp_path / "plan.json"
    autotune_cli.main(["--families", "audio", "--reduced", "--device",
                       "cpu", "--budget", "4", "--shortlist", "2",
                       "--repeats", "1", "--out", str(out), "--cache-dir",
                       str(tmp_path / "dse")])
    text = capsys.readouterr().out
    assert "tokens identical to default" in text
    fam = load_plan(str(out)).family("audio")
    assert fam is not None and len(fam.predicted) == 2
    launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--use-kernels", "--parity", "--measure-every", "64",
                       "--requests", "4", "--plan", str(out)])
    assert "parity OK: all 4 requests" in capsys.readouterr().out


def test_disk_snapshots_carry_the_frames_through_a_kill(ref, tmp_path):
    """Tick-start snapshots written to disk (``snapshot_dir``) with a kill
    mid-decode: one recovery, the tokens of an unfaulted engine, and the
    newest manifest's scheduler (requests with their frames, as
    ``[dtype, nested list]``) rebuilds a scheduler equal to the live one,
    frames bit for bit."""
    from repro_torch.checkpoint import read_manifest
    from repro_torch.runtime import fault
    from repro_torch.runtime.engine import Scheduler
    _, _, _, tcfg, tapi, tparams = ref
    conf = EngineConfig().with_fields(num_slots=2, cache_len=16,
                                      decode_chunk=2,
                                      snapshot_dir=str(tmp_path / "snap"))
    inj = fault.FaultInjector(kill_devices=(0,), at_step=2, phase="decode")
    eng = ServeEngine(tapi, tparams, conf, fault_injector=inj)
    want = _port_engine(tapi, tparams, False, 2).run(
        synthetic_trace(tcfg, **TRACE))
    got = eng.run(synthetic_trace(tcfg, **TRACE))
    assert inj.fired_at == 2 and eng.recoveries == 1
    assert {r: o.tokens for r, o in got.items()} == \
        {r: o.tokens for r, o in want.items()}
    man = read_manifest(str(tmp_path / "snap"))
    sched = Scheduler.from_state_dict(man["extra"]["scheduler"])
    assert sched.state_dict() == man["extra"]["scheduler"]
    reqs = {r.rid: r for r in synthetic_trace(tcfg, **TRACE)}
    held = list(sched.running.values()) + \
        [r for _, _, r in sched._by_arrival] + [r for _, r in sched._ready]
    assert held
    for r in held:
        assert r.extras["frames"].dtype == np.float32
        np.testing.assert_array_equal(r.extras["frames"],
                                      reqs[r.rid].extras["frames"])
