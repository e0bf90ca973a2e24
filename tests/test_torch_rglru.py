"""The port's hybrid family (repro_torch.models.rglru) against the JAX
package's on reduced recurrentgemma-9b in fp32 (d_model 64, lru_width 64,
one (rec, rec, attn) group and an empty tail, window 32) and, for the
dtype flow, in bf16, on the reference's own weights bridged through numpy
and on inputs drawn with numpy from a seed.

Tolerances: block outputs, carried states and logits within rtol 1e-5 /
atol 1e-5 (fp32, summation orders differ: the reference's associative
scan is a tree whose shape depends on the length, the port's a fixed
doubling per chunk); the scan within 1e-6 of a step-by-step loop; at
bf16 a rec block's outputs 99 % equal to the reference's, prefill and
decode logits within relative L2 2e-2 (the GeGLU's ``gelu`` on bf16
rounds 40 % of its outputs apart between jax and torch, relative L2
2.4e-3 per MLP, 1.1e-2 at the logits); the conv state, greedy and engine
tokens, pruned and compacted leaves and dispatch counts exact; pad steps
and row batching bit-exact within the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jattn
import repro.models.rglru as jr
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.runtime.config import ArenaConfig as JaxArenaConfig
from repro.runtime.config import EngineConfig as JaxEngineConfig
from repro.runtime.engine import ServeEngine as JaxServeEngine
from repro.runtime.engine import synthetic_trace as jax_synthetic_trace
from repro.runtime.engine import weight_sparsity as jax_weight_sparsity
from repro.runtime.serve import greedy_generate as jax_greedy
from repro.sparsity import sparsify_params as jax_sparsify
import chip_smoke
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import GriffinWeights
from repro_torch.kernels.sparse_a import ops as sparse_a_ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention, build_model, common, rglru
from repro_torch.models.common import (kernel_dispatch_counts,
                                       reset_kernel_dispatch,
                                       sparse_execution)
from repro_torch.runtime.config import EngineConfig
from repro_torch.runtime.engine import (ServeEngine, synthetic_trace,
                                        weight_sparsity)
from repro_torch.runtime.paging import build_spec, discover_paged_keys
from repro_torch.runtime.serve import greedy_generate
from repro_torch.sparsity import PRUNE, sparsify_params
from repro_torch.tuning.measure import tuning_workload

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "recurrentgemma-9b"
# the reference engine test's trace (tests/test_engine.py _family_parity)
TRACE = dict(num_requests=3, seed=11, prompt_lens=(6, 10), gen_lens=(2, 4),
             arrival_every=1)
REC_STATE = ("rec_h", "rec_conv", "tail_h", "tail_conv")


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


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def _rec(params, name="rec1", g=0):
    return {k: v[g] for k, v in params["groups"][name].items()}


def _prompts(rng, B, S, vocab=128):
    return rng.integers(1, vocab, (B, S)).astype(np.int32)


def _tok(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _mask(lengths, S):
    return np.arange(S)[None, :] < np.asarray(lengths)[:, None]


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------

def test_config_and_reduced_match_reference():
    for jcfg, tcfg in ((jax_get_config(ARCH), get_config(ARCH)),
                       (jax_get_config(ARCH).reduced(),
                        get_config(ARCH).reduced())):
        for f in ("family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "hd", "d_ff", "vocab_size", "window",
                  "act", "norm_eps", "rope_theta", "dtype", "kv_chunk",
                  "block_pattern", "lru_width", "conv_width"):
            assert getattr(jcfg, f) == getattr(tcfg, f), f
        assert jr._group_counts(jcfg) == rglru._group_counts(tcfg)
    assert rglru._group_counts(get_config(ARCH)) == (12, 2)
    assert rglru._group_counts(get_config(ARCH).reduced()) == (1, 0)
    # the other families' reduced rule is unchanged
    assert get_config("xlstm-1.3b").reduced().num_layers == 2
    assert get_config("llama3.2-1b").reduced().lru_width == 0


def test_parameter_count_of_full_width(monkeypatch):
    """The full-width tree's shapes, drawn on the meta device: its block
    GEMM leaves hold the reference registry's count (~8.35 B), with a
    256000 x 4096 embedding and an untied head beside them (~10.4 B)."""
    cfg = get_config(ARCH)
    api = build_model(cfg, device="cpu")
    monkeypatch.setattr(rglru, "dense_init",
                        lambda gen, shape, in_dim, dtype, scale=None:
                        torch.empty(shape, dtype=dtype, device="meta"))
    params = rglru.init_params(cfg, api.generator(0))
    gemm = 0
    for stack in (params["groups"], params["tail"]):
        for block in stack.values():
            gemm += sum(t.numel() for n, t in block.items()
                        if n.startswith("w"))
    want = jax_build_model(jax_get_config(ARCH)).param_count()
    assert gemm == want and 8.3e9 < want < 8.4e9
    assert params["embed"].shape == (256000, 4096)
    assert params["head"].shape == (4096, 256000)
    total = gemm + 2 * 256000 * 4096
    assert 1.03e10 < total < 1.05e10
    assert params["groups"]["rec1"]["w_rg"].shape == (12, 4096, 4096)
    assert params["groups"]["attn"]["wk"].shape == (12, 4096, 256)
    assert params["tail"]["mlp"]["w_down"].shape == (2, 12288, 4096)
    cache = api.init_cache(4, 4224, device=torch.device("meta"))
    assert cache["k"].shape == (12, 4, 2048, 1, 256)
    assert cache["rec_conv"].shape == (12, 2, 4, 3, 4096)
    assert cache["tail_h"].shape == (2, 4, 4096)


def test_empty_tail_has_the_reference_shapes(ref):
    _, _, jparams, tcfg, tapi, _ = ref
    own = tapi.init(tapi.generator(0))
    for name, block in own["tail"].items():
        for leaf, t in block.items():
            want = np.asarray(jparams["tail"][name][leaf])
            assert tuple(t.shape) == want.shape and t.shape[0] == 0, leaf
            assert str(t.dtype).split(".")[-1] == want.dtype.name
    cache = tapi.init_cache(2, 16)
    assert cache["tail_h"].shape == (0, 2, 64)


# ---------------------------------------------------------------------------
# the RG-LRU, the conv and the blocks against the reference
# ---------------------------------------------------------------------------

def test_scan_equals_a_step_loop():
    """The chunked doubling scan within 1e-6 of h_t = a_t h_{t-1} + b_t
    step by step, over one chunk, a ragged second chunk and three."""
    rng = np.random.default_rng(1)
    for S in (1, 7, 64, 100, 192):
        a = _t(rng.uniform(0.2, 1.0, (2, S, 8)).astype(np.float32))
        b = _t(rng.standard_normal((2, S, 8)).astype(np.float32))
        h = rglru._linear_scan(a, b)
        loop, hs = torch.zeros((2, 8)), []
        for t in range(S):
            loop = a[:, t] * loop + b[:, t]
            hs.append(loop)
        np.testing.assert_allclose(h.numpy(), torch.stack(hs, 1).numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_scan_prefix_is_independent_of_the_length():
    """Position t's value is built in an order fixed by t alone: the scan
    of the first S steps is bit-equal to the same positions of a longer
    scan, across chunk boundaries, and identity pad steps after a prefix
    leave it unchanged."""
    rng = np.random.default_rng(2)
    a = _t(rng.uniform(0.2, 1.0, (1, 200, 8)).astype(np.float32))
    b = _t(rng.standard_normal((1, 200, 8)).astype(np.float32))
    full = rglru._linear_scan(a, b)
    for S in (1, 5, 63, 64, 65, 130):
        assert torch.equal(rglru._linear_scan(a[:, :S], b[:, :S]),
                           full[:, :S]), S
        pa, pb = a.clone(), b.clone()
        pa[:, S:], pb[:, S:] = 1.0, 0.0
        assert torch.equal(rglru._linear_scan(pa, pb)[:, :S], full[:, :S])


@pytest.mark.parametrize("with_state", [False, True])
def test_conv_matches_reference_and_gathers_the_real_state(with_state):
    """The conv's output within tolerance; the carried state (a pure
    gather of inputs) bit-equal to the reference's, with and without
    ``lengths``."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 9, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    st = rng.standard_normal((3, 3, 16)).astype(np.float32) \
        if with_state else None
    for lengths in (None, np.array([9, 4, 2], np.int32)):
        jout, jst = jr._causal_conv(
            jnp.asarray(x), jnp.asarray(w),
            None if st is None else jnp.asarray(st),
            lengths=None if lengths is None else jnp.asarray(lengths))
        tout, tst = rglru._causal_conv(
            _t(x), _t(w), None if st is None else _t(st),
            lengths=None if lengths is None else _t(lengths))
        _close(tout, jout)
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


@pytest.mark.parametrize("lengths", [None, (16, 11)])
@pytest.mark.parametrize("with_state", [False, True])
def test_rec_mix_matches_reference(ref, with_state, lengths):
    jcfg, _, jparams, tcfg, _, tparams = ref
    rng = np.random.default_rng(5)
    B, S = 2, 16
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    jstate = tstate = None
    if with_state:
        x0 = rng.standard_normal((B, 8, tcfg.d_model)).astype(np.float32)
        _, jstate = jr.rec_mix(jcfg, _rec(jparams), jnp.asarray(x0))
        tstate = tuple(_t(s) for s in jstate)
    kw = {}
    tkw = {}
    if lengths is not None:
        kw = dict(mask=jnp.asarray(_mask(lengths, S)),
                  lengths=jnp.asarray(lengths, jnp.int32))
        tkw = dict(mask=_t(_mask(lengths, S)),
                   lengths=torch.tensor(lengths, dtype=torch.int32))
    out, st = jr.rec_mix(jcfg, _rec(jparams), jnp.asarray(x), state=jstate,
                         **kw)
    tout, tst = rglru.rec_mix(tcfg, _rec(tparams), _t(x), state=tstate,
                              **tkw)
    _close(tout, out)
    _close(tst, st)
    # one decode step from the carried state
    out, st = jr.rec_mix(jcfg, _rec(jparams), jnp.asarray(x[:, :1]), st)
    tout, tst = rglru.rec_mix(tcfg, _rec(tparams), _t(x[:, :1]), tst)
    _close(tout, out)
    _close(tst, st)


@pytest.mark.parametrize("length", [3, 5, 8, 13])
def test_padded_rec_state_bit_equals_unpadded(ref, length):
    """Within the port, a right-padded rec block carries exactly the
    exact-length block's recurrent and conv state, and its real outputs
    are bit-equal."""
    _, _, _, tcfg, _, tparams = ref
    rng = np.random.default_rng(length)
    x = _t(rng.standard_normal((1, length, 64)).astype(np.float32))
    bucket = 8 if length <= 8 else 16
    out, (h, conv) = rglru.rec_mix(tcfg, _rec(tparams), x)
    xp = torch.nn.functional.pad(x, (0, 0, 0, bucket - length))
    lens = torch.tensor([length], dtype=torch.int32)
    pout, (ph, pconv) = rglru.rec_mix(
        tcfg, _rec(tparams), xp, mask=common.length_mask(lens, bucket),
        lengths=lens)
    assert torch.equal(ph, h) and torch.equal(pconv, conv)
    assert torch.equal(pout[:, :length], out)


def _rowwise(real):
    """``griffin_linear`` one row at a time: the CPU's matmul picks its
    kernel from M (a 1-row product is a gemv), so the card's kernels,
    whose summation order is fixed per output, are stood in for by
    1-row products here (tests/test_torch_gpu.py holds the kernels
    themselves batch invariant on the card)."""
    def f(x, w, **kw):
        rows = x.reshape(-1, x.shape[-1])
        out = torch.cat([real(rows[i:i + 1], w, **kw)
                         for i in range(rows.shape[0])])
        return out.reshape(*x.shape[:-1], out.shape[-1])
    return f


def test_batch_of_four_equals_batch_one(ref, monkeypatch):
    """Each row of a 4-row rec block (a prefill and a decode step from the
    carried state) and of a 4-row model decode step equals the row run
    alone, bit for bit: everything around the GEMMs (norms, conv, scan,
    gates, attention) is batch invariant."""
    _, _, _, tcfg, tapi, tparams = ref
    monkeypatch.setattr(rglru, "griffin_linear",
                        _rowwise(rglru.griffin_linear))
    rng = np.random.default_rng(6)
    x = _t(rng.standard_normal((4, 8, 64)).astype(np.float32))
    out, st = rglru.rec_mix(tcfg, _rec(tparams), x)
    o4, _ = rglru.rec_mix(tcfg, _rec(tparams), x[:, 7:], state=st)
    for i in range(4):
        o, s = rglru.rec_mix(tcfg, _rec(tparams), x[i:i + 1])
        assert torch.equal(o, out[i:i + 1])
        assert torch.equal(s[0], st[0][i:i + 1])
        assert torch.equal(s[1], st[1][i:i + 1])
        o, s = rglru.rec_mix(tcfg, _rec(tparams), x[i:i + 1, 7:],
                             state=(st[0][i:i + 1], st[1][i:i + 1]))
        assert torch.equal(o, o4[i:i + 1])
    toks = _tok(_prompts(rng, 4, 6))
    solo = [tapi.prefill(tparams, {"tokens": toks[i:i + 1]}, cache_len=16)
            for i in range(4)]
    batch = {k: (torch.cat([c[k] for c, _ in solo],
                           dim=2 if k in ("rec_h", "rec_conv") else 1)
                 if k != "pos" else torch.stack([c[k] for c, _ in solo]))
             for k in solo[0][0]}
    feed = toks[:, -1:]
    for _ in range(3):
        logits, batch = tapi.decode_step(tparams, batch, feed)
        for i in range(4):
            one, cache = tapi.decode_step(tparams, solo[i][0],
                                          feed[i:i + 1])
            solo[i] = (cache, one)
            assert torch.equal(one[0], logits[i]), i
        feed = torch.argmax(logits, dim=-1)[:, None]


@pytest.mark.parametrize("S", [20, 32, 45])
def test_local_attention_matches_reference(S):
    """Below, at and above the window (32): the reference's block-local
    attention and the port's banded one, MQA (one KV head)."""
    rng = np.random.default_rng(S)
    q = rng.standard_normal((2, S, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, S, 1, 16)).astype(np.float32)
    v = rng.standard_normal((2, S, 1, 16)).astype(np.float32)
    want = jattn.local_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), window=32, q_chunk=16)
    got = attention.local_attention(_t(q), _t(k), _t(v), window=32,
                                    kv_chunk=16)
    _close(got, want)


def test_attention_blocks_match_reference(ref):
    jcfg, _, jparams, tcfg, _, tparams = ref
    p = {k: v[0] for k, v in tparams["groups"]["attn"].items()}
    jp = {k: v[0] for k, v in jparams["groups"]["attn"].items()}
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    out, (k, v) = jr.attn_mix(jcfg, jp, jnp.asarray(x), jnp.arange(12))
    tout, (tk, tv) = rglru.attn_mix(tcfg, p, _t(x), torch.arange(12))
    _close((tout, tk, tv), (out, k, v))
    # a decode step into a rolling 8-row cache, lockstep and per row
    kc = rng.standard_normal((2, 8, 1, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 8, 1, 16)).astype(np.float32)
    for pos in (np.int32(13), np.array([5, 13], np.int32)):
        out, jk, jv = jr.attn_decode(jcfg, jp, jnp.asarray(x[:, :1]),
                                     jnp.asarray(kc), jnp.asarray(vc),
                                     jnp.asarray(pos))
        tk, tv = _t(kc), _t(vc)
        tout, _, _ = rglru.attn_decode(tcfg, p, _t(x[:, :1]), tk, tv,
                                       torch.as_tensor(pos))
        _close((tout, tk, tv), (out, jk, jv))


@pytest.mark.parametrize("S,lengths", [(10, False), (10, True),
                                       (32, False), (32, True),
                                       (45, False)],
                         ids=["10", "10-bucketed", "32", "32-bucketed",
                              "45"])
def test_prefill_and_decode_match_reference(ref, S, lengths):
    """Prompts below, at and above the window (a bucketed prefill must fit
    it): prefill logits, ``pos`` and every cache leaf, then 40 decode
    steps (the 32-row rolling cache wraps) with their logits and the
    final cache."""
    _, japi, jparams, _, tapi, tparams = ref
    rng = np.random.default_rng(S)
    toks = _prompts(rng, 2, S)
    batch, tbatch = {"tokens": jnp.asarray(toks)}, {"tokens": _tok(toks)}
    if lengths:
        lens = (S, S - 3)
        batch["lengths"] = jnp.asarray(lens, jnp.int32)
        tbatch["lengths"] = torch.tensor(lens, dtype=torch.int32)
    jcache, jlog = japi.prefill(jparams, batch, cache_len=48)
    tcache, tlog = tapi.prefill(tparams, tbatch, cache_len=48)
    _close(tlog, jlog)
    for key, leaf in jcache.items():
        assert tuple(tcache[key].shape) == np.asarray(leaf).shape, key
        if key != "pos" and tcache[key].numel():
            _close(tcache[key], leaf)
    assert tcache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()
    feed = _prompts(rng, 2, 40)
    for t in range(40):
        jlog, jcache = japi.decode_step(jparams, jcache,
                                        jnp.asarray(feed[:, t:t + 1]))
        tlog, tcache = tapi.decode_step(tparams, tcache,
                                        _tok(feed[:, t:t + 1]))
        _close(tlog, jlog)
    for key in REC_STATE + ("k", "v"):
        if tcache[key].numel():
            _close(tcache[key], jcache[key])


def test_greedy_tokens_equal_reference(ref):
    _, japi, jparams, _, tapi, tparams = ref
    toks = _prompts(np.random.default_rng(2), 2, 8)
    for cache_len in (16, 48):
        want = jax_greedy(japi, jparams, {"tokens": jnp.asarray(toks)},
                          steps=30, cache_len=cache_len)
        got = greedy_generate(tapi, tparams, {"tokens": _tok(toks)},
                              steps=30, cache_len=cache_len)
        assert got.tolist() == np.asarray(want).tolist()


# ---------------------------------------------------------------------------
# bf16: the reference's dtype flow
# ---------------------------------------------------------------------------

def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel_l2(got, want):
    g, w = _f32(got), _f32(want)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def test_every_gemm_input_has_the_reference_dtype_at_bf16(ref_bf16,
                                                          monkeypatch):
    """At bf16, every ``griffin_linear`` call of a prefill and a decode
    step takes its input in the reference's dtype (the gate GEMMs fp32 A
    against an fp32 weight, the rest bf16): the set of (input dtype,
    weight dtype, weight shape) triples equals the reference's (the
    reference's scans trace their bodies more than once, so the counts
    are not compared)."""
    _, japi, jparams, _, tapi, tparams = ref_bf16
    japi = jax_build_model(japi.cfg)            # traced here, not cached
    seen = {"jax": [], "torch": []}

    def spy(side, real):
        def f(x, w, **kw):
            shape = tuple(w.shape[-2:]) if hasattr(w, "shape") else \
                (w.k, w.n)
            wdt = str(w.dtype).split(".")[-1] if hasattr(w, "dtype") \
                else "compacted"
            seen[side].append((str(x.dtype).split(".")[-1], wdt, shape))
            return real(x, w, **kw)
        return f

    monkeypatch.setattr(jr, "griffin_linear", spy("jax", jr.griffin_linear))
    monkeypatch.setattr(rglru, "griffin_linear",
                        spy("torch", rglru.griffin_linear))
    toks = _prompts(np.random.default_rng(3), 2, 8)
    jcache, _ = japi.prefill(jparams, {"tokens": jnp.asarray(toks)})
    japi.decode_step(jparams, jcache, jnp.asarray(toks[:, :1]))
    tcache, _ = tapi.prefill(tparams, {"tokens": _tok(toks)})
    tapi.decode_step(tparams, tcache, _tok(toks[:, :1]))
    assert set(seen["torch"]) == set(seen["jax"])
    assert ("float32", "float32", (64, 64)) in seen["torch"]
    assert ("bfloat16", "bfloat16", (64, 128)) in seen["torch"]


@pytest.mark.parametrize("S", [12, 40])
def test_bf16_prefill_and_decode_logits_match_reference(ref_bf16, S):
    """Prefill logits and 8 decode steps' logits at bf16 (through the
    rolling cache's wrap at 40) within relative L2 2e-2 of the
    reference's (1.1e-2 measured, all of it the MLPs' bf16 ``gelu``), the
    carried fp32 recurrent state too.  One rec block alone: at least 99 %
    of its outputs equal the reference's, within relative L2 1e-3 (12
    steps: all equal; 40: 99.6 %, 1.1e-4, the two scans' fp32 sums in
    other orders), and its conv state bit-equal."""
    _, japi, jparams, _, tapi, tparams = ref_bf16
    rng = np.random.default_rng(5)
    toks = _prompts(rng, 2, S)
    jcache, jlog = japi.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                cache_len=32)
    tcache, tlog = tapi.prefill(tparams, {"tokens": _tok(toks)},
                                cache_len=32)
    assert tcache["rec_h"].dtype == torch.float32
    assert tlog.dtype == torch.bfloat16
    gaps = [_rel_l2(tlog, jlog), _rel_l2(tcache["rec_h"], jcache["rec_h"])]
    feed = _prompts(rng, 2, 8)
    for t in range(8):
        jlog, jcache = japi.decode_step(jparams, jcache,
                                        jnp.asarray(feed[:, t:t + 1]))
        tlog, tcache = tapi.decode_step(tparams, tcache,
                                        _tok(feed[:, t:t + 1]))
        gaps.append(_rel_l2(tlog, jlog))
    assert max(gaps) <= 2e-2, gaps
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    out, st = jr.rec_mix(japi.cfg, _rec(jparams), jx)
    tout, tst = rglru.rec_mix(tapi.cfg, _rec(tparams),
                              bridge.array_to_tensor(np.asarray(jx)))
    assert float(np.mean(_f32(tout) == _f32(out))) >= 0.99
    assert _rel_l2(tout, out) <= 1e-3
    assert np.array_equal(_f32(tst[1]), _f32(st[1]))


# ---------------------------------------------------------------------------
# pruning and the bridge on the group stacks with the empty tail
# ---------------------------------------------------------------------------

def _bits(x):
    a = bridge.tensor_to_array(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    return a.view(np.uint8)


@pytest.mark.parametrize("compact", [False, True])
def test_sparsify_params_on_group_stacks(ref, compact):
    """The same kept blocks, ``kidx``/``cnt``/``b_comp`` bit for bit, the
    group lead, the rec blocks' w_x/w_rg/w_ig/w_out left dense and the
    empty tail kept as it is."""
    _, _, jparams, _, _, tparams = ref
    want = jax.tree.map(np.asarray,
                        jax_sparsify(jparams, 0.8, compact=compact, **PRUNE))
    got = sparsify_params(tparams, 0.8, compact=compact, **PRUNE)
    compacted = set()
    for stack in ("groups", "tail"):
        for block, leaves in got[stack].items():
            for name, leaf in leaves.items():
                jl = want[stack][block][name]
                if isinstance(leaf, GriffinWeights):
                    assert compact and stack == "groups"
                    compacted.add((block, name))
                    assert leaf.b_comp.shape[0] == 1
                    for f in ("b_comp", "kidx", "cnt", "inv_perm"):
                        np.testing.assert_array_equal(
                            _bits(getattr(leaf, f)), _bits(getattr(jl, f)))
                    assert (leaf.k, leaf.n, leaf.block_k, leaf.block_n) == \
                        (jl.k, jl.n, jl.block_k, jl.block_n)
                else:
                    np.testing.assert_array_equal(_bits(leaf), _bits(jl),
                                                  name)
    assert isinstance(got["head"], GriffinWeights) == compact
    rec = {(b, n) for b in ("rec1", "rec2") for n in ("w_gate",)}
    mlps = {(b, n) for b in ("mlp1", "mlp2", "mlp3")
            for n in ("w_gate", "w_up", "w_down")}
    # wk/wv (64 x 16) are below the pruning's minimum width at this size
    attn = {("attn", "wq"), ("attn", "wo")}
    assert compacted == ((rec | mlps | attn) if compact else set())
    for name in ("w_x", "w_rg", "w_ig", "w_out", "conv", "lam"):
        assert torch.equal(got["groups"]["rec1"][name],
                           tparams["groups"]["rec1"][name])
    assert got["tail"]["mlp"]["w_up"].shape == (0, 64, 128)


def test_bridge_round_trips_group_stacks_and_cache(ref):
    _, japi, jparams, _, _, _ = ref
    sp = jax.tree.map(np.asarray, jax_sparsify(jparams, 0.8, **PRUNE))
    cache, _ = japi.prefill(jparams, {"tokens": jnp.ones((2, 8), jnp.int32)})
    tree = {"params": sp, "cache": jax.tree.map(np.asarray, cache)}
    port = bridge.to_torch(tree)
    assert port["cache"]["rec_conv"].shape == (1, 2, 2, 3, 64)
    assert port["cache"]["tail_h"].shape == (0, 2, 64)
    back = bridge.to_numpy(port)
    gw, jgw = (back["params"]["groups"]["mlp2"]["w_down"],
               sp["groups"]["mlp2"]["w_down"])
    for f in ("b_comp", "kidx", "cnt", "inv_perm"):
        np.testing.assert_array_equal(getattr(gw, f), getattr(jgw, f))
    for key, leaf in tree["cache"].items():
        np.testing.assert_array_equal(back["cache"][key], leaf)
    assert back["params"]["tail"]["rec"]["w_x"].shape == (0, 64, 64)


def test_weight_sparsity_counts_group_stacks(ref):
    _, _, jparams, _, _, tparams = ref
    for s in (0.0, 0.6):
        sp = jax_sparsify(jparams, s, **PRUNE) if s else jparams
        got = sparsify_params(tparams, s, **PRUNE) if s else tparams
        assert weight_sparsity(got) == pytest.approx(
            jax_weight_sparsity(sp), abs=1e-12)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("decode_chunk", [1, 3])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_engine_equals_reference_and_oracle(ref, sparse, decode_chunk):
    """The port's twin of ``test_engine_parity_dense_fast[hybrid]`` and of
    its sparse sweep (PRUNE, 0.6): tokens and stats equal to the
    reference engine's, and every request equal to the port's batch-1
    greedy oracle on the same bucket."""
    jcfg, japi, jparams, tcfg, tapi, _ = ref
    if sparse:
        jparams = jax_sparsify(jparams, 0.6, **PRUNE)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    jeng = _jax_engine(japi, jparams, sparse, decode_chunk)
    jouts = jeng.run(jax_synthetic_trace(jcfg, **TRACE))
    teng = _port_engine(tapi, tparams, sparse, decode_chunk)
    reqs = synthetic_trace(tcfg, **TRACE)
    touts = teng.run(reqs)
    assert teng.mode.value == jeng.mode.value == ("B" if sparse else "dense")
    for key in ("emitted", "decode_steps", "prefill_calls", "chunk_calls",
                "host_syncs"):
        assert teng.stats[key] == jeng.stats[key], key
    for r in reqs:
        assert touts[r.rid].tokens == jouts[r.rid].tokens, r.rid
    _oracle_equal(teng, tapi, tparams, reqs, touts)


def test_stepwise_engine_equals_reference(ref):
    """The stepwise tick (``fused=False``) on the hybrid cache: tokens and
    counters equal to the reference's stepwise engine, tokens equal to
    the port's fused engine."""
    jcfg, japi, jparams, tcfg, tapi, tparams = ref
    jeng = _jax_engine(japi, jparams, False, 1, fused=False)
    jouts = jeng.run(jax_synthetic_trace(jcfg, **TRACE))
    step = _port_engine(tapi, tparams, False, 1, fused=False)
    fused = _port_engine(tapi, tparams, False, 1)
    souts = step.run(synthetic_trace(tcfg, **TRACE))
    fouts = fused.run(synthetic_trace(tcfg, **TRACE))
    for key in ("emitted", "decode_steps", "prefill_calls", "host_syncs"):
        assert step.stats[key] == jeng.stats[key], key
    for rid, o in souts.items():
        assert o.tokens == jouts[rid].tokens == fouts[rid].tokens, rid


def test_paged_arena_pages_kv_and_keeps_the_state_fixed(ref):
    """cache_len 16 <= window 32: k/v are pageable (the reference's
    discovery), the recurrent leaves stay in the fixed arena beside the
    pools; the paged engine's tokens equal the fixed one's and the
    reference's paged engine's, and the batch-1 oracle's."""
    jcfg, japi, jparams, tcfg, tapi, tparams = ref
    from repro.runtime.paging import discover_paged_keys as jax_discover
    assert discover_paged_keys(tapi, 16) == jax_discover(japi, 16) == \
        ("k", "v")
    jeng = _jax_engine(japi, jparams, False, 3, page_size=4)
    jouts = jeng.run(jax_synthetic_trace(jcfg, **TRACE))
    paged = _port_engine(tapi, tparams, False, 3, page_size=4)
    assert paged._paged is not None and paged._paged.paged_keys == ("k", "v")
    assert paged.cache["k"].shape == (1, 9, 4, 1, 16)      # 2 x 4 pages + DUMP
    assert paged.cache["rec_h"].shape == (1, 2, 2, 64)
    assert paged.cache["rec_conv"].shape == (1, 2, 2, 3, 64)
    fixed = _port_engine(tapi, tparams, False, 3)
    reqs = synthetic_trace(tcfg, **TRACE)
    pouts = paged.run(reqs)
    fouts = fixed.run(synthetic_trace(tcfg, **TRACE))
    for rid, o in fouts.items():
        assert len(o.tokens) > 0
        assert pouts[rid].tokens == o.tokens == jouts[rid].tokens
    _oracle_equal(paged, tapi, tparams, reqs, pouts)


def test_paged_int8_pages_serve_the_hybrid(ref):
    """int8 pages on the hybrid's k/v: every request served, its tokens
    equal to a one-slot int8 engine serving it alone."""
    _, _, _, tcfg, tapi, tparams = ref
    eng = _port_engine(tapi, tparams, False, 3, page_size=4,
                       kv_dtype="int8")
    assert eng.cache["k"].dtype == torch.int8 and "k_scale" in eng.cache
    reqs = synthetic_trace(tcfg, **TRACE)
    outs = eng.run(reqs)
    alone = ServeEngine(tapi, tparams, eng.config.with_fields(num_slots=1))
    aouts = alone.run(synthetic_trace(tcfg, **TRACE))
    for r in reqs:
        assert len(outs[r.rid].tokens) == r.max_new_tokens
        assert outs[r.rid].tokens == aouts[r.rid].tokens


def test_paging_degrades_above_the_window(ref):
    """cache_len 64 > window 32: the rolling cache is pinned at the window,
    so no leaf tracks cache_len, paging degrades whole to the fixed arena
    at the asked cache_len (the reference's rule), and the tokens equal
    the fixed arena's and the reference's."""
    jcfg, japi, jparams, tcfg, tapi, tparams = ref
    spec, clen = build_spec(tapi, 2, 64, 4)
    assert spec is None and clen == 64
    jeng = _jax_engine(japi, jparams, False, 3, page_size=4, cache_len=64)
    assert jeng._paged is None
    jouts = jeng.run(jax_synthetic_trace(jcfg, **TRACE))
    paged = _port_engine(tapi, tparams, False, 3, page_size=4, cache_len=64)
    assert paged._paged is None and "pages" not in paged.cache
    assert paged.cache["k"].shape == (1, 2, 32, 1, 16)
    fixed = _port_engine(tapi, tparams, False, 3, cache_len=64)
    pouts = paged.run(synthetic_trace(tcfg, **TRACE))
    fouts = fixed.run(synthetic_trace(tcfg, **TRACE))
    for rid, o in fouts.items():
        assert pouts[rid].tokens == o.tokens == jouts[rid].tokens


def _depth_true_cfg():
    """Full-width recurrentgemma-9b's depth (12 groups + a tail of 2) at
    the reduced width, head_dim 32 so wk/wv (64 x 32) reach the pruning's
    minimum width as at full width, in bf16: every GEMM of a full-width
    model call with its dtypes, at a size the CPU runs in seconds."""
    return dataclasses.replace(get_config(ARCH).reduced(), num_layers=38,
                               head_dim=32, dtype="bfloat16")


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


@pytest.mark.parametrize("path", ["hybrid_sparse_b", "hybrid_mode_ab"])
def test_dispatch_per_model_call_equals_the_smokes_gates(path, monkeypatch):
    """Per model call (a prefill or a decode step) of a depth-true model:
    the GEMMs the smoke's launch gates count.  Sparse.B: 189 compacted
    leaves through griffin_spmm and the 26 rec blocks' w_x, w_rg, w_ig
    and w_out (104, half of them fp32) through dense_gemm; Mode.AB: the
    189 dual, the 104 through sparse_a, and its metadata built once per
    distinct input (w_x's, the shared w_rg/w_ig input, w_out's): 78; no
    plain GEMM either way."""
    spec = chip_smoke.HYBRID_PATHS[path]
    builds = count_meta_builds(monkeypatch)
    dtypes = []
    real = rglru.griffin_linear

    def spy(x, w, **kw):
        if not isinstance(w, GriffinWeights):
            dtypes.append((x.dtype, w.dtype))
        return real(x, w, **kw)

    monkeypatch.setattr(rglru, "griffin_linear", spy)
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
    calls = eng.stats["prefill_calls"] + eng.stats["decode_steps"]
    launches = spec["launches"]
    assert eng.mode.value == spec["mode"]
    want = {"kernel": calls * (launches["griffin_spmm"]
                               + launches["dense_gemm"]
                               + launches["sparse_a"])}
    if spec["dual"]:
        want["dual"] = calls * spec["dual"]
    assert got == want
    assert launches["griffin_spmm"] == 12 * 15 + 2 * 4 + 1
    assert launches["dense_gemm"] + launches["sparse_a"] == 4 * 26
    mode_ab = path == "hybrid_mode_ab"
    assert launches["sparse_a"] == (104 if mode_ab else 0)
    assert launches["sparse_a_meta"] == (78 if mode_ab else 0)
    assert len(builds) == calls * launches["sparse_a_meta"]
    f32, bf16 = (torch.float32,) * 2, (torch.bfloat16,) * 2
    assert dtypes.count(f32) == dtypes.count(bf16) == calls * 52
    assert len(dtypes) == calls * 104


def test_mode_ab_logits_match_reference(ref):
    """Reduced recurrentgemma in Mode.AB (compacted at 0.6, declared
    activation sparsity 0.5) through the kernels' plain versions: the
    prefill logits within tolerance of the reference's under the same
    scope, and bit-equal to a run that shares no metadata."""
    from repro.models.common import sparse_execution as jax_scope
    _, japi, jparams, _, tapi, _ = ref
    japi = jax_build_model(japi.cfg)            # traced under the scope
    jparams = jax_sparsify(jparams, 0.6, **PRUNE)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    toks = _prompts(np.random.default_rng(12), 2, 8)
    with sparse_execution(use_kernels=True, a_sparsity=0.5):
        _, shared = tapi.prefill(tparams, {"tokens": _tok(toks)})
    real = rglru.shared_activation_meta
    rglru.shared_activation_meta = lambda x, *ws: None
    try:
        with sparse_execution(use_kernels=True, a_sparsity=0.5):
            _, alone = tapi.prefill(tparams, {"tokens": _tok(toks)})
    finally:
        rglru.shared_activation_meta = real
    assert torch.equal(shared, alone)
    with jax_scope(use_kernels=True, interpret=True, a_sparsity=0.5):
        _, jlog = japi.prefill(jparams, {"tokens": jnp.asarray(toks)})
    _close(shared, jlog)


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
    assert api.device.type == "cpu"
    assert api.init_cache(1, 8, device=torch.device("meta"))["k"].shape == \
        (12, 1, 8, 1, 256)


@pytest.mark.parametrize("mode", ["sparse_b", "mode_ab", "paged"])
def test_serve_cli_reduced_parity(tmp_path, capsys, mode):
    """``--arch recurrentgemma-9b --reduced --device cpu --sparsity 0.8
    --use-kernels --parity`` ends in "parity OK" in Sparse.B, in Mode.AB
    (a config file declaring activation sparsity 0.5) and on the paged
    arena (``--page-size 4``: k/v paged, cache_len 49 rounded to 52 >
    window 32 would degrade, so the trace's prompts stay short)."""
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--sparsity",
            "0.8", "--use-kernels", "--parity", "--measure-every", "64"]
    if mode == "mode_ab":
        conf = tmp_path / "engine.json"
        conf.write_text('{"kernels": {"use_kernels": true, '
                        '"a_sparsity": 0.5}}')
        argv += ["--config", str(conf)]
    if mode == "paged":
        argv += ["--page-size", "4", "--prompt-lens", "6,10",
                 "--gen-lens", "4,8"]
    launch_serve.main(argv)
    out = capsys.readouterr().out
    assert f"mode {'AB' if mode == 'mode_ab' else 'B'}" in out
    assert "parity OK: all 8 requests" in out
    if mode == "paged":
        assert "paged, " in out
    else:
        assert "(fixed)" in out and "served 8 requests / 52 tokens" in out


def test_tuning_workload_serves_hybrid():
    cfg, api, params, cache_len, trace = tuning_workload(
        "hybrid", reduced=True, device="cpu")
    assert cfg.family == "hybrid" and api.device.type == "cpu"
    assert cache_len == 27 and len(trace()) == 6
    assert params["groups"]["rec1"]["w_gate"].shape == (1, 64, 64)


def test_autotune_cli_tunes_hybrid_and_serve_reads_its_plan(tmp_path,
                                                            capsys):
    """``launch.autotune --families hybrid`` runs the pipeline on the
    reduced recurrentgemma and writes a plan with a hybrid entry, which
    reloads and which ``launch.serve --arch recurrentgemma-9b --plan``
    applies with the default's tokens ("parity OK")."""
    from repro_torch.launch import autotune as autotune_cli
    from repro_torch.tuning import load_plan
    out = tmp_path / "plan.json"
    autotune_cli.main(["--families", "hybrid", "--reduced", "--device",
                       "cpu", "--budget", "4", "--shortlist", "2",
                       "--repeats", "1", "--out", str(out), "--cache-dir",
                       str(tmp_path / "dse")])
    text = capsys.readouterr().out
    assert "tokens identical to default" in text
    fam = load_plan(str(out)).family("hybrid")
    assert fam is not None and len(fam.predicted) == 2
    assert fam.measured["winner"] in fam.predicted
    launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--use-kernels", "--parity", "--measure-every", "64",
                       "--requests", "4", "--plan", str(out)])
    assert "parity OK: all 4 requests" in capsys.readouterr().out
