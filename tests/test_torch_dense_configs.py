"""The dense family's other configs on the port (stablelm-1.6b,
minitron-8b, command-r-plus-104b) against the JAX package's, on the
reference's own weights bridged through numpy and on inputs drawn with
numpy from a seed.  The reference runs as its own tests run it: on the
CPU, its Pallas kernels in interpret mode.

Each arch runs at its ``reduced()`` config, which makes all three MHA
(4 heads, kv = min(4, kv)), and minitron-8b and command-r-plus-104b also
at a narrow twin built the same way in both packages that keeps the
source's GQA ratio (4H / 1KV and 12H / 1KV), its untied head and its
rope_theta: the twin exists in these tests only.

Tolerances (those of ``tests/test_torch_model.py``): fp32 logits and K/V
caches within rtol 1e-4 / atol 1e-5 (summation orders differ); at bf16
the logits within relative L2 2e-2 (``tests/test_torch_moe.py``);
greedy and engine tokens, counters, dispatch counts and the compacted
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
from repro.models.common import sparse_execution as jax_scope
from repro.runtime.config import ArenaConfig as JaxArenaConfig
from repro.runtime.config import EngineConfig as JaxEngineConfig
from repro.runtime.engine import ServeEngine as JaxServeEngine
from repro.runtime.engine import synthetic_trace as jax_synthetic_trace
from repro.runtime.serve import greedy_generate as jax_greedy
from repro.sparsity import sparsify_params as jax_sparsify
import chip_smoke
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import GriffinWeights
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model, transformer
from repro_torch.models.common import (kernel_dispatch_counts,
                                       reset_kernel_dispatch,
                                       sparse_execution)
from repro_torch.runtime.config import EngineConfig
from repro_torch.runtime.engine import ServeEngine, synthetic_trace
from repro_torch.runtime.serve import greedy_generate
from repro_torch.sparsity import PRUNE, sparsify_params

ARCHS = ("stablelm-1.6b", "minitron-8b", "command-r-plus-104b")
# the narrow twins' (heads, kv heads): the source's GQA ratio at the
# reduced width (stablelm-1.6b's MHA is what reduced() keeps already)
TWIN = {"minitron-8b": (4, 1), "command-r-plus-104b": (12, 1)}
PAIRS = [(a, "reduced") for a in ARCHS] + [(a, "twin") for a in TWIN]
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = 2e-2
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


def _cfgs(arch, variant, dtype="float32"):
    """(reference config, port config) of ``arch`` reduced, or its twin."""
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    kw = dict(dtype=dtype)
    if variant == "twin":
        kw.update(zip(("num_heads", "num_kv_heads"), TWIN[arch]))
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)


def _jitted(japi):
    """The reference's model API with prefill and decode under ``jax.jit``
    (eagerly, every call re-traces its layer scans)."""
    return dataclasses.replace(
        japi, prefill=jax.jit(japi.prefill, static_argnames=("cache_len",)),
        decode_step=jax.jit(japi.decode_step))


def _pair(arch, variant="reduced", dtype="float32"):
    """(jax cfg, jax api, jax params, port cfg, port api, port params) on
    the reference's seed-0 weights, bridged."""
    jcfg, tcfg = _cfgs(arch, variant, dtype)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    tapi = build_model(tcfg, device="cpu")
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    return jcfg, japi, jparams, tcfg, tapi, tparams


_PAIRS = {}


@pytest.fixture(scope="module", params=PAIRS, ids=lambda p: "-".join(p))
def ref(request):
    if request.param not in _PAIRS:
        _PAIRS[request.param] = _pair(*request.param)
    return _PAIRS[request.param]


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


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

FIELDS = ("family", "num_layers", "d_model", "num_heads", "num_kv_heads",
          "hd", "d_ff", "vocab_size", "window", "qk_norm", "tie_embeddings",
          "act", "norm_eps", "rope_theta", "dtype", "kv_chunk", "loss_chunk",
          "remat", "moe")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_reduced_match_reference(arch):
    """Full and reduced configs carry the reference's fields; the three
    are dense with an untied head, and the twin keeps the source's ratio
    of heads to kv heads."""
    for jcfg, tcfg in ((jax_get_config(arch), get_config(arch)),
                       (jax_get_config(arch).reduced(),
                        get_config(arch).reduced())):
        for f in FIELDS:
            assert getattr(jcfg, f) == getattr(tcfg, f), f
    full = get_config(arch)
    assert full.family == "dense" and not full.tie_embeddings
    if arch in TWIN:
        _, twin = _cfgs(arch, "twin")
        assert twin.num_heads // twin.num_kv_heads == \
            full.num_heads // full.num_kv_heads


@pytest.mark.parametrize("arch,total_b", [
    ("stablelm-1.6b", (1.23e9, 1.24e9)), ("minitron-8b", (7.78e9, 7.79e9)),
    ("command-r-plus-104b", (100.6e9, 100.7e9))])
def test_full_width_parameter_counts_equal_the_reference(arch, total_b):
    """``param_count`` and ``param_count_total`` (analytic, embeddings
    excluded: with the embedding and the untied head 1.64 B, 9.88 B and
    107.0 B) equal the reference registry's at full width."""
    japi = jax_build_model(jax_get_config(arch))
    tapi = build_model(get_config(arch), device="cpu")
    assert tapi.param_count() == japi.param_count()
    assert tapi.param_count_total() == japi.param_count_total()
    assert total_b[0] < tapi.param_count_total() < total_b[1]
    assert tapi.draws is None        # no streamed build for the dense family


@pytest.mark.parametrize("arch", ARCHS)
def test_build_model_defaults_to_the_card(arch):
    cfg = get_config(arch)
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)
    api = build_model(cfg, device="cpu")
    shape = api.init_cache(1, 64, device=torch.device("meta"))["k"].shape
    assert shape == (cfg.num_layers, 1, 64, cfg.num_kv_heads, cfg.hd)


def test_init_has_the_reference_layout(ref):
    """Seeded init: every leaf of the reference's tree, the untied head
    among them, with its shape and dtype."""
    _, _, jparams, _, tapi, _ = ref
    own = tapi.init(tapi.generator(0))
    want = jax.tree.map(np.asarray, jparams)
    assert "head" in own and own["head"].shape == want["head"].shape

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
# the model against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bucket", [None, 16])
def test_prefill_and_decode_match_reference(ref, bucket):
    """Prefill (an exact-length batch, or a 16-token bucket with ragged
    true lengths 11 and 7) and three decode steps fed the reference's
    greedy tokens: logits and the K/V caches within tolerance, positions
    equal."""
    _, japi, jparams, _, tapi, tparams = ref
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


def test_sparsify_params_compacts_bit_equal(ref):
    """The port's sparsify_params at 0.8 (the reduced granularity PRUNE,
    as the CLI prunes) on the reference's weights: 7 x L stacked
    ``GriffinWeights`` leaves and the untied head, each leaf's ``b_comp``,
    ``kidx``, ``cnt`` and ``inv_perm`` bit-equal to the reference's; wk
    and wv stay dense where they are narrower than the pruning's minimum
    (the twins' single kv head)."""
    jcfg, _, jparams, tcfg, _, tparams = ref
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
    assert torch.equal(got["embed"], tparams["embed"])


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


@pytest.mark.parametrize("arch", ARCHS)
def test_every_gemm_input_has_the_reference_dtype_at_bf16(arch,
                                                          monkeypatch):
    """Reduced in bf16, pruned and compacted at 0.6, under the kernels:
    every GEMM of a prefill and a decode step takes the same (A, weight)
    dtypes in the same order as the reference's (all bf16: 7 a layer and
    the untied head), and the logits stay within relative L2 2e-2 of the
    reference's."""
    _, japi, jparams, _, tapi, _ = _pair(arch, dtype="bfloat16")
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

    monkeypatch.setattr(jtf, "griffin_linear",
                        spy(seen["jax"], jtf.griffin_linear))
    monkeypatch.setattr(transformer, "griffin_linear",
                        spy(seen["torch"], transformer.griffin_linear))
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
    assert seen["torch"] == seen["jax"]
    assert set(seen["torch"]) == {("bfloat16", "bfloat16")}
    assert len(seen["torch"]) == 2 * (2 * 7 + 1)
    assert tlog.dtype == torch.bfloat16
    assert max(gaps) <= BF16_TOL, gaps


# ---------------------------------------------------------------------------
# the serving engine and the CLI
# ---------------------------------------------------------------------------

def _jax_engine(api, params, decode_chunk, page_size=None, fused=True):
    conf = JaxEngineConfig(arena=JaxArenaConfig(
        num_slots=2, cache_len=16, page_size=page_size)).with_fields(
        decode_chunk=decode_chunk, fused=fused)
    return JaxServeEngine(api, params, config=conf)


@pytest.mark.parametrize("engine", ["fixed", "paged", "stepwise"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_equals_reference_and_oracle(arch, engine):
    """The fixed, paged (4-token pages) and stepwise (fused off, one-step
    decode) engines on the reduced config: tokens and counters equal to
    the reference's engine of the same config, and every request equal to
    the port's batch-1 greedy oracle on the engine's bucket."""
    jcfg, japi, jparams, tcfg, tapi, tparams = _PAIRS.setdefault(
        (arch, "reduced"), _pair(arch))
    kw = {"paged": dict(page_size=4), "stepwise": dict(fused=False)}.get(
        engine, {})
    chunk = 1 if engine == "stepwise" else 3
    jeng = _jax_engine(_jitted(japi), jparams, chunk, **kw)
    jouts = jeng.run(jax_synthetic_trace(jcfg, **TRACE))
    conf = EngineConfig().with_fields(num_slots=2, cache_len=16,
                                      decode_chunk=chunk, **kw)
    teng = ServeEngine(tapi, tparams, conf)
    assert (teng._paged is not None) == (engine == "paged")
    reqs = synthetic_trace(tcfg, **TRACE)
    touts = teng.run(reqs)
    for key in ("emitted", "decode_steps", "prefill_calls", "host_syncs"):
        assert teng.stats[key] == jeng.stats[key], key
    for r in reqs:
        assert touts[r.rid].tokens == jouts[r.rid].tokens, r.rid
        with teng._scope():
            want = greedy_generate(tapi, tparams, r.as_batch(teng.device),
                                   steps=r.max_new_tokens,
                                   cache_len=teng.cache_len,
                                   prompt_bucket=teng.bucket_for(
                                       r.prompt_len))
        assert touts[r.rid].tokens == want[0].tolist(), r.rid


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_reduced_parity(arch, capsys):
    """``--arch <arch> --reduced --device cpu --sparsity 0.8 --use-kernels
    --parity`` ends in "parity OK", Sparse.B throughout."""
    launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--sparsity", "0.8", "--use-kernels", "--parity",
                       "--measure-every", "64"])
    out = capsys.readouterr().out
    assert "mode B" in out
    assert "parity OK: all 8 requests" in out


def _depth_true_cfg(arch):
    """The smoke's depth of ``arch`` (full, or command-r-plus-104b's
    2-layer cut) at the reduced width, in bf16: every GEMM of a full-width
    model call with its dtypes, at a size the CPU runs in seconds."""
    layers = chip_smoke.COMMAND_R_LAYERS if arch == chip_smoke.COMMAND_R \
        else get_config(arch).num_layers
    return dataclasses.replace(get_config(arch).reduced(), num_layers=layers,
                               dtype="bfloat16")


@pytest.mark.parametrize("path", list(chip_smoke.DENSE_PATHS))
def test_dispatch_per_model_call_equals_the_smokes_gates(path, monkeypatch):
    """Per model call of a depth-true model on the smoke path's arena, the
    GEMMs its launch gates count: 7 x L + 1 through griffin_spmm
    (stablelm 169, minitron 225, command-r's 2-layer cut 15), no
    dense_gemm (the head is untied and compacted); stablelm's Mode.A 169
    through sparse_a with 4 x 24 + 1 = 97 metadata builds (wq/wk/wv,
    wo, w_gate/w_up, w_down, then the head); no plain GEMM; the tokens
    equal the oracle's."""
    from repro_torch.kernels.sparse_a import ops as sparse_a_ops
    from repro_torch.models import common
    spec = chip_smoke.DENSE_PATHS[path]
    builds = []
    for mod in (common, sparse_a_ops):
        def counted(*args, _real=mod.compact_activations, **kw):
            builds.append(1)
            return _real(*args, **kw)
        monkeypatch.setattr(mod, "compact_activations", counted)
    cfg = _depth_true_cfg(spec["arch"])
    api = build_model(cfg, device="cpu")
    params = api.init(api.generator(0))
    if spec["sparsity"]:
        params = sparsify_params(params, spec["sparsity"], **PRUNE)
    paged = "page_size" in spec["arena"]
    conf = EngineConfig().with_fields(
        num_slots=2, cache_len=16, decode_chunk=4, use_kernels=True,
        a_sparsity=spec["a_sparsity"], page_size=4 if paged else None)
    eng = ServeEngine(api, params, conf)
    assert (eng._paged is not None) == paged
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
    assert launches["griffin_spmm"] + launches["sparse_a"] == \
        7 * cfg.num_layers + 1
    assert len(builds) == calls * launches["sparse_a_meta"]
    if spec["mode"] == "A":
        assert launches["sparse_a_meta"] == 4 * cfg.num_layers + 1
    for r in reqs:
        with eng._scope():
            want = greedy_generate(api, params, r.as_batch(eng.device),
                                   steps=r.max_new_tokens,
                                   cache_len=eng.cache_len,
                                   prompt_bucket=eng.bucket_for(
                                       r.prompt_len))
        assert outs[r.rid].tokens == want[0].tolist(), r.rid
