"""The port's int8 KV pages against the JAX package's:

* ``quantize_rows``/``dequantize_rows`` (repro_torch.optim.compression)
  bit-equal to the reference's, with exact .5 ties (round half to even),
  an all-zero row (the 1e-12 floor), rows at the +-127 clip and bf16 input;
* ``paged_tree``'s int8 pools and ``<key>_scale`` leaves, and the int8
  paged write and view, bit-equal to the reference's on the same pool,
  table and update;
* engines: int8 tokens and stats equal to the reference's int8 paged
  engine, one slot against four, the CLI and ``check_parity``'s refusal;
* the reference's paged row of ``benchmarks/out/BENCH_serve.json`` with
  int8 pools: 10 paged vs 4 fixed peak slots, 1684 tokens, int8 tokens
  equal to the fixed arena's (the row's ``int8_token_match`` 1.0), and the
  teacher-forced logit gap within ``PAGED_INT8_TOL`` and within 10 % of
  the reference's ``int8_logit_gap`` on the same bridged weights.
"""
import dataclasses
import importlib
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.common import paged_view as jax_paged_view
from repro.models.common import paged_write as jax_paged_write
from repro.optim.compression import dequantize_rows as jax_dequantize_rows
from repro.optim.compression import quantize_rows as jax_quantize_rows
from repro.runtime.config import EngineConfig as JaxEngineConfig
from repro.runtime.engine import ServeEngine as JaxServeEngine
from repro.runtime.engine import _promote_arena as jax_promote_arena
from repro.runtime.engine import synthetic_trace as jax_synthetic_trace
from repro.runtime.paging import build_spec as jax_build_spec
from repro.runtime.paging import paged_tree as jax_paged_tree
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models.common import paged_slot, paged_view, paged_write
from repro_torch.optim import dequantize_rows, quantize_rows
from repro_torch.runtime.config import EngineConfig
from repro_torch.runtime.engine import (ServeEngine, _promote_arena,
                                        int8_logit_gap, synthetic_trace)
from repro_torch.runtime.paging import build_spec, paged_tree

ROOT = pathlib.Path(__file__).resolve().parent.parent
STATS = ("emitted", "decode_steps", "chunk_calls", "prefill_calls",
         "host_syncs", "idle_steps")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Eager torch ops at these sizes gain nothing from threads, and with
    pytest-xdist's parallel workers OpenMP's pools oversubscribe the cores
    (a test of seconds then takes minutes): one thread for the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(case: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((6, 3, 8)) * 4).astype(np.float32)
    if case == "ties":
        # max 127 makes the scale exactly 1, so x / scale is x: .5 ties
        x[0] = np.resize(np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5,
                                   127.0], np.float32), (3, 8))
    elif case == "zeros":
        x[1] = 0                           # the 1e-12 floor, q = 0
        x[2, 0] = 0
    elif case == "clip":
        x[3] = np.float32(3e38)            # every entry at the +-127 clip
        x[3, 1] = np.float32(-3e38)
    elif case == "tiny":
        x *= np.float32(1e-30)
    return x


@pytest.mark.parametrize("ndim_keep", [1, 2])
@pytest.mark.parametrize("case", ["normal", "ties", "zeros", "clip", "tiny",
                                  "bf16"])
def test_quantize_rows_bit_equal_reference(case, ndim_keep):
    x = _rows(case)
    if case == "bf16":
        tx = torch.from_numpy(x).bfloat16()
        jx = jnp.asarray(tx.float().numpy()).astype(jnp.bfloat16)
    else:
        tx, jx = torch.from_numpy(x), jnp.asarray(x)
    q, s = quantize_rows(tx, ndim_keep)
    jq, js = jax_quantize_rows(jx, ndim_keep)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == x.shape[:ndim_keep]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(dequantize_rows(q, s).numpy(),
                                  np.asarray(jax_dequantize_rows(jq, js)))
    if case == "ties" and ndim_keep == 1:
        assert q[0, 0].tolist() == [0, 2, 2, 0, -2, -2, 126, 127]
    if case == "zeros":
        assert not q[1].any() and float(s[1].max()) == np.float32(1e-12) / \
            np.float32(127.0)
    if case == "clip":
        assert set(q[3].unique().tolist()) <= {-127, 127}


@pytest.mark.parametrize("pos", [np.int32(5), np.array([3, 17, 0, 30])],
                         ids=["scalar", "per-row"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_paged_write_and_view_equal_reference(pos, dtype):
    """Row 1 is dead (all DUMP) at a position past max_pages * page_size:
    it wraps, quantizes onto DUMP and reads nothing it wrote.  The view
    dequantizes in fp32 and casts to the cache's dtype."""
    rng = np.random.default_rng(5)
    pool = rng.integers(-127, 128, (9, 4, 2, 3)).astype(np.int8)
    scale = rng.random((9, 4)).astype(np.float32)
    pages = np.array([[1, 2, 3, 4], [0, 0, 0, 0], [5, 6, 0, 0],
                      [7, 8, 0, 0]], np.int32)
    update = (rng.standard_normal((4, 1, 2, 3)) * 3).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jpool, jscale = jax_paged_write(
        jnp.asarray(pool), jnp.asarray(scale), jnp.asarray(pages),
        jnp.asarray(update).astype(jdt), jnp.asarray(pos), 4)
    jview = jax_paged_view(jpool, jscale, jnp.asarray(pages), jdt)
    tpool, tscale = torch.from_numpy(pool.copy()), torch.from_numpy(
        scale.copy())
    tpages = torch.from_numpy(pages).long()
    slot = paged_slot(tpages, torch.from_numpy(np.asarray(pos)), 4)
    tdt = getattr(torch, dtype)
    paged_write(tpool, tscale, slot, torch.from_numpy(update).to(tdt))
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    view = paged_view(tpool, tscale, tpages, tdt)
    assert view.shape == (4, 16, 2, 3) and view.dtype == tdt
    np.testing.assert_array_equal(view.float().numpy(),
                                  np.asarray(jview.astype(jnp.float32)))


def test_int8_paged_tree_equals_reference():
    api = build_model(get_config("llama3.2-1b").reduced(), device="cpu")
    japi = jax_build_model(jax_get_config("llama3.2-1b").reduced())
    spec, clen = build_spec(api, 2, 16, 4, kv_dtype="int8")
    jspec, _ = jax_build_spec(japi, 2, 16, 4, kv_dtype="int8")
    arena = paged_tree(_promote_arena(api.init_cache(
        2, clen, device=torch.device("meta")), 2), 2, spec)
    jarena = jax_paged_tree(jax_promote_arena(japi.init_cache(2, clen), 2),
                            2, jspec)
    assert sorted(arena) == sorted(jarena) == ["k", "k_scale", "pages",
                                               "pos", "v", "v_scale"]
    for key in arena:
        assert tuple(arena[key].shape) == jarena[key].shape, key
        assert str(arena[key].dtype)[6:] == str(jarena[key].dtype), key
    assert arena["k_scale"].shape == (2, spec.num_pages, spec.page_size)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

TRACE = dict(num_requests=7, seed=11, prompt_lens=(6, 10, 17),
             gen_lens=(2, 4, 7), arrival_every=1)


def test_int8_engine_equals_reference():
    """Tokens, emission steps and stats of the port's int8 paged engine
    equal the reference's on its bridged weights and the same trace, with
    a pool small enough that admissions wait for pages."""
    cfg = jax_get_config("llama3.2-1b").reduced()
    japi = jax_build_model(cfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    kw = dict(num_slots=3, cache_len=24, page_size=4, num_pages=9,
              decode_chunk=4, kv_dtype="int8")
    jeng = JaxServeEngine(japi, jparams,
                          config=JaxEngineConfig().with_fields(**kw))
    jouts = jeng.run(jax_synthetic_trace(cfg, **TRACE))
    api = build_model(get_config("llama3.2-1b").reduced(), device="cpu")
    eng = ServeEngine(api, bridge.to_torch(jax.tree.map(np.asarray,
                                                        jparams)),
                      EngineConfig().with_fields(**kw))
    outs = eng.run(synthetic_trace(api.cfg, **TRACE))
    assert eng._paged.kv_dtype == "int8"
    assert eng.cache["k"].dtype == torch.int8
    assert sorted(outs) == sorted(jouts)
    for rid in jouts:
        assert outs[rid].tokens == jouts[rid].tokens, rid
        assert outs[rid].token_steps == jouts[rid].token_steps, rid
    for key in STATS:
        assert eng.stats[key] == jeng.stats[key], key


def test_int8_one_slot_equals_four_slots():
    """Row quantization reads only its own row, so a request's tokens do
    not depend on what else is in the batch."""
    api = build_model(get_config("llama3.2-1b").reduced(), device="cpu")
    params = api.init(api.generator(2))
    conf = EngineConfig().with_fields(cache_len=32, page_size=4,
                                      kv_dtype="int8", decode_chunk=4,
                                      max_admissions_per_step=4)
    reqs = lambda: synthetic_trace(api.cfg, num_requests=8, seed=4,  # noqa
                                   prompt_lens=(5, 9, 14),
                                   gen_lens=(3, 6, 11))
    four = ServeEngine(api, params, conf)
    outs4 = four.run(reqs())
    assert four.peak_active == 4
    outs1 = ServeEngine(api, params, conf.with_fields(num_slots=1)).run(
        reqs())
    for r in reqs():
        assert outs4[r.rid].tokens == outs1[r.rid].tokens, r.rid


def test_check_parity_refuses_int8():
    run = launch_serve.serve(reduced=True, device="cpu", requests=2,
                             config=EngineConfig().with_fields(
                                 page_size=4, kv_dtype="int8"))
    assert run.engine._paged.kv_dtype == "int8"
    with pytest.raises(ValueError, match="logit tolerance"):
        launch_serve.check_parity(run)


# the reference's paged row (benchmarks/bench_serve.py: PAGED, the heavy
# trace, the workload model and PAGED_INT8_TOL)
PAGED = dict(page_size=16, num_pages=64, cache_len=256)
GEN_LENS = (12, 12, 16, 16, 24, 24, 32, 112)
HEAVY = dict(num_requests=48, seed=7, prompt_lens=(8, 16, 24),
             gen_lens=GEN_LENS, arrival_every=0, length_dist="heavy",
             max_gen=224)
WORKLOAD = dict(d_model=96, head_dim=24, d_ff=384, num_layers=2,
                vocab_size=256)
PAGED_INT8_TOL = 0.02


def _drain_peak(eng, reqs):
    for r in reqs:
        eng.add(r)
    peak = 0
    while eng.sched.has_work():
        eng.step()
        peak = max(peak, len(eng.sched.active))
    return peak, {r: list(o.tokens) for r, o in eng.outputs.items()}


def test_reference_paged_row_holds_with_int8_pages(monkeypatch):
    row = json.loads((ROOT / "benchmarks" / "out" /
                      "BENCH_serve.json").read_text())["paged"]
    jcfg = dataclasses.replace(jax_get_config("llama3.2-1b").reduced(),
                               **WORKLOAD)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              **WORKLOAD)
    api = build_model(cfg, device="cpu")
    params = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    runs = {}
    for name, slots, kv in (("fixed", 4, None), ("paged-int8", 10, "int8")):
        kw = dict(num_slots=slots, cache_len=PAGED["cache_len"],
                  decode_chunk=8, max_admissions_per_step=10)
        if kv:
            kw.update(page_size=PAGED["page_size"],
                      num_pages=PAGED["num_pages"], kv_dtype=kv)
        eng = ServeEngine(api, params, EngineConfig().with_fields(**kw))
        runs[name] = (eng,) + _drain_peak(eng, synthetic_trace(cfg, **HEAVY))
    (fixed, fpeak, ftoks), (int8, ipeak, itoks) = runs["fixed"], \
        runs["paged-int8"]
    assert (ipeak, fpeak) == (row["configs"]["paged-int8"]["peak_concurrent"],
                              row["configs"]["fixed"]["peak_concurrent"]) \
        == (10, 4)
    assert int8.stats["emitted"] == fixed.stats["emitted"] == \
        row["configs"]["paged-int8"]["emitted"] == 1684
    assert row["int8_token_match"] == 1.0 and itoks == ftoks
    # the teacher-forced gap: the port's against the reference's own
    # function on the same bridged weights (its model calls jitted, as its
    # engine runs them)
    gap = int8_logit_gap(api, params, EngineConfig().with_fields(
        cache_len=PAGED["cache_len"], page_size=PAGED["page_size"]))
    monkeypatch.syspath_prepend(str(ROOT))
    bench = importlib.import_module("benchmarks.bench_serve")
    assert bench.PAGED_INT8_TOL == PAGED_INT8_TOL
    jitted = dataclasses.replace(
        japi, decode_step=jax.jit(japi.decode_step),
        prefill=jax.jit(japi.prefill, static_argnames=("cache_len",)))
    jgap = bench.int8_logit_gap(jitted, jparams, PAGED["cache_len"],
                                PAGED["page_size"])
    assert 0 < gap <= PAGED_INT8_TOL
    assert abs(gap - jgap) <= 0.1 * jgap, (gap, jgap)
