"""The port's stepwise serving path (``SchedConfig.fused=False``) against
the JAX package's:

* the ``static`` and ``continuous`` rows of
  ``benchmarks/out/BENCH_serve.json`` on the reference's workload (48
  requests, 4 slots, seed 7), reproduced with the benchmark's recipe (one
  warm run, then three runs with zeroed stats on the same engine), with
  the fused ``continuous-chunked`` row beside them; tokens and stats of a
  first run equal the reference engine's;
* the counters of ``chip_smoke.py``'s 8-request trace on its two stepwise
  paths (the constants the card run asserts);
* tokens of the stepwise path equal to the fused path's and to the
  batch-1 oracle through the kernel wrappers, on the fixed and the paged
  arena; the reference engine's tokens and stats through its kernels; and
  the CLI's ``--policy`` flag with a ``{"sched": {"fused": false}}``
  config.
"""
import dataclasses
import importlib
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.runtime.config import EngineConfig as JaxEngineConfig
from repro.runtime.engine import Request as JaxRequest
from repro.runtime.engine import ServeEngine as JaxServeEngine
from repro.runtime.engine import synthetic_trace as jax_synthetic_trace
from repro.sparsity import sparsify_params as jax_sparsify
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models.common import (kernel_dispatch_counts,
                                       reset_kernel_dispatch)
from repro_torch.runtime.config import EngineConfig
from repro_torch.runtime.engine import Request, ServeEngine, synthetic_trace
from repro_torch.runtime.serve import greedy_generate
from repro_torch.sparsity import sparsify_params

ROOT = pathlib.Path(__file__).resolve().parent.parent
STATS = ("emitted", "decode_steps", "chunk_calls", "prefill_calls",
         "host_syncs", "idle_steps", "retraces")

# the reference benchmark's workload (benchmarks/bench_serve.py:
# build_workload, CONFIGS)
WORKLOAD = dict(d_model=96, head_dim=24, d_ff=384, num_layers=2,
                vocab_size=256)
GEN_LENS = (12, 12, 16, 16, 24, 24, 32, 112)
BENCH_TRACE = dict(num_requests=48, seed=7, prompt_lens=(8, 16, 24),
                   gen_lens=GEN_LENS)
ROWS = {"static": ("static", 1, False),
        "continuous": ("continuous", 1, False),
        "continuous-chunked": ("continuous", 8, True)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Eager torch ops at these sizes gain nothing from threads, and with
    pytest-xdist's parallel workers OpenMP's pools oversubscribe the cores
    (a test of seconds then takes minutes): one thread for the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("row", list(ROWS))
def test_bench_serve_rows_hold(row):
    policy, chunk, fused = ROWS[row]
    want = json.loads((ROOT / "benchmarks" / "out" /
                       "BENCH_serve.json").read_text())["configs"][row]
    jcfg = dataclasses.replace(jax_get_config("llama3.2-1b").reduced(),
                               **WORKLOAD)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              **WORKLOAD)
    api = build_model(cfg, device="cpu")
    params = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    kw = dict(num_slots=4, cache_len=24 + 112 + 1, policy=policy,
              decode_chunk=chunk, fused=fused)
    eng = ServeEngine(api, params, EngineConfig().with_fields(**kw))
    assert eng.fused is fused
    outs = eng.run(synthetic_trace(cfg, **BENCH_TRACE))
    jeng = JaxServeEngine(japi, jparams,
                          config=JaxEngineConfig().with_fields(**kw))
    jouts = jeng.run(jax_synthetic_trace(jcfg, **BENCH_TRACE))
    assert sorted(outs) == sorted(jouts)
    for rid in jouts:
        assert outs[rid].tokens == jouts[rid].tokens, rid
        assert outs[rid].token_steps == jouts[rid].token_steps, rid
    for key in STATS:
        assert eng.stats[key] == jeng.stats[key], key
    # the benchmark's recipe: three more runs of the trace on the same
    # engine with zeroed stats; the row is the last (the measurement
    # cadence carries over from run to run)
    for _ in range(3):
        eng.stats = {k: 0 for k in eng.stats}
        eng.run(synthetic_trace(cfg, **BENCH_TRACE))
    st = eng.stats
    assert (st["emitted"], st["decode_steps"], st["chunk_calls"],
            st["prefill_calls"]) == (want["emitted"], want["decode_steps"],
                                     want["chunk_calls"],
                                     want["prefill_calls"])
    assert round(st["host_syncs"] / st["emitted"], 4) == \
        want["host_syncs_per_token"]
    assert sorted(eng.prefill_buckets) == want["prefill_buckets"]
    assert round(st["emitted"] / st["decode_steps"], 3) == \
        want["tok_per_step"]
    pinned = {"static": (844, 0, 0.5061), "continuous": (496, 0, 0.3073),
              "continuous-chunked": (498, 117, 0.0593)}
    assert (want["decode_steps"], want["chunk_calls"],
            want["host_syncs_per_token"]) == pinned[row]
    assert (want["emitted"], want["prefill_calls"]) == (1972, 48)


# chip_smoke.py's trace (launch.serve: seed 1, 8 requests, prompts
# 8/16/32, generations 4/8/16) and its stepwise paths' counters
SMOKE_STATS = {"decode_steps": 22, "prefill_calls": 8, "emitted": 52,
               "host_syncs": 32}


def _smoke_trace(vocab: int):
    """The smoke's trace, drawn for the full-width vocabulary (the draws
    of token ids decide the later length draws) and folded into
    ``vocab``: the counters depend on lengths only."""
    full = synthetic_trace(get_config("llama3.2-1b"), num_requests=8, seed=1,
                           prompt_lens=(8, 16, 32), gen_lens=(4, 8, 16))
    return [Request(r.rid, np.asarray(r.tokens) % vocab, r.max_new_tokens,
                    r.arrival) for r in full]


@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_smoke_trace_stepwise_counters(policy, monkeypatch):
    api = build_model(get_config("llama3.2-1b").reduced(), device="cpu")
    kw = dict(num_slots=4, cache_len=49, policy=policy, fused=False,
              decode_chunk=1)
    eng = ServeEngine(api, api.init(api.generator(0)),
                      EngineConfig().with_fields(**kw))
    eng.run(_smoke_trace(api.cfg.vocab_size))
    assert {k: eng.stats[k] for k in SMOKE_STATS} == SMOKE_STATS
    assert eng.stats["chunk_calls"] == 0
    # the reference engine counts the same on the same trace
    jcfg = jax_get_config("llama3.2-1b").reduced()
    japi = jax_build_model(jcfg)
    jeng = JaxServeEngine(japi, japi.init(jax.random.PRNGKey(0)),
                          config=JaxEngineConfig().with_fields(**kw))
    jeng.run([JaxRequest(rid=r.rid, tokens=r.tokens,
                         max_new_tokens=r.max_new_tokens, arrival=r.arrival)
              for r in _smoke_trace(jcfg.vocab_size)])
    assert {k: jeng.stats[k] for k in SMOKE_STATS} == SMOKE_STATS
    # and chip_smoke.py asserts these constants on the card
    monkeypatch.syspath_prepend(str(ROOT))
    smoke = importlib.import_module("chip_smoke")
    path = smoke.PATHS["sparse_b_static" if policy == "static"
                       else "sparse_b_stepwise"]
    assert path["stats"] == SMOKE_STATS
    assert {k: path["arena"][k] for k in kw if k in path["arena"]} == \
        {k: v for k, v in kw.items() if k in path["arena"]}


@pytest.mark.parametrize("page_size", [None, 4], ids=["fixed", "paged"])
@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_stepwise_tokens_equal_fused_and_oracle(policy, page_size):
    """Compacted weights through the kernel wrappers: the stepwise path
    gives the fused path's tokens and the batch-1 oracle's, with one
    kernel call per GEMM of every model call."""
    api = build_model(get_config("llama3.2-1b").reduced(), device="cpu")
    params = sparsify_params(api.init(api.generator(0)), 0.6, block_k=16,
                             block_n=16, unit=8)
    conf = EngineConfig().with_fields(num_slots=3, cache_len=32,
                                      use_kernels=True, policy=policy,
                                      page_size=page_size,
                                      measure_every=3)
    reqs = lambda: synthetic_trace(api.cfg, num_requests=7, seed=11,  # noqa
                                   prompt_lens=(6, 10, 17),
                                   gen_lens=(2, 4, 7), arrival_every=1)
    fused = ServeEngine(api, params, conf).run(reqs())
    eng = ServeEngine(api, params, conf.with_fields(fused=False,
                                                    decode_chunk=1))
    reset_kernel_dispatch()
    outs = eng.run(reqs())
    st = eng.stats
    assert kernel_dispatch_counts() == {
        "kernel": 15 * (st["prefill_calls"] + st["decode_steps"])}
    # a sync per admission, per step and per measurement (every 3 steps)
    assert st["host_syncs"] == st["prefill_calls"] + st["decode_steps"] + \
        st["decode_steps"] // 3
    for r in reqs():
        assert outs[r.rid].tokens == fused[r.rid].tokens, r.rid
        with eng._scope():
            ref = greedy_generate(api, params, r.as_batch(eng.device),
                                  steps=r.max_new_tokens,
                                  cache_len=eng.cache_len,
                                  prompt_bucket=eng.bucket_for(r.prompt_len))
        assert outs[r.rid].tokens == ref[0].tolist(), r.rid


def test_stepwise_through_kernels_equals_reference():
    """The reference's stepwise engine through its Pallas kernels
    (interpret mode) and the port's through its kernel wrappers: equal
    tokens, emission steps, stats and Mode history."""
    cfg = jax_get_config("llama3.2-1b").reduced()
    japi = jax_build_model(cfg)
    jparams = jax_sparsify(japi.init(jax.random.PRNGKey(0)), 0.6,
                           block_k=16, block_n=16, unit=8)
    kw = dict(num_slots=3, cache_len=32, decode_chunk=1, fused=False,
              use_kernels=True, measure_every=4)
    jeng = JaxServeEngine(japi, jparams, config=JaxEngineConfig().with_fields(
        interpret=True, **kw))
    trace = dict(num_requests=7, seed=11, prompt_lens=(6, 10, 17),
                 gen_lens=(2, 4, 7), arrival_every=1)
    jouts = jeng.run(jax_synthetic_trace(cfg, **trace))
    api = build_model(get_config("llama3.2-1b").reduced(), device="cpu")
    eng = ServeEngine(api, bridge.to_torch(jax.tree.map(np.asarray,
                                                        jparams)),
                      EngineConfig().with_fields(**kw))
    outs = eng.run(synthetic_trace(api.cfg, **trace))
    for rid in jouts:
        assert outs[rid].tokens == jouts[rid].tokens, rid
        assert outs[rid].token_steps == jouts[rid].token_steps, rid
    for key in STATS:
        assert eng.stats[key] == jeng.stats[key], key
    assert [(s, m.value) for s, m in eng.mode_history] == \
        [(s, m.value) for s, m in jeng.mode_history]
    assert eng.a_measured == pytest.approx(jeng.a_measured)


def test_launch_serve_cli_stepwise_config_and_policy(tmp_path, capsys):
    path = tmp_path / "engine.json"
    path.write_text('{"sched": {"fused": false}}')
    launch_serve.main(["--reduced", "--device", "cpu", "--use-kernels",
                       "--config", str(path), "--policy", "static",
                       "--decode-chunk", "1", "--parity"])
    out = capsys.readouterr().out
    assert "policy static, stepwise" in out
    assert "0 fused chunks" in out
    assert "parity OK: all 8 requests" in out
