"""The port's router and SLO layer (``repro_torch.runtime.slo``,
``fault``, ``router``, the engine's router hooks and ``launch/serve.py
--replicas``) against the JAX package's:

* ``CostModel``, ``AdmissionQueue``, ``DegradationLadder`` and
  ``percentile`` equal to the reference's (the queue under a hypothesis
  sweep of push/pop sequences: the same shed log, ``max(0, feasible -
  bound)`` capacity sheds, monotone in the bound);
* the engine hooks against the reference engine: ``cancel`` of waiting
  and running requests (a running request's slot then reused, on the
  fixed, paged and int8-paged arenas), ``load``, ``would_admit``,
  ``chunk_cap`` (same tokens, more chunks) and ``set_degraded``'s Mode
  round trip;
* bursty, SLO-carrying ``synthetic_trace`` equal to the reference's;
* the two ``router`` rows of ``benchmarks/out/BENCH_serve.json`` on the
  reference benchmark's own workload (weights bridged), exactly, with
  tokens per rid equal to a live reference ``RouterEngine`` run, and
  the same rows from 0.8-pruned weights through the kernel wrappers;
* ``chip_smoke.py``'s ``router_kill`` and ``router_hedge`` cells at
  reduced width against the reference's ``RouterEngine``, the hedge
  losers' cancels included (the constants the card run gates on);
* fault-spec parsing, the router's config section and the CLI overload
  smoke.
"""
import argparse
import dataclasses
import importlib
import json
import math
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.runtime import fault as jax_fault
from repro.runtime import slo as jax_slo
from repro.runtime.config import EngineConfig as JaxEngineConfig
from repro.runtime.engine import Request as JaxRequest
from repro.runtime.engine import ServeEngine as JaxServeEngine
from repro.runtime.engine import synthetic_trace as jax_synthetic_trace
from repro.runtime.router import RouterEngine as JaxRouterEngine
from repro.sparsity import sparsify_params as jax_sparsify
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.spec import Mode
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.runtime import fault, slo
from repro_torch.runtime.config import EngineConfig
from repro_torch.runtime.engine import (Attribution, Request, ServeEngine,
                                        synthetic_trace)
from repro_torch.runtime.router import RouterEngine
from repro_torch.sparsity import sparsify_params

ROOT = pathlib.Path(__file__).resolve().parent.parent
ROW_KEYS = ("requests", "completed", "shed", "max_queue_depth", "ticks",
            "ttft_p50", "ttft_p99", "itl_p50", "itl_p99", "slo_attainment",
            "ladder_history")
SHED = ("rid", "step", "priority", "deadline")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Eager torch ops at these sizes gain nothing from threads, and with
    pytest-xdist's parallel workers OpenMP's pools oversubscribe the cores:
    one thread for the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def repo_modules():
    """The reference benchmark (``benchmarks/bench_serve.py``) and
    ``chip_smoke.py``, imported from the repository's root."""
    sys.path.insert(0, str(ROOT))
    try:
        yield (importlib.import_module("benchmarks.bench_serve"),
               importlib.import_module("chip_smoke"))
    finally:
        sys.path.remove(str(ROOT))


def _shed_log(events):
    return [tuple(getattr(e, k) for k in SHED) + (e.reason.value,)
            for e in events]


# ---------------------------------------------------------------------------
# slo units against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tps,plen,gen,bucket", [
    (64, 3, 4, None), (8, 3, 4, None), (8, 3, 4, 16), (8, 100, 1, None),
    (64, 24, 17, 32), (1, 5, 2, 8)])
def test_cost_model_equals_reference(tps, plen, gen, bucket):
    got = slo.CostModel(prefill_tokens_per_step=tps).estimate(plen, gen,
                                                              bucket)
    want = jax_slo.CostModel(prefill_tokens_per_step=tps).estimate(
        plen, gen, bucket)
    assert got == want


_OP = st.one_of(
    st.tuples(st.just("push"), st.integers(1, 40), st.integers(1, 20),
              st.integers(0, 2), st.one_of(st.none(), st.integers(1, 30))),
    st.tuples(st.just("tick")), st.tuples(st.just("pop")))


def _drive(queue, ops, make):
    """Replay ``ops`` on ``queue``: pushes of ``make``'s requests, ticks
    that advance the clock, pops.  Returns (push results, pop results)."""
    now, pushed, popped = 0, [], []
    for i, op in enumerate(ops):
        if op[0] == "push":
            _, plen, gen, prio, dl = op
            req = make(rid=i, tokens=np.ones(plen, np.int32),
                       max_new_tokens=gen, priority=prio, deadline_ms=dl)
            ev = queue.push(req, now)
            pushed.append(None if ev is None else _shed_log([ev])[0])
        elif op[0] == "tick":
            now += 1
        else:
            entry, expired = queue.pop(now)
            popped.append((None if entry is None else entry.rid,
                           _shed_log(expired)))
    return pushed, popped


@settings(max_examples=60, deadline=None)
@given(ops=st.lists(_OP, max_size=40),
       bound=st.one_of(st.none(), st.integers(1, 6)),
       shed_prio=st.one_of(st.none(), st.integers(0, 2)))
def test_admission_queue_equals_reference(ops, bound, shed_prio):
    q, jq = slo.AdmissionQueue(bound), jax_slo.AdmissionQueue(bound)
    q.shed_min_priority = jq.shed_min_priority = shed_prio
    assert _drive(q, ops, Request) == _drive(jq, ops, JaxRequest)
    assert _shed_log(q.shed_log) == _shed_log(jq.shed_log)
    assert (q.depth, q.max_depth) == (jq.depth, jq.max_depth)
    if bound is not None:
        assert q.max_depth <= bound


@settings(max_examples=40, deadline=None)
@given(pushes=st.lists(st.tuples(st.integers(1, 40), st.integers(1, 20),
                                 st.integers(0, 2),
                                 st.one_of(st.none(), st.integers(1, 30))),
                       max_size=30))
def test_admission_queue_capacity_sheds_are_deterministic(pushes):
    """Pushes at one tick: the capacity sheds number max(0, feasible -
    bound), the same on the reference's queue, and never grow with the
    bound."""
    ops = [("push",) + p for p in pushes]
    sheds = []
    for bound in range(1, 8):
        q, jq = slo.AdmissionQueue(bound), jax_slo.AdmissionQueue(bound)
        _drive(q, ops, Request)
        _drive(jq, ops, JaxRequest)
        assert _shed_log(q.shed_log) == _shed_log(jq.shed_log)
        reasons = [e.reason for e in q.shed_log]
        feasible = len(ops) - reasons.count(slo.ShedReason.INFEASIBLE)
        full = reasons.count(slo.ShedReason.QUEUE_FULL)
        assert full == max(0, feasible - bound)
        sheds.append(full)
    assert sheds == sorted(sheds, reverse=True)


@settings(max_examples=60, deadline=None)
@given(pressures=st.lists(st.floats(0.0, 1.5), max_size=60),
       patience=st.integers(1, 3), max_level=st.integers(1, 3))
def test_degradation_ladder_equals_reference(pressures, patience, max_level):
    ladder = slo.DegradationLadder(slo.DegradationConfig(
        patience=patience, max_level=max_level))
    jladder = jax_slo.DegradationLadder(jax_slo.DegradationConfig(
        patience=patience, max_level=max_level))
    levels = [ladder.update(p, t) for t, p in enumerate(pressures)]
    jlevels = [jladder.update(p, t) for t, p in enumerate(pressures)]
    assert levels == jlevels and ladder.history == jladder.history


@settings(max_examples=80, deadline=None)
@given(xs=st.lists(st.integers(-50, 50), max_size=30),
       q=st.floats(0.0, 100.0))
def test_percentile_equals_reference(xs, q):
    assert slo.percentile(xs, q) == jax_slo.percentile(xs, q)
    if xs:
        k = max(0, min(len(xs) - 1, math.ceil(q / 100 * len(xs)) - 1))
        assert slo.percentile(xs, q) == sorted(xs)[k]


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

TRACES = {
    "overload-slo": dict(num_requests=48, seed=11, prompt_lens=(8, 16, 24),
                         gen_lens=(4, 8, 12, 16), arrival_process="bursty",
                         rate=1.0, burst_rate=8.0, burst_switch=0.2,
                         length_dist="heavy", max_gen=24, priorities=(0, 1),
                         deadline_slack=4.0, ttft_deadline=6),
    "cli": dict(num_requests=24, seed=1, prompt_lens=(8, 16, 32),
                gen_lens=(4, 8, 16), arrival_process="bursty", rate=1.0,
                burst_rate=8.0, length_dist="heavy", max_gen=32,
                priorities=(0, 1), deadline_slack=2.0, ttft_deadline=16),
    "three-classes": dict(num_requests=30, seed=5, arrival_process="bursty",
                          priorities=(0, 1, 2), deadline_slack=1.5),
    "fixed-slo": dict(num_requests=10, seed=2, arrival_every=3,
                      ttft_deadline=4),
}


@pytest.mark.parametrize("name", list(TRACES))
def test_bursty_slo_trace_equals_reference(name):
    kw = TRACES[name]
    got = synthetic_trace(get_config("llama3.2-1b"), **kw)
    want = jax_synthetic_trace(jax_get_config("llama3.2-1b"), **kw)
    assert len(got) == len(want)
    for r, j in zip(got, want):
        assert (r.rid, r.max_new_tokens, r.arrival, r.priority,
                r.deadline_ms, r.ttft_deadline_ms) == \
            (j.rid, j.max_new_tokens, j.arrival, j.priority, j.deadline_ms,
             j.ttft_deadline_ms)
        assert np.array_equal(r.tokens, j.tokens)


# ---------------------------------------------------------------------------
# engine hooks against the reference engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced_pair():
    """(port api, port params, reference api, reference params): the
    reduced llama3.2-1b with the reference's weights bridged."""
    jcfg = jax_get_config("llama3.2-1b").reduced()
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    api = build_model(get_config("llama3.2-1b").reduced(), device="cpu")
    return api, bridge.to_torch(jax.tree.map(np.asarray, jparams)), \
        japi, jparams


def _hook_trace():
    return synthetic_trace(get_config("llama3.2-1b").reduced(),
                           num_requests=4, seed=3, prompt_lens=(5, 9),
                           gen_lens=(6, 7))


def _as_jax(reqs):
    return [JaxRequest(rid=r.rid, tokens=r.tokens,
                       max_new_tokens=r.max_new_tokens, arrival=r.arrival,
                       priority=r.priority, deadline_ms=r.deadline_ms,
                       ttft_deadline_ms=r.ttft_deadline_ms) for r in reqs]


def test_engine_cancel_load_and_would_admit_equal_reference(reduced_pair):
    """One slot, four requests: the same ``load`` and ``would_admit``
    after every tick, ``cancel`` of a waiting and of a running request
    (and of an unknown one) answering the same, and equal tokens, emission
    steps and stats to the end."""
    api, params, japi, jparams = reduced_pair
    kw = dict(num_slots=1, cache_len=24, decode_chunk=2)
    eng = ServeEngine(api, params, EngineConfig().with_fields(**kw))
    jeng = JaxServeEngine(japi, jparams,
                          config=JaxEngineConfig().with_fields(**kw))
    reqs = _hook_trace()
    for r, j in zip(reqs, _as_jax(reqs)):
        eng.add(r)
        jeng.add(j)
    record, jrecord = [], []
    for e, rec in ((eng, record), (jeng, jrecord)):
        rec.append((e.load, e.sched.would_admit(e.clock)))
        e.step()                             # admits rid 0
        rec.append((e.load, e.sched.would_admit(e.clock)))
        rec.append((e.cancel(2), e.load))    # waiting
        rec.append((e.cancel(0), e.load))    # running
        rec.append((e.cancel(0), e.cancel(99), e.load))
        rec.append(e.sched.would_admit(e.clock))
        while e.sched.has_work():
            e.step()
            rec.append((e.load, e.sched.would_admit(e.clock)))
    assert record == jrecord
    assert record[2:4] == [(True, 3), (True, 2)]
    assert sorted(eng.outputs) == sorted(jeng.outputs) == [0, 1, 3]
    assert eng.outputs[0].finished < 0 and eng.sched.finished == [1, 3]
    for rid in (1, 3):
        assert eng.outputs[rid].tokens == \
            list(map(int, jeng.outputs[rid].tokens))
        assert eng.outputs[rid].token_steps == jeng.outputs[rid].token_steps
    assert eng.stats == jeng.stats


@pytest.mark.parametrize("arena", [
    dict(), dict(page_size=4), dict(page_size=4, kv_dtype="int8")],
    ids=["fixed", "paged", "paged-int8"])
def test_engine_cancel_running_then_reuse_slot_equals_reference(
        reduced_pair, arena):
    """Two slots: rid 0 and rid 1 run, rid 0 is cancelled mid-decode and
    rid 2 is admitted into its freed slot (on a paged arena: the slot's
    pages come home at the next tick and its page-table row is rewritten
    by the admission).  The admission slots, loads and free pages after
    every tick, the tokens, emission steps and stats equal the reference
    engine's, and the pool is whole again at the end."""
    api, params, japi, jparams = reduced_pair
    kw = dict(num_slots=2, cache_len=24, decode_chunk=2, **arena)
    eng = ServeEngine(api, params, EngineConfig().with_fields(**kw))
    jeng = JaxServeEngine(japi, jparams,
                          config=JaxEngineConfig().with_fields(**kw))
    reqs = _hook_trace()[:3]
    paged = "page_size" in arena
    record, jrecord = [], []
    for e, rec, rs in ((eng, record, reqs), (jeng, jrecord, _as_jax(reqs))):
        def tick():
            e.step()
            rec.append((e.clock, e.load, sorted(
                (s, r.rid) for s, r in e.sched.running.items()),
                e._page_alloc.free_pages if paged else None))
        e.add(rs[0])
        e.add(rs[1])
        tick()
        tick()                               # both admitted, decoding
        (slot,) = [s for s, r in e.sched.running.items() if r.rid == 0]
        assert e.outputs[0].finished < 0 and e.outputs[0].tokens
        rec.append(("cancel", e.cancel(0), slot, e.load))
        e.add(dataclasses.replace(rs[2], arrival=e.clock))
        tick()
        assert e.sched.running.get(slot) is not None and \
            e.sched.running[slot].rid == 2   # the freed slot, reused
        while e.sched.has_work():
            tick()
        if paged:
            e.step()                         # the last slots' pages home
            assert e._page_alloc.free_pages == e._paged.num_pages - 1
    assert record == jrecord
    assert record[2][:2] == ("cancel", True)
    for rid in (1, 2):
        assert eng.outputs[rid].tokens == \
            list(map(int, jeng.outputs[rid].tokens))
        assert eng.outputs[rid].token_steps == jeng.outputs[rid].token_steps
        assert len(eng.outputs[rid].tokens) == reqs[rid].max_new_tokens
    assert eng.sched.finished == [1, 2] and eng.outputs[0].finished < 0
    assert eng.stats == jeng.stats


def test_engine_chunk_cap_same_tokens_more_chunks(reduced_pair):
    api, params, japi, jparams = reduced_pair
    kw = dict(num_slots=2, cache_len=24, decode_chunk=8)
    reqs = _hook_trace()
    free = ServeEngine(api, params, EngineConfig().with_fields(**kw))
    free.run(reqs)
    capped = ServeEngine(api, params, EngineConfig().with_fields(**kw))
    capped.chunk_cap = 2
    capped.run(reqs)
    jcapped = JaxServeEngine(japi, jparams,
                             config=JaxEngineConfig().with_fields(**kw))
    jcapped.chunk_cap = 2
    jcapped.run(_as_jax(reqs))
    for r in reqs:
        assert capped.outputs[r.rid].tokens == free.outputs[r.rid].tokens
        assert capped.outputs[r.rid].tokens == \
            list(map(int, jcapped.outputs[r.rid].tokens))
    assert capped.stats["chunk_calls"] > free.stats["chunk_calls"]
    assert capped.stats == jcapped.stats


def test_engine_set_degraded_mode_round_trip(reduced_pair):
    api, params, japi, jparams = reduced_pair
    conf = dict(num_slots=1, cache_len=24)
    history = []
    for eng in (ServeEngine(api, params, EngineConfig().with_fields(**conf)),
                JaxServeEngine(japi, jparams,
                               config=JaxEngineConfig().with_fields(**conf))):
        eng.b_sparsity = 0.03        # pruned, but under the B threshold
        eng.mode = eng._select_mode()
        eng.mode_history = [(0, eng.mode)]
        assert eng.mode.value == "dense"
        eng.set_degraded(True)
        assert eng.mode.value == "B" and eng.degraded
        eng.set_degraded(True)       # idempotent
        eng.set_degraded(False)
        assert eng.mode.value == "dense"
        history.append([(s, m.value) for s, m in eng.mode_history])
    assert history[0] == history[1] == [(0, "dense"), (0, "B"), (0, "dense")]
    # dense weights stay dense when degraded: 0 > 0 is false
    eng = ServeEngine(api, params, EngineConfig().with_fields(**conf))
    eng.set_degraded(True)
    assert eng.mode == Mode.DENSE and eng.mode_history == [(0, Mode.DENSE)]


def test_request_rows_of_engine_outputs_equal_reference(reduced_pair):
    """The SLO rows and summary of a single engine's outputs (the CLI's
    ``--slo`` without ``--replicas``) equal the reference's."""
    api, params, japi, jparams = reduced_pair
    kw = dict(num_slots=2, cache_len=48, decode_chunk=4)
    reqs = synthetic_trace(api.cfg, **TRACES["fixed-slo"])
    outs = ServeEngine(api, params, EngineConfig().with_fields(**kw)).run(
        reqs)
    jouts = JaxServeEngine(japi, jparams,
                           config=JaxEngineConfig().with_fields(**kw)).run(
        _as_jax(reqs))
    rows = slo.request_rows(outs, reqs)
    assert rows == jax_slo.request_rows(jouts, _as_jax(reqs))
    assert slo.latency_summary(rows) == jax_slo.latency_summary(rows)
    assert all(r["attribution"] == "normal" for r in rows)


# ---------------------------------------------------------------------------
# the overload rows of the reference benchmark
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bench_workload(repo_modules):
    """The reference benchmark's workload (``build_workload``: d=96, 2
    layers, vocab 256, cache_len 137) and its weights bridged."""
    bench, _ = repo_modules
    jcfg, japi, jparams, cache_len, _ = bench.build_workload(48)
    cfg = dataclasses.replace(
        get_config("llama3.2-1b").reduced(), d_model=jcfg.d_model,
        head_dim=jcfg.head_dim, d_ff=jcfg.d_ff, num_layers=jcfg.num_layers,
        vocab_size=jcfg.vocab_size)
    api = build_model(cfg, device="cpu")
    params = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    return cfg, api, params, cache_len, jcfg, japi, jparams


def _overload(bench, cfg, bounded: bool):
    """The reference's ``overload_trace`` arguments, drawn by the port."""
    kw = dict(TRACES["overload-slo"])
    if not bounded:
        for k in ("priorities", "deadline_slack", "ttft_deadline"):
            kw.pop(k)
    assert bench.ROUTER_SLO == dict(deadline_slack=4.0, ttft_deadline=6)
    return synthetic_trace(cfg, **kw)


def _row(router, reqs):
    row = slo.latency_summary(slo.request_rows(router.outputs, reqs))
    row.update(max_queue_depth=router.max_queue_depth, ticks=router.clock,
               ladder_history=[list(t) for t in router.ladder.history]
               if router.ladder else [])
    return {k: row[k] for k in ROW_KEYS}


@pytest.mark.parametrize("row", ["router-bounded", "router-unbounded"])
def test_overload_rows_equal_bench_and_reference(row, bench_workload,
                                                 repo_modules):
    bench, smoke = repo_modules
    cfg, api, params, cache_len, jcfg, japi, jparams = bench_workload
    bounded = row == "router-bounded"
    want = json.loads((ROOT / "benchmarks" / "out" /
                       "BENCH_serve.json").read_text())["router"][row]
    conf = EngineConfig().with_fields(num_slots=bench.SLOTS,
                                      cache_len=cache_len,
                                      decode_chunk=bench.CHUNK)
    router = RouterEngine(
        lambda: ServeEngine(api, params, conf), bench.ROUTER_REPLICAS,
        queue_bound=bench.ROUTER_BOUND if bounded else None,
        degradation=slo.DegradationConfig() if bounded else None)
    reqs = _overload(bench, cfg, bounded)
    router.run(reqs)
    got = _row(router, reqs)
    assert got == {k: want[k] for k in ROW_KEYS}
    # chip_smoke.py gates the full-width cell on the same row
    assert smoke.ROUTER_ROWS[row.replace("-", "_")] == got
    # a live reference router on the same workload: tokens per rid, stats,
    # shed log and SLO rows
    cache = {}
    jrouter = JaxRouterEngine(
        lambda: bench.make_engine(japi, jparams, cache, "continuous",
                                  cache_len, bench.CHUNK, True),
        bench.ROUTER_REPLICAS,
        queue_bound=bench.ROUTER_BOUND if bounded else None,
        degradation=jax_slo.DegradationConfig() if bounded else None)
    jreqs = bench.overload_trace(jcfg, 48, with_slo=bounded)
    jrouter.run(jreqs)
    assert router.stats == jrouter.stats
    assert _shed_log(router.shed_log) == _shed_log(jrouter.shed_log)
    for rid, o in jrouter.outputs.items():
        assert router.outputs[rid].tokens == list(map(int, o.tokens)), rid
        assert router.outputs[rid].token_steps == o.token_steps, rid
    assert slo.request_rows(router.outputs, reqs) == \
        jax_slo.request_rows(jrouter.outputs, jreqs)


def test_overload_rows_hold_from_pruned_weights_through_kernels(
        bench_workload, repo_modules):
    """The chip's overload cells at reduced width: 0.8-pruned, compacted
    weights through the kernel wrappers (Mode B throughout; level 2 of the
    ladder cannot flip it) give both rows unchanged, and every completed
    request equals the batch-1 oracle."""
    bench, smoke = repo_modules
    cfg, api, _, cache_len, _, _, _ = bench_workload
    params = sparsify_params(api.init(api.generator(0)), 0.8, block_k=16,
                             block_n=16, unit=8)
    for name, bounded in (("router_bounded", True),
                          ("router_unbounded", False)):
        cell = smoke.ROUTER_CELLS[name]
        conf = EngineConfig().with_fields(use_kernels=True,
                                          **cell["fields"])
        assert conf.arena.cache_len == cache_len
        router, engines = launch_serve.build_router(api, params, conf)
        reqs = _overload(bench, cfg, bounded)
        assert [dataclasses.astuple(r)[2:] for r in reqs] == [
            dataclasses.astuple(r)[2:] for r in synthetic_trace(
                cfg, num_requests=48, seed=cell["trace"]["trace_seed"],
                **{k: v for k, v in cell["trace"].items()
                   if k not in ("requests", "trace_seed")})]
        router.run(reqs)
        assert _row(router, reqs) == smoke.ROUTER_ROWS[name]
        assert all(e.mode_history == [(0, Mode.B)] for e in engines)
        run = launch_serve.RouteRun(router, engines, reqs, params, 0.0, {},
                                    None)
        assert launch_serve.check_route_parity(run) == \
            router.stats["completed"]


# ---------------------------------------------------------------------------
# chip_smoke.py's replica-kill and hedge cells
# ---------------------------------------------------------------------------

def _small_trace(n: int, vocab: int):
    """The cells' trace, drawn for the full-width vocabulary (as the card
    draws it) and folded into ``vocab``: routing reads lengths only."""
    full = synthetic_trace(get_config("llama3.2-1b"), num_requests=n,
                           seed=11, prompt_lens=(6, 10), gen_lens=(4, 6))
    return [Request(r.rid, np.asarray(r.tokens) % vocab, r.max_new_tokens,
                    r.arrival) for r in full]


def _logged_cancels(monkeypatch, engine_cls):
    """Log every ``cancel`` on ``engine_cls`` as (rid, what it found:
    "running", "waiting" or "none"), as chip_smoke.py's router phase
    does."""
    log, cancel = [], engine_cls.cancel

    def logged(self, rid):
        running = any(r.rid == rid for r in self.sched.running.values())
        hit = cancel(self, rid)
        log.append((rid, "running" if running else
                    "waiting" if hit else "none"))
        return hit

    monkeypatch.setattr(engine_cls, "cancel", logged)
    return log


@pytest.mark.parametrize("name", ["router_kill", "router_hedge"])
def test_small_router_cells_equal_reference(name, repo_modules,
                                            monkeypatch):
    """The cell at reduced width, port against the reference's
    ``RouterEngine`` (its Pallas kernels in interpret mode) on the same
    bridged weights and trace: stats, health log, drained rids, per-rid
    record, the hedge losers' cancels and tokens; then the constants
    chip_smoke.py gates on."""
    _, smoke = repo_modules
    cell = smoke.ROUTER_CELLS[name]
    rc = dict(cell["fields"])
    replicas, inject = rc.pop("replicas"), rc.pop("inject", None)
    hedge_after = rc.pop("hedge_after", None)
    assert rc.pop("shed_policy") == "none"
    kw = dict(rc, use_kernels=True, a_sparsity=cell["a_sparsity"])
    jcfg = jax_get_config("llama3.2-1b").reduced()
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    if cell["sparsity"] > 0:
        jparams = jax_sparsify(jparams, cell["sparsity"], block_k=16,
                               block_n=16, unit=8)
    reqs = _small_trace(cell["trace"]["requests"], jcfg.vocab_size)
    jfaults = []
    if inject:
        jfaults = [jax_fault.parse_fault_spec(inject).build_replica()]
    jcancels = _logged_cancels(monkeypatch, JaxServeEngine)
    cancels = _logged_cancels(monkeypatch, ServeEngine)
    jrouter = JaxRouterEngine(
        lambda: JaxServeEngine(japi, jparams, config=JaxEngineConfig(
        ).with_fields(interpret=True, **kw)),
        replicas, hedge_after=hedge_after, replica_faults=jfaults)
    jrouter.run(_as_jax(reqs))

    api = build_model(get_config("llama3.2-1b").reduced(), device="cpu")
    params = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    conf = EngineConfig().with_fields(use_kernels=True,
                                      a_sparsity=cell["a_sparsity"],
                                      **cell["fields"])
    router, engines = launch_serve.build_router(api, params, conf)
    router.run(reqs)
    assert router.stats == jrouter.stats
    assert router.clock == jrouter.clock
    assert router.health_log == jrouter.health_log
    assert cancels == jcancels
    assert [h.up for h in router.replicas] == \
        [h.up for h in jrouter.replicas]
    fields = ("attribution", "replica", "hedged", "retries", "submit",
              "dispatch", "first_token", "finished", "token_steps")
    for rid, jo in jrouter.outputs.items():
        o = router.outputs[rid]
        assert o.tokens == list(map(int, jo.tokens)), rid
        assert [getattr(o, f) for f in fields] == \
            [getattr(jo, f) for f in fields], rid
    assert [e.mode.value for e in engines] == [cell["mode"]] * len(engines)
    # the constants the card run gates on
    rec = smoke.ROUTER_RECORDS[name]
    got = dict(stats=router.stats, ticks=router.clock,
               health_log=router.health_log,
               served={rid: (o.attribution.value, o.replica)
                       for rid, o in router.outputs.items()})
    if "prefills" in rec:
        got["prefills"] = [e.stats["prefill_calls"] for e in engines]
    got["cancels"] = cancels
    assert got == rec
    run = launch_serve.RouteRun(router, engines, reqs, params, 0.0, {}, None)
    assert launch_serve.check_route_parity(run) == len(reqs)
    for r in reqs:
        assert len(router.outputs[r.rid].tokens) == r.max_new_tokens
    if name == "router_kill":
        assert len(engines) == 3 and router.faults[0].fired_at == 2
        assert [o.attribution for o in router.outputs.values()].count(
            Attribution.RETRIED) == 1
    else:
        # both hedge losers were cancelled mid-decode (a primary and a
        # hedge copy): no engine still owns a hedged rid its replica lost
        assert cancels == [(3, "running"), (4, "running")]
        assert [router.outputs[rid].replica for rid in (3, 4)] == [2, 1]
        for h in router.replicas:
            for o in router.outputs.values():
                if o.hedged:
                    assert h.engine.outputs.get(o.rid) is None or \
                        o.replica == h.index


# ---------------------------------------------------------------------------
# fault specs, config, CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "replica:1@2:decode:3", "replica:0@0", "replica:2@5:idle",
    "replica:1@1:any:1", "kill:-1@3", "kill:0@2:prefill", "delay:1@4",
    "delay:0@1:3.5"])
def test_fault_spec_parses_as_reference(spec):
    got = fault.parse_fault_spec(spec)
    want = jax_fault.parse_fault_spec(spec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if got.kind == "replica":
        assert dataclasses.asdict(got.build_replica()) == \
            dataclasses.asdict(want.build_replica())
    else:
        devs = [argparse.Namespace(id=i) for i in (4, 5, 6)]
        assert dataclasses.asdict(got.build(devs)) == \
            dataclasses.asdict(want.build(devs))
        with pytest.raises(ValueError):
            got.build_replica()


@pytest.mark.parametrize("spec", [
    "replica:1", "replica:x@1", "replica:1@-1", "replica:1@2:busy",
    "replica:1@2:any:0", "kill:0@1:later", "delay:0@1:0.5", "boom:1@1"])
def test_bad_fault_specs_raise_as_reference(spec):
    with pytest.raises(ValueError):
        jax_fault.parse_fault_spec(spec)
    with pytest.raises(ValueError):
        fault.parse_fault_spec(spec)


def test_replica_fault_fires_once_as_reference():
    got, want = fault.ReplicaFault(1, at_step=2, during="decode"), \
        jax_fault.ReplicaFault(1, at_step=2, during="decode")
    polls = [(1, "decode", 1), (0, "decode", 2), (1, "idle", 2),
             (1, "decode", 3), (1, "decode", 4)]
    assert [got.poll(*p) for p in polls] == [want.poll(*p) for p in polls] \
        == [False, False, False, True, False]
    assert got.fired_at == want.fired_at == 3


def test_router_config_served_and_round_trips():
    raw = ('{"router": {"replicas": 2, "queue_bound": 6, "hedge_after": 1, '
           '"shed_policy": "degrade"}, '
           '"fault": {"inject": "replica:1@2:decode:3"}}')
    conf = EngineConfig.from_json(raw)
    assert (conf.router.replicas, conf.router.queue_bound,
            conf.router.hedge_after, conf.router.shed_policy) == \
        (2, 6, 1, "degrade")
    assert EngineConfig.from_json(conf.to_json()) == conf
    # the reference reads the port's JSON and the port the reference's
    jconf = JaxEngineConfig.from_json(raw)
    assert JaxEngineConfig.from_json(conf.to_json()) == jconf
    assert EngineConfig.from_json(jconf.to_json()) == conf
    assert dataclasses.asdict(conf.router) == dataclasses.asdict(jconf.router)


@pytest.mark.parametrize("raw", [
    '{"fault": {"inject": "kill:0@3"}}', '{"fault": {"inject": "delay:0@1"}}',
    '{"fault": {"snapshot_dir": "s"}}',
    '{"fault": {"inject": "replica:0@1", "recovery_model_parallel": 2}}'])
def test_engine_level_fault_config_raises(raw):
    """Engine-level fault specs, the snapshot directory and the post-loss
    mesh (``recovery_model_parallel``, served since remeshing, ROADMAP
    1.15b) load and equal the reference's, both ways through JSON."""
    conf, jconf = EngineConfig.from_json(raw), JaxEngineConfig.from_json(raw)
    assert dataclasses.asdict(conf.fault) == dataclasses.asdict(jconf.fault)
    assert EngineConfig.from_json(jconf.to_json()) == conf
    assert JaxEngineConfig.from_json(conf.to_json()) == jconf


def test_from_args_router_flags_equal_reference():
    defaults = dict(config=None, replicas=0, queue_bound=0, hedge_ms=0,
                    shed_policy="shed", inject_fault=None)
    args = argparse.Namespace(**dict(
        defaults, replicas=3, queue_bound=0, hedge_ms=2,
        shed_policy="degrade", inject_fault="replica:2@4:any:2"))
    got = EngineConfig.from_args(args, defaults=defaults)
    want = JaxEngineConfig.from_args(args, defaults=defaults)
    assert dataclasses.asdict(got.router) == dataclasses.asdict(want.router)
    assert got.router == dataclasses.replace(
        got.router, replicas=3, queue_bound=None, hedge_after=2,
        shed_policy="degrade")
    assert got.fault.inject == want.fault.inject == "replica:2@4:any:2"


def test_route_cli_overload_smoke_on_cpu(capsys):
    """The reference CI's overload stage (``scripts/ci.sh``), on the host:
    bounded queue of 4, the degradation ladder, bursty heavy-tailed SLO
    traffic.  The stats, depth and ladder are what the reference's CLI
    prints for the same flags (routing reads no token)."""
    launch_serve.main([
        "--reduced", "--device", "cpu", "--use-kernels", "--replicas", "2",
        "--queue-bound", "4", "--arrival-process", "bursty", "--rate", "1",
        "--burst-rate", "8", "--length-dist", "heavy", "--priorities", "0,1",
        "--requests", "24", "--slo", "ttft=16,slack=2", "--shed-policy",
        "degrade", "--overload-smoke", "--parity"])
    out = capsys.readouterr().out
    assert ("stats {'submitted': 24, 'dispatches': 19, 'completed': 19, "
            "'shed': 5, 'retried': 0, 'hedged': 0}, max queue depth 4, "
            "ladder history [(3, 1), (5, 0), (9, 1), (13, 0)]") in out
    assert "overload smoke OK: depth 4 <= 4, shed 5" in out
    assert "SLO summary: 19/24 completed, 5 shed, ttft p50/p99 1/2" in out
    assert "parity OK: 19 completed requests" in out


def test_route_cli_replica_fault_and_single_engine_slo(capsys):
    launch_serve.main([
        "--reduced", "--device", "cpu", "--use-kernels", "--replicas", "2",
        "--slots", "2", "--decode-chunk", "2", "--requests", "6",
        "--prompt-lens", "6,10", "--gen-lens", "4,6", "--shed-policy",
        "none", "--inject-fault", "replica:1@2:decode:3", "--parity"])
    out = capsys.readouterr().out
    assert "replica fault log: [{'tick': 2, 'event': 'kill'" in out
    assert "'event': 'rejoin'" in out
    assert "3 engines built" in out and "parity OK: 6 completed" in out
    launch_serve.main(["--reduced", "--device", "cpu", "--requests", "4",
                       "--slo", "ttft=3"])
    out = capsys.readouterr().out
    assert "SLO summary: 4/4 completed, 0 shed" in out
    launch_serve.main(["--reduced", "--device", "cpu", "--inject-fault",
                       "kill:0@1", "--parity"])
    out = capsys.readouterr().out
    assert "fault injected (kill:0@1): 1 recoveries" in out
    assert "parity OK: all 8 requests" in out
