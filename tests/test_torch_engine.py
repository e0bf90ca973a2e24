"""The port's serving engine (repro_torch.runtime) against the JAX package's
ServeEngine on one synthetic trace: reduced llama3.2-1b in fp32, weights
block-pruned and compacted (16/16, unit 8), every GEMM through the kernel
wrappers.  Tokens and the deterministic ``stats`` counters must be equal,
and every request must match the port's own batch-1 greedy oracle."""
import argparse
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.runtime.config import EngineConfig as JaxEngineConfig
from repro.runtime.engine import ServeEngine as JaxServeEngine
from repro.runtime.engine import synthetic_trace as jax_synthetic_trace
from repro.sparsity import sparsify_params as jax_sparsify
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.spec import Mode
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models.common import (kernel_dispatch_counts,
                                       reset_kernel_dispatch)
from repro_torch.runtime.config import EngineConfig
from repro_torch.runtime.engine import (MIN_BUCKET, Request, Scheduler,
                                        ServeEngine, synthetic_trace)
from repro_torch.runtime.serve import (greedy_generate, make_chunk_ladder,
                                       pad_prompt_batch)

STATS = ("emitted", "decode_steps", "chunk_calls", "prefill_calls",
         "host_syncs", "idle_steps")
TRACE = dict(num_requests=7, seed=11, prompt_lens=(6, 10, 17),
             gen_lens=(2, 4, 7), arrival_every=1)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Eager torch ops at these sizes gain nothing from threads, and with
    pytest-xdist's parallel workers OpenMP's pools oversubscribe the cores
    (a test of seconds then takes minutes): one thread for the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=[(3, 4, None), (2, 8, None),
                                        (3, 4, 4)],
                ids=["slots3-chunk4", "slots2-chunk8", "slots3-chunk4-paged"])
def served(request):
    """Both engines on the same weights and trace; the third pair serves
    from paged arenas of 4-token pages."""
    slots, chunk, page_size = request.param
    cfg = jax_get_config("llama3.2-1b").reduced()
    japi = jax_build_model(cfg)
    jparams = jax_sparsify(japi.init(jax.random.PRNGKey(0)), 0.6,
                           block_k=16, block_n=16, unit=8)
    jconf = JaxEngineConfig().with_fields(
        num_slots=slots, cache_len=32, decode_chunk=chunk, use_kernels=True,
        interpret=True, page_size=page_size)
    jeng = JaxServeEngine(japi, jparams, config=jconf)
    jouts = jeng.run(jax_synthetic_trace(cfg, **TRACE))

    tcfg = get_config("llama3.2-1b").reduced()
    tapi = build_model(tcfg, device="cpu")
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    tconf = EngineConfig().with_fields(num_slots=slots, cache_len=32,
                                       decode_chunk=chunk, use_kernels=True,
                                       page_size=page_size)
    reqs = synthetic_trace(tcfg, **TRACE)
    teng = ServeEngine(tapi, tparams, tconf)
    reset_kernel_dispatch()
    touts = teng.run(reqs)
    dispatch = kernel_dispatch_counts()
    return jeng, jouts, teng, touts, reqs, tparams, dispatch


@pytest.fixture(scope="module", params=["dense", "compacted"],
                ids=["mode-a", "mode-ab"])
def served_sparse_a(request):
    """Both engines with a declared activation sparsity of 0.5: on dense
    weights (Mode.A: every GEMM through sparse_a) and on compacted weights
    (Mode.AB: dual griffin_spmm, the unembedding through sparse_a)."""
    cfg = jax_get_config("llama3.2-1b").reduced()
    japi = jax_build_model(cfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    if request.param == "compacted":
        jparams = jax_sparsify(jparams, 0.6, block_k=16, block_n=16, unit=8)
    kw = dict(num_slots=3, cache_len=32, decode_chunk=4, use_kernels=True,
              a_sparsity=0.5)
    jeng = JaxServeEngine(japi, jparams, config=JaxEngineConfig().with_fields(
        interpret=True, **kw))
    jouts = jeng.run(jax_synthetic_trace(cfg, **TRACE))
    tcfg = get_config("llama3.2-1b").reduced()
    tapi = build_model(tcfg, device="cpu")
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    teng = ServeEngine(tapi, tparams, EngineConfig().with_fields(**kw))
    reqs = synthetic_trace(tcfg, **TRACE)
    reset_kernel_dispatch()
    touts = teng.run(reqs)
    return jeng, jouts, teng, touts, reqs, tparams, kernel_dispatch_counts()


def test_activation_sparse_engine_equals_reference(served_sparse_a):
    jeng, jouts, teng, touts, reqs, _, _ = served_sparse_a
    for r in reqs:
        assert touts[r.rid].tokens == jouts[r.rid].tokens, r.rid
        assert touts[r.rid].token_steps == jouts[r.rid].token_steps, r.rid
    for key in STATS:
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.mode.value == jeng.mode.value
    assert [(s, m.value) for s, m in teng.mode_history] == \
        [(s, m.value) for s, m in jeng.mode_history]


def test_activation_sparse_engine_matches_own_oracle(served_sparse_a):
    _, _, teng, touts, reqs, tparams, dispatch = served_sparse_a
    calls = teng.stats["prefill_calls"] + teng.stats["decode_steps"]
    want = {"kernel": 15 * calls}
    if teng.mode == Mode.AB:
        want["dual"] = 14 * calls
    else:
        assert teng.mode == Mode.A
    assert dispatch == want
    for r in reqs:
        with teng._scope():
            ref = greedy_generate(teng.api, tparams, r.as_batch(teng.device),
                                  steps=r.max_new_tokens,
                                  cache_len=teng.cache_len,
                                  prompt_bucket=teng.bucket_for(r.prompt_len))
        assert touts[r.rid].tokens == ref[0].tolist(), r.rid


def test_trace_equals_reference():
    cfg = jax_get_config("llama3.2-1b").reduced()
    want = jax_synthetic_trace(cfg, **TRACE)
    got = synthetic_trace(get_config("llama3.2-1b").reduced(), **TRACE)
    assert [(r.rid, r.max_new_tokens, r.arrival, list(r.tokens))
            for r in want] == [(r.rid, r.max_new_tokens, r.arrival,
                                list(r.tokens)) for r in got]


def test_engine_tokens_equal_reference(served):
    jeng, jouts, teng, touts, reqs, _, _ = served
    assert sorted(jouts) == sorted(touts) == [r.rid for r in reqs]
    for r in reqs:
        assert touts[r.rid].tokens == jouts[r.rid].tokens, r.rid
        assert touts[r.rid].token_steps == jouts[r.rid].token_steps, r.rid
        assert (touts[r.rid].admitted, touts[r.rid].finished) == \
            (jouts[r.rid].admitted, jouts[r.rid].finished)


def test_engine_stats_equal_reference(served):
    jeng, _, teng, _, _, _, _ = served
    for key in STATS:
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.prefill_buckets == jeng.prefill_buckets
    assert teng.mode == jeng.mode == Mode.B
    assert [(s, m.value) for s, m in teng.mode_history] == \
        [(s, m.value) for s, m in jeng.mode_history]
    assert teng.b_sparsity == pytest.approx(jeng.b_sparsity)


def test_engine_matches_own_greedy_oracle(served):
    _, _, teng, touts, reqs, tparams, _ = served
    for r in reqs:
        with teng._scope():
            ref = greedy_generate(teng.api, tparams, r.as_batch(teng.device),
                                  steps=r.max_new_tokens,
                                  cache_len=teng.cache_len,
                                  prompt_bucket=teng.bucket_for(r.prompt_len))
        assert touts[r.rid].tokens == ref[0].tolist(), r.rid


def test_engine_gemms_all_went_through_kernel_wrappers(served):
    _, _, teng, _, _, _, dispatch = served
    calls = teng.stats["prefill_calls"] + teng.stats["decode_steps"]
    # per call: 7 compacted GEMMs x 2 layers + the dense unembedding
    assert dispatch == {"kernel": 15 * calls}


def test_launch_serve_cli_on_cpu(capsys):
    launch_serve.main(["--reduced", "--device", "cpu", "--use-kernels",
                       "--requests", "5", "--decode-chunk", "4",
                       "--arrival-every", "2", "--parity",
                       "--max-syncs-per-token", "0.5"])
    out = capsys.readouterr().out
    assert "parity OK: all 5 requests" in out and "mode B" in out


def test_launch_serve_cli_paged_on_cpu(capsys):
    launch_serve.main(["--reduced", "--device", "cpu", "--page-size", "4",
                       "--num-pages", "40", "--slots", "6",
                       "--length-dist", "heavy", "--parity"])
    out = capsys.readouterr().out
    # heavy lengths: 32 + 2 * 16 + 1 = 65, rounded up to a page multiple
    assert "cache_len 68 (paged, 40 pages of 4)" in out
    assert "parity OK: all 8 requests" in out
    # int8 pages serve, and the oracle parity is skipped for them as in
    # the reference (they are gated by a logit tolerance)
    launch_serve.main(["--reduced", "--device", "cpu", "--page-size", "4",
                       "--kv-dtype", "int8", "--parity"])
    out = capsys.readouterr().out
    assert "(paged, 53 pages of 4), int8 pages" in out
    assert "parity SKIPPED: int8 KV pages" in out


@pytest.mark.parametrize("dist", ["choice", "heavy"])
def test_heavy_trace_and_cache_bound_equal_reference(dist):
    kw = dict(num_requests=12, seed=3, prompt_lens=(5, 9), gen_lens=(3, 6),
              length_dist=dist, max_gen=12 if dist == "heavy" else None)
    cfg = jax_get_config("llama3.2-1b").reduced()
    want = jax_synthetic_trace(cfg, **kw)
    got = synthetic_trace(get_config("llama3.2-1b").reduced(), **kw)
    assert [(r.max_new_tokens, list(r.tokens)) for r in want] == \
        [(r.max_new_tokens, list(r.tokens)) for r in got]
    assert EngineConfig.derive_cache_len((5, 9), (3, 6), dist) == \
        JaxEngineConfig.derive_cache_len((5, 9), (3, 6), dist)
    assert EngineConfig.heavy_gen_cap((3, 6)) == \
        JaxEngineConfig.heavy_gen_cap((3, 6))
    with pytest.raises(ValueError):
        synthetic_trace(cfg, num_requests=1, length_dist="zipf")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default is valid here")
    cfg = get_config("llama3.2-1b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.serve(reduced=True)
    # the mesh launchers raise before any rank is spawned
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.run_ranks(tmesh.check_ranks, tmesh.serve_mesh("1x2"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.mesh_cells_on("2x1", [dict(reduced=True)])


# ---------------------------------------------------------------------------
# host-side machinery
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", [dict(mesh="2x2",
                                        recovery_model_parallel=2),
                                   dict(recovery_model_parallel=2)])
def test_unported_config_fields_raise(field):
    """The post-loss mesh's TP degree is served since remeshing (ROADMAP
    1.15b), on a mesh or not, and equals the reference's field; the mesh
    itself is served since 1.15's serving half, and ``snapshot_dir`` since
    1.13."""
    conf = EngineConfig().with_fields(**field)
    assert conf.fault.recovery_model_parallel == 2
    assert dataclasses.asdict(conf.fault) == dataclasses.asdict(
        JaxEngineConfig().with_fields(**field).fault)
    assert EngineConfig.from_json(conf.to_json()) == conf
    assert EngineConfig().with_fields(snapshot_dir="x").fault.snapshot_dir \
        == "x"
    assert EngineConfig().with_fields(mesh="2x2").mesh == "2x2"


@pytest.mark.parametrize("field", [dict(page_size=16, kv_dtype="int8"),
                                   dict(kv_dtype="int8"),
                                   dict(fused=False),
                                   dict(policy="static", fused=False,
                                        decode_chunk=1)])
def test_int8_and_stepwise_config_fields_round_trip(field):
    """int8 pages and the stepwise path, unported before, build and
    round-trip through JSON; the reference's file of the same fields
    loads equal."""
    conf = EngineConfig().with_fields(**field)
    assert EngineConfig.from_json(conf.to_json()) == conf
    ref = JaxEngineConfig().with_fields(**field)
    assert EngineConfig.from_json(ref.to_json()) == conf


def test_engine_config_json_round_trip_and_reference_file():
    conf = EngineConfig().with_fields(num_slots=3, decode_chunk=2,
                                      use_kernels=True, a_sparsity=0.5,
                                      block_m=64, cache_len=40)
    assert EngineConfig.from_json(conf.to_json()) == conf
    # a file written by the reference loads when it sets only what the
    # port serves; its unported kernel fields sit at their defaults
    ref = JaxEngineConfig().with_fields(num_slots=3, decode_chunk=2,
                                        use_kernels=True, a_sparsity=0.5,
                                        block_m=64, cache_len=40)
    assert EngineConfig.from_json(ref.to_json()) == conf


@pytest.mark.parametrize("raw", [
    '{"kernels": {"interpret": true}}',
    '{"fault": {"recovery_model_parallel": 1}}',
    '{"fault": {"recovery_model_parallel": 2}}'])
def test_engine_config_json_unported_fields_raise(raw):
    """The reference's kernel field ``interpret`` has no counterpart and
    raises; ``recovery_model_parallel`` is served since remeshing and
    loads as the reference's file does."""
    if "interpret" in raw:
        with pytest.raises(NotImplementedError):
            EngineConfig.from_json(raw)
        return
    conf = EngineConfig.from_json(raw)
    assert dataclasses.asdict(conf.fault) == dataclasses.asdict(
        JaxEngineConfig.from_json(raw).fault)


@pytest.mark.parametrize("raw,want", [
    ('{"arena": {"kv_dtype": "int8", "page_size": 16}}',
     dict(kv_dtype="int8", page_size=16)),
    ('{"sched": {"fused": false, "policy": "static"}}',
     dict(fused=False, policy="static")),
    ('{"router": {"replicas": 2, "queue_bound": 6, "shed_policy": "none"}}',
     dict(replicas=2, queue_bound=6, shed_policy="none"))])
def test_engine_config_json_serves_int8_and_stepwise(raw, want):
    conf = EngineConfig.from_json(raw)
    assert conf == EngineConfig().with_fields(**want)
    assert EngineConfig.from_json(conf.to_json()) == conf


@pytest.mark.parametrize("raw", ['[]', '{"kernels": {"bogus": 1}}',
                                 '{"nope": {}}'])
def test_engine_config_json_rejects_unknown(raw):
    with pytest.raises(ValueError):
        EngineConfig.from_json(raw)


def test_engine_config_from_args_flag_beats_file(tmp_path):
    path = tmp_path / "engine.json"
    path.write_text(EngineConfig().with_fields(
        decode_chunk=2, num_slots=5, a_sparsity=0.5).to_json())
    defaults = dict(config=None, slots=4, decode_chunk=8, use_kernels=False,
                    page_size=None, num_pages=None, kv_dtype="fp32",
                    policy="continuous")
    args = argparse.Namespace(config=str(path), slots=4, decode_chunk=4,
                              use_kernels=False, page_size=8, num_pages=None,
                              kv_dtype="int8", policy="static")
    conf = EngineConfig.from_args(args, defaults)
    # --decode-chunk 4, --page-size 8, --kv-dtype int8 and --policy static
    # were given; --slots left at its default keeps 5
    assert (conf.sched.decode_chunk, conf.arena.num_slots,
            conf.kernels.a_sparsity, conf.arena.page_size) == (4, 5, 0.5, 8)
    assert (conf.arena.kv_dtype, conf.sched.policy) == ("int8", "static")
    # --snapshot-dir (ROADMAP 1.13) and the post-loss mesh's
    # --remesh-model-parallel (1.15b) land in the config, as in the
    # reference
    args.snapshot_dir = "s"
    args.remesh_model_parallel = 2
    conf = EngineConfig.from_args(args, defaults)
    assert conf.fault.snapshot_dir == "s"
    assert conf.fault.recovery_model_parallel == 2
    assert dataclasses.asdict(conf.fault) == dataclasses.asdict(
        JaxEngineConfig.from_args(args, defaults).fault)


def test_launch_serve_cli_config_selects_sparse_a_on_cpu(tmp_path, capsys):
    path = tmp_path / "engine.json"
    path.write_text(EngineConfig().with_fields(
        use_kernels=True, a_sparsity=0.5, decode_chunk=2).to_json())
    launch_serve.main(["--reduced", "--device", "cpu", "--sparsity", "0",
                       "--config", str(path), "--requests", "4",
                       "--decode-chunk", "4", "--parity"])
    out = capsys.readouterr().out
    assert "declared activation sparsity 0.5 -> mode A" in out
    assert "parity OK: all 4 requests" in out


def test_scheduler_fcfs_and_static_policy():
    s = Scheduler(2, "static")
    for i in range(3):
        s.add(Request(rid=i, tokens=np.ones(4, np.int32), max_new_tokens=1,
                      arrival=0))
    assert [(slot, r.rid) for slot, r in s.admissions(0)] == [(0, 0), (1, 1)]
    assert s.admissions(1) == []          # static: pool must drain first
    assert s.emit(0) and s.emit(1)
    assert [r.rid for _, r in s.admissions(2)] == [2]
    assert s.finished == [0, 1]
    with pytest.raises(ValueError):
        Scheduler(0)


def test_bucket_for_and_chunk_ladder():
    api = build_model(get_config("llama3.2-1b").reduced(), device="cpu")
    params = api.init(api.generator(0))
    eng = ServeEngine(api, params, EngineConfig().with_fields(
        num_slots=1, cache_len=40, decode_chunk=4))
    assert eng.bucket_for(1) == MIN_BUCKET
    assert (eng.bucket_for(9), eng.bucket_for(17)) == (16, 32)
    assert eng.bucket_for(33) is None
    ladder = make_chunk_ladder(api, 4)
    assert ladder(2) is ladder(2)
    for bad in (0, 5):
        with pytest.raises(ValueError):
            ladder(bad)
    with pytest.raises(ValueError):
        eng.add(Request(rid=0, tokens=np.ones(30, np.int32),
                        max_new_tokens=11))
    padded = pad_prompt_batch({"tokens": torch.ones((1, 5),
                                                    dtype=torch.int64)}, 8)
    assert padded["tokens"].shape == (1, 8) and padded["lengths"].tolist() \
        == [5]


def test_dense_engine_uses_plain_dots_and_matches_oracle():
    api = build_model(get_config("llama3.2-1b").reduced(), device="cpu")
    params = api.init(api.generator(1))
    eng = ServeEngine(api, params, EngineConfig().with_fields(
        num_slots=2, cache_len=24, decode_chunk=4))
    reqs = synthetic_trace(api.cfg, num_requests=3, seed=2,
                           prompt_lens=(5, 9), gen_lens=(3, 5))
    reset_kernel_dispatch()
    outs = eng.run(reqs)
    assert kernel_dispatch_counts().get("kernel", 0) == 0
    assert eng.mode == Mode.DENSE
    for r in reqs:
        ref = greedy_generate(api, params, r.as_batch(eng.device),
                              steps=r.max_new_tokens, cache_len=24,
                              prompt_bucket=eng.bucket_for(r.prompt_len))
        assert outs[r.rid].tokens == ref[0].tolist()
