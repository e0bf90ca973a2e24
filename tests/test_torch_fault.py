"""The port's engine-level fault tolerance (``repro_torch.runtime.fault``,
``straggler``, ``checkpoint``, the engine's snapshots, rollback and
replay, ``launch/serve.py --inject-fault``) against the JAX package's, on
the reference's reduced llama3.2-1b with its own weights bridged:

* ``FaultInjector``, ``FaultSpec.build`` and ``StragglerDetector`` fed the
  same sequences as the reference's give the same answers;
* ``Scheduler`` and ``PageAllocator`` state dicts JSON-equal to the
  reference's after the same calls, and each loads the other's;
* checkpoints: compacted ``GriffinWeights`` plus a promoted arena round
  trip leaf-exact in fp32 and bf16, and the files' layout (keys, shapes,
  dtypes, arrays) equals the reference's, which the port restores;
* a kill at each phase on the fixed, stepwise, paged fp32, paged int8 and
  disk-snapshot engines: tokens equal the reference's uninterrupted run
  (int8: the port's unfaulted int8 run), ``recovery_log`` the reference's
  faulted engine's; a Mode.AB kill through the kernel wrappers; after
  every tick the faulted engine's whole state equals an unfaulted one's;
* an unarmed engine captures nothing (host syncs per token as in
  PERF.md §5), and ``chip_smoke.py``'s fault cells fire where the card
  run expects, replaying the calls it expects;
* the (step, phase) pairs at which the reference's engine fires are the
  port's, with equal tokens.
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

from repro.checkpoint import read_manifest as jax_read_manifest
from repro.checkpoint import save as jax_save
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.runtime import fault as jax_fault
from repro.runtime import straggler as jax_straggler
from repro.runtime.config import EngineConfig as JaxEngineConfig
from repro.runtime.engine import Request as JaxRequest
from repro.runtime.engine import Scheduler as JaxScheduler
from repro.runtime.engine import ServeEngine as JaxServeEngine
from repro.runtime.engine import _promote_arena as jax_promote_arena
from repro.runtime.engine import synthetic_trace as jax_synthetic_trace
from repro.runtime.paging import PageAllocator as JaxPageAllocator
from repro.sparsity import sparsify_params as jax_sparsify
from repro_torch import bridge
from repro_torch.checkpoint import latest_step, read_manifest, restore, save
from repro_torch.checkpoint.checkpoint import keyed_leaves
from repro_torch.configs import get_config
from repro_torch.kernels import GriffinWeights
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models.common import (kernel_dispatch_counts,
                                       reset_kernel_dispatch)
from repro_torch.runtime import engine as engine_mod
from repro_torch.runtime import fault, straggler
from repro_torch.runtime.config import EngineConfig
from repro_torch.runtime.engine import (Request, Scheduler, ServeEngine,
                                        synthetic_trace)
from repro_torch.runtime.paging import PageAllocator
from repro_torch.sparsity import PRUNE, init_sparse_params

ROOT = pathlib.Path(__file__).resolve().parent.parent
PHASES = ("admission", "prefill", "decode")
# the reference's fault tests: 3 slots, cache 24, chunk 4, 5 requests
ENGINE = dict(num_slots=3, cache_len=24, decode_chunk=4)
TRACE = dict(num_requests=5, seed=11, prompt_lens=(6, 10), gen_lens=(2, 4),
             arrival_every=1)
# engine kind -> its fields beyond ENGINE ("disk" adds a snapshot_dir)
ENGINES = {"fixed": {}, "stepwise": dict(fused=False, decode_chunk=1),
           "paged": dict(page_size=4),
           "paged_int8": dict(page_size=4, kv_dtype="int8"),
           "disk": dict(page_size=4)}


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
def small():
    """The reference's reduced model and weights, and the port's with the
    same weights bridged."""
    cfg = jax_get_config("llama3.2-1b").reduced()
    japi = jax_build_model(cfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    tapi = build_model(get_config("llama3.2-1b").reduced(), device="cpu")
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    return japi, jparams, tapi, tparams


@pytest.fixture(scope="module")
def reference(small):
    """The reference engine's uninterrupted tokens on the trace."""
    japi, jparams, _, _ = small
    eng = JaxServeEngine(japi, jparams,
                         config=JaxEngineConfig().with_fields(**ENGINE))
    return _tokens(eng.run(jax_synthetic_trace(japi.cfg, **TRACE)))


@pytest.fixture(scope="module")
def reference_polls(small):
    """Every (phase, clock) at which the reference's engine polls its
    injector on the trace: a kill at (step, phase) fires iff some poll of
    that phase comes at a clock >= step (the run is the unfaulted one up
    to the first firing poll)."""
    japi, jparams, _, _ = small

    class Recorder(jax_fault.FaultInjector):
        def poll(self, phase, clock):
            seen.append((phase, clock))

    seen = []
    eng = JaxServeEngine(japi, jparams,
                         config=JaxEngineConfig().with_fields(**ENGINE),
                         fault_injector=Recorder())
    eng.run(jax_synthetic_trace(japi.cfg, **TRACE))
    return seen


def _tokens(outs):
    return {r: list(map(int, o.tokens)) for r, o in outs.items()}


def _trace(api):
    return synthetic_trace(api.cfg, **TRACE)


def _conf(kind: str, tmp_path=None) -> EngineConfig:
    conf = EngineConfig().with_fields(**ENGINE).with_fields(**ENGINES[kind])
    if kind == "disk":
        conf = conf.with_fields(snapshot_dir=str(tmp_path / "port"))
    return conf


def _kill(phase: str, at_step: int = 2) -> fault.FaultInjector:
    return fault.FaultInjector(kill_devices=(0,), at_step=at_step,
                               phase=phase)


# ---------------------------------------------------------------------------
# injector, spec, straggler
# ---------------------------------------------------------------------------

POLLS = [("admission", 5), ("decode", 1), ("prefill", 2), ("decode", 4),
         ("decode", 5), ("prefill", 7), ("admission", 9)]


def _polled(inj):
    out = []
    for phase, clock in POLLS:
        try:
            inj.poll(phase, clock)
            out.append(None)
        except (fault.DeviceLoss, jax_fault.DeviceLoss) as e:
            out.append((type(e).__name__, e.lost, str(e)))
    return out, inj.fired_at, inj.fired


@pytest.mark.parametrize("kw", [
    dict(kill_devices=(3, 1, 3), at_step=2, phase="decode"),
    dict(kill_devices=(0,), at_step=0, phase="admission"),
    dict(kill_devices=(2,), at_step=6, phase="prefill"),
    dict(delay_host=1, at_step=3, delay_factor=12.0)])
def test_injector_polls_and_delays_as_reference(kw):
    got, want = fault.FaultInjector(**kw), jax_fault.FaultInjector(**kw)
    assert _polled(got) == _polled(want)
    assert [got.host_delay(h, c) for h in range(3) for c in range(6)] == \
        [want.host_delay(h, c) for h in range(3) for c in range(6)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("kw", [dict(phase="epilogue"), dict(at_step=-1)])
def test_injector_validation_as_reference(kw):
    for cls in (fault.FaultInjector, jax_fault.FaultInjector):
        with pytest.raises(ValueError):
            cls(kill_devices=(0,), **kw)


@dataclasses.dataclass
class _Dev:
    id: int


@pytest.mark.parametrize("spec", ["kill:-1@3:prefill", "kill:0@2",
                                  "kill:1@0:admission", "delay:1@2:9",
                                  "delay:0@4"])
def test_fault_spec_build_as_reference(spec):
    devs = [_Dev(10), _Dev(11), _Dev(12)]
    got = fault.parse_fault_spec(spec).build(devs)
    want = jax_fault.parse_fault_spec(spec).build(devs)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_fault_spec_build_reads_torch_device_indices():
    cards = [torch.device("cuda", i) for i in range(4)]
    assert fault.parse_fault_spec("kill:-1@1").build(cards).kill_devices \
        == (3,)
    assert fault.parse_fault_spec("kill:0@1").build(
        [torch.device("cpu")]).kill_devices == (0,)
    with pytest.raises(IndexError):
        fault.parse_fault_spec("kill:2@1").build([torch.device("cpu")])


@pytest.mark.parametrize("hosts,cfg,slow", [
    (4, dict(threshold=1.5, evict_after=3), 2),
    (2, dict(threshold=1.5, evict_after=4), 1),
    (5, dict(ema=0.5, threshold=1.2, evict_after=2), 0),
    (1, dict(evict_after=1), 0)])
def test_straggler_sequences_as_reference(hosts, cfg, slow):
    """Seeded step times (host ``slow`` 3x slower for 12 steps, then back
    to par), queried several times per step: every verdict, streak and
    EMA as the reference's.  One host is its own median: never flagged."""
    got = straggler.StragglerDetector(hosts,
                                      straggler.StragglerConfig(**cfg))
    want = jax_straggler.StragglerDetector(
        hosts, jax_straggler.StragglerConfig(**cfg))
    rng = np.random.default_rng(hosts)
    for step in range(30):
        for h in range(hosts):
            t = float(rng.uniform(0.9, 1.1)) * (3.0 if h == slow
                                                and step < 12 else 1.0)
            got.record(h, t)
            want.record(h, t)
        for _ in range(step % 3):
            assert got.stragglers() == want.stragglers()
            assert got.evictions() == want.evictions()
        assert got.observe() == want.observe()
        assert got.evictions() == want.evictions()
        np.testing.assert_array_equal(got.flagged_streak,
                                      want.flagged_streak)
        np.testing.assert_array_equal(got.ema, want.ema)
    if hosts == 1:
        assert got.flagged_streak.tolist() == [0]
    for shards, healthy in ((7, [0, 2, 3]), (2, [5])):
        assert straggler.reassign_shards(shards, healthy) == \
            jax_straggler.reassign_shards(shards, healthy)
    for mod in (straggler, jax_straggler):
        with pytest.raises(ValueError):
            mod.StragglerDetector(0)


# ---------------------------------------------------------------------------
# scheduler and allocator state
# ---------------------------------------------------------------------------

def _json(d):
    return json.loads(json.dumps(d))


@pytest.mark.parametrize("policy,budget", [("continuous", 2),
                                           ("continuous", 1),
                                           ("static", 1)])
def test_scheduler_state_dict_as_reference(policy, budget):
    """The same calls on both schedulers give JSON-equal state dicts at
    every point; the port rebuilds the reference's, and the rebuilt
    scheduler then admits exactly as the original does."""
    got = Scheduler(3, policy, budget)
    want = JaxScheduler(3, policy, budget)
    for rid in range(7):
        kw = dict(rid=rid, tokens=np.arange(4 + rid, dtype=np.int32),
                  max_new_tokens=2 + rid % 3, arrival=rid // 2,
                  priority=rid % 2, deadline_ms=(9 if rid == 3 else None))
        got.add(Request(**kw))
        want.add(JaxRequest(**kw))
    assert _json(got.state_dict()) == _json(want.state_dict())

    def both(op):
        a, b = op(got), op(want)
        assert _json(got.state_dict()) == _json(want.state_dict())
        return a, b

    for step in range(4):
        a, b = both(lambda s: [(sl, r.rid) for sl, r in
                               s.admissions(step)])
        assert a == b
        if got.active:
            both(lambda s: s.emit(s.active[0]))
        if step == 1:
            both(lambda s: s.remove_waiting(6))
        if step == 2 and got.active:
            both(lambda s: s.cancel_slot(s.active[-1]).rid)
    clone = Scheduler.from_state_dict(_json(want.state_dict()))
    assert _json(clone.state_dict()) == _json(got.state_dict())
    for step in range(4, 12):
        assert [(s, r.rid) for s, r in clone.admissions(step)] == \
            [(s, r.rid) for s, r in got.admissions(step)]
        for s in list(clone.active):
            clone.emit(s)
            got.emit(s)
    assert clone.finished == got.finished


def test_scheduler_state_rejects_extras():
    """Requests with extras (an encoder-decoder's frames) were refused
    before the audio family was ported; now a scheduler holding them
    round-trips as the reference's does (tests/test_fault_tolerance.py
    ``test_scheduler_state_dict_roundtrip``): the same state-dict JSON,
    extras as ``[dtype, nested list]``, fp32 frames back bit for bit, and
    a clone of either side's JSON admits what both admit."""
    got = Scheduler(3, "continuous", max_admissions_per_step=2)
    want = JaxScheduler(3, "continuous", max_admissions_per_step=2)
    rng = np.random.default_rng(3)
    for rid in range(6):
        extras = ({"frames": rng.standard_normal((2, 4)).astype(np.float32)}
                  if rid % 2 else None)
        kw = dict(rid=rid, tokens=np.arange(4 + rid, dtype=np.int32),
                  max_new_tokens=2 + rid % 3, arrival=rid // 2,
                  extras=extras)
        got.add(Request(**kw))
        want.add(JaxRequest(**kw))
    for sched in (got, want):
        sched.admissions(0)
        sched.emit(sched.active[0])
    assert _json(got.state_dict()) == _json(want.state_dict())
    assert _json(got.state_dict())["running"]["1"]["extras"]["frames"][0] \
        == "float32"
    clone = Scheduler.from_state_dict(_json(want.state_dict()))
    jclone = JaxScheduler.from_state_dict(_json(got.state_dict()))
    assert _json(clone.state_dict()) == _json(got.state_dict()) == \
        _json(jclone.state_dict())
    for slot, req in clone.running.items():
        if req.rid % 2 == 0:
            assert req.extras is None
            continue
        frames = got.running[slot].extras["frames"]
        assert req.extras["frames"].dtype == np.float32
        np.testing.assert_array_equal(req.extras["frames"], frames)
    for step in range(1, 5):
        a = [(s, r.rid) for s, r in clone.admissions(step)]
        assert a == [(s, r.rid) for s, r in got.admissions(step)] == \
            [(s, r.rid) for s, r in jclone.admissions(step)]
    assert clone.finished == got.finished
    assert clone.waiting_count == got.waiting_count


def test_page_allocator_state_dict_as_reference():
    got, want = PageAllocator(12), JaxPageAllocator(12)
    held = []
    for n in (3, 2, 4):
        a, b = got.reserve(n), want.reserve(n)
        assert a == b
        held.append(a)
    for alloc in (got, want):
        alloc.free(held[0])
    assert got.state_dict() == want.state_dict()
    clone = PageAllocator.from_state_dict(_json(want.state_dict()))
    jclone = JaxPageAllocator.from_state_dict(_json(got.state_dict()))
    assert clone.state_dict() == jclone.state_dict() == got.state_dict()
    for n in (1, 2, 3, 5):
        assert clone.reserve(n) == got.reserve(n) == jclone.reserve(n)
    assert clone.free_pages == got.free_pages


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _serving_state(small, dtype=None):
    """Compacted weights plus a promoted 3-slot arena of seeded values,
    the reference's tree and the port's (bridged), both fp32; ``dtype``
    casts the port's floating leaves."""
    japi, jparams, tapi, _ = small
    jsp = jax_sparsify(jparams, 0.6, block_k=16, block_n=16, unit=8)
    rng = np.random.default_rng(0)
    jcache = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(x.dtype))
        if jnp.issubdtype(x.dtype, jnp.floating) else x,
        jax_promote_arena(japi.init_cache(3, 16), 3))
    jstate = {"params": jsp, "cache": jcache,
              "tokens": jnp.arange(3, dtype=jnp.int32)[:, None],
              "remaining": jnp.asarray([4, 0, 2], jnp.int32)}
    state = bridge.to_torch(jax.tree.map(np.asarray, jstate))
    if dtype is not None:
        def to(t):
            if isinstance(t, GriffinWeights):
                return dataclasses.replace(t, b_comp=t.b_comp.to(dtype))
            if isinstance(t, dict):
                return {k: to(v) for k, v in t.items()}
            return t.to(dtype) if t.is_floating_point() else t
        state = to(state)
    return jstate, state


def _assert_leaves_equal(a, b):
    fa, fb = list(keyed_leaves(a)), list(keyed_leaves(b))
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype, k
        assert torch.equal(x, y), k


@pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_checkpoint_round_trip_compacted_serving_state(tmp_path, small,
                                                       dtype):
    _, state = _serving_state(small, dtype)
    d = str(tmp_path / "ck")
    save(d, 7, state)
    out = restore(d, state, step=7)
    _assert_leaves_equal(out, state)
    gw, back = state["params"]["layers"]["wq"], out["params"]["layers"]["wq"]
    assert isinstance(back, GriffinWeights)
    assert torch.equal(back.perm, gw.perm)           # rebuilt from inv_perm
    assert (back.k, back.n, back.block_k) == (gw.k, gw.n, gw.block_k)
    # a template on the meta device places every leaf on the CPU; a
    # subtree reads only its own keys
    meta = {"cache": {k: v.to("meta") for k, v in state["cache"].items()}}
    sub = restore(d, meta)
    _assert_leaves_equal(sub, {"cache": state["cache"]})
    man = read_manifest(d)
    if dtype is not None:
        assert man["dtypes"]["['cache']['k']"] == "bfloat16"
        assert man["shapes"]["['cache']['k']"] == \
            list(state["cache"]["k"].shape)


def test_checkpoint_layout_equals_reference(tmp_path, small):
    """The same state saved by both packages: equal manifests and equal
    arrays under every key; the port restores the reference's file."""
    jstate, state = _serving_state(small)
    extra = {"clock": 3, "scheduler": {"seq": 1}}
    jax_save(str(tmp_path / "jax"), 3, jstate, extra=extra)
    save(str(tmp_path / "port"), 3, state, extra=extra)
    jman = jax_read_manifest(str(tmp_path / "jax"))
    man = read_manifest(str(tmp_path / "port"))
    assert man == jman
    with np.load(tmp_path / "jax" / "step_0000000003" / "arrays.npz") as a, \
            np.load(tmp_path / "port" / "step_0000000003" / "arrays.npz") \
            as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    _assert_leaves_equal(restore(str(tmp_path / "jax"), state), state)


def test_checkpoint_retention_and_errors(tmp_path):
    d = str(tmp_path / "ck")
    assert latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        read_manifest(d)
    x = {"x": torch.arange(4, dtype=torch.float32)}
    for step in range(1, 6):
        save(d, step, x, keep=2, extra={"s": step})
    assert latest_step(d) == 5
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == \
        ["step_0000000004", "step_0000000005"]
    assert read_manifest(d)["extra"] == {"s": 5}
    assert read_manifest(d, step=4)["extra"] == {"s": 4}
    with pytest.raises(ValueError, match="shape mismatch"):
        restore(d, {"x": torch.zeros(5)})


# ---------------------------------------------------------------------------
# kills: rollback and replay
# ---------------------------------------------------------------------------

# (phase, step) of the kills held against the reference: every phase at
# step 2, and the prefill and decode polls of the first tick, whose lost
# tick built the first function set (the recovery keeps it, so the replay
# counts no retrace, as in the reference)
KILLS = [pytest.param(p, 2, id=p) for p in PHASES] + \
    [pytest.param(p, 0, id=f"{p}-step0") for p in ("prefill", "decode")]


@pytest.mark.parametrize("phase,step", KILLS)
@pytest.mark.parametrize("kind", list(ENGINES))
def test_kill_recovers_as_reference(small, reference, tmp_path, kind,
                                    phase, step):
    """A kill at step 2 (and at step 0) on each engine: one recovery, the
    reference's faulted engine's ``recovery_log`` and stats (``retraces``
    among them), and the reference's uninterrupted tokens (int8 pages:
    the port's unfaulted int8 run's).  The disk engine's newest manifest
    equals the reference's, scheduler and paging state included."""
    japi, jparams, tapi, tparams = small
    jconf = JaxEngineConfig().with_fields(**ENGINE).with_fields(
        **ENGINES[kind])
    if kind == "disk":
        jconf = jconf.with_fields(snapshot_dir=str(tmp_path / "jax"))
    jinj = jax_fault.FaultInjector(kill_devices=(0,), at_step=step,
                                   phase=phase)
    jeng = JaxServeEngine(japi, jparams, config=jconf, fault_injector=jinj)
    jeng.run(jax_synthetic_trace(japi.cfg, **TRACE))
    inj = _kill(phase, step)
    eng = ServeEngine(tapi, tparams, _conf(kind, tmp_path),
                      fault_injector=inj)
    out = eng.run(_trace(tapi))
    assert inj.fired_at == jinj.fired_at == step
    assert eng.recoveries == jeng.recoveries == 1
    assert eng.recovery_log == jeng.recovery_log
    assert eng.stats == jeng.stats
    if kind == "paged_int8":
        plain = ServeEngine(tapi, tparams, _conf(kind))
        assert _tokens(out) == _tokens(plain.run(_trace(tapi)))
    else:
        assert _tokens(out) == reference
    if kind == "disk":
        man = read_manifest(str(tmp_path / "port"))
        jman = jax_read_manifest(str(tmp_path / "jax"))
        assert man["extra"] == _json(jman["extra"])
        assert set(man["extra"]) == {"scheduler", "clock", "mode", "paging"}
        assert man["keys"] == jman["keys"] and \
            man["shapes"] == jman["shapes"]
        # the port's feedback tokens are int64 (torch's argmax), the
        # reference's int32; every other leaf has the reference's dtype
        assert {k: v for k, v in man["dtypes"].items()
                if k != "['tokens']"} == \
            {k: v for k, v in jman["dtypes"].items() if k != "['tokens']"}
        assert len(eng.save_s) == len(eng.capture_s)
        assert len(list((tmp_path / "port").iterdir())) == 2   # keep=2


def _full_state(eng):
    """Everything a tick can mutate, host side (device tensors apart)."""
    st = {"sched": eng.sched.state_dict(),
          "outputs": {r: dataclasses.asdict(o)
                      for r, o in eng.outputs.items()},
          "events": list(eng.events), "clock": eng.clock, "mode": eng.mode,
          "a_measured": eng.a_measured, "since": eng._since_measure,
          "mode_history": list(eng.mode_history), "stats": dict(eng.stats),
          "buckets": set(eng.prefill_buckets),
          "peak_active": eng.peak_active, "mode_fns": sorted(
              m.value for m in eng._mode_fns),
          "reserved": dict(eng._reserved_pages)}
    if eng._paged is not None:
        st["paging"] = eng._paging_state()
    return st


def _device_state(eng):
    dev = dict(eng.cache, tokens=eng._tokens, remaining=eng._remaining)
    if eng._page_rows is not None:
        dev["page_rows"] = eng._page_rows
    return dev


@pytest.fixture(scope="module")
def family_small():
    """The port's reduced mixtral-8x7b (the moe family) and reduced
    chameleon-34b (the vlm family), both pruned 0.6 and compacted through
    the streamed build, reduced xlstm-1.3b (the ssm family) and reduced
    whisper-large-v3 (the audio family) with their own seed-0 weights."""
    moe = build_model(get_config("mixtral-8x7b").reduced(), device="cpu")
    vlm = build_model(get_config("chameleon-34b").reduced(), device="cpu")
    ssm = build_model(get_config("xlstm-1.3b").reduced(), device="cpu")
    audio = build_model(get_config("whisper-large-v3").reduced(),
                        device="cpu")
    return {"moe": (moe, init_sparse_params(moe, moe.generator(0), 0.6,
                                            **PRUNE)),
            "vlm": (vlm, init_sparse_params(vlm, vlm.generator(0), 0.6,
                                            **PRUNE)),
            "ssm": (ssm, ssm.init(ssm.generator(0))),
            "audio": (audio, audio.init(audio.generator(0)))}


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("kind", ["fixed", "stepwise", "paged",
                                  "paged_int8", "moe_fixed", "moe_paged",
                                  "ssm_fixed", "ssm_paged", "audio_fixed",
                                  "audio_paged", "vlm_fixed", "vlm_paged"])
def test_recovered_engine_state_equals_unfaulted(small, family_small, kind,
                                                 phase):
    """A faulted and an unfaulted engine ticked in lockstep: after every
    tick (the faulted one's replay included) the whole state — scheduler,
    outputs, events, clock, Mode, measurement, stats, buckets, peak
    active slots, function sets, paging, and every device tensor bit for
    bit (int8 pages and scales, page table, pinned page rows) — is
    equal.  The dense family on every engine kind; the moe and the vlm
    family (compacted, through the kernels' plain versions; the vlm's
    QK-norm in every layer) and the ssm family
    on the fixed and the paged arena (the ssm's recurrent state does not
    track cache_len, so its paged arena degrades to the fixed one); the
    audio family, whose requests carry frames and whose cross K/V stay
    fixed beside the paged k/v, on both too."""
    _, _, tapi, tparams = small
    family, _, arena = kind.rpartition("_")
    if family in family_small:
        tapi, tparams = family_small[family]
        kind = arena
    conf = _conf(kind)
    if family in ("moe", "vlm"):
        conf = conf.with_fields(use_kernels=True)
    inj = _kill(phase)
    eng = ServeEngine(tapi, tparams, conf, fault_injector=inj)
    plain = ServeEngine(tapi, tparams, conf)
    for r in _trace(tapi):
        eng.add(r)
        plain.add(r)
    ticks = 0
    while plain.sched.has_work():
        assert eng.step() == plain.step()
        ticks += 1
        assert _full_state(eng) == _full_state(plain)
        a, b = _device_state(eng), _device_state(plain)
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (k, eng.clock)
    assert not eng.sched.has_work() and eng.recoveries == 1
    assert len(eng.capture_s) == ticks and len(plain.capture_s) == 0


@pytest.fixture(scope="module")
def hybrid_small():
    """The port's reduced recurrentgemma-9b with its own seed-0 weights."""
    api = build_model(get_config("recurrentgemma-9b").reduced(),
                      device="cpu")
    return api, api.init(api.generator(0))


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("kind", ["fixed", "paged"])
def test_recovered_hybrid_engine_state_equals_unfaulted(hybrid_small, kind,
                                                        phase):
    """The lockstep test above on the hybrid family's mixed arena: after
    every tick the faulted engine's recurrent state, conv state and K/V
    (on the paged kind the k/v pools and the page table beside the fixed
    recurrent leaves) are bit-equal to the unfaulted engine's, and so is
    its whole host state."""
    tapi, tparams = hybrid_small
    conf = _conf(kind)
    inj = _kill(phase)
    eng = ServeEngine(tapi, tparams, conf, fault_injector=inj)
    plain = ServeEngine(tapi, tparams, conf)
    assert (eng._paged is not None) == (kind == "paged")
    assert {"rec_h", "rec_conv", "tail_h", "tail_conv", "k", "v"} <= \
        set(eng.cache)
    for r in _trace(tapi):
        eng.add(r)
        plain.add(r)
    while plain.sched.has_work():
        assert eng.step() == plain.step()
        assert _full_state(eng) == _full_state(plain)
        a, b = _device_state(eng), _device_state(plain)
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (k, eng.clock)
    assert not eng.sched.has_work() and eng.recoveries == 1
    assert eng.stats["emitted"] == sum(r.max_new_tokens
                                       for r in _trace(tapi))


def test_mode_ab_kill_through_kernel_wrappers(small):
    """Compacted weights with a declared activation sparsity of 0.5 (Mode
    AB: every GEMM through the wrappers, their plain versions here): a
    decode kill gives the unfaulted run's tokens, stats and Mode history,
    and the wrappers' dispatches count every model call made, the
    replayed ones too."""
    _, jparams, tapi, _ = small
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jax_sparsify(
        jparams, 0.6, block_k=16, block_n=16, unit=8)))
    conf = EngineConfig().with_fields(**ENGINE, use_kernels=True,
                                      a_sparsity=0.5)
    reset_kernel_dispatch()
    plain = ServeEngine(tapi, tparams, conf)
    want = plain.run(_trace(tapi))
    per_call = kernel_dispatch_counts()
    calls = plain.stats["prefill_calls"] + plain.stats["decode_steps"]
    reset_kernel_dispatch()
    inj = _kill("decode")
    eng = ServeEngine(tapi, tparams, conf, fault_injector=inj)
    got = eng.run(_trace(tapi))
    assert eng.mode.value == "AB" and eng.recoveries == 1
    assert eng.mode_history == plain.mode_history
    assert _tokens(got) == _tokens(want) and eng.stats == plain.stats
    assert eng.replayed_calls > 0
    made = calls + eng.replayed_calls
    assert kernel_dispatch_counts() == {
        k: v // calls * made for k, v in per_call.items()}
    assert set(per_call) == {"kernel", "dual"}


# ---------------------------------------------------------------------------
# unarmed engines, the card's cells
# ---------------------------------------------------------------------------

# the smoke's paths and their host syncs over its 52 tokens (PERF.md §5:
# 0.2115 fixed fused, 0.1538 paged, 0.6154 stepwise)
SMOKE_SYNCS = {"sparse_b": 11, "sparse_b_paged": 8, "sparse_b_stepwise": 32}


def _smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    return importlib.import_module("chip_smoke")


def _smoke_run(smoke, path: str, tmp_path=None, **fields):
    """launch.serve on the smoke's trace and path at reduced width."""
    cell = smoke.PATHS[path]
    trace = dict(smoke.TRACE)
    trace["requests"] = fields.pop("requests", trace["requests"])
    conf = dict(decode_chunk=8, use_kernels=True,
                a_sparsity=cell["a_sparsity"])
    conf.update(cell["arena"])
    conf.update(fields)
    return launch_serve.serve(reduced=True, device="cpu",
                              sparsity=cell["sparsity"],
                              config=EngineConfig().with_fields(**conf),
                              **trace)


@pytest.mark.parametrize("path", list(SMOKE_SYNCS))
def test_unarmed_engine_captures_nothing(monkeypatch, path):
    """No injector, detector or snapshot directory: no capture, and the
    smoke trace's host syncs are PERF.md's; an armed engine whose kill
    never comes captures every tick and still counts the same syncs,
    keeping the seconds of only the newest ``TIMING_WINDOW`` captures."""
    smoke = _smoke(monkeypatch)
    run = _smoke_run(smoke, path)
    eng = run.engine
    assert len(eng.capture_s) == 0 and eng._snap_host is None
    assert eng.stats["host_syncs"] == SMOKE_SYNCS[path]
    assert eng.stats["emitted"] == 52
    if path == "sparse_b_stepwise":
        assert {k: eng.stats[k] for k in smoke.STEPWISE_STATS} == \
            smoke.STEPWISE_STATS
    monkeypatch.setattr(engine_mod, "TIMING_WINDOW", 4)
    armed = _smoke_run(smoke, path, inject="kill:0@1000").engine
    assert not armed.faults.fired and armed.stats == eng.stats
    assert armed.clock > 4 and len(armed.capture_s) == 4
    assert armed.snapshot_bytes > 0


@pytest.mark.parametrize("name", ["fault_kill_admission",
                                  "fault_kill_prefill", "fault_kill_decode",
                                  "fault_kill_stepwise",
                                  "fault_kill_paged_int8",
                                  "fault_kill_mode_ab",
                                  "fault_snapshot_dir"])
def test_smoke_fault_cells(monkeypatch, tmp_path, name):
    """chip_smoke.py's fault cells at reduced width through launch.serve:
    each kill fires at the clock the card run gates on, one recovery, the
    replayed model calls it gates on, and the unfaulted run's tokens and
    stats (the clock and the calls depend on the trace and scheduler
    only)."""
    smoke = _smoke(monkeypatch)
    cell = smoke.FAULT_CELLS[name]
    extra = {}
    if "requests" in cell:
        extra["requests"] = cell["requests"]
    if "snapshot_dir" in cell:
        extra["snapshot_dir"] = str(tmp_path / "snap")
    run = _smoke_run(smoke, cell["path"],
                     inject=f"kill:0@{cell['at']}:{cell['phase']}", **extra)
    plain = _smoke_run(smoke, cell["path"], **{
        k: v for k, v in extra.items() if k == "requests"})
    eng = run.engine
    assert eng.faults.fired_at == cell["at"] and eng.recoveries == 1
    assert eng.recovery_log == [{"step": cell["at"], "lost": [0],
                                 "mesh": "unsharded"}]
    assert eng.replayed_calls == cell["replayed"]
    assert eng.stats == plain.engine.stats
    assert _tokens(eng.outputs) == _tokens(plain.engine.outputs)
    assert [(s, m.value) for s, m in eng.mode_history] == \
        [(0, smoke.PATHS[cell["path"]]["mode"])]
    if "snapshot_dir" in cell:
        man = read_manifest(str(tmp_path / "snap"))
        assert Scheduler.from_state_dict(
            man["extra"]["scheduler"]).num_slots == eng.num_slots
        assert PageAllocator.from_state_dict(
            man["extra"]["paging"]["allocator"]).num_pages == \
            eng._paged.num_pages


# ---------------------------------------------------------------------------
# when the fault fires
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("step", range(8))
def test_port_fires_where_reference_fires(small, reference, reference_polls,
                                          step, phase):
    """The twin of the reference's ``test_recovery_invariant_to_fault_step``
    over every (step, phase) of the 7-tick trace: the port fires exactly
    where the reference's engine would (its first poll of that phase at a
    clock >= step), recovers once when it does, and gives the
    uninterrupted tokens either way."""
    clocks = [c for p, c in reference_polls if p == phase and c >= step]
    _, _, tapi, tparams = small
    inj = _kill(phase, step)
    eng = ServeEngine(tapi, tparams, _conf("fixed"), fault_injector=inj)
    out = eng.run(_trace(tapi))
    assert inj.fired_at == (clocks[0] if clocks else None)
    assert eng.recoveries == (1 if clocks else 0)
    assert _tokens(out) == reference


def test_prefill_kill_at_step_5_never_fires_in_either(small, reference):
    """The reference's hypothesis draw (5, 'prefill') that its own test
    asserts fires: the trace admits nothing at clock 5 or later, so
    neither engine fires there."""
    japi, jparams, tapi, tparams = small
    jinj = jax_fault.FaultInjector(kill_devices=(0,), at_step=5,
                                   phase="prefill")
    jeng = JaxServeEngine(japi, jparams,
                          config=JaxEngineConfig().with_fields(**ENGINE),
                          fault_injector=jinj)
    jeng.run(jax_synthetic_trace(japi.cfg, **TRACE))
    inj = _kill("prefill", 5)
    eng = ServeEngine(tapi, tparams, _conf("fixed"), fault_injector=inj)
    assert _tokens(eng.run(_trace(tapi))) == reference
    assert not jinj.fired and not inj.fired
    assert jeng.recoveries == eng.recoveries == 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_kill_and_delay_faults(tmp_path, capsys):
    """``--inject-fault kill:0@2:decode`` (with disk snapshots) ends in
    parity with one recovery; a delay spec feeds the one-host straggler
    detector, which never evicts."""
    launch_serve.main(["--reduced", "--device", "cpu", "--use-kernels",
                       "--inject-fault", "kill:0@2:decode", "--parity",
                       "--snapshot-dir", str(tmp_path / "snap")])
    out = capsys.readouterr().out
    assert ("fault injected (kill:0@2:decode): 1 recoveries, log "
            "[{'step': 2, 'lost': [0], 'mesh': 'unsharded'}]") in out
    assert "parity OK: all 8 requests" in out
    assert latest_step(str(tmp_path / "snap")) is not None
    launch_serve.main(["--reduced", "--device", "cpu", "--inject-fault",
                       "delay:0@1:4", "--evict-after", "2", "--parity"])
    out = capsys.readouterr().out
    assert "fault injected (delay:0@1:4): 0 recoveries, log []" in out
    assert "parity OK" in out


def test_route_with_kill_spec_arms_every_engine():
    """A ``kill:`` spec behind the router arms each engine built with its
    own injector, as the reference's CLI does; every request completes
    with the oracle's tokens."""
    conf = EngineConfig().with_fields(num_slots=2, decode_chunk=2,
                                      replicas=2, shed_policy="none",
                                      inject="kill:0@1:decode")
    run = launch_serve.route(reduced=True, device="cpu", config=conf,
                             requests=6, prompt_lens=(6, 10),
                             gen_lens=(4, 6), trace_seed=11)
    assert len(run.engines) == 2 and run.router.faults == []
    assert all(e.faults.fired and e.recoveries == 1 for e in run.engines)
    assert run.engines[0].faults is not run.engines[1].faults
    assert run.router.stats["completed"] == 6
    assert launch_serve.check_route_parity(run) == 6
