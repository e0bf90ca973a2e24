"""The port's paged KV arena (repro_torch.runtime.paging, the paged write
and view of repro_torch.models.common, the paged engine) against the JAX
package's, mirroring tests/test_paged_arena.py with pages in the cache's
own dtype (int8 pages are held in tests/test_torch_int8_pages.py):

* ``PageAllocator`` units: lowest id first, never DUMP, all-or-nothing on
  exhaustion, double free raises, the reference's page ids under one
  reserve/free sequence, and a seeded sweep of reserve/free
  interleavings;
* discovery and spec: the probe runs on the meta device, ``build_spec``
  rounds cache_len up and validates, ``paged_tree``'s shapes and dtypes
  equal the reference's;
* the paged write and view are bit-equal to the reference's (pure data
  movement), wrapping dead rows onto the DUMP page;
* engines: paged fp32 tokens bit-equal to the port's fixed arena at
  decode_chunk 1 and 3 and through slot and page reuse; tokens and stats
  equal to the reference's paged engine; and the reference's paged row of
  ``benchmarks/out/BENCH_serve.json`` (heavy trace, seed 7, 48 requests,
  page_size 16, 64 pages, cache_len 256): 10 paged vs 4 fixed peak slots,
  1684 tokens, paged token-exact to fixed and to the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.common import paged_view as jax_paged_view
from repro.models.common import paged_write as jax_paged_write
from repro.runtime.config import EngineConfig as JaxEngineConfig
from repro.runtime.engine import ServeEngine as JaxServeEngine
from repro.runtime.engine import _promote_arena as jax_promote_arena
from repro.runtime.engine import synthetic_trace as jax_synthetic_trace
from repro.runtime.paging import PageAllocator as JaxPageAllocator
from repro.runtime.paging import build_spec as jax_build_spec
from repro.runtime.paging import paged_tree as jax_paged_tree
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.common import paged_slot, paged_view, paged_write
from repro_torch.runtime.config import EngineConfig
from repro_torch.runtime.engine import (Request, Scheduler, ServeEngine,
                                        _promote_arena, synthetic_trace)
from repro_torch.runtime.paging import (DUMP_PAGE, PageAllocator, build_spec,
                                        discover_paged_keys, paged_tree)

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


@pytest.fixture(scope="module")
def reduced():
    """(port api, port params) of reduced llama3.2-1b on the CPU."""
    api = build_model(get_config("llama3.2-1b").reduced(), device="cpu")
    return api, api.init(api.generator(0))


# ---------------------------------------------------------------------------
# PageAllocator units
# ---------------------------------------------------------------------------

def test_allocator_lowest_first_and_deterministic_reuse():
    alloc = PageAllocator(9)                    # pages 1..8 usable, 0 = DUMP
    a = alloc.reserve(3)
    b = alloc.reserve(3)
    assert a == [1, 2, 3] and b == [4, 5, 6]
    alloc.free(a)
    assert alloc.reserve(2) == [1, 2]
    assert alloc.reserve(2) == [3, 7]


def test_allocator_never_hands_out_dump():
    alloc = PageAllocator(5)
    ids = alloc.reserve(4)
    assert DUMP_PAGE not in ids
    assert alloc.reserve(1) is None


def test_allocator_exhaustion_is_all_or_nothing():
    alloc = PageAllocator(9)
    assert alloc.reserve(8) is not None
    before = alloc.free_pages
    assert alloc.reserve(1) is None
    assert alloc.free_pages == before


def test_allocator_double_free_raises():
    alloc = PageAllocator(9)
    ids = alloc.reserve(2)
    alloc.free(ids)
    with pytest.raises(ValueError):
        alloc.free(ids)
    with pytest.raises(ValueError):
        alloc.free([7])


def test_allocator_gives_the_reference_page_ids():
    ours, ref = PageAllocator(17), JaxPageAllocator(17)
    held = []
    for n in (4, 5, 2):
        ids = ours.reserve(n)
        assert ids == ref.reserve(n)
        held.append(ids)
    for ids in (held[0], held[2]):
        ours.free(ids)
        ref.free(ids)
    for n in (3, 6, 1, 9):
        assert ours.reserve(n) == ref.reserve(n)
        assert ours.free_pages == ref.free_pages


@pytest.mark.parametrize("seed", range(5))
def test_allocator_admission_order_seeded(seed):
    """Under any interleaving of reserve and free, live reservations never
    overlap, never include DUMP, and every page comes home."""
    rng = np.random.default_rng(seed)
    alloc = PageAllocator(17)
    held = []
    for _ in range(80):
        val = int(rng.integers(0, 64))
        if rng.integers(0, 2) == 0:
            ids = alloc.reserve(1 + val % 6)
            if ids is not None:
                assert DUMP_PAGE not in ids
                assert not {i for h in held for i in h} & set(ids)
                held.append(ids)
        elif held:
            alloc.free(held.pop(val % len(held)))
    for h in held:
        alloc.free(h)
    assert alloc.free_pages == 16


# ---------------------------------------------------------------------------
# discovery, spec and tree
# ---------------------------------------------------------------------------

class _Devices(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.devices = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor):
            self.devices.add(out.device.type)
        return out


def test_discovery_probes_the_meta_device(reduced):
    api, _ = reduced
    with _Devices() as mode:
        assert discover_paged_keys(api, 16) == ("k", "v")
    assert mode.devices == {"meta"}


def test_discovery_keeps_a_rolling_window_fixed():
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(), window=8)
    api = build_model(cfg, device="cpu")
    assert discover_paged_keys(api, 64) == ()
    spec, clen = build_spec(api, 2, 64, 4)
    assert spec is None and clen == 64


@pytest.mark.parametrize("args", [(2, 10, 4), (3, 16, 4, 9), (2, 33, 16)])
def test_build_spec_rounds_like_reference(reduced, args):
    api, _ = reduced
    japi = jax_build_model(jax_get_config("llama3.2-1b").reduced())
    spec, clen = build_spec(api, *args)
    jspec, jclen = jax_build_spec(japi, *args)
    assert clen == jclen == spec.cache_len
    assert spec.max_pages * spec.page_size == clen
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)


def test_build_spec_validates_and_int8_raises(reduced):
    """Bad page sizes, dtypes and pools raise; int8, once unported, now
    builds the reference's spec and config (the name is kept from then)."""
    api, _ = reduced
    assert build_spec(api, 2, 16, None) == (None, 16)
    with pytest.raises(ValueError):
        build_spec(api, 2, 16, 3)               # not a power of two
    with pytest.raises(ValueError):
        build_spec(api, 2, 16, 4, kv_dtype="fp8")
    with pytest.raises(ValueError):
        build_spec(api, 2, 16, 4, num_pages=4)  # one slot needs 4 + DUMP
    japi = jax_build_model(jax_get_config("llama3.2-1b").reduced())
    spec, clen = build_spec(api, 2, 16, 4, kv_dtype="int8")
    assert dataclasses.asdict(spec) == dataclasses.asdict(
        jax_build_spec(japi, 2, 16, 4, kv_dtype="int8")[0])
    assert spec.kv_dtype == "int8" and clen == 16
    conf = EngineConfig().with_fields(page_size=4, kv_dtype="int8")
    assert (conf.arena.page_size, conf.arena.kv_dtype) == (4, "int8")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_tree_shapes_and_dtypes(dtype):
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              dtype=dtype)
    api = build_model(cfg, device="cpu")
    spec, clen = build_spec(api, 2, 16, 4)
    arena = paged_tree(_promote_arena(api.init_cache(2, clen), 2), 2, spec)
    japi = jax_build_model(jax_get_config("llama3.2-1b").reduced())
    jspec, _ = jax_build_spec(japi, 2, 16, 4)
    jarena = jax_paged_tree(jax_promote_arena(japi.init_cache(2, clen), 2),
                            2, jspec)
    assert sorted(arena) == sorted(jarena) == ["k", "pages", "pos", "v"]
    for key in arena:
        assert tuple(arena[key].shape) == jarena[key].shape, key
    assert arena["k"].shape == (cfg.num_layers, spec.num_pages,
                                spec.page_size, cfg.num_kv_heads, cfg.hd)
    assert arena["k"].dtype == arena["v"].dtype == getattr(torch, dtype)
    assert arena["pages"].dtype == torch.int32
    assert not arena["pages"].any()


# ---------------------------------------------------------------------------
# paged write and view
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos", [np.int32(5), np.array([3, 17, 0, 30])],
                         ids=["scalar", "per-row"])
def test_paged_write_and_view_equal_reference(pos):
    """Row 1 is dead (all DUMP) at a position past max_pages * page_size:
    it wraps, writes onto DUMP and reads nothing it wrote."""
    rng = np.random.default_rng(4)
    pool = rng.standard_normal((9, 4, 2, 3)).astype(np.float32)
    pages = np.array([[1, 2, 3, 4], [0, 0, 0, 0], [5, 6, 0, 0],
                      [7, 8, 0, 0]], np.int32)
    update = rng.standard_normal((4, 1, 2, 3)).astype(np.float32)
    jpool, _ = jax_paged_write(jnp.asarray(pool), None, jnp.asarray(pages),
                               jnp.asarray(update), jnp.asarray(pos), 4)
    jview = jax_paged_view(jpool, None, jnp.asarray(pages), jnp.float32)
    tpool = torch.from_numpy(pool.copy())
    tpages = torch.from_numpy(pages).long()
    slot = paged_slot(tpages, torch.from_numpy(np.asarray(pos)), 4)
    paged_write(tpool, None, slot, torch.from_numpy(update))
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
    view = paged_view(tpool, None, tpages, torch.float32)
    assert view.shape == (4, 16, 2, 3)
    np.testing.assert_array_equal(view.numpy(), np.asarray(jview))


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _trace(cfg, num_requests):
    return synthetic_trace(cfg, num_requests=num_requests, seed=11,
                           prompt_lens=(6, 10), gen_lens=(2, 4),
                           arrival_every=1)


def _engine(api, params, page_size=None, decode_chunk=3, cache_len=16):
    return ServeEngine(api, params, EngineConfig().with_fields(
        num_slots=2, cache_len=cache_len, page_size=page_size,
        decode_chunk=decode_chunk))


@pytest.mark.parametrize("decode_chunk,num_requests", [(1, 4), (3, 4),
                                                       (3, 8)],
                         ids=["chunk1", "chunk3", "chunk3-reuse"])
def test_paged_tokens_bit_equal_fixed(reduced, decode_chunk, num_requests):
    """fp32 pages at a page-multiple cache_len give the fixed arena's
    tokens; 8 requests on 2 slots recycle slots and pages mid-run."""
    api, params = reduced
    fixed = _engine(api, params, decode_chunk=decode_chunk)
    paged = _engine(api, params, page_size=4, decode_chunk=decode_chunk)
    assert paged._paged is not None and paged.cache_len == 16
    outs_f = fixed.run(_trace(api.cfg, num_requests))
    outs_p = paged.run(_trace(api.cfg, num_requests))
    for r in _trace(api.cfg, num_requests):
        assert outs_p[r.rid].tokens == outs_f[r.rid].tokens, r.rid
    assert paged.stats == fixed.stats
    # the last finished slots give their pages back at the next tick start
    paged._flush_dirty()
    assert paged._page_alloc.free_pages == paged._paged.usable_pages
    assert not paged.cache["pages"].any()        # every row back on DUMP


def test_paged_engine_equals_reference():
    """Tokens, emission steps and stats of the port's paged engine equal
    the reference's on its bridged weights and the same trace, with a pool
    small enough that admissions wait for pages."""
    cfg = jax_get_config("llama3.2-1b").reduced()
    japi = jax_build_model(cfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    kw = dict(num_slots=3, cache_len=24, page_size=4, num_pages=9,
              decode_chunk=4)
    jeng = JaxServeEngine(japi, jparams,
                          config=JaxEngineConfig().with_fields(**kw))
    trace = dict(num_requests=7, seed=11, prompt_lens=(6, 10, 17),
                 gen_lens=(2, 4, 7), arrival_every=1)
    jouts = jeng.run(jax_synthetic_trace(cfg, **trace))
    tapi = build_model(get_config("llama3.2-1b").reduced(), device="cpu")
    teng = ServeEngine(tapi, bridge.to_torch(jax.tree.map(np.asarray,
                                                          jparams)),
                       EngineConfig().with_fields(**kw))
    touts = teng.run(synthetic_trace(tapi.cfg, **trace))
    assert teng.cache_len == jeng.cache_len == 24
    assert sorted(touts) == sorted(jouts)
    for rid in jouts:
        assert touts[rid].tokens == jouts[rid].tokens, rid
        assert touts[rid].token_steps == jouts[rid].token_steps, rid
    for key in STATS:
        assert teng.stats[key] == jeng.stats[key], key
    assert teng._page_alloc.free_pages == jeng._page_alloc.free_pages
    assert sorted(teng._page_alloc._held) == sorted(jeng._page_alloc._held)


def test_scheduler_gate_blocks_the_head_of_the_line():
    """A vetoed head request stays first and stops admission, so a later
    request that would fit does not overtake it."""
    sched = Scheduler(3, max_admissions_per_step=3)
    for rid, gen in enumerate((2, 5, 1)):
        sched.add(Request(rid=rid, tokens=np.ones(4, np.int32),
                          max_new_tokens=gen))
    budget = [6]

    def gate(req):
        if req.max_new_tokens > budget[0]:
            return False
        budget[0] -= req.max_new_tokens
        return True

    assert [r.rid for _, r in sched.admissions(0, gate=gate)] == [0]
    assert sched.waiting_count == 2 and budget == [4]
    budget[0] = 6
    assert [r.rid for _, r in sched.admissions(1, gate=gate)] == [1, 2]


def test_page_gate_reserves_all_or_nothing(reduced):
    api, params = reduced
    eng = _engine(api, params, page_size=4)     # 8 usable pages
    req = Request(rid=0, tokens=np.ones(6, np.int32), max_new_tokens=3)
    eng._page_alloc.reserve(6)                  # 2 pages left; req needs 3
    assert not eng._page_gate(req) and eng._reserved_pages == {}
    assert eng._page_alloc.free_pages == 2
    eng._page_alloc.free([1])
    assert eng._page_gate(req) and eng._reserved_pages == {0: [1, 7, 8]}
    assert eng._page_alloc.free_pages == 0
    assert _engine(api, params)._admission_gate() is None   # fixed arena


# the reference's paged row (benchmarks/bench_serve.py: PAGED, the heavy
# trace and the workload model)
PAGED = dict(page_size=16, num_pages=64, cache_len=256)
GEN_LENS = (12, 12, 16, 16, 24, 24, 32, 112)
HEAVY = dict(num_requests=48, seed=7, prompt_lens=(8, 16, 24),
             gen_lens=GEN_LENS, arrival_every=0, length_dist="heavy",
             max_gen=224)


def _drain_peak(eng, reqs):
    """Tick to the end, tracking the most slots active after a tick (the
    reference benchmark's measure)."""
    for r in reqs:
        eng.add(r)
    peak = 0
    while eng.sched.has_work():
        eng.step()
        peak = max(peak, len(eng.sched.active))
    return peak, {r: list(o.tokens) for r, o in eng.outputs.items()}


def test_reference_paged_row_holds_with_fp32_pages():
    jcfg = dataclasses.replace(jax_get_config("llama3.2-1b").reduced(),
                               d_model=96, head_dim=24, d_ff=384,
                               num_layers=2, vocab_size=256)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              d_model=96, head_dim=24, d_ff=384,
                              num_layers=2, vocab_size=256)
    api = build_model(cfg, device="cpu")
    params = bridge.to_torch(jax.tree.map(np.asarray, jparams))
    reqs = synthetic_trace(cfg, **HEAVY)
    assert [(r.max_new_tokens, list(r.tokens)) for r in reqs] == \
        [(r.max_new_tokens, list(r.tokens))
         for r in jax_synthetic_trace(jcfg, **HEAVY)]
    assert EngineConfig.heavy_gen_cap(GEN_LENS) == HEAVY["max_gen"]
    runs = {}
    for name, slots, paged in (("fixed", 4, False), ("paged", 10, True)):
        kw = dict(num_slots=slots, cache_len=PAGED["cache_len"],
                  decode_chunk=8, max_admissions_per_step=10)
        if paged:
            kw.update(page_size=PAGED["page_size"],
                      num_pages=PAGED["num_pages"])
        eng = ServeEngine(api, params, EngineConfig().with_fields(**kw))
        runs[name] = (eng,) + _drain_peak(eng, synthetic_trace(cfg, **HEAVY))
    (fixed, fpeak, ftoks), (paged, ppeak, ptoks) = runs["fixed"], \
        runs["paged"]
    # the same 1024 KV rows: 4 x 256 fixed, 64 pages x 16 with DUMP
    assert PAGED["num_pages"] * PAGED["page_size"] == 4 * 256
    assert (ppeak, fpeak) == (10, 4)
    assert paged.stats["emitted"] == fixed.stats["emitted"] == 1684
    assert ptoks == ftoks
    # request for request, the reference's paged fp32 engine
    jeng = JaxServeEngine(japi, jparams, config=JaxEngineConfig().with_fields(
        num_slots=10, decode_chunk=8, max_admissions_per_step=10, **PAGED))
    _, jtoks = _drain_peak(jeng, jax_synthetic_trace(jcfg, **HEAVY))
    assert ptoks == jtoks
