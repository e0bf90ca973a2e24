"""The port's autotuner (repro_torch.tuning, launch/autotune.py, the pure
half of roofline/) against the JAX package's, on reduced llama3.2-1b in
fp32 on the CPU: the cases of tests/test_autotune.py that need no mesh,
each held against the reference through ``repro_torch.bridge``.

  - plan files: JSON round trip, schema rejection, one schema constant,
    plans interchangeable between the packages;
  - candidates: first-match rules, the candidate grid (names and order)
    at the reduced and the full-width GEMM shapes;
  - ``sparsify_params(plan=)``: block shapes, ``a_thr``, idempotence, and
    compacted fields bit-equal to the reference's (pure data movement);
  - engine thresholds: the family ``a_threshold`` and ``b_threshold`` and
    a per-GEMM ``a_thr`` reach the Mode decision and the dispatch;
  - token identity: tuned vs default, and the port's tuned tokens vs the
    reference's;
  - scores: ``compaction_stats`` and ``predict_scores`` equal to the
    reference's at the reference's peak, bandwidth and step cost, and the
    committed ``benchmarks/out/kernel_plan.json`` predicted table;
  - the CLIs: ``launch.autotune`` writes a plan that reloads in both
    packages, ``launch.serve --plan`` ends in "parity OK".

Tolerances: counts, grid steps and DSE speedups (rounded to 4 places, as
the plan stores them) exact; bound, predicted seconds and scores within
rel 1e-12 (the two packages sum the GEMMs' terms in their own tree order).
"""
import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

import repro.roofline.analysis as jax_roofline
from repro.configs import get_config as jax_get_config
from repro.core.dse import ResultsCache as JaxResultsCache
from repro.models import build_model as jax_build_model
from repro.runtime.config import EngineConfig as JaxEngineConfig
from repro.runtime.engine import ServeEngine as JaxServeEngine
from repro.runtime.engine import synthetic_trace as jax_synthetic_trace
from repro.sparsity import sparsify_params as jax_sparsify
from repro.tuning import PLAN_SCHEMA_VERSION as JAX_PLAN_SCHEMA_VERSION
from repro.tuning import load_plan as jax_load_plan
from repro.tuning.measure import PRUNE as JAX_PRUNE
from repro.tuning.search import compaction_stats as jax_compaction_stats
from repro.tuning.search import enumerate_candidates as jax_enumerate
from repro.tuning.search import gemm_leaves as jax_gemm_leaves
from repro.tuning.search import predict_scores as jax_predict_scores
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.dse import CONFIG_SCHEMA_VERSION, ResultsCache
from repro_torch.core.spec import Mode
from repro_torch.kernels import GriffinWeights, decompact_weights
from repro_torch.launch import autotune as autotune_cli
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models.common import (kernel_dispatch_counts,
                                       reset_kernel_dispatch)
from repro_torch.roofline import analysis as roofline
from repro_torch.runtime.config import EngineConfig
from repro_torch.runtime.engine import ServeEngine, synthetic_trace
from repro_torch.sparsity import (PRUNE, PRUNE_FULL, prune_for,
                                  sparsify_params)
from repro_torch.tuning import (PLAN_SCHEMA_VERSION, FamilyPlan, GemmRule,
                                KernelPlan, PlanSchemaError, load_plan)
from repro_torch.tuning import search
from repro_torch.tuning.measure import FAMILY_ARCHS, tuning_workload
from repro_torch.tuning.search import (Candidate, compaction_stats,
                                       enumerate_candidates, gemm_leaves,
                                       predict_scores, select_best,
                                       shortlist, step_overhead_for)

ROOT = pathlib.Path(__file__).resolve().parent.parent
COMMITTED_PLAN = ROOT / "benchmarks" / "out" / "kernel_plan.json"
REL = 1e-12
# the reference's CPU step cost (its STEP_OVERHEAD_INTERPRET)
REF_STEP = 2e-4
# llama3.2-1b's seven GEMM shapes at full width (K x N)
FULL_SHAPES = {"wq": (2048, 2048), "wk": (2048, 512), "wv": (2048, 512),
               "wo": (2048, 2048), "w_gate": (2048, 8192),
               "w_up": (2048, 8192), "w_down": (8192, 2048)}

_PLAN = FamilyPlan(
    family="dense", a_threshold=0.9,
    rules=(GemmRule(match="*", block_k=64, block_n=64, unit=8,
                    a_threshold=0.9),),
    predicted={"bk64_bn64_u8_f8_t0p9": {"score": 1.0}},
    measured={"winner": "bk64_bn64_u8_f8_t0p9"})


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
def caches(tmp_path_factory):
    """One DSE sweep cache per package for the module: the first scoring
    call of each package runs its sweeps cold, later ones read them."""
    root = tmp_path_factory.mktemp("dse")
    return (ResultsCache(str(root / "port")),
            JaxResultsCache(str(root / "reference")))


@pytest.fixture(scope="module")
def reference():
    """The reference's reduced dense model, its seed-0 weights, and those
    weights pruned (not compacted) at PRUNE: the committed plan's inputs."""
    cfg = jax_get_config(FAMILY_ARCHS["dense"]).reduced()
    api = jax_build_model(cfg)
    params = api.init(jax.random.PRNGKey(0))
    pruned = jax_sparsify(params, 0.8, compact=False, **JAX_PRUNE)
    return cfg, api, params, pruned


def _port_model():
    cfg = get_config(FAMILY_ARCHS["dense"]).reduced()
    api = build_model(cfg, device="cpu")
    return cfg, api, api.init(api.generator(0))


def _trace(cfg, requests=3):
    return synthetic_trace(cfg, num_requests=requests, seed=3,
                           prompt_lens=(4, 6), gen_lens=(3, 5),
                           arrival_every=1)


def _griffin_leaves(tree):
    if isinstance(tree, GriffinWeights):
        return [tree]
    if isinstance(tree, dict):
        return [g for v in tree.values() for g in _griffin_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [g for v in tree for g in _griffin_leaves(v)]
    return []


def _decompact_any(gw):
    if gw.b_comp.dim() == 2:
        return decompact_weights(gw)
    return torch.stack([decompact_weights(gw[i])
                        for i in range(gw.b_comp.shape[0])])


def _tokens(outs):
    return {r: tuple(int(t) for t in o.tokens) for r, o in outs.items()}


def _engine(api, params, plan=None, **fields):
    conf = EngineConfig().with_fields(num_slots=4, cache_len=16, **fields)
    return ServeEngine(api, params, conf, plan=plan)


# ---------------------------------------------------------------------------
# plan files
# ---------------------------------------------------------------------------

def test_plan_json_round_trip(tmp_path):
    plan = KernelPlan(
        families={"dense": _PLAN,
                  "ssm": FamilyPlan(family="ssm", b_threshold=0.2)},
        meta={"tool": "repro_torch.launch.autotune", "sparsity": 0.8})
    path = str(tmp_path / "plan.json")
    plan.save(path)
    re = load_plan(path)
    assert re.schema_version == PLAN_SCHEMA_VERSION
    assert re.families == plan.families
    assert re.meta == plan.meta
    assert re.family("dense").rule_for("wo").block_k == 64
    assert re.family("moe") is None


def test_plan_schema_version_rejected(tmp_path):
    doc = KernelPlan(families={"dense": _PLAN}).to_json()
    for bad in (PLAN_SCHEMA_VERSION + 1, PLAN_SCHEMA_VERSION - 1, None,
                str(PLAN_SCHEMA_VERSION)):
        doc["schema_version"] = bad
        path = str(tmp_path / "bad.json")
        with open(path, "w") as f:
            json.dump({k: v for k, v in doc.items()
                       if v is not None or k != "schema_version"}, f)
        with pytest.raises(PlanSchemaError, match="repro_torch.launch"):
            load_plan(path)


def test_plan_schema_constant_shared_with_dse_and_reference():
    assert PLAN_SCHEMA_VERSION == CONFIG_SCHEMA_VERSION == \
        JAX_PLAN_SCHEMA_VERSION == 2


def test_port_plan_loads_in_reference(tmp_path):
    path = str(tmp_path / "plan.json")
    KernelPlan(families={"dense": _PLAN}, meta={"x": 1}).save(path)
    got = jax_load_plan(path)
    fam = got.family("dense")
    assert got.schema_version == PLAN_SCHEMA_VERSION
    assert (fam.a_threshold, fam.b_threshold) == (0.9, None)
    assert [dataclasses.asdict(r) for r in fam.rules] == \
        [dataclasses.asdict(r) for r in _PLAN.rules]
    assert (fam.predicted, fam.measured) == (_PLAN.predicted,
                                             _PLAN.measured)


def test_committed_plan_loads_in_port():
    plan = load_plan(str(COMMITTED_PLAN))
    ref = jax_load_plan(str(COMMITTED_PLAN))
    assert set(plan.families) == set(ref.families) == {"dense", "ssm"}
    for name, fam in plan.families.items():
        want = ref.family(name)
        assert [dataclasses.asdict(r) for r in fam.rules] == \
            [dataclasses.asdict(r) for r in want.rules]
        assert (fam.a_threshold, fam.b_threshold, fam.predicted,
                fam.measured) == (want.a_threshold, want.b_threshold,
                                  want.predicted, want.measured)
    assert plan.meta == ref.meta


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------

def test_rule_resolution_first_match_wins():
    fp = FamilyPlan(family="dense", rules=(
        GemmRule(match="wo", block_k=32),
        GemmRule(match="*", block_k=64)))
    assert fp.rule_for("wo").block_k == 32
    assert fp.rule_for("w_up").block_k == 64
    assert FamilyPlan(family="dense").rule_for("wo") is None


@pytest.mark.parametrize("budget", [4, 8, 16, 64])
@pytest.mark.parametrize("width", ["reduced", "full"])
def test_enumerate_candidates_equal_reference(width, budget):
    if width == "full":
        shapes = FULL_SHAPES
    else:
        _, _, params = _port_model()
        shapes = {k: tuple(w.shape) for k, w in gemm_leaves(params).items()}
    got = enumerate_candidates(shapes, budget)
    want = jax_enumerate(shapes, budget)
    assert [c.name for c in got] == [c.name for c in want]
    assert [dataclasses.astuple(c) for c in got] == \
        [dataclasses.astuple(c) for c in want]


def test_full_width_grid_spans_five_granularities():
    cands = enumerate_candidates(FULL_SHAPES, 16)
    assert len(cands) == 16
    assert sorted({c.block_k for c in cands}) == [16, 32, 64, 128, 512]
    assert all(c.block_k == c.block_n and c.fanin == 8 for c in cands)
    assert {c.unit for c in cands if c.block_k == 512} == {8, 512}


def test_enumerate_candidates_budget_and_determinism():
    shapes = {"wo": (64, 64), "w_up": (64, 256)}
    cands = enumerate_candidates(shapes, budget=8)
    assert len(cands) == 8
    assert cands == enumerate_candidates(shapes, budget=8)
    assert len({c.name for c in cands}) == len(cands)
    assert all(c.block_k <= 64 and c.block_n <= 64 for c in cands)
    assert len({c.block_k for c in cands}) > 1
    assert len({c.a_threshold for c in cands}) > 1


def test_candidate_family_plan_shape():
    c = Candidate(block_k=64, block_n=64, unit=8, fanin=8, a_threshold=0.9)
    fp = c.family_plan("dense")
    assert fp.a_threshold == 0.9
    r = fp.rule_for("anything")
    assert (r.block_k, r.block_n, r.unit, r.a_threshold) == (64, 64, 8, 0.9)


def test_gemm_leaves_equal_reference(reference):
    _, _, _, pruned = reference
    want = jax_gemm_leaves(pruned)
    got = gemm_leaves(bridge.to_torch(jax.tree.map(np.asarray, pruned)))
    assert list(got) == list(want)
    for name, w in got.items():
        np.testing.assert_array_equal(w.numpy(), np.asarray(want[name]))


# ---------------------------------------------------------------------------
# sparsify_params(plan=)
# ---------------------------------------------------------------------------

def test_plan_changes_sparsify_block_shapes():
    _, _, params = _port_model()
    base = _griffin_leaves(sparsify_params(params, 0.8, compact=True,
                                           **PRUNE))
    tuned = _griffin_leaves(sparsify_params(params, 0.8, compact=True,
                                            plan=_PLAN, **PRUNE))
    assert base and len(base) == len(tuned)
    assert all(g.block_k == 16 and g.block_n == 16 and g.a_thr is None
               for g in base)
    assert all(g.block_k == min(64, g.k) and g.block_n == min(64, g.n)
               and g.a_thr == 0.9 for g in tuned)
    # compaction moved, values did not
    for g, b in zip(tuned, base):
        k = min(g.k, b.k)
        assert torch.equal(_decompact_any(g)[..., :k, :],
                           _decompact_any(b)[..., :k, :])


@pytest.mark.parametrize("bk,thr", [(16, None), (32, 0.05), (64, 0.9)])
def test_plan_application_idempotent(bk, thr):
    rng = np.random.default_rng(7)
    params = {"layers": [
        {"wo": torch.from_numpy(rng.standard_normal((64, 64))
                                .astype(np.float32)),
         "w_up": torch.from_numpy(rng.standard_normal((64, 96))
                                  .astype(np.float32))}]}
    plan = FamilyPlan(family="x", rules=(
        GemmRule(match="*", block_k=bk, block_n=bk, unit=8,
                 a_threshold=thr),))
    kw = dict(block_k=16, block_n=16, unit=8)
    once = _griffin_leaves(sparsify_params(params, 0.7, plan=plan, **kw))
    twice = _griffin_leaves(sparsify_params(params, 0.7, plan=plan, **kw))
    assert len(once) == 2
    for a, b in zip(once, twice):
        assert (a.k, a.n, a.block_k, a.block_n, a.a_thr) == \
            (b.k, b.n, b.block_k, b.block_n, b.a_thr)
        assert a.block_k == bk and a.a_thr == thr
        for fa, fb in zip((a.b_comp, a.kidx, a.cnt, a.inv_perm),
                          (b.b_comp, b.kidx, b.cnt, b.inv_perm)):
            assert (fa is None) == (fb is None)
            if fa is not None:
                assert torch.equal(fa, fb)


def _assert_griffin_bitwise(jgw, tgw):
    for f in ("b_comp", "kidx", "cnt", "inv_perm"):
        ja, ta = getattr(jgw, f), getattr(tgw, f)
        assert (ja is None) == (ta is None), f
        if ja is not None:
            ja = np.asarray(ja)
            assert ja.shape == tuple(ta.shape), f
            np.testing.assert_array_equal(
                ja.view(np.uint8), bridge.tensor_to_array(ta).view(np.uint8),
                f)
    for f in ("k", "n", "block_k", "block_n", "a_thr"):
        assert getattr(jgw, f) == getattr(tgw, f), f


@pytest.mark.parametrize("plan", [
    _PLAN,
    FamilyPlan(family="dense", rules=(
        GemmRule(match="w_up", block_k=32, block_n=16, unit=16),
        GemmRule(match="*", block_k=16, block_n=64, a_threshold=0.05))),
    FamilyPlan(family="dense", rules=(GemmRule(match="wo", block_k=128),))],
    ids=["plan64", "mixed", "wo-only"])
def test_plan_compaction_bitwise_equal_reference(reference, plan):
    """Pure data movement: every compacted field equals the reference's
    bit for bit, leaf by leaf, under the same plan."""
    _, _, params, _ = reference
    from repro.tuning import FamilyPlan as JaxFamilyPlan
    from repro.tuning import GemmRule as JaxGemmRule
    jplan = JaxFamilyPlan(family=plan.family, rules=tuple(
        JaxGemmRule(**dataclasses.asdict(r)) for r in plan.rules))
    want = jax_sparsify(params, 0.8, compact=True, plan=jplan, **JAX_PRUNE)
    got = sparsify_params(bridge.to_torch(jax.tree.map(np.asarray, params)),
                          0.8, compact=True, plan=plan, **PRUNE)
    wl = {k: v for k, v in want["layers"].items()}
    gl = {k: v for k, v in got["layers"].items()
          if isinstance(v, GriffinWeights)}
    assert set(gl) == {k for k, v in wl.items()
                       if hasattr(v, "b_comp")} and len(gl) == 7
    for name in gl:
        _assert_griffin_bitwise(jax.tree.map(np.asarray, wl[name]), gl[name])


# ---------------------------------------------------------------------------
# engine thresholds
# ---------------------------------------------------------------------------

def test_family_threshold_changes_engine_select_mode():
    """The plan's a_threshold flips the engine's Mode decision (AB -> B
    under declared activation sparsity 0.5) and turns the dual kernels
    off, with token-identical output."""
    cfg, api, params = _port_model()
    sp = sparsify_params(params, 0.8, compact=True, **PRUNE)
    kw = dict(use_kernels=True, a_sparsity=0.5, decode_chunk=3)
    base = _engine(api, sp, **kw)
    assert base.mode == Mode.AB
    reset_kernel_dispatch()
    ref = _tokens(base.run(_trace(cfg)))
    assert kernel_dispatch_counts().get("dual", 0) > 0

    tuned = _engine(api, sp, plan=FamilyPlan(family=cfg.family,
                                             a_threshold=0.9), **kw)
    assert tuned.mode == Mode.B
    reset_kernel_dispatch()
    got = _tokens(tuned.run(_trace(cfg)))
    assert kernel_dispatch_counts().get("dual", 0) == 0
    assert got == ref


def test_per_gemm_a_thr_overrides_scope_threshold():
    """A rule-level a_threshold rides on the compacted weights and wins
    over the scope threshold in ``griffin_linear`` while the engine's
    Mode stays AB."""
    cfg, api, params = _port_model()
    fp = FamilyPlan(family=cfg.family,
                    rules=(GemmRule(match="*", a_threshold=0.9),))
    sp = sparsify_params(params, 0.8, compact=True, plan=fp, **PRUNE)
    assert all(g.a_thr == 0.9 for g in _griffin_leaves(sp))
    kw = dict(use_kernels=True, a_sparsity=0.5, decode_chunk=3)
    eng = _engine(api, sp, plan=fp, **kw)
    assert eng.mode == Mode.AB
    reset_kernel_dispatch()
    got = _tokens(eng.run(_trace(cfg)))
    assert kernel_dispatch_counts().get("dual", 0) == 0

    base = _engine(api, sparsify_params(params, 0.8, compact=True, **PRUNE),
                   **kw)
    reset_kernel_dispatch()
    ref = _tokens(base.run(_trace(cfg)))
    assert kernel_dispatch_counts().get("dual", 0) > 0
    assert got == ref


def test_family_b_threshold_reaches_engine():
    _, api, params = _port_model()
    sp = sparsify_params(params, 0.8, compact=True, **PRUNE)
    base = _engine(api, sp, use_kernels=True)
    assert base.mode == Mode.B
    plan = KernelPlan(families={"dense": FamilyPlan(family="dense",
                                                    b_threshold=0.999)})
    tuned = _engine(api, sp, plan=plan, use_kernels=True)
    assert tuned.plan.b_threshold == 0.999      # resolved by family
    assert tuned.b_sparsity == base.b_sparsity
    assert tuned.mode == Mode.DENSE
    # degraded (the router's level 2) still zeroes the B-side threshold
    tuned.set_degraded(True)
    assert tuned.mode == Mode.B


def test_engine_without_plan_keeps_default_thresholds():
    _, api, params = _port_model()
    sp = sparsify_params(params, 0.8, compact=True, **PRUNE)
    eng = _engine(api, sp, use_kernels=True)
    assert eng.plan is None
    assert eng._a_threshold == eng._b_threshold == 0.05
    assert _engine(api, sp, plan=KernelPlan(families={}),
                   use_kernels=True).plan is None


# ---------------------------------------------------------------------------
# token identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("compacted", [False, True],
                         ids=["dense", "sparseB"])
def test_tuned_vs_default_token_identity(compacted, chunk):
    cfg, api, params = _port_model()
    plan = dataclasses.replace(_PLAN, family=cfg.family)
    if compacted:
        base_p = sparsify_params(params, 0.8, compact=True, **PRUNE)
        tuned_p = sparsify_params(params, 0.8, compact=True, plan=plan,
                                  **PRUNE)
        kw = dict(use_kernels=True)
    else:
        base_p = tuned_p = sparsify_params(params, 0.8, compact=False,
                                           **PRUNE)
        kw = {}
    ref = _tokens(_engine(api, base_p, decode_chunk=chunk, **kw)
                  .run(_trace(cfg)))
    got = _tokens(_engine(api, tuned_p, plan=plan, decode_chunk=chunk, **kw)
                  .run(_trace(cfg)))
    assert got == ref, (compacted, chunk)
    assert all(len(t) > 0 for t in got.values())


def test_tuned_tokens_equal_reference(reference):
    """The reference's tuned engine (its kernels in interpret mode) and the
    port's, on the reference's weights compacted under the same plan by
    each package, serve the same tokens."""
    from repro.tuning import FamilyPlan as JaxFamilyPlan
    from repro.tuning import GemmRule as JaxGemmRule
    jcfg, japi, params, _ = reference
    jplan = JaxFamilyPlan(family="dense", a_threshold=0.9, rules=tuple(
        JaxGemmRule(**dataclasses.asdict(r)) for r in _PLAN.rules))
    jp = jax_sparsify(params, 0.8, compact=True, plan=jplan, **JAX_PRUNE)
    jeng = JaxServeEngine(japi, jp, config=JaxEngineConfig().with_fields(
        num_slots=4, cache_len=16, decode_chunk=3, use_kernels=True,
        interpret=True), plan=jplan)
    want = _tokens(jeng.run(jax_synthetic_trace(
        jcfg, num_requests=3, seed=3, prompt_lens=(4, 6), gen_lens=(3, 5),
        arrival_every=1)))

    cfg, api, _ = _port_model()
    tp = sparsify_params(bridge.to_torch(jax.tree.map(np.asarray, params)),
                         0.8, compact=True, plan=_PLAN, **PRUNE)
    eng = _engine(api, tp, plan=_PLAN, use_kernels=True, decode_chunk=3)
    got = _tokens(eng.run(_trace(cfg)))
    assert got == want
    assert eng.mode.value == jeng.mode.value


# ---------------------------------------------------------------------------
# scores
# ---------------------------------------------------------------------------

@pytest.fixture
def reference_roofline(monkeypatch):
    """The port's roofline at the reference's peak and bandwidth."""
    monkeypatch.setattr(roofline, "PEAK_FLOPS", jax_roofline.PEAK_FLOPS)
    monkeypatch.setattr(roofline, "HBM_BW", jax_roofline.HBM_BW)


@pytest.mark.parametrize("bk,bn", [(16, 16), (32, 32), (64, 64), (16, 64),
                                   (128, 32)])
def test_compaction_stats_equal_reference(reference, bk, bn):
    _, _, _, pruned = reference
    jl = jax_gemm_leaves(pruned)
    tl = gemm_leaves(bridge.to_torch(jax.tree.map(np.asarray, pruned)))
    for name in jl:
        assert compaction_stats(tl[name], bk, bn) == \
            jax_compaction_stats(np.asarray(jl[name]), bk, bn), name


def _close(a, b):
    assert abs(a - b) <= REL * abs(b), (a, b)


def test_predict_scores_equal_reference(reference, caches,
                                        reference_roofline):
    _, _, _, pruned = reference
    jl = jax_gemm_leaves(pruned)
    tl = gemm_leaves(bridge.to_torch(jax.tree.map(np.asarray, pruned)))
    shapes = {k: tuple(w.shape) for k, w in tl.items()}
    port_cache, ref_cache = caches
    got = predict_scores(enumerate_candidates(shapes, 16), tl, batch=4,
                         cache=port_cache, seed=0, step_overhead=REF_STEP)
    want = jax_predict_scores(jax_enumerate(shapes, 16), jl, batch=4,
                              cache=ref_cache, seed=0,
                              step_overhead=REF_STEP)
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        assert (g["dse_speedup"], g["grid_steps"]) == \
            (w["dse_speedup"], w["grid_steps"]), g["name"]
        for key in ("bound_s", "predicted_s", "score"):
            _close(g[key], w[key])
    assert [r["name"] for r in shortlist(got, 3)] == \
        [r["name"] for r in shortlist(want, 3)]


def test_committed_plan_predicted_table(reference, caches,
                                        reference_roofline):
    """The committed plan's dense ``predicted`` table comes out of the
    port's scoring on the same weights at the reference's step cost."""
    _, _, _, pruned = reference
    table = load_plan(str(COMMITTED_PLAN)).family("dense").predicted
    tl = gemm_leaves(bridge.to_torch(jax.tree.map(np.asarray, pruned)))
    cands = [c for c in enumerate_candidates(
        {k: tuple(w.shape) for k, w in tl.items()}, 16) if c.name in table]
    assert len(cands) == len(table) == 3
    rows = predict_scores(cands, tl, batch=4, cache=caches[0], seed=0,
                          step_overhead=REF_STEP)
    for r in rows:
        want = table[r["name"]]
        assert (r["dse_speedup"], r["grid_steps"]) == (2.8257, 10)
        assert (r["dse_speedup"], r["grid_steps"]) == \
            (want["dse_speedup"], want["grid_steps"])
        assert round(r["score"], 6) == want["score"] == 1412.688287
        _close(r["predicted_s"], want["predicted_s"])


def test_step_overhead_keys_on_the_device():
    assert step_overhead_for(torch.device("cpu")) == REF_STEP
    assert step_overhead_for("cuda") == search.STEP_OVERHEAD_HW
    assert search.STEP_OVERHEAD_HW is not None and \
        0 < search.STEP_OVERHEAD_HW < REF_STEP


def test_roofline_constants_are_the_cards():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    s = roofline.CostSample(flops=989e12, bytes_accessed=6.7e12, coll={})
    t = roofline.roofline_terms(s, model_flops=494.5e12, chips=1)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 2.0, 0.0)
    assert t.dominant == "memory" and t.bound_s == 2.0
    assert t.useful_ratio == 0.5 and t.roofline_fraction == 0.25
    f = roofline.extrapolate(
        roofline.CostSample(1.0, 2.0, {"a": 1.0}),
        roofline.CostSample(3.0, 5.0, {"a": 2.0, "b": 1.0}), 4)
    assert (f.flops, f.bytes_accessed, f.coll) == \
        (7.0, 11.0, {"a": 4.0, "b": 3.0})
    assert roofline.model_flops_for("decode", 10, 2, 99) == 40.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shortlist_and_winner_deterministic(seed):
    rng = np.random.default_rng(seed)
    names = [f"c{i}" for i in range(10)]
    table = {n: float(rng.integers(0, 5)) for n in names}   # forced ties
    rows = [{"name": n, "score": s} for n, s in table.items()]
    perm = [rows[i] for i in rng.permutation(len(rows))]
    assert [r["name"] for r in shortlist(perm, 4)] == \
        [r["name"] for r in shortlist(rows, 4)]
    winner = select_best(table)
    shuffled = {n: table[n] for n in rng.permutation(names)}
    assert select_best(shuffled) == winner
    assert winner == sorted(n for n in names
                            if table[n] == max(table.values()))[0]


# ---------------------------------------------------------------------------
# workload and CLIs
# ---------------------------------------------------------------------------

def test_tuning_workload_families():
    assert prune_for(True) == PRUNE == JAX_PRUNE
    assert prune_for(False) == PRUNE_FULL == dict(block_k=128, block_n=128,
                                                  unit=32)
    cfg, api, params, cache_len, trace = tuning_workload(
        "dense", reduced=True, device="cpu")
    assert (cfg.d_model, api.device.type, cache_len) == (64, "cpu", 27)
    reqs = trace()
    assert len(reqs) == 6 and [r.arrival for r in reqs] == list(range(6))
    cfg, api, params, cache_len, trace = tuning_workload(
        "vlm", reduced=True, device="cpu")
    assert (cfg.family, cfg.qk_norm, api.device.type) == ("vlm", True, "cpu")
    assert params["layers"]["qn"].shape == params["layers"]["kn"].shape == \
        (2, 16)
    # the moe, audio and vlm families are served since their ports
    # (tests/test_torch_moe.py, tests/test_torch_whisper.py,
    # tests/test_torch_chameleon.py)
    assert tuning_workload("moe", reduced=True,
                           device="cpu")[0].family == "moe"
    cfg, api, params, cache_len, trace = tuning_workload(
        "audio", reduced=True, device="cpu")
    assert (cfg.family, api.device.type, cache_len) == ("audio", "cpu", 27)
    assert all(r.extras["frames"].shape == (8, 64) for r in trace())
    assert params["dec_layers"]["cross"]["wk"].shape == (2, 64, 64)


def test_autotune_cli_writes_plan_that_reloads(tmp_path, caches, capsys):
    out = tmp_path / "plan.json"
    autotune_cli.main(["--reduced", "--device", "cpu", "--budget", "4",
                       "--shortlist", "2", "--repeats", "1", "--out",
                       str(out), "--cache-dir", caches[0].path])
    text = capsys.readouterr().out
    assert "tokens identical to default" in text
    assert "kernel plan ->" in text
    plan = load_plan(str(out))
    fam = plan.family("dense")
    assert plan.meta["tool"] == "repro_torch.launch.autotune"
    assert fam.measured["winner"] in fam.predicted
    assert len(fam.predicted) == 2 and fam.rules[0].match == "*"
    # the reference reads the port's plan
    jfam = jax_load_plan(str(out)).family("dense")
    assert dataclasses.asdict(jfam.rules[0]) == \
        dataclasses.asdict(fam.rules[0])


def test_autotune_cli_defaults():
    assert autotune_cli.DEFAULT_OUT == "chiprun_out/kernel_plan_torch.json"
    assert not autotune_cli.DEFAULT_OUT.startswith("benchmarks")


@pytest.mark.parametrize("replicas", [0, 2])
def test_serve_cli_with_committed_plan_parity(capsys, replicas):
    launch_serve.main(["--reduced", "--device", "cpu", "--use-kernels",
                       "--requests", "4", "--plan", str(COMMITTED_PLAN),
                       "--replicas", str(replicas), "--parity"])
    out = capsys.readouterr().out
    assert "parity OK" in out


def test_serve_applies_plan_from_config_file(tmp_path):
    conf = tmp_path / "engine.json"
    conf.write_text(json.dumps({"kernels": {"use_kernels": True,
                                            "plan": str(COMMITTED_PLAN)}}))
    econf = EngineConfig.from_json(conf.read_text())
    assert econf.kernels.plan == str(COMMITTED_PLAN)
    run = launch_serve.serve(reduced=True, device="cpu", requests=3,
                             config=econf)
    leaves = _griffin_leaves(run.params)
    assert leaves and all(g.block_k == 64 and g.a_thr == 0.05
                          for g in leaves)
    assert run.engine.plan.family == "dense"
    assert run.engine._a_threshold == 0.05
    assert launch_serve.check_parity(run) == 3


def test_serve_plan_without_family_entry_serves_defaults(tmp_path, capsys):
    path = tmp_path / "plan.json"
    KernelPlan(families={"ssm": FamilyPlan(family="ssm")}).save(str(path))
    econf = EngineConfig().with_fields(use_kernels=True, plan=str(path))
    run = launch_serve.serve(reduced=True, device="cpu", requests=2,
                             config=econf)
    assert "no entry for family 'dense'" in capsys.readouterr().out
    assert run.engine.plan is None
    assert all(g.block_k == 16 for g in _griffin_leaves(run.params))
