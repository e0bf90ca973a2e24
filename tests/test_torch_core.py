"""The port's cycle model and DSE engine (``repro_torch.core``) against the
JAX package's (``repro.core``): the same numpy inputs, from seeds, through
both packages give equal results — integers exactly, floats to the bit
(both are the same numpy arithmetic), the Figure 8 sweep within |rel| 1e-12.
Nothing here needs a card.
"""
import dataclasses
import importlib
import pathlib
import sys

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from repro.core import (analytical as r_an, dse as r_dse, evaluate as r_ev,
                        functional as r_fn, hybrid as r_hy, overhead as r_ov,
                        scheduler as r_sc, spec as r_sp, workloads as r_wl)
from repro_torch.core import (analytical as p_an, dse as p_dse,
                              evaluate as p_ev, functional as p_fn,
                              hybrid as p_hy, overhead as p_ov,
                              scheduler as p_sc, spec as p_sp,
                              workloads as p_wl)

# the packages export a function of the module's name
r_eff = importlib.import_module("repro.core.efficiency")
p_eff = importlib.import_module("repro_torch.core.efficiency")

ROOT = pathlib.Path(__file__).resolve().parent.parent
NAMED = ["DENSE_BASELINE", "SPARSE_B_STAR", "SPARSE_A_STAR", "SPARSE_AB_STAR",
         "GRIFFIN", "TCL_B", "TDASH_AB", "SPARTEN_AB", "SPARTEN_A",
         "SPARTEN_B", "CAMBRICON_X", "CNVLUTIN"]
# the Figure 8 design list (benchmarks/fig8_overall.py)
FIG8 = ["DENSE_BASELINE", "SPARSE_B_STAR", "TCL_B", "SPARSE_A_STAR",
        "SPARSE_AB_STAR", "GRIFFIN", "TDASH_AB", "SPARTEN_AB"]
MODES = ["dense", "B", "A", "AB"]
# (package, spec) pairs built the same way in both
SPEC_ARGS = [("b", (4, 0, 1)), ("b", (2, 1, 0)), ("a", (2, 1, 0)),
             ("a", (1, 0, 1)), ("ab", (2, 0, 0, 2, 0, 1)),
             ("ab", (1, 1, 0, 3, 0, 2))]
WINDOW_CONFIGS = [(0, 0, 0, False), (2, 1, 0, False), (4, 0, 2, True),
                  (1, 2, 1, True), (8, 3, 2, False), (3, 0, 0, True),
                  (15, 0, 0, False)]


def plain(x):
    """A result as plain Python data, whichever package made it."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return x.tolist()
    if hasattr(x, "value") and hasattr(x, "name"):      # a Mode
        return x.value
    return x


def specs(pkg_spec, with_named=True):
    """The named designs and SPEC_ARGS from one package's spec module."""
    ctor = {"a": pkg_spec.sparse_a, "b": pkg_spec.sparse_b,
            "ab": pkg_spec.sparse_ab}
    out = [ctor[kind](*args, shuffle=bool(i % 2))
           for i, (kind, args) in enumerate(SPEC_ARGS)]
    if with_named:
        out += [getattr(pkg_spec, n) for n in NAMED if n != "GRIFFIN"]
    return out


def tiny_wl(ev):
    """The reference tests' TINY_WL (tests/test_batched_parity.py)."""
    return ev.Workload("tiny", (ev.GemmShape(24, 96, 40),
                                ev.GemmShape(8, 64, 32),
                                ev.GemmShape(16, 48, 16, b_static=False)),
                       a_sparsity=0.5, b_sparsity=0.8)


def test_exports_and_spec_module_equal():
    assert P.__all__ == R.__all__
    assert plain(P.PRESETS) == plain(R.PRESETS)
    assert plain(p_sp.CoreConfig()) == plain(r_sp.CoreConfig())
    assert p_sp.CoreConfig().dense_tops == r_sp.CoreConfig().dense_tops
    assert [m.value for m in p_sp.Mode] == [m.value for m in r_sp.Mode]
    assert p_sp.SPARTEN_DEPTH == r_sp.SPARTEN_DEPTH
    for name in NAMED:
        p, r = getattr(p_sp, name), getattr(r_sp, name)
        assert plain(p) == plain(r), name
        for mode in MODES:
            if name == "GRIFFIN":
                got, want = p.spec_for(p_sp.Mode(mode)), \
                    r.spec_for(r_sp.Mode(mode))
            else:
                got, want = p.degrade_to(p_sp.Mode(mode)), \
                    r.degrade_to(r_sp.Mode(mode))
                assert p.label() == r.label()
            assert plain(got) == plain(want) and got.label() == want.label()
    for p, r in zip(specs(p_sp), specs(r_sp)):
        assert plain(p) == plain(r) and p.label() == r.label()
        assert (p.supports_a, p.supports_b) == (r.supports_a, r.supports_b)


@pytest.mark.parametrize("name", NAMED)
@pytest.mark.parametrize("k0", [16, 32])
def test_cost_model_equal_for_every_named_design(name, k0):
    """``structure``, ``power_area``, ``efficiency`` and ``sparsity_tax``."""
    p, r = getattr(p_sp, name), getattr(r_sp, name)
    pc, rc = p_sp.CoreConfig(k0=k0), r_sp.CoreConfig(k0=k0)
    base_p = p.base if name == "GRIFFIN" else p
    base_r = r.base if name == "GRIFFIN" else r
    assert plain(p_ov.structure(base_p, pc)) == \
        plain(r_ov.structure(base_r, rc))
    assert plain(p_ov.power_area(p, pc)) == plain(r_ov.power_area(r, rc))
    for sp in (1.0, 1.7, 4.6730856363236315):
        pe, re_ = p_eff.efficiency(p, sp, pc), r_eff.efficiency(r, sp, rc)
        assert plain(pe) == plain(re_)
        assert (pe.tops_w, pe.tops_mm2) == (re_.tops_w, re_.tops_mm2)
    assert p_eff.sparsity_tax(p, pc) == r_eff.sparsity_tax(r, rc)


def test_cost_and_workload_tables_equal():
    assert p_ov.TABLE_VII_TOTALS == r_ov.TABLE_VII_TOTALS
    assert p_ov.SPARTEN_COSTS == r_ov.SPARTEN_COSTS
    assert plain(p_ov.DEFAULT_COST_MODEL) == plain(r_ov.DEFAULT_COST_MODEL)
    assert plain(p_wl.TABLE_IV) == plain(r_wl.TABLE_IV)
    core_p, core_r = p_sp.CoreConfig(), r_sp.CoreConfig()
    assert [(w.name, w.dense_cycles(core_p)) for w in p_wl.paper_workloads()] \
        == [(w.name, w.dense_cycles(core_r)) for w in r_wl.paper_workloads()]
    for mode in MODES:
        assert plain(p_wl.category_workloads(p_sp.Mode(mode))) == \
            plain(r_wl.category_workloads(r_sp.Mode(mode)))


@pytest.mark.parametrize("mode", MODES)
def test_gemm_cycles_equal_integers(mode):
    """``gemm_cycles`` and ``gemm_cycles_batched`` on ``MaskModel`` masks:
    the same masks from the same seeds, equal (dense, sparse) cycles, and
    the port's batched twin equal to its scalar path."""
    masks = []
    for ev in (p_ev, r_ev):
        mm, rng = ev.MaskModel(), np.random.default_rng(3)
        masks.append((mm.act_mask(32, 128, 0.5, rng),
                      mm.weight_mask(128, 48, 0.25, rng)))
    np.testing.assert_array_equal(masks[0][0], masks[1][0])
    np.testing.assert_array_equal(masks[0][1], masks[1][1])
    a_mask, b_mask = masks[0]
    got = p_ev.gemm_cycles_batched(specs(p_sp), p_sp.Mode(mode), a_mask,
                                   b_mask, p_sp.CoreConfig(),
                                   np.random.default_rng(7))
    want = r_ev.gemm_cycles_batched(specs(r_sp), r_sp.Mode(mode), a_mask,
                                    b_mask, r_sp.CoreConfig(),
                                    np.random.default_rng(7))
    assert [(g.dense, g.sparse) for g in got] == \
        [(w.dense, w.sparse) for w in want]
    for spec, g, w in zip(specs(p_sp), got, want):
        one = p_ev.gemm_cycles(spec, p_sp.Mode(mode), a_mask, b_mask,
                               p_sp.CoreConfig(), np.random.default_rng(7))
        assert (one.dense, one.sparse) == (w.dense, w.sparse), spec.label()


def test_scheduler_equal():
    """The engine's entry points: per-row configs with placements, per-row
    stream lengths, the static packing bound and the SparTen model."""
    rng = np.random.default_rng(7)
    mask = rng.random((5, 23, 8, 3)) < 0.35
    big = np.concatenate([mask] * len(WINDOW_CONFIGS), axis=0)
    cfg = [np.repeat([c[i] for c in WINDOW_CONFIGS], 5) for i in range(4)]
    for rec in (False, True):
        got = p_sc.schedule_batched(big, *cfg[:3], shuffle=cfg[3],
                                    record=rec)
        want = r_sc.schedule_batched(big, *cfg[:3], shuffle=cfg[3],
                                     record=rec)
        assert plain(got) == plain(want)
    lens = rng.integers(1, 24, size=40)
    rows = rng.random((40, 23, 8, 2)) < 0.3
    np.testing.assert_array_equal(
        p_sc.schedule_batched(rows, 2, 1, 0, t_len=lens).cycles,
        r_sc.schedule_batched(rows, 2, 1, 0, t_len=lens).cycles)
    pack = rng.random((11, 48, 16, 2)) < 0.2
    np.testing.assert_array_equal(
        p_sc.static_pack_cycles_batched(pack, *cfg[:3], shuffle=cfg[3]),
        r_sc.static_pack_cycles_batched(pack, *cfg[:3], shuffle=cfg[3]))
    counts = rng.integers(0, 40, size=(70, 45))
    np.testing.assert_array_equal(p_sc.sparten_tile_cycles(counts),
                                  r_sc.sparten_tile_cycles(counts))
    np.testing.assert_array_equal(p_sc.shuffle_lanes(mask),
                                  r_sc.shuffle_lanes(mask))
    assert p_sc._offsets(2, 3) == r_sc._offsets(2, 3)
    assert p_sc.dense_cycles(17) == r_sc.dense_cycles(17)


@pytest.mark.parametrize("mode", ["B", "A", "AB"])
def test_network_speedup_and_sweep_rows_equal_on_tiny_wl(mode, monkeypatch):
    """``network_speedup_batched``, the hybrid entry points and ``sweep``
    rows (its category swapped for TINY_WL in both packages)."""
    pw, rw = tiny_wl(p_ev), tiny_wl(r_ev)
    pm, rm = p_sp.Mode(mode), r_sp.Mode(mode)
    core_p, core_r = p_sp.CoreConfig(), r_sp.CoreConfig()
    got = p_ev.network_speedup_batched(specs(p_sp, False), pw, core_p,
                                       seed=11, mode=pm)
    want = r_ev.network_speedup_batched(specs(r_sp, False), rw, core_r,
                                        seed=11, mode=rm)
    np.testing.assert_array_equal(got, want)
    assert p_ev.network_speedup(p_sp.SPARSE_AB_STAR, pw, core_p, seed=2,
                                mode=pm) == \
        r_ev.network_speedup(r_sp.SPARSE_AB_STAR, rw, core_r, seed=2,
                             mode=rm)
    assert plain(p_hy.running_spec(p_sp.GRIFFIN, pm)) == \
        plain(r_hy.running_spec(r_sp.GRIFFIN, rm))
    assert p_hy.design_speedup(p_sp.GRIFFIN, pw, core_p, seed=4, mode=pm) == \
        r_hy.design_speedup(r_sp.GRIFFIN, rw, core_r, seed=4, mode=rm)
    designs_p = [p_sp.GRIFFIN] + specs(p_sp, False)
    designs_r = [r_sp.GRIFFIN] + specs(r_sp, False)
    np.testing.assert_array_equal(
        p_hy.category_design_speedup_batched(designs_p, [pw], core_p,
                                             seed=4, mode=pm),
        r_hy.category_design_speedup_batched(designs_r, [rw], core_r,
                                             seed=4, mode=rm))
    monkeypatch.setattr(p_dse, "category_workloads", lambda m: [pw])
    monkeypatch.setattr(r_dse, "category_workloads", lambda m: [rw])
    rows = p_dse.sweep(designs_p, pm, core_p, seed=4)
    assert rows == r_dse.sweep(designs_r, rm, core_r, seed=4)
    assert rows[:2] == [p_dse.score(d, pm, core_p, seed=4)
                        for d in designs_p[:2]]


def test_select_mode_equal():
    for a in (0.0, 0.04, 0.05, 0.3):
        for b in (0.0, 0.06, 0.8):
            for b_thr in (None, 0.5):
                assert p_hy.select_mode(a, b, b_threshold=b_thr).value == \
                    r_hy.select_mode(a, b, b_threshold=b_thr).value
    assert p_hy.SPARSE_THRESHOLD == r_hy.SPARSE_THRESHOLD


def test_enumerators_and_pareto_equal():
    for fn in ("enumerate_sparse_a", "enumerate_sparse_b",
               "enumerate_sparse_ab"):
        got, want = getattr(p_dse, fn)(), getattr(r_dse, fn)()
        assert plain(got) == plain(want) and len(got) > 10
    rng = np.random.default_rng(5)
    x = rng.random(60)
    rows = [{"design": str(i), "tops_w": float(a), "tops_mm2": float(b)}
            for i, (a, b) in enumerate(zip(x, 1 - x + 0.3 * rng.random(60)))]
    got = p_dse.pareto(rows, "tops_w", "tops_mm2")
    assert got == r_dse.pareto(rows, "tops_w", "tops_mm2") and len(got) > 1


@pytest.mark.parametrize("cfg", [(1, 0, 0, False), (4, 0, 1, False),
                                 (2, 1, 1, False), (8, 0, 1, True),
                                 (4, 0, 1, True)])
def test_execute_b_sparse_exact(cfg):
    """Executing the Sparse.B schedule reproduces A @ B (as the reference
    asserts), op for op what the reference executes."""
    rng = np.random.default_rng(sum(cfg[:3]))
    a = rng.standard_normal((8, 48))
    b = rng.standard_normal((48, 24)) * (rng.random((48, 24)) < 0.3)
    c, ops = p_fn.execute_b_sparse(a, b, p_sp.sparse_b(*cfg[:3],
                                                       shuffle=cfg[3]))
    np.testing.assert_allclose(c, a @ b, rtol=1e-12, atol=1e-12)
    assert ops == (b != 0).sum()
    c_ref, ops_ref = r_fn.execute_b_sparse(a, b, r_sp.sparse_b(
        *cfg[:3], shuffle=cfg[3]))
    np.testing.assert_array_equal(c, c_ref)
    assert ops == ops_ref


@pytest.mark.parametrize("density", [0.1, 0.4])
@pytest.mark.parametrize("cfg", [(2, 0, 0, False), (4, 0, 1, True),
                                 (8, 0, 1, True)])
def test_analytical_verify_equal(density, cfg):
    rng = np.random.default_rng(0)
    mask = p_ev.MaskModel().weight_mask(512, 128, density, rng)
    got = p_an.verify(p_sp.sparse_b(*cfg[:3], shuffle=cfg[3]), mask)
    want = r_an.verify(r_sp.sparse_b(*cfg[:3], shuffle=cfg[3]), mask)
    assert (got.predicted, got.simulated) == (want.predicted, want.simulated)
    assert 0.55 < got.ratio < 1.8


def test_results_cache_recomputes_a_corrupt_entry(tmp_path):
    cache = p_dse.ResultsCache(str(tmp_path / "cache"))
    designs = [p_sp.SPARSE_B_STAR]
    core = p_sp.CoreConfig()
    cold = p_dse.sweep(designs, p_sp.Mode.DENSE, core, seed=1, cache=cache)
    assert (cache.hits, cache.misses) == (0, 1)
    files = list((tmp_path / "cache").iterdir())
    assert len(files) == 1
    files[0].write_text("{not json")
    again = p_dse.sweep(designs, p_sp.Mode.DENSE, core, seed=1, cache=cache)
    assert again == cold and cache.misses == 2
    warm = p_dse.sweep(designs, p_sp.Mode.DENSE, core, seed=1, cache=cache)
    assert warm == cold and cache.hits == 1     # repaired in place


def test_port_cache_keys_and_directory_are_its_own():
    """The digest hashes the port's own sources, so a port row never
    reuses a reference cache entry; the default directory is the port's."""
    assert p_dse._model_digest() != r_dse._model_digest()
    for name in ("SPARSE_B_STAR", "GRIFFIN"):
        args = (p_sp.Mode.B, p_sp.CoreConfig(), 1, p_ev.DEFAULT_MASK_MODEL)
        rargs = (r_sp.Mode.B, r_sp.CoreConfig(), 1, r_ev.DEFAULT_MASK_MODEL)
        assert p_dse.design_fingerprint(getattr(p_sp, name), *args) != \
            r_dse.design_fingerprint(getattr(r_sp, name), *rargs)
    default = pathlib.Path(p_dse.ResultsCache().path)
    assert default == (ROOT / "build" / "repro_torch_dse_cache").resolve()
    assert "benchmarks" not in default.parts


def test_figure8_sweep_equals_reference_and_chip_smoke_rows():
    """The paper's Figure 8 sweep (benchmarks/fig8_overall.py: its design
    list, the four modes, CoreConfig(), seed 4, no cache) through both
    packages: equal rows, and equal to the constants chip_smoke.py holds
    the card's run to."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    got, want = {}, {}
    for mode in MODES:
        for out, dse, sp in ((got, p_dse, p_sp), (want, r_dse, r_sp)):
            for row in dse.sweep([getattr(sp, n) for n in FIG8],
                                 sp.Mode(mode), sp.CoreConfig(), seed=4):
                out[(row["design"], row["mode"])] = row
    assert got == want
    assert set(got) == set(chip_smoke.FIG8_ROWS)
    for key, const in chip_smoke.FIG8_ROWS.items():
        for field, c in zip(("speedup", "tops_w", "tops_mm2"), const):
            assert abs(got[key][field] - c) <= chip_smoke.FIG8_REL_TOL * \
                abs(c), (key, field)
    assert chip_smoke.fig8_designs() == [getattr(p_sp, n) for n in FIG8]
