"""Hardware overhead and 7nm power/area model (paper Table II, IV-A, VII).

Structural quantities (buffer depths, MUX fan-ins, adder trees, control
units) follow the paper's closed-form formulas exactly.  The translation to
milliwatts / kilo-um^2 uses per-unit costs fitted once against the paper's
own synthesis results (Table VII, Synopsys DC, 7nm, 800 MHz, 0.71 V); the
fit residuals are reported by ``benchmarks/table7_breakdown.py``.  SparTen's
microarchitecture (MAC-per-output, 128-deep prefix-sum buffers, no shared
accumulators) is outside this structural family, so its costs are taken from
Table VII directly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

from .spec import (CoreConfig, HybridSpec, Mode, SparseSpec, GRIFFIN,
                   SPARTEN_AB, SPARTEN_A, SPARTEN_B)


@dataclasses.dataclass(frozen=True)
class Structure:
    """Structural overheads of a design point (units: words / inputs / units)."""

    abuf_depth: int = 1
    bbuf_depth: int = 0
    abuf_words: int = 0           # total buffer words beyond the dense core
    bbuf_words: int = 0
    amux_fanin: int = 1
    bmux_fanin: int = 1
    amux_inputs: int = 0          # total extra mux inputs, all muxes
    bmux_inputs: int = 0
    extra_adders_per_pe: int = 0
    ctrl_units: int = 0           # per-PE controllers (dual) / per-row arbiters
    shuffler: bool = False
    dual: bool = False
    a_window: int = 1             # 1 + da1 (SRAM banking for B-side fetch)
    b_window: int = 1             # 1 + db1 (SRAM banking for A-side fetch)


def structure(spec: SparseSpec, core: CoreConfig) -> Structure:
    """Table II (single sparse) and Section IV-A (dual) structural formulas."""
    k0, n0, m0 = core.k0, core.n0, core.m0
    a1, a2, a3 = spec.a_window
    b1, b2, b3 = spec.b_window
    use_a, use_b = spec.supports_a, spec.supports_b
    if use_a and use_b:
        L = (1 + a1) * (1 + b1)
        abuf_depth, bbuf_depth = L, 1 + b1
        amux_fanin = 1 + (L - 1) * (1 + a2 + b2) * (1 + a3)
        bmux_fanin = 1 + a1 * (1 + a2)
        extra_adders = max(a3, b3, a3 * b3)
        ctrl = n0 * m0                       # per-PE zero-mask/arbiter logic
    elif use_b:
        abuf_depth, bbuf_depth = 1 + b1, 0
        amux_fanin = (1 + b1) * (1 + b2)
        bmux_fanin = 1
        extra_adders = b3
        ctrl = 0                             # metadata-driven, no arbiter
    elif use_a:
        abuf_depth, bbuf_depth = 1 + a1, 1 + a1
        amux_fanin = (1 + a1) * (1 + a2) * (1 + a3)
        bmux_fanin = (1 + a1) * (1 + a2)
        extra_adders = a3
        ctrl = m0                            # one arbiter per PE row
    else:
        return Structure(shuffler=spec.shuffle)
    abuf_words = max(abuf_depth - 1, 0) * k0 * m0
    bbuf_words = bbuf_depth * k0 * n0 if bbuf_depth else 0
    # AMUX shared per (lane, column) across the M0 rows; BMUX shared per
    # (lane, row) across columns (Section III).
    amux_inputs = (amux_fanin - 1) * k0 * n0
    bmux_inputs = (bmux_fanin - 1) * k0 * m0
    return Structure(
        abuf_depth=abuf_depth, bbuf_depth=bbuf_depth,
        abuf_words=abuf_words, bbuf_words=bbuf_words,
        amux_fanin=amux_fanin, bmux_fanin=bmux_fanin,
        amux_inputs=amux_inputs, bmux_inputs=bmux_inputs,
        extra_adders_per_pe=extra_adders, ctrl_units=ctrl,
        shuffler=spec.shuffle, dual=use_a and use_b,
        a_window=1 + a1, b_window=1 + b1)


# ---------------------------------------------------------------------------
# power / area translation (fitted to Table VII; see module docstring)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CostModel:
    # dense core (Table VII baseline row)
    base_power_datapath: float = 118.1   # REG/WR + ACC + MUL + ADT (mW)
    base_power_sram: float = 33.3
    base_area_datapath: float = 41.5     # k-um^2
    base_area_sram: float = 176.0
    # fitted unit costs
    buf_uw_per_word: float = 23.4        # buffer power  (uW / word)
    buf_um2_per_word: float = 6.0        # buffer area   (um^2 / word)
    dual_buf_power: float = 1.2          # extra ports in the dual pipeline
    dual_buf_area: float = 2.6
    mux_uw_per_input: float = 3.4
    mux_um2_per_input: float = 6.3
    ctrl_mw_per_unit: float = 0.071      # per-PE controller (dual)
    ctrl_um2_per_unit: float = 0.032
    arb_mw_per_unit: float = 0.30        # per-row arbiter (Sparse.A)
    arb_um2_per_unit: float = 0.17
    adt_mw_per_tree: float = 0.085       # extra adder tree, per PE
    adt_um2_per_tree: float = 0.022
    shf_mw: float = 1.0                  # shuffler (<=1% of dense, Section VI-E)
    shf_um2: float = 1.3
    reg_mw_per_word: float = 18.0e-3     # pipeline regs scale with buffering
    # SRAM banking for windowed fetch (fitted: gamma_a from Sparse.A*,
    # gamma_b from Sparse.B*; cross-checked on Sparse.AB* within 3%)
    gamma_a: float = 0.67
    gamma_b: float = 0.25


DEFAULT_COST_MODEL = CostModel()

# SparTen costs measured by the paper (Table VII): (power mW, area k-um^2).
SPARTEN_COSTS = {"SparTen.AB": (991.0, 1139.0),
                 "SparTen.A": (700.0, 800.0),   # one-sided: ~70% of dual
                 "SparTen.B": (700.0, 800.0)}


@dataclasses.dataclass(frozen=True)
class PowerArea:
    power_mw: float
    area_kum2: float
    breakdown_power: Dict[str, float]
    breakdown_area: Dict[str, float]


def power_area(design: Union[SparseSpec, HybridSpec],
               core: CoreConfig = CoreConfig(),
               cm: CostModel = DEFAULT_COST_MODEL) -> PowerArea:
    """Total power/area of the *physical* design point.

    For a hybrid, the physical hardware is the dual-sparse base plus the
    morphing extras (wider metadata path, one global arbiter per row, larger
    BMUX fan-in — paper Table III): Griffin costs ~2 mW / ~4 k-um^2 over
    Sparse.AB* in Table VII.
    """
    hybrid_extra_p, hybrid_extra_a = 0.0, 0.0
    if isinstance(design, HybridSpec):
        base = design.base
        sa = structure(design.conf_a, core)
        sab = structure(base, core)
        # conf.A needs BMUX fan-in 5 vs 3 (Table III): extra mux inputs, plus
        # one global arbiter per row.
        extra_inputs = max(0, (sa.bmux_fanin - sab.bmux_fanin)) * core.k0 * core.m0
        hybrid_extra_p = extra_inputs * cm.mux_uw_per_input * 1e-3 + \
            core.m0 * cm.arb_mw_per_unit
        hybrid_extra_a = extra_inputs * cm.mux_um2_per_input * 1e-3 + \
            core.m0 * cm.arb_um2_per_unit
        spec = base
    else:
        spec = design
    if spec.name in SPARTEN_COSTS:
        p, a = SPARTEN_COSTS[spec.name]
        return PowerArea(p, a, {"total(paper)": p}, {"total(paper)": a})

    s = structure(spec, core)
    bp = cm.dual_buf_power if s.dual else 1.0
    ba = cm.dual_buf_area if s.dual else 1.0
    words = s.abuf_words + s.bbuf_words
    p_buf_a = s.abuf_words * cm.buf_uw_per_word * bp * 1e-3
    p_buf_b = s.bbuf_words * cm.buf_uw_per_word * bp * 1e-3
    p_mux = (s.amux_inputs + s.bmux_inputs) * cm.mux_uw_per_input * 1e-3
    p_ctrl = (s.ctrl_units * (cm.ctrl_mw_per_unit if s.dual
                              else cm.arb_mw_per_unit))
    p_adt = s.extra_adders_per_pe * core.n0 * core.m0 * cm.adt_mw_per_tree
    p_shf = cm.shf_mw if s.shuffler else 0.0
    p_reg = words * cm.reg_mw_per_word
    p_sram = cm.base_power_sram * (1 + cm.gamma_a * (s.a_window - 1) +
                                   cm.gamma_b * (s.b_window - 1))
    p_total = (cm.base_power_datapath + p_reg + p_buf_a + p_buf_b + p_mux +
               p_ctrl + p_adt + p_shf + p_sram)

    a_buf_a = s.abuf_words * cm.buf_um2_per_word * ba * 1e-3
    a_buf_b = s.bbuf_words * cm.buf_um2_per_word * (1.0 if not s.dual else 1.4) * 1e-3
    a_mux = (s.amux_inputs + s.bmux_inputs) * cm.mux_um2_per_input * 1e-3
    a_ctrl = s.ctrl_units * (cm.ctrl_um2_per_unit if s.dual
                             else cm.arb_um2_per_unit)
    a_adt = s.extra_adders_per_pe * core.n0 * core.m0 * cm.adt_um2_per_tree
    a_shf = cm.shf_um2 if s.shuffler else 0.0
    a_sram = cm.base_area_sram * (1 + 0.11 * (s.a_window - 1) +
                                  0.028 * (s.b_window - 1))
    a_total = (cm.base_area_datapath + a_buf_a + a_buf_b + a_mux + a_ctrl +
               a_adt + a_shf + a_sram)

    return PowerArea(
        power_mw=p_total + hybrid_extra_p,
        area_kum2=a_total + hybrid_extra_a,
        breakdown_power={
            "datapath": cm.base_power_datapath, "reg": p_reg,
            "abuf": p_buf_a, "bbuf": p_buf_b, "mux": p_mux, "ctrl": p_ctrl,
            "adt": p_adt, "shf": p_shf, "sram": p_sram,
            "hybrid": hybrid_extra_p},
        breakdown_area={
            "datapath": cm.base_area_datapath, "abuf": a_buf_a,
            "bbuf": a_buf_b, "mux": a_mux, "ctrl": a_ctrl, "adt": a_adt,
            "shf": a_shf, "sram": a_sram, "hybrid": hybrid_extra_a})


# Table VII ground truth for the fit check (power mW, area k-um^2).
TABLE_VII_TOTALS = {
    "Baseline": (151.0, 217.0),
    "Sparse.B*": (206.0, 258.0),
    "TCL.B": (209.0, 233.0),
    "Sparse.A*": (223.0, 253.0),
    "Sparse.AB*": (282.0, 282.0),
    "Griffin": (284.0, 286.0),
    "TDash.AB": (284.0, 276.0),
    "SparTen.AB": (991.0, 1139.0),
}
