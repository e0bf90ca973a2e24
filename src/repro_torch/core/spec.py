"""Parametric specification of sparse GEMM accelerator architectures (the
port's own copy of the JAX package's ``core.spec``; ``Mode`` is also what
the serving code runs on).

This module encodes the paper's Definition III.1/III.2/IV.1: an architecture
is described by how far a multiplier may *borrow* a nonzero operand to replace
a zero one, along three dimensions of each input matrix:

  d?1 : time      — future K-chunks (lookahead)
  d?2 : lane      — neighbouring lane inside the K0-wide dot-product unit
  d?3 : cross-PE  — neighbouring PE (output column for B / output row for A),
                    which requires an extra adder tree to route the partial sum
                    back to the owning accumulator.

``da*`` applies to matrix A (activations, skipped on the fly), ``db*`` to
matrix B (weights, preprocessed offline).  ``shuffle`` enables the paper's
local 4x4 rotation load balancing (Section III, "Load Balancing").
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Tuple


class Mode(str, enum.Enum):
    """DNN model / execution category (paper Table I)."""

    DENSE = "dense"  # (dense, dense)
    A = "A"          # sparse activations only  -> Sparse.A
    B = "B"          # sparse weights only      -> Sparse.B
    AB = "AB"        # dual sparse              -> Sparse.AB

    @staticmethod
    def of(a_sparse: bool, b_sparse: bool) -> "Mode":
        if a_sparse and b_sparse:
            return Mode.AB
        if a_sparse:
            return Mode.A
        if b_sparse:
            return Mode.B
        return Mode.DENSE


@dataclasses.dataclass(frozen=True)
class CoreConfig:
    """The dense baseline core (paper Table IV, bottom)."""

    k0: int = 16          # dot-product unit width (lanes)
    n0: int = 16          # PE columns (output channels)
    m0: int = 4           # PE rows (output rows)
    freq_ghz: float = 0.8
    # memory system (used by the power model's bandwidth-scaling term)
    asram_kb: int = 512
    bsram_kb: int = 32
    asram_gbps: float = 51.2
    bsram_gbps: float = 204.8
    dram_gbps: float = 50.0

    @property
    def macs(self) -> int:
        return self.k0 * self.n0 * self.m0

    @property
    def dense_tops(self) -> float:
        """Dense INT8 TOPS: 2 ops (mul+add) per MAC per cycle."""
        return 2 * self.macs * self.freq_ghz / 1e3


@dataclasses.dataclass(frozen=True)
class SparseSpec:
    """Borrowing distances for one architecture configuration.

    ``Sparse.A(da1,da2,da3)``  == SparseSpec(da1,da2,da3, 0,0,0)
    ``Sparse.B(db1,db2,db3)``  == SparseSpec(0,0,0, db1,db2,db3)
    ``Sparse.AB(x,y,z,x',y',z')`` carries all six.
    """

    da1: int = 0
    da2: int = 0
    da3: int = 0
    db1: int = 0
    db2: int = 0
    db3: int = 0
    shuffle: bool = False
    name: Optional[str] = None

    # ---- derived properties -------------------------------------------------
    @property
    def a_window(self) -> Tuple[int, int, int]:
        return (self.da1, self.da2, self.da3)

    @property
    def b_window(self) -> Tuple[int, int, int]:
        return (self.db1, self.db2, self.db3)

    @property
    def supports_a(self) -> bool:
        return any(self.a_window)

    @property
    def supports_b(self) -> bool:
        return any(self.b_window)

    def label(self) -> str:
        if self.name:
            return self.name
        s = "on" if self.shuffle else "off"
        if self.supports_a and self.supports_b:
            return f"AB({self.da1},{self.da2},{self.da3},{self.db1},{self.db2},{self.db3},{s})"
        if self.supports_b:
            return f"B({self.db1},{self.db2},{self.db3},{s})"
        if self.supports_a:
            return f"A({self.da1},{self.da2},{self.da3},{s})"
        return f"dense({s})"

    def degrade_to(self, mode: Mode) -> "SparseSpec":
        """Non-hybrid behaviour: a dual-sparse design running a single-sparse
        model simply ignores the other side's borrowing (paper Section IV-B:
        'this design point downgrades to Sparse.A(2,0,0) and Sparse.B(2,0,1)')."""
        if mode == Mode.A:
            return dataclasses.replace(self, db1=0, db2=0, db3=0, name=None)
        if mode == Mode.B:
            return dataclasses.replace(self, da1=0, da2=0, da3=0, name=None)
        if mode == Mode.DENSE:
            return dataclasses.replace(
                self, da1=0, da2=0, da3=0, db1=0, db2=0, db3=0, name=None)
        return self


@dataclasses.dataclass(frozen=True)
class HybridSpec:
    """A hybrid architecture: one physical design (``base`` determines the
    hardware overhead) that *morphs* into per-category configurations
    (paper Section IV-B, Table VI)."""

    base: SparseSpec                      # physical design point (Sparse.AB*)
    conf_a: SparseSpec                    # morph for DNN.A
    conf_b: SparseSpec                    # morph for DNN.B
    name: str = "hybrid"

    def spec_for(self, mode: Mode) -> SparseSpec:
        if mode == Mode.A:
            return self.conf_a
        if mode == Mode.B:
            return self.conf_b
        if mode == Mode.DENSE:
            return self.base.degrade_to(Mode.DENSE)
        return self.base


# --------------------------------------------------------------------------
# Named design points (paper Table V / Table VI and Section V baselines).
# --------------------------------------------------------------------------

def sparse_a(da1: int, da2: int, da3: int, shuffle: bool = False, name=None) -> SparseSpec:
    return SparseSpec(da1, da2, da3, 0, 0, 0, shuffle, name)


def sparse_b(db1: int, db2: int, db3: int, shuffle: bool = False, name=None) -> SparseSpec:
    return SparseSpec(0, 0, 0, db1, db2, db3, shuffle, name)


def sparse_ab(da1, da2, da3, db1, db2, db3, shuffle: bool = False, name=None) -> SparseSpec:
    return SparseSpec(da1, da2, da3, db1, db2, db3, shuffle, name)


DENSE_BASELINE = SparseSpec(name="Baseline")

# Paper Table VI optimal points.
SPARSE_B_STAR = sparse_b(4, 0, 1, shuffle=True, name="Sparse.B*")
SPARSE_A_STAR = sparse_a(2, 1, 0, shuffle=True, name="Sparse.A*")
SPARSE_AB_STAR = sparse_ab(2, 0, 0, 2, 0, 1, shuffle=True, name="Sparse.AB*")

GRIFFIN = HybridSpec(
    base=SPARSE_AB_STAR,
    conf_a=sparse_a(2, 1, 1, shuffle=True, name="Griffin.confA"),
    conf_b=sparse_b(8, 0, 1, shuffle=True, name="Griffin.confB"),
    name="Griffin",
)

# State-of-the-art comparison points (paper Table V; Section V).
#  - Bit-Tactical (TCL.B): weight-only, lookahead+lookaside, no shuffle, db3=0.
#  - TensorDash (TDash.AB): dual, lookahead/lookaside both sides, no
#    preprocessing of B (joint on-the-fly scheduling; see scheduler.py).
#  - SparTen: dual, per-PE time-only intersection with very deep buffers.
TCL_B = sparse_b(2, 5, 0, shuffle=False, name="TCL.B")
TDASH_AB = sparse_ab(2, 1, 0, 2, 1, 0, shuffle=False, name="TDash.AB")
SPARTEN_DEPTH = 127  # 128-deep buffers (paper Section VI-E)
SPARTEN_AB = sparse_ab(SPARTEN_DEPTH, 0, 0, SPARTEN_DEPTH, 0, 0,
                       shuffle=False, name="SparTen.AB")
SPARTEN_A = sparse_a(SPARTEN_DEPTH, 0, 0, shuffle=False, name="SparTen.A")
SPARTEN_B = sparse_b(SPARTEN_DEPTH, 0, 0, shuffle=False, name="SparTen.B")
# Related work encoded as parameter points (Section VII).
CAMBRICON_X = sparse_b(16, 16, 0, shuffle=False, name="Cambricon-X")
CNVLUTIN = sparse_a(15, 0, 0, shuffle=False, name="Cnvlutin")

PRESETS: Dict[str, SparseSpec] = {
    s.name: s for s in [
        DENSE_BASELINE, SPARSE_B_STAR, SPARSE_A_STAR, SPARSE_AB_STAR,
        TCL_B, TDASH_AB, SPARTEN_AB, SPARTEN_A, SPARTEN_B,
        CAMBRICON_X, CNVLUTIN,
    ]
}
