"""Three-term roofline arithmetic — the pure half of
``repro/roofline/analysis.py``.

    compute term    = FLOPs / (chips x peak FLOP/s)
    memory term     = bytes / (chips x device-memory bandwidth)
    collective term = collective bytes / (chips x link bandwidth)

The reference fills :class:`CostSample` from XLA's compiled cost analysis
and HLO text; that half (``sample_costs``, ``collective_bytes``) is not
ported.  The port's callers build samples from shapes they count
themselves (``tuning.search``), so only the arithmetic is here, with the
card's constants in place of the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# NVIDIA H100 80GB HBM3, 700 W (SXM; NVIDIA's data sheet, dense rates)
PEAK_FLOPS = 989e12          # bf16 tensor cores, FLOP/s
HBM_BW = 3.35e12             # device memory, bytes/s
LINK_BW = 450e9              # NVLink, bytes/s each way to the other cards


@dataclasses.dataclass
class CostSample:
    """Per-device costs of one step."""

    flops: float
    bytes_accessed: float
    coll: Dict[str, float]

    @property
    def coll_total(self) -> float:
        return float(sum(self.coll.values()))


def extrapolate(f1: CostSample, f2: CostSample, units: float) -> CostSample:
    """total = f1 + (units - 1) * (f2 - f1), per field."""
    keys = set(f1.coll) | set(f2.coll)
    coll = {k: f1.coll.get(k, 0.0) +
            (units - 1) * (f2.coll.get(k, 0.0) - f1.coll.get(k, 0.0))
            for k in keys}
    return CostSample(
        flops=f1.flops + (units - 1) * (f2.flops - f1.flops),
        bytes_accessed=f1.bytes_accessed +
        (units - 1) * (f2.bytes_accessed - f1.bytes_accessed),
        coll=coll)


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_dev: float
    bytes_dev: float
    coll_bytes_dev: float
    model_flops: float
    useful_ratio: float          # MODEL_FLOPS / (FLOPs x chips)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the step's lower bound spent on *useful* model math:
        model_flops/(chips*peak) / max(term)."""
        ideal = self.model_flops / (PEAK_FLOPS * self._chips)
        return ideal / max(self.bound_s, 1e-30)

    _chips: int = 1


def roofline_terms(costs: CostSample, model_flops: float, chips: int
                   ) -> RooflineTerms:
    t = RooflineTerms(
        compute_s=costs.flops / PEAK_FLOPS,
        memory_s=costs.bytes_accessed / HBM_BW,
        collective_s=costs.coll_total / LINK_BW,
        flops_dev=costs.flops,
        bytes_dev=costs.bytes_accessed,
        coll_bytes_dev=costs.coll_total,
        model_flops=model_flops,
        useful_ratio=model_flops / max(costs.flops * chips, 1e-30),
    )
    t._chips = chips
    return t


def model_flops_for(kind: str, n_active_params: float, batch: int,
                    seq_len: int) -> float:
    """MODEL_FLOPS: 6ND for training, 2ND for prefill, 2N per decoded token
    (attention flops excluded, as in the reference)."""
    if kind == "train":
        return 6.0 * n_active_params * batch * seq_len
    if kind == "prefill":
        return 2.0 * n_active_params * batch * seq_len
    return 2.0 * n_active_params * batch          # decode: one token
