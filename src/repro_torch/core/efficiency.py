"""Effective power/area efficiency metrics (paper Definition V.1)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Union

from .overhead import CostModel, DEFAULT_COST_MODEL, power_area
from .spec import CoreConfig, HybridSpec, Mode, SparseSpec


@dataclasses.dataclass(frozen=True)
class Efficiency:
    speedup: float
    power_mw: float
    area_kum2: float

    @property
    def tops_w(self) -> float:
        """Effective TOPS/W = sparsity speedup x dense TOPS / power."""
        return self.speedup * CoreConfig().dense_tops / (self.power_mw * 1e-3)

    @property
    def tops_mm2(self) -> float:
        return self.speedup * CoreConfig().dense_tops / (self.area_kum2 * 1e-3)


def efficiency(design: Union[SparseSpec, HybridSpec], speedup: float,
               core: CoreConfig = CoreConfig(),
               cm: CostModel = DEFAULT_COST_MODEL) -> Efficiency:
    pa = power_area(design, core, cm)
    return Efficiency(speedup=speedup, power_mw=pa.power_mw,
                      area_kum2=pa.area_kum2)


def sparsity_tax(design: Union[SparseSpec, HybridSpec],
                 core: CoreConfig = CoreConfig(),
                 cm: CostModel = DEFAULT_COST_MODEL) -> Dict[str, float]:
    """Efficiency lost on DNN.dense relative to the dense baseline
    (paper Section VI-F: Griffin's 'sparsity tax' is 29%/24% power/area)."""
    from .spec import DENSE_BASELINE
    base = power_area(DENSE_BASELINE, core, cm)
    this = power_area(design, core, cm)
    return {
        "power_tax": 1.0 - base.power_mw / this.power_mw,
        "area_tax": 1.0 - base.area_kum2 / this.area_kum2,
    }
