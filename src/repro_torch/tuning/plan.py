"""Versioned kernel plans: the artifact the autotuner emits and the
execution stack consumes — the counterpart of ``repro/tuning/plan.py``.

A :class:`KernelPlan` maps model families to :class:`FamilyPlan` entries;
each family entry carries Mode-selection thresholds plus per-GEMM
:class:`GemmRule` compaction rules (block granularity / balance unit,
matched by trailing param name, ``"*"`` as the default rule).  Consumers:

  - ``sparsity.sparsify_params(plan=...)`` applies the rules at weight
    *compaction* time.  Rules never touch the *pruning* granularity: a
    pruned block is exactly zero and compaction at any granularity keeps
    every surviving value, so a plan changes how GEMMs execute, never
    what they compute.  On the card this holds bit for bit because
    griffin_spmm sums each output in an order fixed by the weight's
    (K, N) alone (``csrc/griffin_spmm.cu``, point 4); ``chip_smoke.py``
    holds every candidate's logits equal to the default's, and
    ``launch/autotune.py`` asserts equal tokens, as the reference does.
  - ``runtime.engine.ServeEngine(plan=...)`` applies the family
    thresholds to its Mode decision and serving scope; per-GEMM
    ``a_threshold`` rules are stamped onto the compacted
    ``GriffinWeights`` (``a_thr``) and read by
    ``models.common.griffin_linear``.

The JSON schema is versioned by ``PLAN_SCHEMA_VERSION``, the same constant
(``core.dse.CONFIG_SCHEMA_VERSION``) the DSE sweep cache keys include, and
the same value the JAX package writes: plan files load in either package.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

from ..core.dse import CONFIG_SCHEMA_VERSION

PLAN_SCHEMA_VERSION = CONFIG_SCHEMA_VERSION


class PlanSchemaError(ValueError):
    """A plan file's ``schema_version`` is not the one this code writes."""


@dataclasses.dataclass(frozen=True)
class GemmRule:
    """Per-GEMM execution rule, matched by trailing param name.

    ``match`` is a name from ``sparsity.pruning.GEMM_WEIGHTS`` or ``"*"``
    (matches every GEMM leaf; list it last — first match wins).  ``None``
    fields keep the caller's default; set fields are clamped to the leaf's
    actual dims when applied.
    """

    match: str
    block_k: Optional[int] = None
    block_n: Optional[int] = None
    unit: Optional[int] = None
    a_threshold: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class FamilyPlan:
    """Tuned execution config for one model family.

    ``a_threshold``/``b_threshold`` override ``core.hybrid
    .SPARSE_THRESHOLD`` in the engine's Mode decision; ``rules`` steer
    per-GEMM compaction granularity and per-GEMM A thresholds.
    ``predicted``/``measured`` are the autotuner's score records (kept for
    auditability; never read at execution time).
    """

    family: str
    rules: Tuple[GemmRule, ...] = ()
    a_threshold: Optional[float] = None
    b_threshold: Optional[float] = None
    predicted: Dict[str, Any] = dataclasses.field(default_factory=dict)
    measured: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def rule_for(self, name: str) -> Optional[GemmRule]:
        for r in self.rules:
            if r.match == name or r.match == "*":
                return r
        return None


@dataclasses.dataclass
class KernelPlan:
    """A family -> FamilyPlan mapping plus provenance metadata."""

    families: Dict[str, FamilyPlan]
    schema_version: int = PLAN_SCHEMA_VERSION
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def family(self, name: str) -> Optional[FamilyPlan]:
        return self.families.get(name)

    def to_json(self) -> Dict[str, Any]:
        return {
            "schema_version": self.schema_version,
            "meta": dict(self.meta),
            "families": {
                f: {
                    "family": fp.family,
                    "a_threshold": fp.a_threshold,
                    "b_threshold": fp.b_threshold,
                    "rules": [dataclasses.asdict(r) for r in fp.rules],
                    "predicted": fp.predicted,
                    "measured": fp.measured,
                } for f, fp in self.families.items()
            },
        }

    @classmethod
    def from_json(cls, data: Dict[str, Any]) -> "KernelPlan":
        got = data.get("schema_version")
        if got != PLAN_SCHEMA_VERSION:
            raise PlanSchemaError(
                f"kernel plan schema_version {got!r} != supported "
                f"{PLAN_SCHEMA_VERSION} — re-run `python -m "
                "repro_torch.launch.autotune` to regenerate the plan")
        fams = {}
        for f, fd in data.get("families", {}).items():
            fams[f] = FamilyPlan(
                family=fd["family"],
                rules=tuple(GemmRule(**r) for r in fd.get("rules", [])),
                a_threshold=fd.get("a_threshold"),
                b_threshold=fd.get("b_threshold"),
                predicted=fd.get("predicted", {}),
                measured=fd.get("measured", {}))
        return cls(families=fams, schema_version=got,
                   meta=data.get("meta", {}))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")


def load_plan(path: str) -> KernelPlan:
    """Load + schema-check a plan file (raises :class:`PlanSchemaError`
    on any version this code does not write)."""
    with open(path) as f:
        return KernelPlan.from_json(json.load(f))
