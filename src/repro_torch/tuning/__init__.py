"""DSE-in-the-loop autotuning — the counterpart of ``repro/tuning``.

``plan`` defines the versioned kernel-plan artifact (importable from
anywhere: no runtime dependencies); ``search`` enumerates and scores
candidate configs through the cycle-model DSE and a roofline of the
compacted decode step; ``measure`` validates shortlisted candidates
against measured tok/s on warm serving runs.  ``launch/autotune.py`` is
the CLI gluing the three into a pipeline.

Only the plan layer is re-exported here: ``measure`` imports the serving
runtime, and consumers of plans (``sparsity``, ``runtime.engine``) must
be importable without it.
"""
from .plan import (FamilyPlan, GemmRule, KernelPlan, PlanSchemaError,
                   PLAN_SCHEMA_VERSION, load_plan)

__all__ = ["FamilyPlan", "GemmRule", "KernelPlan", "PlanSchemaError",
           "PLAN_SCHEMA_VERSION", "load_plan"]
