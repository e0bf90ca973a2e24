"""Engine configuration — the port's own copy of ``repro/runtime/config.py``.

A frozen ``EngineConfig`` of frozen sections with the reference's field
names.  The port serves the fixed or paged slot arena (same-dtype or int8
pages) through the fused or the stepwise decode path on one device, and
several such engines behind the multi-replica router (``RouterConfig``,
``runtime.router``).  ``FaultConfig.inject`` is a fault spec: ``kill:`` or
``delay:`` arms an engine's recovery, ``replica:`` kills a router replica;
``snapshot_dir`` sends the engine's tick-start snapshots to disk.
``mesh`` ("DxM") serves through ``runtime.mesh_serve.MeshServeEngine``
and ``kernels.spmd_kernels=False`` sends its GEMMs through the parity
oracle (``--spmd-fallback``).  ``recovery_model_parallel`` caps the
model axis of the mesh the survivors of a loss form
(``--remesh-model-parallel``; None keeps the mesh's).  The
reference's kernel field ``interpret`` has no counterpart: a JSON file may
carry it at its default, and any other value raises; ``launch/serve.py``
defines no flag for an unported field.  ``kernels.plan`` names a tuned kernel plan file
(``repro_torch.tuning``), read by ``launch/serve.py``.
``to_json``/``from_json`` round-trip the config and power
``launch/serve.py --config engine.json``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Sequence

from .fault import parse_fault_spec


@dataclasses.dataclass(frozen=True)
class ArenaConfig:
    """KV arena shape.  ``page_size=None`` keeps the fixed ``num_slots x
    cache_len`` arena; a power of two activates the paged pool
    (``runtime/paging.py``) of ``num_pages`` physical pages (default: the
    fixed arena's capacity + the DUMP page).  ``kv_dtype="fp32"`` keeps
    pages in the cache's own dtype; ``"int8"`` quantizes each token row
    with its own scale (a gated logit tolerance, not token parity).
    ``cache_len=None`` means "derive from the trace"
    (:meth:`EngineConfig.derive_cache_len`)."""

    num_slots: int = 4
    cache_len: Optional[int] = None
    page_size: Optional[int] = None
    num_pages: Optional[int] = None
    kv_dtype: str = "fp32"


@dataclasses.dataclass(frozen=True)
class SchedConfig:
    """Admission ``policy`` (``"continuous"`` or ``"static"``), the fused
    chunk ladder, bucketed prefill; ``fused=False`` is the stepwise path
    (one decode step and one host sync per tick, the reference's
    baseline)."""

    policy: str = "continuous"
    max_admissions_per_step: int = 1
    decode_chunk: int = 8
    measure_every: int = 8
    bucket_prompts: bool = True
    fused: bool = True


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    use_kernels: bool = False
    a_sparsity: Optional[float] = None
    block_m: int = 128
    spmd_kernels: bool = True
    plan: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """``inject`` is a fault spec (``runtime.fault.parse_fault_spec``):
    ``kill:``/``delay:`` arm the engine's rollback and replay, ``replica:``
    the router's replica kill.  ``snapshot_dir`` writes every tick-start
    snapshot through ``checkpoint.save`` and recovers through
    ``checkpoint.restore``.  ``recovery_model_parallel`` caps the model
    axis of the post-loss mesh (None: the current one)."""

    inject: Optional[str] = None
    snapshot_dir: Optional[str] = None
    recovery_model_parallel: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Multi-replica routing (``launch/serve.py --replicas``):
    ``replicas=0`` is plain single-engine serving; ``queue_bound=None``
    with ``shed_policy`` ``"shed"`` or ``"degrade"`` bounds the queue at
    2 x slots x replicas, ``"none"`` leaves it unbounded, ``"degrade"``
    adds the pressure ladder; ``hedge_after`` ticks arm hedging."""

    replicas: int = 0
    queue_bound: Optional[int] = None
    hedge_after: Optional[int] = None
    shed_policy: str = "shed"


_SECTIONS = {"arena": ArenaConfig, "sched": SchedConfig,
             "kernels": KernelConfig, "fault": FaultConfig,
             "router": RouterConfig}

# reference fields the port has no counterpart for, with their defaults
_UNPORTED_DEFAULTS = {"kernels": {"interpret": False}}

# launch/serve.py flag dest -> flat field name
_FLAGS = {"slots": "num_slots", "measure_every": "measure_every",
          "decode_chunk": "decode_chunk", "use_kernels": "use_kernels",
          "page_size": "page_size", "num_pages": "num_pages",
          "kv_dtype": "kv_dtype", "policy": "policy",
          "replicas": "replicas", "queue_bound": "queue_bound",
          "hedge_ms": "hedge_after", "shed_policy": "shed_policy",
          "inject_fault": "inject", "snapshot_dir": "snapshot_dir",
          "remesh_model_parallel": "recovery_model_parallel",
          "plan": "plan", "mesh": "mesh"}

# flags whose 0 means "off" (None in the config), as in the reference
_ZERO_IS_NONE = ("queue_bound", "hedge_after")

# flat field name -> (section, field), as in the reference
_FIELDS = {
    "num_slots": ("arena", "num_slots"),
    "cache_len": ("arena", "cache_len"),
    "page_size": ("arena", "page_size"),
    "num_pages": ("arena", "num_pages"),
    "kv_dtype": ("arena", "kv_dtype"),
    "policy": ("sched", "policy"),
    "max_admissions_per_step": ("sched", "max_admissions_per_step"),
    "decode_chunk": ("sched", "decode_chunk"),
    "measure_every": ("sched", "measure_every"),
    "bucket_prompts": ("sched", "bucket_prompts"),
    "fused": ("sched", "fused"),
    "use_kernels": ("kernels", "use_kernels"),
    "a_sparsity": ("kernels", "a_sparsity"),
    "block_m": ("kernels", "block_m"),
    "spmd_kernels": ("kernels", "spmd_kernels"),
    "plan": ("kernels", "plan"),
    "inject": ("fault", "inject"),
    "snapshot_dir": ("fault", "snapshot_dir"),
    "recovery_model_parallel": ("fault", "recovery_model_parallel"),
    "replicas": ("router", "replicas"),
    "queue_bound": ("router", "queue_bound"),
    "hedge_after": ("router", "hedge_after"),
    "shed_policy": ("router", "shed_policy"),
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    arena: ArenaConfig = dataclasses.field(default_factory=ArenaConfig)
    sched: SchedConfig = dataclasses.field(default_factory=SchedConfig)
    kernels: KernelConfig = dataclasses.field(default_factory=KernelConfig)
    fault: FaultConfig = dataclasses.field(default_factory=FaultConfig)
    router: RouterConfig = dataclasses.field(default_factory=RouterConfig)
    mesh: Optional[str] = None

    def __post_init__(self):
        if self.fault.inject is not None:
            parse_fault_spec(self.fault.inject)
        if self.mesh is not None:
            from ..launch.mesh import parse_mesh
            parse_mesh(self.mesh)

    def with_fields(self, **kv: Any) -> "EngineConfig":
        """Functional update by flat field name (``num_slots=8``)."""
        out = self
        for key, val in kv.items():
            if key == "mesh":
                out = dataclasses.replace(out, mesh=val)
                continue
            if key not in _FIELDS:
                raise TypeError(f"unknown engine config field {key!r}")
            section, field = _FIELDS[key]
            sec = dataclasses.replace(getattr(out, section), **{field: val})
            out = dataclasses.replace(out, **{section: sec})
        return out

    @staticmethod
    def heavy_gen_cap(gen_lens: Sequence[int]) -> int:
        """Generation cap of ``length_dist="heavy"`` traces: twice the
        largest nominal gen length, so the arena bound stays finite."""
        return 2 * max(gen_lens)

    @classmethod
    def derive_cache_len(cls, prompt_lens: Sequence[int],
                         gen_lens: Sequence[int],
                         length_dist: str = "choice") -> int:
        """The trace-driven arena bound: longest prompt + the generation
        cap + 1 feedback token."""
        gen_cap = (cls.heavy_gen_cap(gen_lens) if length_dist == "heavy"
                   else max(gen_lens))
        return max(prompt_lens) + gen_cap + 1

    @classmethod
    def from_args(cls, args: Any, defaults: Optional[Dict[str, Any]] = None
                  ) -> "EngineConfig":
        """EngineConfig from launch/serve.py's argparse namespace, with the
        reference's rule: ``--config <json>`` (``args.config``) sets the
        baseline and every flag whose value differs from its parser default
        (``defaults``, dest -> default) is laid on top, so a flag set *to*
        its default never overrides the file.  ``defaults=None`` counts
        every present flag as explicit."""
        path = getattr(args, "config", None)
        if path:
            with open(path) as f:
                base = cls.from_json(f.read())
        else:
            base = cls()

        def explicit(dest: str) -> bool:
            if not hasattr(args, dest):
                return False
            if defaults is None or dest not in defaults:
                return True
            return getattr(args, dest) != defaults[dest]

        kv = {field: getattr(args, dest) for dest, field in _FLAGS.items()
              if explicit(dest)}
        for field in _ZERO_IS_NONE:
            if field in kv:
                kv[field] = kv[field] or None
        return base.with_fields(**kv) if kv else base

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "EngineConfig":
        raw = json.loads(text)
        if not isinstance(raw, dict):
            raise ValueError("engine config json must be an object")
        kw: Dict[str, Any] = {}
        for name, val in raw.items():
            if name == "mesh":
                kw["mesh"] = val
                continue
            if name not in _SECTIONS:
                raise ValueError(f"unknown engine config section {name!r}")
            sec_cls = _SECTIONS[name]
            val = dict(val)
            for field, default in _UNPORTED_DEFAULTS.get(name, {}).items():
                if field in val and val.pop(field) != default:
                    raise NotImplementedError(
                        f"{name}.{field} is not ported yet")
            unknown = set(val) - {f.name for f in dataclasses.fields(sec_cls)}
            if unknown:
                raise ValueError(f"unknown {name} config fields: "
                                 f"{sorted(unknown)}")
            kw[name] = sec_cls(**val)
        return cls(**kw)
