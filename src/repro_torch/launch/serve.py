"""Serving driver: block-prune (and with ``--use-kernels`` compact) a
model's weights, serve a synthetic request trace through the
continuous-batching engine, and optionally check every request against the
batch-1 greedy oracle — the counterpart of ``repro/launch/serve.py``'s
single-engine path.

    python -m repro_torch.launch.serve --arch llama3.2-1b --sparsity 0.8 \\
        --use-kernels --parity

runs full-width llama3.2-1b on the CUDA card (``--arch stablelm-1.6b``,
``minitron-8b`` and ``command-r-plus-104b`` the dense family's other
configs; ``--arch chameleon-34b`` the vlm family and ``--arch
mixtral-8x7b`` the moe family, their compacted weights built one matrix
at a time by ``sparsity.init_sparse_params``; ``--arch
whisper-large-v3`` the audio family, each request carrying its encoder
frames; ``xlstm-1.3b`` and ``recurrentgemma-9b`` the ssm and hybrid
families); ``--reduced --device cpu`` runs the reduced config on the host
(the kernels' plain versions).
``--page-size 16`` serves from the paged KV arena (``--num-pages`` sizes
its pool, ``--kv-dtype int8`` quantizes its pages), ``--policy static``
admits only into a drained pool, and ``--length-dist heavy`` draws
heavy-tailed generation lengths.  The stepwise decode path is chosen
through the config file (``{"sched": {"fused": false}}``), as in the
reference.

``--inject-fault kill:<dev>@<step>[:<phase>]`` kills the serving device
at an engine step (phase admission, prefill or decode): the engine rolls
back to its tick-start snapshot and replays the tick, and the run prints
its recovery log and still ends in parity; ``delay:<host>@<step>`` feeds
the straggler detector (``--evict-after``) instead.  ``--snapshot-dir``
writes every tick-start snapshot to disk through ``checkpoint.save``.

``--replicas N`` serves through the SLO-aware multi-replica router
(:func:`route`): N engines sharing one set of weights behind one bounded
EDF admission queue (``--queue-bound``, ``--shed-policy
none|shed|degrade``, ``--hedge-ms``, ``--inject-fault
replica:<i>@<tick>[:<during>[:<recover>]]``), fed by bursty arrivals
(``--arrival-process bursty --rate --burst-rate``) with priorities and
virtual-tick SLOs (``--priorities 0,1 --slo ttft=6,slack=4``);
``--overload-smoke`` asserts the queue stayed bounded and shed work.
``--config engine.json`` reads an ``EngineConfig`` (explicit flags beat
the file); its ``kernels.a_sparsity`` declares the activation sparsity of
the workload category, which with ``--use-kernels`` selects Sparse.A
(dense weights, ``--sparsity 0``) or Sparse.AB (compacted weights).
``--plan PATH`` (or the file's ``kernels.plan``) reads a tuned kernel plan
(``repro_torch.launch.autotune``, or the JAX package's, same schema): the
model family's entry steers weight-compaction granularity and the
Mode-selection thresholds of every engine.  It changes how the GEMMs run,
not what they compute: griffin_spmm sums every output in an order fixed by
the weight's (K, N) alone, so every compaction gives the default's bits
(``chip_smoke.py`` holds this on the card).

``--mesh DxM`` serves on a ("data", "model") mesh of D x M ranks
(:func:`serve_on_mesh`, ``runtime.mesh_serve.MeshServeEngine``): spawned
here (``launch.mesh.run_ranks``; under ``torchrun`` this process is one of
them), gloo on the host with ``--device cpu``, on the card nccl with a card
per rank or gloo on CUDA tensors with more ranks than cards.  The slots
split over the D data rows, every weight GEMM's output columns and the
arena's head axes over the M model ranks; the tokens are the
single-device engine's, and ``--parity``
holds rank 0's against ``greedy_generate`` on the whole weights after the
ranks' host states are held equal.  ``--model-parallel P`` plans the mesh
(``runtime.elastic.plan_mesh``) over the cards (on the host: P ranks)
when ``--mesh`` is not given; ``--spmd-fallback`` sends the mesh's GEMMs
through the decompaction / dense-product oracle instead of the kernels'
shard entries (the parity baseline).  On a mesh ``--inject-fault
kill:<rank>@<step>[:<phase>]`` loses the rank at that mesh position
(``delay:<row>@<step>`` slows a data row until the straggler detector
evicts it): the ranks roll back, remesh onto the survivors (the model
axis at most ``--remesh-model-parallel``, default the mesh's) and finish
the trace; the run prints the recovery log and the final mesh, and
``--parity`` holds a surviving rank's tokens against the oracle.
``--snapshot-dir`` works on a mesh too (a directory a data row's head
share).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import get_config
from ..kernels import launch_counts
from ..models import build_model
from ..models.common import kernel_dispatch_counts
from ..runtime import slo
from ..runtime.config import EngineConfig
from ..runtime.elastic import plan_mesh
from ..runtime.engine import ServeEngine, synthetic_trace
from ..runtime.fault import parse_fault_spec
from ..runtime.mesh_serve import MeshServeEngine, host_digest
from ..runtime.sharding import griffin_leaves, sharded_leaves
from ..runtime.router import RouterEngine
from ..runtime.serve import greedy_generate
from ..runtime.slo import DegradationConfig
from ..runtime.straggler import StragglerConfig, StragglerDetector
from ..sparsity import init_sparse_params, prune_for, sparsify_params
from ..tuning import load_plan
from .mesh import backend_line, mesh_spec, run_ranks, serve_mesh


def _lens(spec: str):
    return tuple(int(x) for x in spec.split(",") if x)


def _parse_slo(spec: str):
    """``--slo`` spec: comma-separated ``ttft=<ticks>`` (first-token
    deadline) and ``slack=<factor>`` (completion deadline = slack x the
    request's own expected service).  Either half may be omitted."""
    ttft, slack = None, None
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        if k == "ttft":
            ttft = int(v)
        elif k == "slack":
            slack = float(v)
        else:
            raise ValueError(f"--slo {spec!r}: unknown key {k!r} "
                             "(known: ttft, slack)")
    return ttft, slack


def _devices(device: torch.device) -> List[torch.device]:
    """The serving device list a ``kill:`` spec's index resolves
    against: every visible card, or the host."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def fault_hooks(econf: EngineConfig, device: torch.device,
                evict_after: int = 3, mesh=None) -> Dict:
    """The engine's ``fault_injector`` and ``straggler`` keywords from a
    ``kill:``/``delay:`` spec in ``fault.inject`` (none for no spec or a
    router-level ``replica:`` spec).  A delay spec also arms a straggler
    detector, so the eviction path, not the injector, drives recovery:
    one host on one device (its own median, never evicted), a host a data
    row on a ``mesh``, whose ranks the kill index resolves against."""
    if econf.fault.inject is None:
        return {}
    spec = parse_fault_spec(econf.fault.inject)
    if spec.kind == "replica":
        return {}
    on_mesh = mesh is not None and mesh.size > 1
    hooks = {"fault_injector": spec.build(mesh.members if on_mesh
                                          else _devices(device))}
    if spec.kind == "delay":
        hooks["straggler"] = StragglerDetector(
            mesh.data if on_mesh else 1,
            StragglerConfig(evict_after=evict_after))
    return hooks


def _setup(arch: str, reduced: bool, sparsity: float, seed: int,
           device: Optional[str], econf: EngineConfig, requests: int,
           prompt_lens: Sequence[int], gen_lens: Sequence[int],
           arrival_every: int, length_dist: str, max_gen: Optional[int],
           trace_seed: int, trace_kw: Dict, params: Optional[Dict] = None):
    """(api, params, trace, config, plan): the model with seeded random
    weights on ``device``, pruned (and compacted with
    ``kernels.use_kernels``) to ``sparsity`` — full-width blocks
    128/128/32, the reduced config's 16/16/8, as in the reference — and
    the synthetic trace; the config's ``cache_len`` defaults to the
    trace's bound.  Given ``params`` (an earlier call's, same arguments),
    they are served as they are and nothing is drawn.  ``plan`` is the
    family's entry of the plan file ``kernels.plan`` names (None without
    one, or when the file has no entry for the family: then the defaults
    serve, as in the reference), applied to the compaction here and to
    every engine by the caller."""
    if econf.arena.cache_len is None:
        econf = econf.with_fields(cache_len=EngineConfig.derive_cache_len(
            prompt_lens, gen_lens, length_dist))
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    plan = None
    if econf.kernels.plan:
        plan = load_plan(econf.kernels.plan).family(cfg.family)
        if plan is None:
            print(f"plan {econf.kernels.plan} has no entry for family "
                  f"{cfg.family!r}; serving with defaults")
    api = build_model(cfg, device=device)
    if params is None:
        params = _draw(api, sparsity, seed, econf.kernels.use_kernels, plan,
                       reduced)
    if max_gen is None and length_dist == "heavy":
        max_gen = EngineConfig.heavy_gen_cap(gen_lens)
    reqs = synthetic_trace(cfg, num_requests=requests, seed=trace_seed,
                           prompt_lens=prompt_lens, gen_lens=gen_lens,
                           arrival_every=arrival_every,
                           length_dist=length_dist, max_gen=max_gen,
                           **trace_kw)
    return api, params, reqs, econf, plan


def _draw(api, sparsity: float, seed: int, use_kernels: bool, plan,
          reduced: bool) -> Dict:
    """The seeded weights :func:`_setup` serves."""
    if sparsity > 0 and use_kernels and api.draws is not None:
        # the vlm and moe families: compacted one matrix at a time, never
        # holding the dense tree (chameleon-34b's 68.6 GB and its
        # compaction do not fit the card together; mixtral-8x7b's 93 GB
        # alone do not)
        return init_sparse_params(api, api.generator(seed), sparsity,
                                  plan=plan, **prune_for(reduced))
    params = api.init(api.generator(seed))
    if sparsity > 0:
        params = sparsify_params(params, sparsity, compact=use_kernels,
                                 plan=plan, **prune_for(reduced))
    return params


def _sync(api) -> None:
    if api.device.type == "cuda":
        torch.cuda.synchronize(api.device)


@dataclasses.dataclass
class ServeRun:
    """What :func:`serve` did: the engine (its ``stats``, outputs and
    ``mode_history``), the trace, the served params, the wall time, and
    the GEMM dispatch and kernel launch counts of the engine's run alone
    (not the build's or the engine's construction).  ``whole`` is the
    whole tree served (on a mesh ``params`` is the rank's share)."""

    engine: ServeEngine
    requests: List
    params: Dict
    seconds: float
    dispatch: Dict[str, int]
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    whole: Optional[Dict] = None

    @property
    def tokens_per_second(self) -> float:
        return self.engine.stats["emitted"] / max(self.seconds, 1e-9)

    @property
    def syncs_per_token(self) -> float:
        return self.engine.stats["host_syncs"] / \
            max(self.engine.stats["emitted"], 1)


def serve(arch: str = "llama3.2-1b", *, reduced: bool = False,
          requests: int = 8, prompt_lens: Sequence[int] = (8, 16, 32),
          gen_lens: Sequence[int] = (4, 8, 16), arrival_every: int = 0,
          length_dist: str = "choice", max_gen: Optional[int] = None,
          sparsity: float = 0.8, seed: int = 0, trace_seed: int = 1,
          device: Optional[str] = "cuda",
          config: Optional[EngineConfig] = None, evict_after: int = 3,
          params: Optional[Dict] = None, mesh=None, **trace_kw) -> ServeRun:
    """Build the model with seeded random weights on ``device``, prune
    (compact with ``config.kernels.use_kernels``), and serve a synthetic
    trace through one engine.  ``config`` (default ``EngineConfig()``)
    sets the slots, the chunk, the kernels and the declared activation
    sparsity (``kernels.a_sparsity``) and the arena, fixed or paged; its
    ``cache_len`` defaults to the trace's bound; its ``fault`` section
    arms recovery (:func:`fault_hooks`, ``evict_after`` the straggler
    streak of a delay spec).  ``length_dist="heavy"`` draws Pareto
    generation lengths capped at ``max_gen`` (default
    ``EngineConfig.heavy_gen_cap(gen_lens)``); ``trace_kw`` passes the
    arrival process and SLO fields on to ``synthetic_trace``.  ``params``,
    an earlier run's weights for the same ``arch``, ``reduced``,
    ``sparsity``, ``seed`` and kernels, are served instead of a new draw
    (which would give the same bits).  ``mesh``: this rank's joined mesh
    (inside :func:`serve_on_mesh`'s ranks); the run serves through a
    ``MeshServeEngine`` on the mesh's device, and ``params`` in the result
    are the rank's share."""
    econf = config or EngineConfig()
    if econf.fault.inject is not None and \
            parse_fault_spec(econf.fault.inject).kind == "replica":
        raise ValueError("a replica fault needs the router "
                         "(router.replicas > 0)")
    if mesh is not None:
        device = mesh.device
    api, params, reqs, econf, plan = _setup(
        arch, reduced, sparsity, seed, device, econf, requests, prompt_lens,
        gen_lens, arrival_every, length_dist, max_gen, trace_seed, trace_kw,
        params)
    hooks = fault_hooks(econf, api.device, evict_after, mesh)
    whole = params
    if mesh is not None:
        engine = MeshServeEngine(api, params, mesh=mesh, config=econf,
                                 plan=plan, **hooks)
        params = engine.params
    else:
        engine = ServeEngine(api, params, econf, plan=plan, **hooks)
    before = kernel_dispatch_counts()
    l0 = launch_counts()
    _sync(api)
    t0 = time.perf_counter()
    engine.run(reqs)
    if (getattr(engine, "departed", None) or {}).get("status") != "lost":
        _sync(api)                  # a lost rank's device is not touched
    dt = time.perf_counter() - t0
    after = kernel_dispatch_counts()
    dispatch = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    launches = {k: v - l0.get(k, 0) for k, v in launch_counts().items()}
    return ServeRun(engine, reqs, params, dt, dispatch, launches, whole)


def _since(now: Dict[str, int], then: Dict[str, int]) -> Dict[str, int]:
    return {k: v - then.get(k, 0) for k, v in now.items()}


def mesh_rank(mesh, kw: Dict, drawn: Optional[Dict] = None) -> Dict:
    """One rank of :func:`serve_on_mesh`: :func:`serve` on this rank's
    mesh and device, then what the caller reads, as plain values: the
    tokens, the counters, the GEMM dispatch and kernel launch counts of
    the engine's run, the host-state digest (held equal on every rank of
    the final mesh here), the rank's prefills, its shares of the weights,
    its arena's bytes by leaf, its gathers and their seconds by axis (the
    "model" axis's also split into its prefills' and its decode steps')
    and by call site (``Mesh.sites``),
    and the wall seconds.  After a
    loss: the final mesh, the recoveries and their log, each remesh's
    record, and the launches, dispatch counts and model calls since the
    last recovery.  A rank the remesh left out returns its ``status``
    (``"lost"`` or ``"dropped"``), its handover, its launches, and its
    launches and dispatch counts since the loss instead, and makes no
    further collective here.
    ``drawn`` (a dict) receives the whole tree served under ``"tree"``."""
    import torch.distributed as dist

    mesh.reset_counts()
    run = serve(mesh=mesh, **kw)
    if drawn is not None:
        drawn["tree"] = run.whole
    eng = run.engine
    left = eng.departed
    if left is not None:
        return {"rank": mesh.rank, "mesh": mesh_spec(mesh),
                "status": left["status"], "step": left["step"],
                "final_mesh": left["mesh"], "remesh": list(eng.remesh_log),
                "launches": run.launches,
                "launches_after_loss": _since(launch_counts(),
                                              left["launches"]),
                "dispatch_after_loss": _since(kernel_dispatch_counts(),
                                              left["dispatch"])}
    final = eng.mesh
    digest = host_digest(eng)
    if final.size > 1:
        digests = [None] * final.size
        dist.all_gather_object(digests, digest, group=final.groups["host"])
        if len(set(digests)) != 1:
            raise RuntimeError(f"the ranks' host states differ after the "
                               f"run: {digests}")
    meshes = [mesh] + ([final] if final is not mesh else [])
    rec = eng.after_recovery
    recovery = {}
    if rec is not None:
        recovery = {
            "launches_after": _since(launch_counts(), rec["launches"]),
            "dispatch_after": _since(kernel_dispatch_counts(),
                                     rec["dispatch"]),
            "calls_after": eng.prefills_here - rec["prefills"]
            + eng.stats["decode_steps"] - rec["decode_steps"],
            "tok_s_before": eng.at_loss["emitted"]
            / max(eng.at_loss["t"] - eng.run_started, 1e-9),
            "tok_s_after": (eng.stats["emitted"] - rec["emitted"])
            / max(eng.run_ended - rec["t"], 1e-9)}
    return {"rank": mesh.rank, "mesh": mesh_spec(mesh),
            "status": "served", "final_mesh": mesh_spec(final),
            "final_rank": final.rank, "recoveries": eng.recoveries,
            "recovery_log": list(eng.recovery_log),
            "replayed_calls": eng.replayed_calls,
            "remesh": list(eng.remesh_log), **recovery,
            "backend": mesh.backend, "device": str(mesh.device),
            "tokens": {r: list(o.tokens) for r, o in eng.outputs.items()},
            "stats": dict(eng.stats), "mode": eng.mode.value,
            "mode_history": [(c, m.value) for c, m in eng.mode_history],
            "b_sparsity": eng.b_sparsity, "peak_active": eng.peak_active,
            "buckets": sorted(eng.prefill_buckets),
            "cache_len": eng.cache_len, "dispatch": run.dispatch,
            "launches": run.launches, "digest": digest,
            "prefills_here": eng.prefills_here,
            "sharded_leaves": sharded_leaves(eng.params),
            "griffin_blocks": sorted({(g.block_k, g.block_n, g.a_thr)
                                      for g in griffin_leaves(eng.params)},
                                     key=str),
            "arena_bytes": {k: t.numel() * t.element_size()
                            for k, t in eng.cache.items()},
            "gathers": {a: sum(m.gathers[a] for m in meshes)
                        for a in mesh.gathers},
            "model_gathers": {
                "prefill": eng.prefill_gathers,
                "decode": sum(m.gathers["model"] for m in meshes)
                - eng.prefill_gathers},
            "gather_s": {a: sum(m.gather_s[a] for m in meshes)
                         for a in mesh.gather_s},
            "gather_sites": _sum_sites(meshes),
            "seconds": run.seconds}


def _sum_sites(meshes) -> Dict[str, Dict[str, float]]:
    """The meshes' gathers by call site (``Mesh.sites``), summed: the
    count, the host seconds until the local tensor was ready and in all."""
    out: Dict[str, Dict[str, float]] = {}
    for m in meshes:
        for site, (n, ready, total) in m.sites.items():
            o = out.setdefault(site, {"n": 0, "ready_s": 0.0, "s": 0.0})
            o["n"] += n
            o["ready_s"] += ready
            o["s"] += total
    return out


def serve_on_mesh(spec: str, device: Optional[str] = "cuda",
                  threads: int = 1, **kw) -> List[Dict]:
    """:func:`serve` (``kw``: its arguments) on a ``"DxM"`` mesh, one
    rank a position (``launch.mesh.run_ranks``): every rank draws the
    seeded weights on its device, keeps its share and serves the trace.
    Returns each rank's :func:`mesh_rank` record in rank order (under
    ``torchrun``, this rank's alone).  Raises when a rank fails."""
    return mesh_cells_on(spec, [dict(kw, device=device)], device=device,
                         threads=threads)[0]


def mesh_cells_on(spec: str, cells: Sequence[Dict], device="cuda",
                  threads: int = 1) -> List[List[Dict]]:
    """Several :func:`mesh_rank` runs (each cell a dict of :func:`serve`
    arguments) in turn on one set of ranks, to pay for one spawn: a list
    per cell of the ranks' records."""
    per_rank = run_ranks(mesh_cells, serve_mesh(spec), list(cells),
                         device=device, threads=threads)
    return [[recs[i] for recs in per_rank] for i in range(len(cells))]


def _draw_key(kw: Dict) -> Tuple:
    """What :func:`serve`'s draw of the weights depends on (its defaults
    where ``kw`` leaves them out)."""
    conf = kw.get("config") or EngineConfig()
    return (kw.get("arch", "llama3.2-1b"), kw.get("reduced", False),
            kw.get("sparsity", 0.8), kw.get("seed", 0),
            conf.kernels.use_kernels, conf.kernels.plan)


def mesh_cells(mesh, cells: Sequence[Dict]) -> List[Dict]:
    """The ranks' side of :func:`mesh_cells_on`.  A cell that draws the
    same weights as the cell before it (same arch, width, sparsity, seed,
    kernels and plan) serves that cell's tree, which a second draw would
    give bit for bit, and draws nothing."""
    out, prev = [], None
    for kw in cells:
        key, own = _draw_key(kw), "params" in kw
        if not own and prev is not None and prev[0] == key:
            kw = dict(kw, params=prev[1])
        drawn: Dict = {}
        out.append(mesh_rank(mesh, kw, drawn))
        prev = None if own else (key, drawn["tree"])
    return out


@dataclasses.dataclass
class RouteRun:
    """What :func:`route` did: the router (outputs, ``stats``,
    ``health_log``, the queue and the ladder), every engine ``make_engine``
    built (the killed ones and the rejoined ones too, in build order), the
    trace, the served params, the wall time, the GEMM dispatch counts and
    the device memory the replicas took on top of the weights
    (``build_bytes``, None off the card)."""

    router: RouterEngine
    engines: List[ServeEngine]
    requests: List
    params: Dict
    seconds: float
    dispatch: Dict[str, int]
    build_bytes: Optional[int]

    def total(self, key: str) -> int:
        """``key`` of the engines' stats, summed over every engine."""
        return sum(e.stats[key] for e in self.engines)

    @property
    def model_calls(self) -> int:
        return self.total("prefill_calls") + self.total("decode_steps")

    @property
    def delivered(self) -> int:
        """Tokens of the completed requests (what the clients got)."""
        return sum(len(o.tokens) for o in self.router.outputs.values()
                   if o.finished >= 0)

    @property
    def tokens_per_second(self) -> float:
        return self.delivered / max(self.seconds, 1e-9)

    @property
    def syncs_per_token(self) -> float:
        """Host syncs per emitted token, both summed over every engine."""
        return self.total("host_syncs") / max(self.total("emitted"), 1)

    def summary(self) -> Dict:
        """The virtual-tick row of the reference benchmark's router rows:
        the latency summary plus queue depth, ticks and ladder history."""
        rows = slo.request_rows(self.router.outputs, self.requests)
        ladder = self.router.ladder
        return dict(slo.latency_summary(rows),
                    max_queue_depth=self.router.max_queue_depth,
                    ticks=self.router.clock,
                    ladder_history=[list(t) for t in ladder.history]
                    if ladder else [])


def build_router(api, params, econf: EngineConfig, plan=None
                 ) -> Tuple[RouterEngine, List[ServeEngine]]:
    """The router ``econf.router`` describes, over engines that all serve
    the *same* ``params`` (one set of weights on the device), and the list
    that every engine ``make_engine`` builds (a rejoining replica's fresh
    engine too) is appended to.  The queue bound is
    ``router.queue_bound``, or 2 x slots x replicas when unset, or none
    under ``shed_policy="none"``; ``"degrade"`` adds the pressure ladder
    (``DegradationConfig()``); ``fault.inject`` may hold one ``replica:``
    spec, or a ``kill:``/``delay:`` spec that arms every engine built
    (:func:`fault_hooks`), as in the reference.  ``plan`` (a tuned family
    plan) reaches every engine built."""
    rc = econf.router
    if rc.replicas < 1:
        raise ValueError("the router needs router.replicas >= 1")
    if rc.shed_policy not in ("none", "shed", "degrade"):
        raise ValueError(f"unknown shed policy {rc.shed_policy!r}")
    spec = (parse_fault_spec(econf.fault.inject) if econf.fault.inject
            else None)
    faults = ([spec.build_replica()] if spec is not None
              and spec.kind == "replica" else [])
    bound = rc.queue_bound
    if rc.shed_policy == "none":
        bound = None
    elif bound is None:
        bound = 2 * econf.arena.num_slots * rc.replicas
    engines: List[ServeEngine] = []

    def make_engine() -> ServeEngine:
        eng = ServeEngine(api, params, econf, plan=plan,
                          **fault_hooks(econf, api.device))
        engines.append(eng)
        return eng

    router = RouterEngine(
        make_engine, rc.replicas, queue_bound=bound,
        hedge_after=rc.hedge_after, replica_faults=faults,
        degradation=(DegradationConfig() if rc.shed_policy == "degrade"
                     else None))
    return router, engines


def route(arch: str = "llama3.2-1b", *, reduced: bool = False,
          requests: int = 8, prompt_lens: Sequence[int] = (8, 16, 32),
          gen_lens: Sequence[int] = (4, 8, 16), arrival_every: int = 0,
          length_dist: str = "choice", max_gen: Optional[int] = None,
          sparsity: float = 0.8, seed: int = 0, trace_seed: int = 1,
          device: Optional[str] = "cuda",
          config: Optional[EngineConfig] = None,
          params: Optional[Dict] = None, **trace_kw) -> RouteRun:
    """:func:`serve`'s model and trace (``params`` as there) served by
    ``config.router.replicas`` engines behind the SLO-aware router, as the
    reference's ``serve.py --replicas N`` does (:func:`build_router`)."""
    econf = config or EngineConfig()
    api, params, reqs, econf, plan = _setup(
        arch, reduced, sparsity, seed, device, econf, requests, prompt_lens,
        gen_lens, arrival_every, length_dist, max_gen, trace_seed, trace_kw,
        params)
    on_card = api.device.type == "cuda"
    _sync(api)
    mem0 = torch.cuda.memory_allocated(api.device) if on_card else 0
    router, engines = build_router(api, params, econf, plan=plan)
    build_bytes = (torch.cuda.memory_allocated(api.device) - mem0
                   if on_card else None)
    before = kernel_dispatch_counts()
    _sync(api)
    t0 = time.perf_counter()
    router.run(reqs)
    _sync(api)
    dt = time.perf_counter() - t0
    after = kernel_dispatch_counts()
    dispatch = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    return RouteRun(router, engines, reqs, params, dt, dispatch, build_bytes)


def replay_oracle(engines: Sequence[ServeEngine], params: Dict, requests,
                  tokens: Dict[int, List[int]]) -> int:
    """Replay each of ``requests`` through the batch-1 greedy oracle under
    the engines' scope and compare with ``tokens[rid]``; raise on the
    first divergence.  Returns the number of requests checked.  Refused:
    int8 KV pages (gated by a logit tolerance, not by token equality), an
    engine whose Mode changed mid-run, and engines in different Modes (a
    single-mode replay would compare across categories)."""
    eng = engines[0]
    if eng._paged is not None and eng._paged.kv_dtype == "int8":
        raise ValueError("int8 KV pages are gated by a logit tolerance, "
                         "not by token parity with the greedy oracle")
    for e in engines:
        if len(e.mode_history) > 1:
            raise RuntimeError("execution mode changed mid-run: "
                               f"{e.mode_history}; a single-mode oracle "
                               "replay would compare across categories")
    if len({e.mode for e in engines}) != 1:
        raise RuntimeError("replicas ran in different modes: "
                           f"{[e.mode for e in engines]}")
    for r in requests:
        with eng._scope():
            ref = greedy_generate(
                eng.api, params, r.as_batch(eng.device),
                steps=r.max_new_tokens, cache_len=eng.cache_len,
                prompt_bucket=eng.bucket_for(r.prompt_len))
        got, want = tokens[r.rid], ref[0].tolist()
        if got != want:
            raise AssertionError(f"request {r.rid} diverged from the greedy "
                                 f"oracle: {got} vs {want}")
    return len(requests)


def check_parity(run: ServeRun) -> int:
    """Replay every request through the batch-1 greedy oracle
    (:func:`replay_oracle`).  Returns the number of requests checked."""
    eng = run.engine
    return replay_oracle([eng], run.params, run.requests,
                         {rid: o.tokens for rid, o in eng.outputs.items()})


def check_route_parity(run: RouteRun,
                       rids: Optional[Sequence[int]] = None) -> int:
    """Replay every completed request (or those of ``rids``) through the
    batch-1 greedy oracle (:func:`replay_oracle`).  Returns the number of
    requests checked."""
    outs = run.router.outputs
    reqs = [r for r in run.requests if outs[r.rid].finished >= 0
            and (rids is None or r.rid in rids)]
    return replay_oracle(run.engines, run.params, reqs,
                         {r.rid: outs[r.rid].tokens for r in reqs})


def _print_slo(rows, summary) -> None:
    """Per-request SLO attainment table and the aggregate latency summary
    (virtual ticks)."""
    print("per-request SLO attainment (virtual ticks):")
    for r in rows:
        mark = {True: "ok", False: "MISS", None: "-"}[r["attained"]]
        ttft = r["ttft"] if r["ttft"] is not None else "-"
        done = r["completion"] if r["completion"] is not None else "-"
        print(f"  rid {r['rid']:>3} prio {r['priority']} ttft {ttft:>4} "
              f"done {done:>4} tokens {r['tokens']:>3} "
              f"{r['attribution']:<8} {mark}")
    print(f"SLO summary: {summary['completed']}/{summary['requests']} "
          f"completed, {summary['shed']} shed, "
          f"ttft p50/p99 {summary['ttft_p50']}/{summary['ttft_p99']}, "
          f"itl p50/p99 {summary['itl_p50']}/{summary['itl_p99']}, "
          f"attainment {summary['slo_attainment']}")


def _main_router(args, econf: EngineConfig, trace: Dict) -> None:
    """``--replicas N``: route the trace, print the router's record and
    the SLO rows, then the overload smoke's and the parity's checks."""
    run = route(args.arch, reduced=args.reduced, sparsity=args.sparsity,
                seed=args.seed, device=args.device, config=econf, **trace)
    router = run.router
    e0 = run.engines[0]
    rc = e0.config.router
    bound = router.queue.bound
    print(f"router: {rc.replicas} replicas x {e0.num_slots} slots on "
          f"{e0.device}, queue bound {bound or 'unbounded'}, shed policy "
          f"{rc.shed_policy}, hedge after {rc.hedge_after or 'off'}, "
          f"weight sparsity {e0.b_sparsity:.2f} -> mode {e0.mode.value}")
    print(f"routed {len(run.requests)} requests / {run.delivered} tokens in "
          f"{run.seconds:.2f}s ({run.tokens_per_second:.1f} tok/s) over "
          f"{router.clock} virtual ticks; stats {router.stats}, max queue "
          f"depth {router.max_queue_depth}"
          + (f", ladder history {router.ladder.history}"
             if router.ladder else "")
          + f"; {len(run.engines)} engines built, {run.model_calls} model "
          f"calls, {run.syncs_per_token:.3f} host syncs/token, dispatch "
          f"{run.dispatch}")
    if router.faults:
        print(f"replica fault log: {router.health_log}")
        if router.stats["completed"] + router.stats["shed"] < \
                len(run.requests):
            raise SystemExit("router fault run left requests unaccounted")
    rows = slo.request_rows(router.outputs, run.requests)
    _print_slo(rows, slo.latency_summary(rows))
    if args.overload_smoke:
        if bound is None:
            raise SystemExit("--overload-smoke needs a bounded queue")
        if router.max_queue_depth > bound:
            raise SystemExit(f"queue depth {router.max_queue_depth} "
                             f"exceeded bound {bound}")
        if router.stats["shed"] == 0:
            raise SystemExit("overload trace shed nothing — not actually "
                             "overloaded?")
        print(f"overload smoke OK: depth {router.max_queue_depth} <= "
              f"{bound}, shed {router.stats['shed']}")
    if args.parity:
        if any(len(e.mode_history) > 1 for e in run.engines):
            print("parity SKIPPED: execution mode changed mid-run")
            return
        n = check_route_parity(run)
        print(f"parity OK: {n} completed requests token-identical to "
              "greedy_generate")


def _main_mesh(args, econf: EngineConfig, trace: Dict) -> None:
    """``--mesh DxM``: serve on the mesh's ranks and print the record of
    the first rank that served to the end (every such rank's host state
    was held equal), after a fault the recovery line, then the parity
    check: that rank's tokens against ``greedy_generate`` on the whole
    weights, on this process's device."""
    import os
    lead = int(os.environ.get("RANK", "0")) == 0
    if lead:
        print(backend_line(serve_mesh(econf.mesh), args.device))
    recs = serve_on_mesh(econf.mesh, device=args.device, arch=args.arch,
                         reduced=args.reduced, sparsity=args.sparsity,
                         seed=args.seed, config=econf,
                         evict_after=args.evict_after, **trace)
    if not lead:
        return
    served = [r for r in recs if r["status"] == "served"]
    if not served:
        raise SystemExit(f"no rank served to the end: "
                         f"{[r['status'] for r in recs]}")
    rec = served[0]
    if any(r["tokens"] != rec["tokens"] for r in served):
        raise SystemExit("the ranks' tokens differ")
    st = rec["stats"]
    calls = max(rec["prefills_here"] + st["decode_steps"], 1)
    syncs = st["host_syncs"] / max(st["emitted"], 1)
    mg = rec["model_gathers"]
    print(f"engine: {econf.arena.num_slots} slots x cache_len "
          f"{rec['cache_len']} on {len(recs)} rank(s) of mesh {rec['mesh']}"
          f" ({rec['device']}), weight sparsity {rec['b_sparsity']:.2f} -> "
          f"mode {rec['mode']}, {rec['sharded_leaves']} sharded leaves a "
          f"rank")
    print(f"served {len(rec['tokens'])} requests / {st['emitted']} tokens "
          f"in {rec['seconds']:.2f}s "
          f"({st['emitted'] / max(rec['seconds'], 1e-9):.1f} tok/s); "
          f"{st['decode_steps']} decode steps in {st['chunk_calls']} fused "
          f"chunks, {st['prefill_calls']} prefills over buckets "
          f"{rec['buckets']}, {syncs:.3f} host syncs/token, dispatch "
          f"{rec['dispatch']}; rank 0: {rec['gathers']['model']} "
          f"model-axis gathers ({rec['gathers']['model'] / calls:.1f} a "
          f"model call, {1e3 * rec['gather_s']['model'] / calls:.3f} ms; "
          f"{mg['prefill'] / max(rec['prefills_here'], 1):.1f} a prefill, "
          f"{mg['decode'] / max(st['decode_steps'], 1):.1f} a decode step),"
          f" {rec['gathers']['data']} data-axis gathers; arena "
          f"{sum(rec['arena_bytes'].values())} B a rank; host states equal "
          f"on every rank of mesh {rec['final_mesh']}")
    if econf.fault.inject is not None:
        done = sum(len(t) > 0 for t in rec["tokens"].values())
        if done != trace["requests"]:
            raise SystemExit(f"fault run finished {done}/"
                             f"{trace['requests']} requests")
        left = ", ".join(f"rank {r['rank']} {r['status']}" for r in recs
                         if r["status"] != "served")
        print(f"fault injected ({econf.fault.inject}): {rec['recoveries']} "
              f"recoveries, log {rec['recovery_log']}, final mesh "
              f"{rec['final_mesh']}; all {done} requests completed"
              + (f" ({left})" if left else ""))
    if args.max_syncs_per_token > 0 and syncs > args.max_syncs_per_token:
        raise SystemExit(f"host syncs/token {syncs:.3f} exceeds "
                         f"{args.max_syncs_per_token}")
    where = f"mesh {rec['mesh']}" + (
        f", final mesh {rec['final_mesh']}"
        if rec["final_mesh"] != rec["mesh"] else "")
    if not args.parity:
        print(f"done: {where}")
        return
    if len(rec["mode_history"]) > 1:
        print(f"parity SKIPPED: execution mode changed mid-run "
              f"({rec['mode_history']}); {where}")
        return
    kw = {k: v for k, v in trace.items()
          if k not in ("requests", "prompt_lens", "gen_lens",
                       "arrival_every", "length_dist")}
    api, params, reqs, ec, plan = _setup(
        args.arch, args.reduced, args.sparsity, args.seed, args.device,
        dataclasses.replace(econf, mesh=None), trace["requests"],
        trace["prompt_lens"], trace["gen_lens"], trace["arrival_every"],
        trace["length_dist"], None, 1, kw)
    eng = ServeEngine(api, params, ec, plan=plan)
    n = replay_oracle([eng], params, reqs, rec["tokens"])
    print(f"parity OK: all {n} requests token-identical to greedy_generate "
          f"on the whole weights; {where}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, metavar="PATH",
                    help="EngineConfig JSON (runtime.config.EngineConfig"
                         ".to_json); flags set explicitly override it")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=None,
                    help="serve from the paged KV arena: power-of-two "
                         "tokens per page; default keeps the fixed "
                         "num_slots x cache_len arena")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="physical page-pool size (default: the fixed "
                         "arena's capacity + the DUMP page)")
    ap.add_argument("--kv-dtype", choices=("fp32", "int8"), default="fp32",
                    help="paged KV page dtype: int8 stores quantized pages "
                         "with per-token-row scales (gated logit "
                         "tolerance; fp32, the cache's own dtype, stays "
                         "token-exact)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-lens", default="8,16,32")
    ap.add_argument("--gen-lens", default="4,8,16")
    ap.add_argument("--arrival-every", type=int, default=0)
    ap.add_argument("--arrival-process", choices=("fixed", "bursty"),
                    default="fixed",
                    help="'bursty' draws Markov-modulated arrival gaps "
                         "(seeded, replayable) instead of the fixed "
                         "--arrival-every stagger")
    ap.add_argument("--rate", type=float, default=0.5,
                    help="bursty calm-state arrival rate (requests/tick)")
    ap.add_argument("--burst-rate", type=float, default=4.0,
                    help="bursty burst-state arrival rate (requests/tick)")
    ap.add_argument("--length-dist", choices=("choice", "heavy"),
                    default="choice",
                    help="'heavy' draws Pareto generation lengths (tail "
                         "stragglers) instead of a uniform choice over "
                         "--gen-lens")
    ap.add_argument("--priorities", default="0",
                    help="comma-separated priority classes drawn per "
                         "request (0 = most important)")
    ap.add_argument("--slo", default=None, metavar="SPEC",
                    help="attach virtual-tick SLOs to the trace: "
                         "'ttft=<ticks>,slack=<factor>' (either half "
                         "optional); deadlines drive the router's EDF "
                         "admission and the attainment summary")
    ap.add_argument("--sparsity", type=float, default=0.8)
    ap.add_argument("--use-kernels", action="store_true",
                    help="compact pruned weights into GriffinWeights and "
                         "run every GEMM through the hand-written kernels; "
                         "default keeps the pruned-dense twin on plain "
                         "torch matmuls")
    ap.add_argument("--policy", choices=("continuous", "static"),
                    default="continuous")
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="fused decode steps per host round-trip")
    ap.add_argument("--measure-every", type=int, default=8)
    ap.add_argument("--max-syncs-per-token", type=float, default=0.0,
                    help="fail when host_syncs/token exceeds this "
                         "(0 disables)")
    ap.add_argument("--parity", action="store_true",
                    help="check engine tokens == greedy_generate per request")
    ap.add_argument("--replicas", type=int, default=0, metavar="N",
                    help="serve through the SLO-aware multi-replica router: "
                         "N engines sharing one set of weights behind one "
                         "bounded-EDF admission queue; 0 keeps the "
                         "single-engine path")
    ap.add_argument("--queue-bound", type=int, default=0,
                    help="router admission-queue bound (0 = 2 x slots x "
                         "replicas, unless --shed-policy none)")
    ap.add_argument("--hedge-ms", type=int, default=0,
                    help="router tail-latency hedge: a dispatched request "
                         "with no first token after this many virtual "
                         "ticks is re-dispatched to a second replica and "
                         "the loser cancelled (0 = off)")
    ap.add_argument("--shed-policy", choices=("none", "shed", "degrade"),
                    default="shed",
                    help="router overload response: 'none' = unbounded "
                         "queue, 'shed' = bounded queue, 'degrade' = "
                         "bounded queue + the pressure ladder (chunk cap "
                         "-> cheaper Mode -> priority shed)")
    ap.add_argument("--inject-fault", default=None, metavar="SPEC",
                    help="deterministic chaos: 'kill:<dev>@<step>[:<phase>]'"
                         " raises a device loss for device index <dev> (on "
                         "--mesh: the rank at that position) at engine "
                         "step <step> (phase admission|prefill|decode, "
                         "default decode), and the engine rolls back to "
                         "its tick-start snapshot, remeshes onto the "
                         "survivors on a mesh, and replays the tick; "
                         "'delay:<host>@<step>[:<factor>]' inflates one "
                         "host's (a mesh's data row's) step times for the "
                         "straggler detector; with --replicas, 'replica:<i>@<tick>"
                         "[:<during>[:<recover>]]' kills a whole replica "
                         "(during prefill|decode|idle|any)")
    ap.add_argument("--snapshot-dir", default=None,
                    help="write tick-start snapshots through "
                         "checkpoint.save here and recover through "
                         "checkpoint.restore (default keeps snapshots in "
                         "host memory)")
    ap.add_argument("--evict-after", type=int, default=3,
                    help="straggler eviction streak for delay faults; no "
                    "effect on one device, whose one host is its own median "
                    "and is never evicted")
    ap.add_argument("--overload-smoke", action="store_true",
                    help="with --replicas: fail unless the queue stayed "
                         "within its bound and shed work")
    ap.add_argument("--plan", default=None, metavar="PATH",
                    help="tuned kernel plan JSON (repro_torch.launch"
                         ".autotune): this model family's entry steers "
                         "weight-compaction granularity and Mode-selection "
                         "thresholds; griffin_spmm gives the default "
                         "compaction's bits at every granularity")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve on a data x model mesh of D*M ranks (e.g. "
                         "2x2; spawned here, gloo on the host, nccl with a "
                         "card per rank, else gloo on CUDA tensors); '1x1' "
                         "is the single-device engine")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="without --mesh: plan the mesh over the cards "
                         "(on the host: this many ranks) with at most this "
                         "model-parallel degree")
    ap.add_argument("--spmd-fallback", action="store_true",
                    help="serve >1 meshes through the decompaction / "
                         "dense-product oracle instead of the kernels' "
                         "shard entries (the parity baseline)")
    ap.add_argument("--remesh-model-parallel", type=int, default=None,
                    help="model-parallel cap of the mesh the survivors of a "
                         "device loss or a straggler eviction form on "
                         "--mesh (default: the mesh's model axis)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    econf = EngineConfig.from_args(
        args, defaults={d: ap.get_default(d) for d in vars(args)})
    ttft, slack = _parse_slo(args.slo) if args.slo else (None, None)
    trace = dict(requests=args.requests,
                 prompt_lens=_lens(args.prompt_lens),
                 gen_lens=_lens(args.gen_lens),
                 arrival_every=args.arrival_every,
                 arrival_process=args.arrival_process, rate=args.rate,
                 burst_rate=args.burst_rate, length_dist=args.length_dist,
                 priorities=_lens(args.priorities), deadline_slack=slack,
                 ttft_deadline=ttft)
    if args.spmd_fallback:
        econf = econf.with_fields(spmd_kernels=False)
    if econf.mesh is None and args.model_parallel > 1:
        cards = (torch.cuda.device_count() if args.device != "cpu"
                 else args.model_parallel)
        econf = econf.with_fields(
            mesh=plan_mesh(max(cards, 1), args.model_parallel).spec)
    if econf.mesh is not None and econf.mesh != "1x1":
        if econf.router.replicas > 0:
            raise SystemExit("the router serves single-device replicas; "
                             "--mesh and --replicas do not combine")
        _main_mesh(args, econf, trace)
        return
    if econf.router.replicas > 0:
        _main_router(args, econf, trace)
        return
    run = serve(args.arch, reduced=args.reduced, sparsity=args.sparsity,
                seed=args.seed, device=args.device, config=econf,
                evict_after=args.evict_after, **trace)
    eng = run.engine
    spec = eng._paged
    arena = ("fixed" if spec is None else
             f"paged, {spec.num_pages} pages of {spec.page_size}")
    kv = "" if spec is None else f", {spec.kv_dtype} pages"
    print(f"engine: {eng.num_slots} slots x cache_len {eng.cache_len} "
          f"({arena}){kv} on {eng.device}, policy {eng.sched.policy}, "
          f"{'fused' if eng.fused else 'stepwise'}, peak "
          f"{eng.peak_active} slots active, "
          f"weight sparsity {eng.b_sparsity:.2f}, "
          f"declared activation sparsity {eng.a_declared} -> mode "
          f"{eng.mode.value}")
    st = eng.stats
    print(f"served {len(run.requests)} requests / {st['emitted']} tokens in "
          f"{run.seconds:.2f}s ({run.tokens_per_second:.1f} tok/s); "
          f"{st['decode_steps']} decode steps in {st['chunk_calls']} fused "
          f"chunks, {st['prefill_calls']} prefills over buckets "
          f"{sorted(eng.prefill_buckets)}, {run.syncs_per_token:.3f} host "
          f"syncs/token, dispatch {run.dispatch}")
    print("request 0 token ids:",
          np.asarray(eng.outputs[run.requests[0].rid].tokens[:12]))
    if args.slo:
        rows = slo.request_rows(eng.outputs, run.requests)
        _print_slo(rows, slo.latency_summary(rows))
    if econf.fault.inject is not None:
        done = sum(o.finished >= 0 and len(o.tokens) > 0
                   for o in eng.outputs.values())
        if done != len(run.requests):
            raise SystemExit(f"fault run finished {done}/"
                             f"{len(run.requests)} requests")
        print(f"fault injected ({econf.fault.inject}): {eng.recoveries} "
              f"recoveries, log {eng.recovery_log}, {eng.replayed_calls} "
              f"model calls replayed; all {done} requests completed")
    if args.max_syncs_per_token > 0 and \
            run.syncs_per_token > args.max_syncs_per_token:
        raise SystemExit(f"host syncs/token {run.syncs_per_token:.3f} "
                         f"exceeds {args.max_syncs_per_token}")
    if args.parity:
        if spec is not None and spec.kv_dtype == "int8":
            print("parity SKIPPED: int8 KV pages are gated by logit "
                  "tolerance, not token equality")
            return
        if len(eng.mode_history) > 1:
            # as in the reference: tokens before a measured category flip
            # came from the previous Mode's kernels, so a single-Mode
            # oracle replay would compare across categories
            print("parity SKIPPED: execution mode changed mid-run "
                  f"({[(s, m.value) for s, m in eng.mode_history]})")
            return
        n = check_parity(run)
        print(f"parity OK: all {n} requests token-identical to "
              "greedy_generate")


if __name__ == "__main__":
    main()
