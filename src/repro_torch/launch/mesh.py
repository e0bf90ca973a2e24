"""Serving meshes over ``torch.distributed`` — the counterpart of
``repro/launch/mesh.py``.

A ("data", "model") mesh of D x M positions is D x M processes, one rank
each (rank r at data row r // M, model column r % M).  Each rank holds one
process group per axis: the "model" group of its data row (the ranks that
split every weight's output columns and gather them back) and the "data"
group of its model column (the ranks whose slot pools make up the engine's
slots).  :func:`run_ranks` starts the ranks (or joins ``torchrun``'s),
:class:`Mesh` is one rank's view, and :meth:`Mesh.gather` is the one
collective the serving path calls.

The backend rule is fixed, never a fallback:

* CPU tensors: ``gloo``;
* CUDA with a card per rank: ``nccl``, rank r on ``cuda:r``;
* CUDA with more ranks than cards: ``gloo`` on the CUDA tensors, rank r on
  ``cuda:(r mod cards)`` (NCCL refuses two ranks on one card).

The reference's ``make_production_mesh`` comes with the dry-run launcher
(ROADMAP 1.18).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..device import resolve_device

AXES = ("data", "model")
TIMEOUT_S = 120          # a collective no peer joins fails within this


def parse_mesh(spec: str) -> Tuple[int, int]:
    """(D, M) of a ``"DxM"`` spec, with the reference's parse errors."""
    parts = spec.lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() for p in parts):
        raise ValueError(f"mesh spec {spec!r} is not 'DxM' (e.g. '2x4')")
    d, m = int(parts[0]), int(parts[1])
    if d < 1 or m < 1:
        raise ValueError(f"mesh spec {spec!r}: axes must be >= 1")
    return d, m


@dataclasses.dataclass
class Mesh:
    """One rank's view of a (data, model) mesh: its shape, its rank, its
    device and, once joined (:func:`run_ranks`), its process group on each
    axis.  An unjoined mesh (``groups`` empty, ``device`` None) is a shape
    only: what :func:`serve_mesh` returns, and all a 1x1 mesh needs."""

    data: int
    model: int
    rank: int = 0                  # the position in the mesh, row-major
    device: Optional[torch.device] = None      # None: not placed yet
    backend: Optional[str] = None
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)
    axis_names: Tuple[str, ...] = AXES
    # the world rank at each position (None: position r is world rank r)
    # and the gloo group over the whole world, kept whole by regroup
    ranks: Optional[Tuple[int, ...]] = None
    world: Any = None
    # collectives made and their host seconds, by axis (the serving path's
    # per-model-call gathers are the "model" axis)
    gathers: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {a: 0 for a in AXES})
    gather_s: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {a: 0.0 for a in AXES})
    # the same gathers by call site (a sharded GEMM's columns "gemm", a
    # head share's output "heads", else the axis): [count, host seconds
    # until the local tensor was ready on its device, host seconds in all]
    sites: Dict[str, List] = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def members(self) -> List[int]:
        """The world ranks of the mesh, in position order."""
        return list(self.ranks) if self.ranks is not None \
            else list(range(self.size))

    @property
    def world_rank(self) -> int:
        return self.members[self.rank]

    def row_ranks(self, d: int) -> List[int]:
        """The world ranks of data row ``d``."""
        return self.members[d * self.model:(d + 1) * self.model]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.rank // self.model if axis == "data" \
            else self.rank % self.model

    def reset_counts(self) -> None:
        for a in AXES:
            self.gathers[a], self.gather_s[a] = 0, 0.0
        self.sites.clear()

    def gather(self, t: torch.Tensor, axis: str,
               site: Optional[str] = None) -> torch.Tensor:
        """(S, *t.shape): ``t`` from every rank of this rank's ``axis``
        group, in coordinate order (S the axis size).  Every rank of the
        group must call it with a tensor of the same shape and dtype.
        ``site`` names the caller in :attr:`sites` (default: ``axis``)."""
        size = self.shape[axis]
        if size == 1:
            return t[None]
        group = self.groups.get(axis)
        if group is None:
            raise RuntimeError(f"mesh {mesh_spec(self)} is not joined: "
                               "start its ranks with run_ranks")
        import torch.distributed as dist
        t0 = time.perf_counter()
        t = t.contiguous()
        if t.is_cuda and self.backend == "gloo":
            # gloo copies a CUDA tensor to the host, so the collective
            # waits for it anyway; waiting here splits that time out
            torch.cuda.current_stream(t.device).synchronize()
        ready = time.perf_counter() - t0
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t, group=group)
        dt = time.perf_counter() - t0
        self.gathers[axis] += 1
        self.gather_s[axis] += dt
        n = self.sites.setdefault(site or axis, [0, 0.0, 0.0])
        n[0], n[1], n[2] = n[0] + 1, n[1] + ready, n[2] + dt
        return torch.stack(parts)


def serve_mesh(spec: str = "1x1") -> Mesh:
    """The unjoined serving mesh of a ``"DxM"`` spec (data x model): the
    ``--mesh`` flag of ``launch/serve.py``.  ``"1x1"`` is the
    single-device special case.  Raises when the spec is malformed."""
    d, m = parse_mesh(spec)
    return Mesh(d, m)


def mesh_spec(mesh: Mesh) -> str:
    """The ``"DxM"`` spec of a mesh: the inverse of :func:`serve_mesh`."""
    return f"{mesh.shape.get('data', 1)}x{mesh.shape.get('model', 1)}"


def chips(mesh: Mesh) -> int:
    return mesh.size


def backend_for(device: torch.device, world: int) -> Tuple[str, str]:
    """(backend, the line that says why) of the fixed backend rule."""
    if device.type == "cpu":
        return "gloo", f"gloo on the host ({world} ranks, CPU tensors)"
    cards = torch.cuda.device_count()
    if cards >= world:
        return "nccl", f"nccl ({world} ranks, one card each)"
    return "gloo", (f"gloo on CUDA tensors ({world} ranks on {cards} "
                    f"card{'s' if cards != 1 else ''}: nccl takes one rank "
                    "a card)")


def rank_device(device: torch.device, rank: int) -> torch.device:
    """Rank ``rank``'s device: the host, or card ``rank`` mod the cards
    (``device`` resolved, so a CUDA device with no card has raised)."""
    device = resolve_device(device)
    if device.type == "cpu":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


# the process groups this process made after its join (a regroup's, and
# the names it skipped to stay level with the ranks that made more)
_GROUPS_MADE = [0]


def _join(shape: Mesh, rank: int, device: torch.device, store_dir: str,
          env: bool) -> Mesh:
    """Initialise this rank's process group (a ``FileStore`` under
    ``store_dir``, or ``torchrun``'s environment with ``env``) and make the
    per-axis groups; every rank makes every group, in the same order."""
    import torch.distributed as dist
    world = shape.size
    backend, _ = backend_for(device, world)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if env:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world, timeout=timeout)
    else:
        store = dist.FileStore(os.path.join(store_dir, "store"), world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, timeout=timeout)
    mesh = Mesh(shape.data, shape.model, rank=rank, device=dev,
                backend=backend)
    _GROUPS_MADE[0] = 0                  # a new world counts afresh
    _make_groups(mesh, join=True)
    mesh.world = mesh.groups["host"]
    return mesh


def _make_groups(mesh: Mesh, member: bool = True, join: bool = False
                 ) -> None:
    """The mesh's groups: a "model" group per data row, a "data" group per
    model column, and the gloo "host" group over the whole mesh (at the
    join on gloo, the world group itself).  Every process of the world
    makes every group in the same order, members or not
    (``dist.new_group`` names groups by a per-process count); ``member``
    False walks the groups of a mesh this process is not in."""
    import torch.distributed as dist
    D, M = mesh.data, mesh.model
    ranks = mesh.members
    groups = {}
    for d in range(D):
        g = dist.new_group(mesh.row_ranks(d))
        if member and d == mesh.index("data"):
            groups["model"] = g
    for m in range(M):
        g = dist.new_group([ranks[d * M + m] for d in range(D)])
        if member and m == mesh.index("model"):
            groups["data"] = g
    made = D + M
    if join and mesh.backend == "gloo":
        groups["host"] = dist.group.WORLD
    else:
        groups["host"] = dist.new_group(ranks, backend="gloo")
        made += 1
    if member:
        mesh.groups.update(groups)
    if not join:
        _GROUPS_MADE[0] += made


def regroup(mesh: Mesh, lost: Sequence[int], model_parallel: int
            ) -> Tuple[Any, Optional[Mesh]]:
    """The mesh after the world ranks ``lost`` are gone: the plan
    (``runtime.elastic.plan_mesh`` over the survivors in mesh order, the
    model axis at most ``model_parallel``) and this rank's view of the new
    mesh, or None where the plan leaves this rank out (a lost rank, or a
    survivor beyond the largest mesh that fits).  Every rank of ``mesh``
    calls this at a recovery, in the same order, the lost and the dropped
    ones too: ``dist.new_group`` must be called by every process, so the
    ranks first agree, over the old mesh's host group, on how many groups
    the most active of them has made, and each makes up the names it
    missed (a rank that left an earlier remesh of the run made none); the
    agreement is also the old mesh's barrier, so what its rows wrote to
    disk is there before anyone reads it.  Then every rank of the old
    mesh makes every new group.  A position keeps its device.  An unjoined
    mesh gives an unjoined view."""
    from ..runtime.elastic import plan_mesh, surviving
    survivors = surviving(mesh.members, lost)
    if not survivors:
        raise RuntimeError(f"no surviving ranks after losing {sorted(lost)}")
    plan = plan_mesh(len(survivors), model_parallel, devices=survivors)
    me = mesh.world_rank
    member = me in plan.devices
    new = Mesh(plan.data, plan.model,
               rank=plan.devices.index(me) if member else 0,
               device=mesh.device, backend=mesh.backend,
               ranks=tuple(plan.devices), world=mesh.world)
    if mesh.groups:
        import torch.distributed as dist
        made = torch.tensor([_GROUPS_MADE[0]], dtype=torch.int64)
        dist.all_reduce(made, op=dist.ReduceOp.MAX,
                        group=mesh.groups["host"])
        other = [0 if me else 1]
        for _ in range(int(made[0]) - _GROUPS_MADE[0]):
            dist.new_group(other)              # a name another rank used
        _GROUPS_MADE[0] = int(made[0])
        _make_groups(new, member=member)
    return plan, (new if member else None)


def _rank_main(rank: int, fn: Callable, shape: Mesh, args: tuple,
               device: str, store_dir: str, threads: int) -> None:
    """A spawned rank: join, run ``fn(mesh, *args)``, pickle its result
    under ``store_dir`` (an exception propagates and fails the run)."""
    import torch.distributed as dist
    if threads:
        torch.set_num_threads(threads)
    mesh = _join(shape, rank, torch.device(device), store_dir, env=False)
    try:
        out = fn(mesh, *args)
        with open(os.path.join(store_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    except BaseException:
        # the peers of a failed rank fail next (their collective loses its
        # peer), and the launcher may see their error first: each rank's
        # own error is kept, so the run names the rank that failed first
        with open(os.path.join(store_dir, f"rank{rank}.err"), "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, mesh: Mesh, *args, device="cuda",
              threads: int = 1) -> List[Any]:
    """Run ``fn(joined_mesh, *args)`` on every rank of ``mesh`` and return
    the results in rank order.  ``fn`` must be importable by module path
    (spawned ranks import it) and return picklable values.

    Outside ``torchrun`` (no ``WORLD_SIZE``) this spawns D x M ranks and
    waits for them; any rank that raises or exits non-zero fails the call
    (the others are stopped), and a collective no peer joins fails within
    ``TIMEOUT_S``.  Under ``torchrun`` this process is one rank: it joins
    and returns its own result alone.  A 1x1 mesh runs ``fn`` here on the
    unjoined mesh.  ``threads`` (0: leave as is) sets each spawned rank's
    torch threads.  The ranks run on the card unless ``device="cpu"``;
    with no card the default raises before any rank starts."""
    device = resolve_device(device)
    if "WORLD_SIZE" in os.environ:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        if world != mesh.size:
            raise ValueError(f"torchrun started {world} ranks for mesh "
                             f"{mesh_spec(mesh)}")
        joined = _join(mesh, rank, device, "", env=True)
        import torch.distributed as dist
        try:
            return [fn(joined, *args)]
        finally:
            dist.destroy_process_group()
    if mesh.size == 1:
        return [fn(Mesh(1, 1, device=rank_device(device, 0)), *args)]
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="mesh") as store_dir:
        try:
            mp.spawn(_rank_main, args=(fn, Mesh(mesh.data, mesh.model), args,
                                       str(device), store_dir, threads),
                     nprocs=mesh.size, join=True)
        except Exception as err:
            raise RuntimeError(_rank_errors(store_dir, mesh.size)) from err
        out = []
        for r in range(mesh.size):
            with open(os.path.join(store_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def check_ranks(mesh: Mesh, fail_rank: Optional[int] = None) -> Dict:
    """A rank's check of the mesh itself: it gathers every rank's
    coordinates over both axes and holds them to the layout (data row r //
    M, model column r % M); ``fail_rank`` raises on that rank instead,
    after the others have entered a collective, which the launcher must
    turn into a failed run, not a hang.  Returns the rank's view."""
    if mesh.rank == fail_rank:
        raise RuntimeError(f"rank {fail_rank} failed on purpose")
    me = torch.tensor([mesh.rank, mesh.index("data"), mesh.index("model")],
                      device=mesh.device)
    rows = mesh.gather(me, "model").cpu().tolist()
    cols = mesh.gather(me, "data").cpu().tolist()
    d, m = mesh.index("data"), mesh.index("model")
    if rows != [[d * mesh.model + j, d, j] for j in range(mesh.model)] or \
            cols != [[i * mesh.model + m, i, m] for i in range(mesh.data)]:
        raise RuntimeError(f"rank {mesh.rank}: mesh layout {rows} {cols}")
    return {"rank": mesh.rank, "coords": (d, m), "backend": mesh.backend,
            "device": str(mesh.device)}


def _rank_errors(store_dir: str, world: int) -> str:
    """The failed ranks' errors, the first to fail first."""
    errs = []
    for r in range(world):
        path = os.path.join(store_dir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                at, _, tb = f.read().partition("\n")
            errs.append((float(at), r, tb))
    if not errs:
        return "a mesh rank exited before it could report an error"
    return "mesh ranks failed, the first first:\n" + "\n".join(
        f"-- rank {r}:\n{tb}" for _, r, tb in sorted(errs))


def backend_line(mesh: Mesh, device="cuda") -> str:
    """The printed backend line of a mesh run on ``device``."""
    _, why = backend_for(resolve_device(device), mesh.size)
    return f"mesh {mesh_spec(mesh)}: {why}"


__all__ = ["AXES", "Mesh", "backend_for", "backend_line", "check_ranks",
           "chips", "mesh_spec", "parse_mesh", "regroup", "run_ranks",
           "serve_mesh"]
