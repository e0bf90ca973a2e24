"""Remeshing in the port (``MeshServeEngine``'s failure handling,
``launch.mesh.regroup``, ``runtime.elastic``, the per-row disk snapshots)
held against the JAX package's chaos matrix (``tests/test_fault_tolerance
.py``), on its reduced llama3.2-1b with its own weights bridged, and gloo
ranks on the host (``launch.serve.mesh_cells_on``, one spawn a mesh shape,
one torch thread a rank):

* the matrix: a kill of the last rank at admission, prefill and decode of
  step 3, on 2x2 -> 1x2 and on 2x4 -> 2x2 (``recovery_model_parallel``
  2), dense and compacted (Sparse.B) weights;
* a straggler eviction of data row 1 on 2x2 -> 1x2 (two ranks lost); a
  recovery from the per-row disk snapshots on 2x2 -> 1x2, whose manifests
  hold the scheduler; the paged arena (fp32 and int8 pages) killed on 2x2
  at every phase; a 2x1 mesh, where the lost rank's host snapshot is the
  only copy of its row, and its disk snapshots, whole rows as share 0;
* a 2x2-saved serving state (compacted weights, the arena, the promoted
  (B,) counters) restored on 1x2 leaf for leaf.

The arena splits its KV heads over the model ranks, so a remesh hands
over head shares: each share a new rank needs comes from the old rank
that held it, a survivor, or the lost rank's host copy where the lost
rank held it; the bytes are the share's and the CRCs agree on both ends.

Every run's tokens are held exactly against the reference's uninterrupted
unsharded ``ServeEngine`` on the same weights (the oracle of the
reference's own matrix; int8 pages: the port's unsharded int8 engine),
with its recoveries, final mesh and lost ranks; the ranks that leave
record why and made no GEMM dispatch or kernel launch after the loss; the
survivors' host-state digests are equal.  The reference's mesh engine
needs eight XLA host devices, which this pytest process cannot set, so
the reference's tokens come from its unsharded engine alone.
"""
import importlib
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.runtime.config import EngineConfig as JaxEngineConfig
from repro.runtime.engine import ServeEngine as JaxServeEngine
from repro.runtime.engine import synthetic_trace as jax_synthetic_trace
from repro.sparsity import sparsify_params as jax_sparsify
from repro_torch import bridge
from repro_torch.checkpoint import (keyed_leaves, read_manifest, restore,
                                   row_dir)
from repro_torch.configs import get_config
from repro_torch.kernels.griffin_spmm.ops import GriffinShard
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.runtime import sharding
from repro_torch.runtime.config import EngineConfig
from repro_torch.runtime.engine import _promote_arena
from repro_torch.runtime.mesh_serve import MeshServeEngine

ROOT = pathlib.Path(__file__).resolve().parent.parent
PRUNE = dict(block_k=16, block_n=16, unit=8)
PHASES = ("admission", "prefill", "decode")
# the reference's chaos engine and trace: 4 slots, cache 16, chunk 3
ENGINE = dict(num_slots=4, cache_len=16, decode_chunk=3)
TRACE = dict(requests=4, prompt_lens=(6, 10), gen_lens=(2, 4),
             arrival_every=1, trace_seed=11)
WEIGHTS = {"dense": False, "sparseB": True}
# (mesh, recovery_model_parallel, the survivors' mesh)
SHRINKS = {"2x2to1x2": ("2x2", None, "1x2"), "2x4to2x2": ("2x4", 2, "2x2")}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_REF: dict = {}


def _reference(sparse: bool):
    """The reference's reduced llama3.2-1b (PRNGKey 0; pruned 0.6 and
    compacted when ``sparse``), its uninterrupted unsharded tokens on the
    chaos trace (its kernels in interpret mode when sparse), and the
    weights bridged to the port."""
    if sparse not in _REF:
        cfg = jax_get_config("llama3.2-1b").reduced()
        api = jax_build_model(cfg)
        params = api.init(jax.random.PRNGKey(0))
        kw = {}
        if sparse:
            params = jax_sparsify(params, 0.6, **PRUNE)
            kw = dict(use_kernels=True, interpret=True)
        eng = JaxServeEngine(api, params, config=JaxEngineConfig()
                             .with_fields(**ENGINE, **kw))
        outs = eng.run(jax_synthetic_trace(
            cfg, num_requests=4, seed=11, prompt_lens=(6, 10),
            gen_lens=(2, 4), arrival_every=1))
        assert len(eng.mode_history) == 1
        _REF[sparse] = (
            {r: list(map(int, o.tokens)) for r, o in outs.items()},
            bridge.to_torch(jax.tree.map(np.asarray, params)))
    return _REF[sparse]


def _cell(sparse: bool, evict_after: int = 3, **fields):
    """:func:`launch.serve.serve`'s arguments for one faulted run on the
    bridged weights, every GEMM through the kernels' shard entries."""
    _, params = _reference(sparse)
    conf = EngineConfig().with_fields(**ENGINE, use_kernels=True, **fields)
    return dict(arch="llama3.2-1b", reduced=True, params=params,
                config=conf, evict_after=evict_after, **TRACE)


def _check(recs, want, final: str, lost, step=3) -> list:
    """Hold one faulted cell's records: the survivors' tokens, recovery
    (at engine step ``step``; None: the step the departed ranks left at),
    final mesh and digests; the departed ranks' status and their silence
    after the loss.  Returns the survivors' records."""
    served = [r for r in recs if r["status"] == "served"]
    left = [r for r in recs if r["status"] != "served"]
    if step is None:
        step = left[0]["step"]
    D, M = map(int, final.split("x"))
    assert len(served) == D * M
    assert len({r["digest"] for r in served}) == 1, "host states differ"
    for rec in served:
        assert rec["tokens"] == want, rec["rank"]
        assert rec["recoveries"] == 1 and rec["final_mesh"] == final
        assert rec["recovery_log"] == [{"step": step, "lost": lost,
                                        "mesh": final}]
        assert rec["calls_after"] > 0
        bucket = "shard" if M > 1 else "replicated" if D > 1 else "kernel"
        assert rec["dispatch_after"].get(bucket, 0) > 0
        assert rec["dispatch_after"].get("spmd_oracle", 0) == 0
    for rec in left:
        assert rec["status"] == ("lost" if rec["rank"] in lost
                                 else "dropped")
        assert rec["step"] == step and rec["final_mesh"] == final
        assert not any(rec["dispatch_after_loss"].values()), rec
        assert not any(rec["launches_after_loss"].values()), rec
    assert sorted(r["rank"] for r in left if r["status"] == "lost") == lost
    return served


_SPAWNS: dict = {}


def _share_bytes(spec: str) -> int:
    """The bytes of one rank's tick-start state on a ``spec`` mesh of the
    chaos engine: its data row's slots of k and v (fp32) at its share of
    the KV heads, and the row's positions, feedback tokens and owed-token
    counters (int32, int64, int32)."""
    D, M = map(int, spec.split("x"))
    cfg = get_config("llama3.2-1b").reduced()
    P = ENGINE["num_slots"] // D
    kv = 2 * cfg.num_layers * P * ENGINE["cache_len"] * \
        (cfg.num_kv_heads // M) * cfg.hd * 4
    return kv + P * (4 + 8 + 4)


def _paged_int8_tokens():
    """The port's uninterrupted unsharded int8-paged tokens on the dense
    bridged weights (the reference's int8 oracle is its own int8 run)."""
    if "int8" not in _REF:
        run = launch_serve.serve(device="cpu", **_cell(False, page_size=8,
                                                       kv_dtype="int8"))
        assert run.engine._paged.kv_dtype == "int8"
        _REF["int8"] = {r: list(o.tokens)
                        for r, o in run.engine.outputs.items()}
    return _REF["int8"]


def _spawn(spec: str, tmp_path_factory) -> dict:
    """Every cell of one mesh shape in one spawn (memoized)."""
    if spec in _SPAWNS:
        return _SPAWNS[spec]
    cells, snap = {}, None
    if spec in ("2x2", "2x4"):
        mp = SHRINKS["2x2to1x2" if spec == "2x2" else "2x4to2x2"][1]
        for w, sparse in WEIGHTS.items():
            for ph in PHASES:
                cells[f"{w}-{ph}"] = _cell(
                    sparse, inject=f"kill:-1@3:{ph}",
                    recovery_model_parallel=mp)
    if spec == "2x2":
        snap = str(tmp_path_factory.mktemp("remesh") / "snap")
        cells["straggler"] = _cell(False, inject="delay:1@0:50")
        cells["disk"] = _cell(False, inject="kill:-1@3:decode",
                              snapshot_dir=snap)
        for kv in ("fp32", "int8"):
            for ph in PHASES:
                cells[f"paged-{kv}-{ph}"] = _cell(
                    False, inject=f"kill:-1@3:{ph}", page_size=8,
                    kv_dtype=kv)
    if spec == "2x1":
        snap = str(tmp_path_factory.mktemp("remesh") / "snap")
        cells["lost-only-copy"] = _cell(True, inject="kill:1@3:decode")
        cells["disk"] = _cell(False, inject="kill:1@3:decode",
                              snapshot_dir=snap)
    recs = launch_serve.mesh_cells_on(spec, list(cells.values()),
                                      device="cpu")
    _SPAWNS[spec] = dict(zip(cells, recs), snap_dir=snap)
    return _SPAWNS[spec]


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("shrink", list(SHRINKS))
@pytest.mark.parametrize("weights", list(WEIGHTS))
def test_chaos_matrix(phase, shrink, weights, tmp_path_factory):
    """Kill the last rank at every injection point, on both mesh
    transitions, for both weight representations: the survivors remesh
    and finish with the reference's uninterrupted unsharded tokens."""
    spec, _, final = SHRINKS[shrink]
    recs = _spawn(spec, tmp_path_factory)[f"{weights}-{phase}"]
    want, _ = _reference(WEIGHTS[weights])
    D, M = map(int, spec.split("x"))
    served = _check(recs, want, final, [D * M - 1])
    # each head share of a row a new rank did not hold came from the old
    # rank that held it (the lost rank's host copy for its own share);
    # the bytes are the share's, and the sums agree on both ends
    sent = {(t["row"], t["share"], t["dst"]): t for r in recs
            for x in r["remesh"] for t in x["transfers"]
            if t["src"] == r["rank"]}
    got = [t for rec in served for t in rec["remesh"][0]["transfers"]]
    for rec in served:
        (x,) = rec["remesh"]
        assert x["mesh"] == final and x["regroup_s"] >= 0
        for t in x["transfers"]:
            assert t["src"] == t["row"] * M + t["share"]
            assert t["bytes"] == _share_bytes(spec)
            assert sent[(t["row"], t["share"], t["dst"])]["crc32"] == \
                t["crc32"]
    assert any(t["src"] == D * M - 1 for t in got)
    # each new rank has every share its new row and heads cover: its own
    # where it held one of them, the rest received
    FD, FM = map(int, final.split("x"))
    slots = ENGINE["num_slots"]
    for rec in served:
        d, m = divmod(rec["final_rank"], FM)
        rows = {s // (slots // D)
                for s in range(d * slots // FD, (d + 1) * slots // FD)}
        per = M // FM
        need = {(r, j) for r in rows for j in range(m * per, (m + 1) * per)}
        own = divmod(rec["rank"], M)
        came = {(t["row"], t["share"]) for t in rec["remesh"][0]["transfers"]
                if t["dst"] == rec["rank"]}
        assert own not in came and came | ({own} & need) == need


def test_chaos_straggler_eviction_drives_remesh(tmp_path_factory):
    """Data row 1 delayed 50x from the first tick: the detector (the ranks
    agree on one tick time) evicts it after three flagged ticks, and its
    two ranks leave through the same remesh: 2x2 -> 1x2, the reference's
    tokens."""
    recs = _spawn("2x2", tmp_path_factory)["straggler"]
    want, _ = _reference(False)
    _check(recs, want, "1x2", [2, 3], step=None)


def test_chaos_disk_snapshot_recovery_on_mesh(tmp_path_factory):
    """Snapshots on disk, a directory a data row's head share: the
    survivors restore their share of both rows through
    ``checkpoint.restore`` onto 1x2; each share's manifest holds the
    scheduler, the first row's first share's arrays the weights."""
    cells = _spawn("2x2", tmp_path_factory)
    want, _ = _reference(False)
    served = _check(cells["disk"], want, "1x2", [3])
    for rec in served:
        moved = rec["remesh"][0]["transfers"]
        assert {t["src"] for t in moved} == {"disk"}
        assert [(t["row"], t["share"]) for t in moved] == \
            [(0, rec["final_rank"]), (1, rec["final_rank"])]
        assert all(t["bytes"] == _share_bytes("2x2") for t in moved)
    snap = cells["snap_dir"]
    assert sorted(p.name for p in pathlib.Path(snap).iterdir()) == \
        ["row0-share0", "row0-share1", "row1-share0", "row1-share1"]
    for row in (0, 1):
        for share in (0, 1):
            man = read_manifest(row_dir(snap, row, share))
            assert "scheduler" in man["extra"]
            assert man["extra"]["share"] == share
            assert any(k.startswith("['params']") for k in man["keys"]) \
                == (row == 0 and share == 0)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("phase", PHASES)
def test_chaos_paged_mesh_kill(phase, kv_dtype, tmp_path_factory):
    """The paged arena on 2x2 killed at every phase: each page of the
    merged pool comes from the row whose slot owns it, and the 1x2
    survivors finish with the unsharded paged tokens (fp32: the
    reference's fixed-arena tokens; int8: the port's unsharded int8
    run)."""
    recs = _spawn("2x2", tmp_path_factory)[f"paged-{kv_dtype}-{phase}"]
    want = _reference(False)[0] if kv_dtype == "fp32" else \
        _paged_int8_tokens()
    _check(recs, want, "1x2", [3])


def test_chaos_disk_snapshot_of_an_unsplit_arena(tmp_path_factory):
    """Snapshots on disk on 2x1, where no head axis splits: each row's one
    rank saves the whole row as share 0 (the first row the weights too),
    and the 1x1 survivor restores both rows from disk and finishes with
    the reference's tokens."""
    cells = _spawn("2x1", tmp_path_factory)
    want, _ = _reference(False)
    (rec,) = _check(cells["disk"], want, "1x1", [1])
    moved = rec["remesh"][0]["transfers"]
    assert [(t["row"], t["share"], t["src"]) for t in moved] == \
        [(0, 0, "disk"), (1, 0, "disk")]
    assert all(t["bytes"] == _share_bytes("2x1") for t in moved)
    snap = cells["snap_dir"]
    assert sorted(p.name for p in pathlib.Path(snap).iterdir()) == \
        ["row0-share0", "row1-share0"]
    for row in (0, 1):
        man = read_manifest(row_dir(snap, row, 0))
        assert "scheduler" in man["extra"] and man["extra"]["share"] == 0
        assert any(k.startswith("['params']") for k in man["keys"]) \
            == (row == 0)


def test_chaos_lost_ranks_snapshot_is_the_rows_only_copy(tmp_path_factory):
    """2x1: one model rank a row, so when rank 1's device goes, the only
    copy of row 1's tick-start state is the lost rank's host snapshot; it
    sends it to the survivor and makes no launch, and the 1x1 survivor
    finishes with the reference's tokens."""
    recs = _spawn("2x1", tmp_path_factory)["lost-only-copy"]
    want, _ = _reference(True)
    (rec,) = _check(recs, want, "1x1", [1])
    (t,) = rec["remesh"][0]["transfers"]
    assert (t["row"], t["src"], t["dst"]) == (1, 1, 0) and t["bytes"] > 0


def test_chaos_checkpoint_reshards_2x2_to_1x2(tmp_path):
    """A serving state saved from 2x2 (each rank its share of its row's
    arena: its row's slots, its two of the four KV heads; the first
    row's first rank the whole compacted weights) restores on 1x2 leaf
    for leaf: the weights (``GriffinWeights`` fields), every rank's share
    of them, and on each 1x2 rank the arena with its promoted (B,)
    counters, the rows' shares put together and merged into the 1x2
    row's four slots at that rank's heads."""
    cfg = get_config("llama3.2-1b").reduced()
    api = build_model(cfg, device="cpu")
    _, params = _reference(True)
    gen = torch.Generator().manual_seed(0)
    whole = {k: (torch.randint(0, 9, v.shape, generator=gen).to(v.dtype)
                 if v.dtype in (torch.int32, torch.int64)
                 else torch.randn(v.shape, generator=gen).to(v.dtype))
             for k, v in _promote_arena(api.init_cache(4, 16), 4).items()}
    remaining = torch.tensor([3, 1, 0, 2], dtype=torch.int32)
    conf = EngineConfig().with_fields(**ENGINE, use_kernels=True,
                                      snapshot_dir=str(tmp_path))
    heads = {"k": 3, "v": 3}            # (L, B, S, KVH, hd); pos whole

    def cut(k, v, row, m, shares):
        v = v.narrow(max(axes[k], 0), 2 * row, 2)
        if k in heads:
            n = cfg.num_kv_heads // shares
            v = v.narrow(heads[k], m * n, n)
        return v

    axes = old_axes = None
    for rank in range(4):
        eng = MeshServeEngine(api, params, config=conf,
                              mesh=tmesh.Mesh(2, 2, rank=rank))
        axes, old_axes = eng._axes, eng._heads_ax
        assert old_axes == {"k": 3, "v": 3, "pos": None}
        d, m = divmod(rank, 2)
        for k, v in whole.items():
            eng.cache[k].copy_(cut(k, v, d, m, 2))
        eng._remaining.copy_(remaining[2 * d:2 * d + 2])
        eng._capture()
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["row0-share0", "row0-share1", "row1-share0", "row1-share1"]
    for rank in (0, 1):
        small = MeshServeEngine(api, params, config=conf,
                                mesh=tmesh.Mesh(1, 2, rank=rank))
        half = {"cache": {k: v.narrow(max(axes[k], 0), 0, 2)
                          for k, v in small.cache.items()},
                "tokens": small._tokens[:2],
                "remaining": small._remaining[:2]}
        shares = {(d, rank): restore(row_dir(str(tmp_path), d, rank), half,
                                     step=0) for d in (0, 1)}
        merged = small._merge(small._rows_from_shares(
            shares, tmesh.Mesh(2, 2), old_axes), 2)
        for k, v in whole.items():
            want = v if k not in heads else v.narrow(heads[k], 2 * rank, 2)
            assert torch.equal(merged["cache"][k], want), (rank, k)
        assert torch.equal(merged["remaining"], remaining)
    got = restore(row_dir(str(tmp_path), 0, 0), {"params": params},
                  step=0)["params"]
    flat = dict(keyed_leaves(got))
    for key, leaf in keyed_leaves(params):
        assert torch.equal(flat[key], leaf), key
    mesh = tmesh.Mesh(1, 2, rank=1)
    ours, want = (sharding.shard_params(t, mesh) for t in (got, params))
    wq, wq_want = ours["layers"]["wq"], want["layers"]["wq"]
    assert isinstance(wq, GriffinShard)
    for f in ("b_comp", "kidx", "cnt", "gather_inv"):
        assert torch.equal(getattr(wq, f), getattr(wq_want, f)), f


def test_smoke_remesh_cell(monkeypatch):
    """chip_smoke.py's mesh_remesh at reduced width on 2x2 gloo ranks: the
    kill fires at the clock and replays the model calls the card run
    gates on, ranks 2 and 3 leave as it expects, and the 1x2 survivors
    give the unfaulted engine's tokens and stats with every GEMM through a
    shard entry after the recovery (the clock and the calls depend on the
    trace and the scheduler only)."""
    monkeypatch.syspath_prepend(str(ROOT))
    smoke = importlib.import_module("chip_smoke")
    conf = EngineConfig().with_fields(decode_chunk=8, use_kernels=True,
                                      **smoke.MESH["arena"])
    cell = dict(arch="llama3.2-1b", reduced=True,
                sparsity=smoke.MESH["sparsity"], seed=smoke.SEED,
                config=conf.with_fields(inject=smoke.MESH_REMESH["inject"]),
                **smoke.TRACE)
    (recs,) = launch_serve.mesh_cells_on(smoke.MESH["spec"], [cell],
                                         device="cpu")
    plain = launch_serve.serve(device="cpu", **dict(cell, config=conf))
    want = {r: o.tokens for r, o in plain.engine.outputs.items()}
    (log,) = smoke.MESH_REMESH["log"]
    served = _check(recs, want, log["mesh"], log["lost"], step=log["step"])
    assert {r["rank"]: r["status"] for r in recs
            if r["status"] != "served"} == smoke.MESH_REMESH["left"]
    for rec in served:
        assert rec["replayed_calls"] == smoke.MESH_REMESH["replayed"]
        # the remesh drops the function sets, and the replay builds the
        # Mode's set again and counts it, as the reference's remesh does
        assert rec["stats"] == dict(plain.engine.stats,
                                    retraces=plain.engine.stats["retraces"]
                                    + 1)
        # reduced llama: 2 layers x 7 GEMMs + the tied head a model call
        assert rec["dispatch_after"] == {"shard": 15 * rec["calls_after"]}
