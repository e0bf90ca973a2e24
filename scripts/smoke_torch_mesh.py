"""The mesh phases of ``chip_smoke.py`` alone, on one card.

    python3 scripts/smoke_torch_mesh.py [--no-kernels]

Builds the kernels, runs ``chip_smoke.kernel_shards`` (each kernel's shard
entry over 2 and 4 model ranks, gathered, bit-equal to the whole kernel at
llama3.2-1b's shapes, its tied head and one CUDA-core K2 shape; skipped
with ``--no-kernels``), serves ``sparse_b`` with every check of the smoke,
then ``mesh_2x2`` (``chip_smoke.phase_mesh``: the same trace on four ranks
sharing the card, gated on sparse_b's tokens, the launches per rank and
model call, the shard dispatch, the host syncs and the ranks' host-state
digests) and, in the same spawn, ``mesh_remesh`` (rank 3's device lost,
the survivors remeshed onto 1x2; ``chip_smoke.check_remesh``).  Prints
each phase's seconds; the records go to chiprun_out/smoke_torch_mesh.json.
"""
from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("smoke_torch_mesh: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import build

    card = cs.card_line()
    print(card)
    clock = cs.PhaseClock()
    cs.phase_build(build)
    clock.done("build")
    out = {"card": card}
    if "--no-kernels" not in sys.argv[1:]:
        gen = torch.Generator(device="cuda").manual_seed(0)
        out["kernels"] = cs.kernel_shards(torch, gen)
        clock.done("kernels")
    run, launches, gaps, extra = cs.phase_serve(torch, "sparse_b",
                                                **cs.PATHS["sparse_b"])
    out["sparse_b"] = cs.serve_record(run, launches, gaps, extra)
    tokens = {r: o.tokens for r, o in run.engine.outputs.items()}
    del run
    torch.cuda.empty_cache()
    clock.done("sparse_b")
    out["mesh_2x2"], out["mesh_remesh"] = cs.phase_mesh(
        torch, card, tokens, out["sparse_b"])
    clock.done("mesh_2x2")
    out["phase_s"] = clock.seconds
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "smoke_torch_mesh.json").write_text(
        json.dumps(out, indent=1, default=str))
    print(f"[done] {sum(clock.seconds.values()):.1f}s; {card}")


if __name__ == "__main__":
    main()
