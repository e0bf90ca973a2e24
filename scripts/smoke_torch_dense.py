"""The dense-layout configs' phases of ``chip_smoke.py`` alone, on one
card: the dense family's other configs and the vlm family's chameleon-34b.

    python3 scripts/smoke_torch_dense.py [--only dense|vlm] [--no-kernels]
                                          [--profile]

Builds the kernels, runs ``chip_smoke.kernel_dense_configs`` (griffin_spmm
at every K2 leaf shape of stablelm-1.6b, minitron-8b and
command-r-plus-104b, and of chameleon-34b, checked, timed beside
torch.matmul and its bound, the route the Python mirror predicts gated
against the route the launch took; sparse_a and its metadata at
stablelm-1.6b's FFN and head and at chameleon-34b's every leaf; skipped
with ``--no-kernels``), then serves ``chip_smoke.DENSE_PATHS`` and
``chip_smoke.VLM_PATHS`` with every check of the smoke (exact launches per
model call, oracle parity or the _sparse_b path's tokens on the paged
paths, host syncs, the prefill logits against the plain route and the
fp32 model, the build's memory, each leaf's K2 route and the launches per
route, the leaves checked as served; a profiled one-step chunk on each
vlm path); ``--only`` keeps one of the two; ``--profile`` adds the
smoke's profiled engine run and decode step per path.  Prints each
phase's seconds; the records go to chiprun_out/smoke_torch_dense.json.
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
        sys.exit("smoke_torch_dense: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import build

    card = cs.card_line()
    print(card)
    clock = cs.PhaseClock()
    cs.phase_build(build)
    clock.done("build")
    out = {"card": card}
    args = sys.argv[1:]
    only = args[args.index("--only") + 1] if "--only" in args else None
    sets = [(cs.DENSE_SPMM, ((cs.STABLELM, cs.STABLELM_K3),),
             cs.DENSE_PATHS, None),
            (cs.VLM_SPMM, ((cs.CHAMELEON, cs.CHAMELEON_K3),), cs.VLM_PATHS,
             1)]
    if only is not None:
        sets = [sets[("dense", "vlm").index(only)]]
    if "--no-kernels" not in args:
        gen = torch.Generator(device="cuda").manual_seed(0)
        out["kernels"] = [row for spmm, k3, _, _ in sets for row in
                          cs.kernel_dense_configs(torch, gen, spmm, k3)]
        clock.done("kernels")
    for _, _, paths, steps in sets:
        cs.phase_dense_configs(torch, clock, out, paths, profile_steps=steps)
    out["phase_s"] = clock.seconds
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "smoke_torch_dense.json").write_text(
        json.dumps(out, indent=1, default=str))
    print(f"[done] {sum(clock.seconds.values()):.1f}s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")


if __name__ == "__main__":
    main()
