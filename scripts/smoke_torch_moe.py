"""The moe family's phases of ``chip_smoke.py`` alone, on one card.

    python3 scripts/smoke_torch_moe.py [--free-routing] [--no-kernels]

Builds the kernels, runs ``chip_smoke.kernel_moe`` (the kernels at
mixtral-8x7b's shapes, checked and timed; skipped with ``--no-kernels``),
then serves full-width mixtral-8x7b on ``chip_smoke.MOE_PATHS`` with every
check of the smoke (exact launches, oracle parity, host syncs, the build's
memory, the prefill logits against the plain route) and the profiled
4-step chunk, and ``moe_long_window`` after ``moe_sparse_b``.  With
``--free-routing`` the long window is run a second time with the plain
route choosing its own experts: its logit and K/V gaps are reported, not
gated (top-k is a step function, and bf16 near ties flip between the two
routes).  Prints each phase's seconds; the records go to
chiprun_out/smoke_torch_moe.json.
"""
from __future__ import annotations

import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("smoke_torch_moe: no CUDA device")
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
        out["kernels"] = cs.kernel_moe(torch, gen, {})
        clock.done("kernels")
    tokens = None
    for name, path in cs.MOE_PATHS.items():
        run, launches, gaps, extra = cs.phase_serve(
            torch, name, arch=cs.MOE, fp32_gap=False, **path)
        extra["profile"] = cs.chunk_profile(torch, name, run)
        out[name] = cs.serve_record(run, launches, gaps, extra)
        clock.done(name)
        if name == "moe_sparse_b":
            tokens = {r: o.tokens for r, o in run.engine.outputs.items()}
            free = "--free-routing" in sys.argv[1:]
            for replay in (True, False) if free else (True,):
                key = "moe_long_window" + ("" if replay else "_free")
                out[key] = cs.phase_long_window(
                    torch, run, key, cs.MOE_LONG, cs.MOE_SB["launches"],
                    cs.MOE_SB["sparsity"], replay=replay)
                clock.done(key)
        if name == "moe_paged":
            cs.check_same_tokens(name, run, tokens, "moe_sparse_b")
        del run
        gc.collect()
        torch.cuda.empty_cache()
    out["phase_s"] = clock.seconds
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "smoke_torch_moe.json").write_text(
        json.dumps(out, indent=1, default=str))
    print(f"[done] {sum(clock.seconds.values()):.1f}s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


if __name__ == "__main__":
    main()
