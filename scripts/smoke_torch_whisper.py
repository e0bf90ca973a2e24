"""The audio family's phases of ``chip_smoke.py`` alone, on one card.

    python3 scripts/smoke_torch_whisper.py [--no-kernels] [--profile]

Builds the kernels, runs ``chip_smoke.kernel_whisper`` (griffin_spmm at
whisper-large-v3's shapes, checked and timed; skipped with
``--no-kernels``), then serves full-width whisper-large-v3 on
``chip_smoke.WHISPER_PATHS`` with every check of the smoke (exact launches
per prefill and per decode step, fp32-A launches, cast-oracle parity, the
admission's memory rise, host syncs, the prefill logits against the plain
route and the gap to fp32); ``--profile`` adds the smoke's profiled engine
run and decode step per path.  Prints each phase's seconds; the records go
to chiprun_out/smoke_torch_whisper.json.
"""
from __future__ import annotations

import gc
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("smoke_torch_whisper: no CUDA device")
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
        out["kernels"] = cs.kernel_whisper(torch, gen, {})
        clock.done("kernels")
    tokens = None
    for name, path in cs.WHISPER_PATHS.items():
        run, launches, gaps, extra = cs.phase_serve(torch, name,
                                                    arch=cs.WHISPER, **path)
        if "--profile" in sys.argv[1:]:
            cs.phase_profile(torch, name, run)
        out[name] = cs.serve_record(run, launches, gaps, extra)
        if name == "whisper_sparse_b":
            tokens = {r: o.tokens for r, o in run.engine.outputs.items()}
        if path.get("tokens_of"):
            cs.check_same_tokens(name, run, tokens, path["tokens_of"])
        del run
        gc.collect()
        torch.cuda.empty_cache()
        clock.done(name)
    out["phase_s"] = clock.seconds
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "smoke_torch_whisper.json").write_text(
        json.dumps(out, indent=1, default=str))
    print(f"[done] {sum(clock.seconds.values()):.1f}s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


if __name__ == "__main__":
    main()
