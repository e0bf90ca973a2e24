"""The train phase of ``chip_smoke.py`` alone, on one card.

    python3 scripts/smoke_torch_train.py [--profile]

Builds the kernels, then runs ``chip_smoke.phase_train``: full-width
llama3.2-1b trained through ``repro_torch.launch.train``'s CLI with every
gate of the smoke (the flash backward against the materialised attention,
bf16 against fp32, 30 steps, the prune milestone, the checkpoint restart,
the trained weights on the kernels).  ``--profile`` first profiles one
train step (batch 8, seq 128, bf16, remat on) under torch.profiler: device
ops, the device's busy share of the profiled wall and the top kernels.
Prints each phase's seconds; the record goes to
chiprun_out/smoke_torch_train.json.
"""
from __future__ import annotations

import gc
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def profile_step(torch, cs) -> dict:
    """One warm full-width train step of the CLI's config, profiled."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train import (init_state, make_train_step,
                                           to_device)

    api = build_model(get_config(cs.TRAIN["arch"]))
    shape = ShapeConfig("cli", cs.TRAIN["seq"], cs.TRAIN["batch"], "train")
    state = init_state(api, api.generator(0))
    step = make_train_step(api, AdamWConfig(lr=3e-3, warmup_steps=6,
                                            total_steps=30))
    batch = to_device(synth_batch(api.cfg, shape, DataConfig(), 0), "cuda")
    state, _ = step(state, batch)                       # warm
    holder = [state]

    def run():
        holder[0], m = step(holder[0], batch)
        float(m["loss"])

    wall_ms, by_name, ops = cs.profiled(torch, run)
    cs.print_profile("[train profile]", wall_ms, by_name,
                     f"one train step: {ops} device ops")
    busy = sum(t for t, _ in by_name.values())
    del holder, state
    gc.collect()
    torch.cuda.empty_cache()
    return {"wall_ms": wall_ms, "device_ops": ops, "busy_ms": busy,
            "top": sorted(((k, v) for k, v in by_name.items()),
                          key=lambda kv: -kv[1][0])[:10]}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("smoke_torch_train: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import build

    card = cs.card_line()
    print(card)
    clock = cs.PhaseClock()
    cs.phase_build(build)
    clock.done("build")
    out = {"card": card}
    if "--profile" in sys.argv[1:]:
        out["profile"] = profile_step(torch, cs)
        clock.done("profile")
    launches, out["train"] = cs.phase_train(torch, card)
    out["launches"] = launches
    clock.done("train")
    out["phase_s"] = clock.seconds
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "smoke_torch_train.json").write_text(
        json.dumps(out, indent=1, default=str))
    print(f"[done] {sum(clock.seconds.values()):.1f}s")


if __name__ == "__main__":
    main()
