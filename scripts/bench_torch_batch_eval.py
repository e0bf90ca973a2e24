"""Device time of the port's batch_eval kernel (the cycle model's greedy
schedule) on the Figure 8 sweep's largest stream of each config, on one
NVIDIA GPU.

    python3 scripts/bench_torch_batch_eval.py [--src DIR] [--label NAME]
        [--streams FILE]

``--src`` is the ``src`` directory of the tree to time (default: this
checkout's), so one call can time two trees in turns, each in its own
process.  The streams are those ``chip_smoke.py``'s cycle_model phase
captures (chip_smoke.fig8_sweep, split by config): the first process
writes each config's largest to ``--streams`` (default
chiprun_out/bench_batch_eval_streams.npz, with the numpy engine's cycles)
and a later one reads them, so both trees run the same masks.  Per config
one JSON line: the kernel's cycles held equal to the engine's, its median
time over 20 launches after a 64 MB L2 flush (chip_smoke.timed_ms), its
device duration under torch.profiler (chip_smoke.device_ms: 20
back-to-back launches), the route where the tree has one, the mask's byte
bound, and the card's name and power limit.  A first line gives the
launch floor: a one-element fill timed both ways.  Needs a card; exits 1
without one.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def streams(path: pathlib.Path):
    """{config: (mask, cycles)}: each config's largest captured stream."""
    import numpy as np

    if path.exists():
        data = np.load(path)
        return {tuple(int(v) for v in key.split("_")): (data[key],
                                                         data[key + "_c"])
                for key in data.files if not key.endswith("_c")}
    import chip_smoke

    _, groups, _ = chip_smoke.fig8_sweep()
    best = {}
    for cfg, mask, cycles in chip_smoke.split_by_config(groups):
        if cfg not in best or mask.size > best[cfg][0].size:
            best[cfg] = (mask, cycles)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {}
    for cfg, (mask, cycles) in best.items():
        key = "_".join(str(v) for v in cfg)
        flat[key], flat[key + "_c"] = mask, cycles
    np.savez(path, **flat)
    return best


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--streams", default=str(
        ROOT / "chiprun_out" / "bench_batch_eval_streams.npz"))
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_batch_eval: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from chip_smoke import bound, card_line, device_ms, launch_floor, timed_ms
    from repro_torch.core.scheduler import shuffle_lanes
    from repro_torch.kernels.batch_eval import kernel

    card = card_line()
    print(json.dumps({"label": args.label, "card": card,
                      "launch_floor": launch_floor(torch)}), flush=True)
    for cfg, (mask, want) in sorted(streams(pathlib.Path(args.streams))
                                    .items()):
        host = shuffle_lanes(mask, 1, 2) if cfg[3] else mask
        dev = torch.from_numpy(np.ascontiguousarray(host)).cuda()

        def go():
            return kernel.batch_eval(dev, *cfg[:3])
        got = go().cpu().numpy()
        if not np.array_equal(got, want):
            sys.exit(f"bench_torch_batch_eval: {cfg} cycles differ from the "
                     "numpy engine's")
        route = getattr(kernel, "route", None)
        print(json.dumps({
            "label": args.label, "config": list(cfg),
            "shape": list(mask.shape),
            "route": route(*cfg[:3]) if route else "one thread a tile",
            "cycles_max": int(want.max()), "ms": timed_ms(torch, go),
            "device_ms": device_ms(torch, go, "batch_eval"),
            "bound_ms": bound(mask.nbytes, 0, "float32")[0],
            "card": card}), flush=True)


if __name__ == "__main__":
    main()
