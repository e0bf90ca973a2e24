"""Device time of the port's griffin_matmul (K2) at llama3.2-1b's four
compacted GEMM shapes, on one NVIDIA GPU.

    python3 scripts/bench_torch_griffin_spmm.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory of the tree to time (default: this
checkout's), so one call can time two trees in turns, each in its own
process.  Weights are block-pruned to 0.8 at 128x128 / unit 32, balanced,
bf16, made from seed 0; A is random (dense).  For M in (4, 32) it prints
one JSON line: the median device time of ``griffin_matmul``, dual off and
on, over 20 launches each after a 64 MB L2 flush (chip_smoke.timed_ms;
whatever the tree's call launches: the kernel, and in older trees the
gather after it); the same for ``torch.matmul`` on the decompacted weight
(a yardstick); the bound (live-block bytes over 3.35 TB/s); and the card's
name and power limit.  A first line gives the time of a one-element fill,
the floor of this way of timing.  Needs a card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import HBM_BYTES_PER_S, card_line, timed_ms  # noqa: E402

SHAPES = (("wq/wo", 2048, 2048), ("wk/wv", 2048, 512),
          ("w_gate/w_up", 2048, 8192), ("w_down", 8192, 2048))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_griffin_spmm: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from repro_torch.kernels import (decompact_weights, griffin_matmul,
                                     preprocess_weights)
    from repro_torch.sparsity import block_prune
    card = card_line()
    dev = torch.device("cuda")
    tiny = torch.zeros(1, device=dev)
    print(json.dumps({"label": args.label, "card": card,
                      "one_element_fill_ms": timed_ms(torch, tiny.zero_)}),
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, k, n in SHAPES:
        w = block_prune(torch.randn(k, n, generator=gen, device=dev), 0.8)
        gw = preprocess_weights(w.bfloat16())
        w_dense = decompact_weights(gw)
        live = int(gw.cnt.sum())
        for m in (4, 32):
            a = torch.randn(m, k, generator=gen, device=dev).bfloat16()
            nbytes = (a.numel() + live * 128 * 128 + m * n) * 2
            row = {"label": args.label, "gemm": name,
                   "k": k, "n": n, "m": m, "live_blocks": live,
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "library_ms": timed_ms(torch,
                                          lambda: torch.matmul(a, w_dense)),
                   "card": card}
            for dual in (False, True):
                row["dual_ms" if dual else "ms"] = timed_ms(
                    torch, lambda: griffin_matmul(a, gw, dual=dual))
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
