"""Device time of the port's sparse_a_matmul (K3) and its activation
metadata at llama3.2-1b's five Sparse.A GEMM shapes, on one NVIDIA GPU.

    python3 scripts/bench_torch_sparse_a.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory of the tree to time (default: this
checkout's), so one call can time two trees in turns, each in its own
process.  Weights are dense bf16 from seed 0: wq/wo, wk/wv, w_gate/w_up and
w_down row-major, the unembedding read as the view ``embed.T``.  A is
random bf16 with every K block live, or with the upper half of its K
blocks zero ("half dead").  For M in (4, 32) and both A it prints one JSON
line: the median device time of ``sparse_a_matmul`` with its metadata
given, and of ``compact_activations`` alone, over 20 launches each after a
64 MB L2 flush (chip_smoke.timed_ms); ``torch.matmul`` on the same
operands (a yardstick); the bound (visited weight bytes over 3.35 TB/s);
and the card's name and power limit.  A first line gives the time of a
one-element fill, the floor of this way of timing.  Needs a card; exits 1
without one.
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
          ("w_gate/w_up", 2048, 8192), ("w_down", 8192, 2048),
          ("unembedding", 2048, 128256))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_sparse_a: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from repro_torch.kernels import compact_activations, sparse_a_matmul
    card = card_line()
    dev = torch.device("cuda")
    tiny = torch.zeros(1, device=dev)
    print(json.dumps({"label": args.label, "card": card,
                      "one_element_fill_ms": timed_ms(torch, tiny.zero_)}),
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, k, n in SHAPES:
        w = torch.randn(n, k, generator=gen, device=dev).bfloat16().T
        if name != "unembedding":
            w = w.contiguous()
        for m in (4, 32):
            dense = torch.randn(m, k, generator=gen, device=dev).bfloat16()
            half = dense.clone()
            half[:, k // 2:] = 0
            for live, a in (("all", dense), ("half", half)):
                meta = compact_activations(a)
                rows = min(int(meta.cnt.max()) * meta.block_k, k)
                nbytes = (a.numel() + rows * n + m * n) * 2
                print(json.dumps({
                    "label": args.label, "gemm": name, "k": k, "n": n,
                    "m": m, "live": live, "cnt": meta.cnt.tolist(),
                    "ms": timed_ms(torch, lambda: sparse_a_matmul(
                        a, w, meta=meta)),
                    "meta_ms": timed_ms(torch,
                                        lambda: compact_activations(a)),
                    "library_ms": timed_ms(torch, lambda: torch.matmul(a, w)),
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "card": card}), flush=True)
        del w


if __name__ == "__main__":
    main()
