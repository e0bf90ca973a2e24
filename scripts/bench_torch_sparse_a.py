"""Device time of the port's sparse_a_matmul (K3) and its activation
metadata at llama3.2-1b's five Sparse.A GEMM shapes, on one NVIDIA GPU.

    python3 scripts/bench_torch_sparse_a.py [--src DIR] [--label NAME]
        [--meta-only] [--profile]

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
and the card's name and power limit.  A first line gives the launch floor:
a one-element fill timed the same way and by its device duration.

The metadata kernel alone at chip_smoke's ``META_SHAPES`` (4 x 2048, 32 x
4096, 128 x 8192, bf16, every block live): ``timed_ms``, its device
duration under torch.profiler (chip_smoke.device_ms: 20 back-to-back
launches), the plain metadata (torch ops) and the byte bound; where the
tree's wrapper takes a split, every power of two up to 16 at each shape.
``--meta-only`` skips the GEMM lines.  ``--profile`` then serves
chip_smoke's ``mode_a`` and ``xlstm_mode_ab`` paths and prints each
one's device-time breakdown (chip_smoke.phase_profile) with the metadata
kernel's total and launches.  Needs a card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import inspect
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SHAPES = (("wq/wo", 2048, 2048), ("wk/wv", 2048, 512),
          ("w_gate/w_up", 2048, 8192), ("w_down", 8192, 2048),
          ("unembedding", 2048, 128256))


def gemm_lines(torch, args, card, gen):
    from chip_smoke import HBM_BYTES_PER_S, timed_ms
    from repro_torch.kernels import compact_activations, sparse_a_matmul

    dev = torch.device("cuda")
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


def meta_lines(torch, args, card, gen):
    from chip_smoke import META_SHAPES, bound, device_ms, timed_ms
    from repro_torch.kernels import compact_activations
    from repro_torch.kernels.sparse_a import kernel as k3
    from repro_torch.kernels.sparse_a.ref import compact_activations_ref

    splits = "slices" in inspect.signature(k3.sparse_a_meta).parameters
    for m, k in META_SHAPES:
        a = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        meta = compact_activations(a)
        bm, bk = meta.block_m, meta.block_k
        want = compact_activations_ref(a, block_m=bm, block_k=bk)
        if not (torch.equal(meta.kidx, want[0])
                and torch.equal(meta.cnt, want[1])):
            sys.exit(f"bench_torch_sparse_a: metadata differs at {m} x {k}")
        b_ms, _ = bound(a.numel() * 2 + 4 * (meta.kidx.numel() + 1), 0,
                        "bfloat16")
        row = {"label": args.label, "meta": [m, k], "block": [bm, bk],
               "ms": timed_ms(torch, lambda: compact_activations(a)),
               "device_ms": device_ms(torch, lambda: compact_activations(a),
                                      "sparse_a_meta"),
               "plain_ms": timed_ms(torch, lambda: compact_activations_ref(
                   a, block_m=bm, block_k=bk)),
               "bound_ms": b_ms, "card": card}
        if splits:
            row["slices"] = k3.meta_slices(min(m, bm), k, bk, 2)
            mt, kt = meta.kidx.shape
            by_split = {}
            for s in (1, 2, 4, 8, 16):
                if s > kt:
                    break

                def go(s=s):
                    return k3.sparse_a_meta(a, block_m=bm, block_k=bk,
                                            m_tiles=mt, k_tiles=kt,
                                            slices=s)
                got = go()
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    sys.exit(f"bench_torch_sparse_a: split {s} differs at "
                             f"{m} x {k}")
                by_split[s] = {"ms": timed_ms(torch, go),
                               "device_ms": device_ms(torch, go,
                                                      "sparse_a_meta")}
            row["by_split"] = by_split
        print(json.dumps(row), flush=True)


def profile_paths(torch):
    import chip_smoke

    for name, arch in (("mode_a", None), ("xlstm_mode_ab", chip_smoke.XLSTM)):
        if arch is None:
            path, kw = chip_smoke.PATHS[name], {}
        else:
            path, kw = chip_smoke.XLSTM_PATHS[name], {"arch": arch}
        run, *_ = chip_smoke.phase_serve(torch, name, **path, **kw)
        _, by_name = chip_smoke.phase_profile(torch, name, run)
        busy = sum(t for t, _ in by_name.values())
        meta = [(t, n) for k, (t, n) in by_name.items()
                if "sparse_a_meta" in k]
        ms, launches = sum(t for t, _ in meta), sum(n for _, n in meta)
        print(f"[profile {name}] sparse_a_meta {ms:.3f} ms in {launches} "
              f"launches = {ms / busy:.4f} of device time", flush=True)
        del run
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--meta-only", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_sparse_a: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from chip_smoke import card_line, launch_floor
    card = card_line()
    print(json.dumps({"label": args.label, "card": card,
                      "launch_floor": launch_floor(torch)}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if not args.meta_only:
        gemm_lines(torch, args, card, gen)
    meta_lines(torch, args, card, gen)
    if args.profile:
        profile_paths(torch)


if __name__ == "__main__":
    main()
