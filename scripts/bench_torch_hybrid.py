"""The kernels at recurrentgemma-9b's shapes on the card, several passes in
one process on one card.

    python3 scripts/bench_torch_hybrid.py [--repeats N]

Each pass runs ``chip_smoke.kernel_hybrid``: griffin_spmm at the five
compacted shapes (bf16, pruned 0.8 at 128 x 128 / unit 32, dual and not),
dense_gemm's wide route and sparse_a with its metadata at the rec blocks'
dense 4096 x 4096 leaves (bf16 and fp32), M 4 and 32, each checked against
its plain version and timed (median of 20 launches, each after a 64 MB L2
flush: ``chip_smoke.timed_ms``) beside its bound and torch.matmul.  The
passes draw new weights from one generator, so a row's spread over the
passes shows how far one reading can be trusted.  After the passes the
untied head (4096 x 256000) is timed once more at M 4 and 32 with its
device duration under torch.profiler (``chip_smoke.device_ms``, 20
back-to-back launches, warm L2).  Needs one card; the rows go to
chiprun_out/bench_torch_hybrid.json.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("bench_torch_hybrid: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import build, griffin_matmul, preprocess_weights
    from repro_torch.sparsity import block_prune

    print(cs.card_line())
    cs.phase_build(build)
    gen = torch.Generator(device="cuda").manual_seed(0)
    passes = [cs.kernel_hybrid(torch, gen, {}) for _ in range(args.repeats)]
    keys = ("kernel", "leaf", "dtype", "m", "dual")
    spread = {}
    for rows in passes:
        for r in rows:
            if "ms" in r:
                spread.setdefault(tuple(r.get(k) for k in keys),
                                  []).append(r["ms"])
    for key, ms in spread.items():
        print(f"[spread] {dict(zip(keys, key))}: ms {ms}, "
              f"max/min {max(ms) / min(ms):.3f}")
    k, n = cs.HYBRID_SPMM["head"]
    gw = preprocess_weights(block_prune(
        torch.randn(k, n, generator=gen, device="cuda"), 0.8).bfloat16())
    head = []
    for m in cs.XLSTM_ROWS:
        a = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        row = {"m": m, "ms": cs.timed_ms(torch, lambda: griffin_matmul(a, gw)),
               "device_ms": cs.device_ms(torch, lambda: griffin_matmul(a, gw),
                                         "spmm")}
        head.append(row)
        print(f"[head] {json.dumps(row)}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "bench_torch_hybrid.json").write_text(json.dumps(
        {"card": cs.card_line(), "passes": passes, "head": head}, indent=1))


if __name__ == "__main__":
    main()
