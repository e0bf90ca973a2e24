"""K1 (dense_gemm) on the card: its skinny route against the wide route at
xlstm-1.3b's (4096 x 4) gate leaves, in one call on one card.

    python3 scripts/bench_torch_dense_gemm.py [--xlstm-profile]

For bf16, fp32 and fp32 A x bf16 weight at M 4 and 32 it times (median of
20 launches, each after a 64 MB L2 flush: chip_smoke.timed_ms) the skinny
route through the wrapper, the wide route forced through the same C entry
(``slices`` 0: the design K1 had before the skinny route, a warp per 4
columns) and torch.matmul, in turns (each twice, the lower kept, both in
``turns``), and the plain version, beside the bound.  Then,
under torch.profiler, it runs 20 launches of each route and of
torch.matmul at M 4 and 32 and prints every device kernel with its mean
device duration, so the event timing can be held against the kernels'
own durations; with the grid, the threads and the registers (ptxas) of
each route it derives the live warps per SM used and the DRAM rate the
duration implies.  ncu is tried once on one launch of each route; where
it does not run, the script says so.  The unembedding (A 4 x 2048 against
embed.T, bf16, the wide route) is timed too.  ``--xlstm-profile`` then
serves chip_smoke's ``xlstm_sparse_b`` path and prints its device-time
breakdown (chip_smoke.phase_profile) with every griffin kernel's share.
Needs one card; the report goes to chiprun_out/bench_torch_dense_gemm.json.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

K, N = 4096, 4
ROWS = (4, 32)
SMS = 132


def wide(torch, a, b):
    """The wide route at any N: the C entry with slices 0."""
    from repro_torch.kernels import build
    from repro_torch.kernels.dense_gemm import kernel

    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    err = kernel._fn()(kernel.PAIR_CODES[(a.dtype, b.dtype)], a.data_ptr(),
                       b.data_ptr(), out.data_ptr(), m, n, k, a.stride(0),
                       b.stride(0), b.stride(1), out.stride(0), 0,
                       torch.cuda.current_stream().cuda_stream)
    build.check_launch("dense_gemm", err)
    return out


def registers(log: str):
    """ptxas' registers per dense_gemm kernel instantiation."""
    regs, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "registers" in line and name:
            regs[name] = int(line.split("Used ")[1].split()[0])
    return regs


def try_ncu():
    """One ncu attempt on one skinny launch; what it printed, or why not."""
    ncu = shutil.which("ncu") or "/usr/local/cuda/bin/ncu"
    if not pathlib.Path(ncu).exists():
        return "ncu not found"
    cmd = [ncu, "--set", "full", "--launch-count", "1", "--kernel-name",
           "regex:dense_skinny", sys.executable, __file__, "--one-launch"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=180, cwd=ROOT)
    except subprocess.TimeoutExpired:
        return "ncu timed out after 180 s"
    text = (out.stdout + out.stderr).strip().splitlines()
    return f"ncu exit {out.returncode}: " + " | ".join(text[-12:])


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_torch_dense_gemm: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import PAIRS, bound, card_line, profiled, timed_ms
    from chip_smoke import within_tol
    from repro_torch.kernels import build, dense_matmul
    from repro_torch.kernels.dense_gemm.kernel import (SKINNY_THREADS,
                                                       skinny_slices)
    from repro_torch.kernels.dense_gemm.ref import dense_matmul_ref

    if "--one-launch" in sys.argv[1:]:           # ncu's target
        a = torch.randn(4, K, device="cuda").bfloat16()
        w = torch.randn(K, N, device="cuda").bfloat16()
        dense_matmul(a, w)
        wide(torch, a, w)
        torch.cuda.synchronize()
        return
    card = card_line()
    regs = registers(build.build_all(["dense_gemm"], verbose=True)
                     ["dense_gemm"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, (ta, tw) in PAIRS.items():
        da, dw = getattr(torch, ta), getattr(torch, tw)
        w = torch.randn(K, N, generator=gen, device="cuda").to(dw)
        w_lib = w.to(da)
        for m in ROWS:
            a = torch.randn(m, K, generator=gen, device="cuda").to(da)
            ref = dense_matmul_ref(a, w)
            for route, fn in (("skinny", lambda: dense_matmul(a, w)),
                              ("wide", lambda: wide(torch, a, w))):
                out = fn()
                torch.cuda.synchronize()
                err, ok = within_tol(torch, out, ref, label)
                if not ok:
                    sys.exit(f"{route} route disagrees: {label} M {m} {err}")
            nbytes = (a.numel() + m * N) * a.element_size() + \
                w.numel() * w.element_size()
            b_ms, b_by = bound(nbytes, 2.0 * m * K * N, label)
            # in turns: skinny, wide, library, library, wide, skinny
            fns = {"skinny_ms": lambda: dense_matmul(a, w),
                   "wide_ms": lambda: wide(torch, a, w),
                   "library_ms": lambda: torch.matmul(a, w_lib)}
            order = list(fns) + list(fns)[::-1]
            times = {key: [] for key in fns}
            for key in order:
                times[key].append(timed_ms(torch, fns[key]))
            row = {"dtype": label, "m": m, "k": K, "n": N,
                   **{key: min(t) for key, t in times.items()},
                   "turns": times,
                   "plain_ms": timed_ms(torch,
                                        lambda: dense_matmul_ref(a, w)),
                   "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
            rows.append(row)
            print(f"[bench] {json.dumps(row)}")

    # device durations under the profiler, and what they imply
    profile = {}
    for m in ROWS:
        a = torch.randn(m, K, generator=gen, device="cuda").bfloat16()
        w = torch.randn(K, N, generator=gen, device="cuda").bfloat16()
        s = skinny_slices(K)
        grids = {"skinny": (s * -(-m // 4), SKINNY_THREADS, 1),
                 "wide": (-(-m // 4), 256, 1)}
        nbytes = (a.numel() + w.numel() + m * N) * 2
        for what, fn in (("skinny", lambda: dense_matmul(a, w)),
                         ("wide", lambda: wide(torch, a, w)),
                         ("torch.matmul", lambda: torch.matmul(a, w))):
            fn()
            torch.cuda.synchronize()
            _, by_name, _ = profiled(torch, lambda: [fn() for _ in
                                                     range(20)])
            kern = {k: {"mean_ms": t / c, "launches": c}
                    for k, (t, c) in by_name.items()}
            rec = {"kernels": kern}
            if what in grids:
                blocks, threads, live = grids[what]
                mine = [v for k, v in kern.items() if "dense" in k]
                dur = mine[0]["mean_ms"] if mine else float("nan")
                rec.update(
                    blocks=blocks, threads=threads,
                    live_warps_per_block=(SKINNY_THREADS // 32
                                          if what == "skinny" else live),
                    sms_used=min(blocks, SMS),
                    dram_gb_s=nbytes / (dur * 1e-3) / 1e9)
            profile[f"{what} M {m}"] = rec
            print(f"[profile] {what} M {m}: {json.dumps(rec)}")
    print("[profile] registers at bf16 N 4 (skinny; wide, scalar loads): "
          + json.dumps({k: v for k, v in regs.items()
                        if "skinny_kernelI13__nv_bfloat16S1_Li4E" in k
                        or "gemm_kernelI13__nv_bfloat16S1_Lb0E" in k}))

    # the unembedding, the wide route
    embed = torch.randn(128256, 2048, generator=gen,
                        device="cuda").bfloat16()
    a = torch.randn(4, 2048, generator=gen, device="cuda").bfloat16()
    unembed = {"ms": timed_ms(torch, lambda: dense_matmul(a, embed.T)),
               "library_ms": timed_ms(torch,
                                      lambda: torch.matmul(a, embed.T))}
    print(f"[bench] unembedding 4 x 2048 . embed.T bf16: "
          f"{json.dumps(unembed)}")
    del embed
    ncu = try_ncu()
    print(f"[ncu] {ncu}")

    if "--xlstm-profile" in sys.argv[1:]:
        import chip_smoke
        path = chip_smoke.XLSTM_PATHS["xlstm_sparse_b"]
        run, *_ = chip_smoke.phase_serve(torch, "xlstm_sparse_b",
                                         arch=chip_smoke.XLSTM, **path)
        wall_ms, by_name = chip_smoke.phase_profile(torch, "xlstm_sparse_b",
                                                    run)
        busy = sum(t for t, _ in by_name.values())
        for kname, (ms, n) in sorted(by_name.items()):
            if "griffin::" in kname:
                print(f"[profile xlstm_sparse_b] {ms:9.3f} ms {n:7d}x "
                      f"= {ms / busy:.4f} of device time  {kname[:90]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "bench_torch_dense_gemm.json").write_text(json.dumps(
        {"card": card, "rows": rows, "profile": profile,
         "registers": regs, "unembedding": unembed, "ncu": ncu},
        indent=1))
    print(card)


if __name__ == "__main__":
    main()
