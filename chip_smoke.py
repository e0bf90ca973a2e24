"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line
(``--profile`` adds a profiled engine run after the serve phase):

1. build   - compile every kernel under src/repro_torch/csrc/ with nvcc for
             sm_90a (one nvcc per source, in parallel) and print the time
             and ptxas' register/spill report.
2. kernels - call each kernel's wrapper on the card at the shapes the
             serving path gives it, fp32 and bf16 (griffin_spmm also dual
             off/on and balance on/off), and hold it against its plain
             PyTorch version.  Tolerances: fp32 |err| <= 1e-5 * max|ref|
             (summation orders differ); bf16 |err| <= one bf16 ulp of the
             output plus the same fp32 term.  Times kernel, plain version
             and one library call (torch.matmul, a yardstick the port never
             calls), each with a 64 MB L2 flush before every launch, and
             the bound: the larger of bytes / 3.35 TB/s and operations /
             the card's peak for the type (989 TFLOP/s bf16, 67 TFLOP/s
             fp32), counting only the live blocks griffin_spmm must read.
3. serve   - full-width llama3.2-1b (bf16, random weights from a seed,
             block-pruned to 0.8 at 128x128 / unit 32 and compacted) through
             repro_torch.launch.serve: 4 slots, 8 requests with prompt
             lengths 8/16/32 and generation lengths 4/8/16, decode_chunk 8.
             Launch counters are zeroed just before and read just after the
             engine run.  Checks: every request token-identical to the
             batch-1 greedy oracle; no plain GEMM; dense_gemm launched once
             and griffin_spmm 112 times (7 GEMMs x 16 layers) per prefill
             and decode step; at most 0.25 host syncs per token; a prefill
             and a fused chunk run under CUDA's sync debug mode; prefill
             logits finite and within 2% (relative L2) of the same model
             served through plain torch matmuls on the decompacted weights.

The line before the last is the kernel summary JSON, the one before it the
card's name and power limit; the last line is the result JSON.  The full
per-shape report goes to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SPMM_SHAPES = ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048))
M_ROWS = (4, 8, 16, 32)          # decode slots, prefill buckets 8..32


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def timed_ms(torch, fn, iters: int = 20) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after a
    64 MB write that evicts the 50 MB L2 (the serving path reads each
    weight once per step, cold).  A device-side sleep is queued first so
    the host enqueues every launch before the device reaches it: the events
    then bracket device work only, not the wrapper's host time."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)          # ~0.1 s of device cycles
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in times)
    return ms[len(ms) // 2]


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def within_tol(torch, out, ref, dtype: str):
    """(max |err|, ok) under the stated tolerance."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    scale = float(r.abs().max())
    allowed = 1e-5 * scale
    if dtype == "bfloat16":
        mag = torch.maximum(o.abs(), r.abs()).clamp(min=1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        ok = bool((err <= ulp + allowed).all())
    else:
        ok = bool((err <= allowed).all())
    return float(err.max()), ok


def phase_build(build):
    t0 = time.perf_counter()
    logs = build.build_all(verbose=True)
    dt = time.perf_counter() - t0
    print(f"[build] {len(logs)} kernels built from src/repro_torch/csrc "
          f"for sm_90a in {dt:.1f}s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    return dt


def phase_kernels(torch):
    from repro_torch.kernels import (decompact_weights, dense_matmul,
                                     griffin_matmul, preprocess_weights)
    from repro_torch.kernels.dense_gemm.ref import dense_matmul_ref
    from repro_torch.kernels.griffin_spmm.ref import griffin_spmm_ref
    from repro_torch.sparsity import block_prune

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, summary = [], {}

    # K1: the tied unembedding, A (M, 2048) x embed.T (2048, 128256)
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        embed = torch.randn(128256, 2048, generator=gen, device=dev).to(dt)
        for m in (4, 1):
            a = torch.randn(m, 2048, generator=gen, device=dev).to(dt)
            out = dense_matmul(a, embed.T)
            ref = dense_matmul_ref(a, embed.T)
            torch.cuda.synchronize()
            err, ok = within_tol(torch, out, ref, dtype)
            row = {"kernel": "dense_gemm", "dtype": dtype, "m": m, "k": 2048,
                   "n": 128256, "max_abs_err": err, "ok": ok}
            if not ok:
                fail(f"dense_gemm disagrees with its plain version: {row}")
            if m == 4:
                esz = a.element_size()
                nbytes = (a.numel() + embed.numel() + m * 128256) * esz
                b_ms, b_by = bound(nbytes, 2.0 * m * 2048 * 128256, dtype)
                row.update(
                    ms=timed_ms(torch, lambda: dense_matmul(a, embed.T)),
                    plain_ms=timed_ms(torch,
                                      lambda: dense_matmul_ref(a, embed.T)),
                    library_ms=timed_ms(torch, lambda: torch.matmul(a,
                                                                    embed.T)),
                    bound_ms=b_ms, bound_by=b_by)
                if dtype == "bfloat16":
                    summary["dense_gemm"] = row
            rows.append(row)
            print(f"[kernels] {json.dumps(row)}")
        del embed

    # K2: every compacted GEMM shape of llama3.2-1b at 0.8 sparsity
    for (k, n) in SPMM_SHAPES:
        w32 = block_prune(torch.randn(k, n, generator=gen, device=dev), 0.8)
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            for balance in (True, False):
                gw = preprocess_weights(w32.to(dt), balance=balance)
                live = int(gw.cnt.sum())
                for m in M_ROWS:
                    a = torch.randn(m, k, generator=gen, device=dev).to(dt)
                    a[:, :256] = 0      # two all-zero K blocks for dual
                    for dual in (False, True):
                        out = griffin_matmul(a, gw, dual=dual)
                        ref = griffin_spmm_ref(a, gw)
                        torch.cuda.synchronize()
                        err, ok = within_tol(torch, out, ref, dtype)
                        row = {"kernel": "griffin_spmm", "dtype": dtype,
                               "m": m, "k": k, "n": n, "balance": balance,
                               "dual": dual, "live_blocks": live,
                               "max_cnt": gw.kidx.shape[1],
                               "max_abs_err": err, "ok": ok}
                        if not ok:
                            fail("griffin_spmm disagrees with its plain "
                                 f"version: {row}")
                        if balance and not dual and m in (4, 32):
                            esz = a.element_size()
                            nbytes = (a.numel() + live * gw.block_k
                                      * gw.block_n + m * n) * esz + 4 * (
                                gw.kidx.numel() + gw.cnt.numel()
                                + gw.inv_perm.numel())
                            flops = 2.0 * m * live * gw.block_k * gw.block_n
                            b_ms, b_by = bound(nbytes, flops, dtype)
                            w_dense = decompact_weights(gw)
                            row.update(
                                ms=timed_ms(torch,
                                            lambda: griffin_matmul(a, gw)),
                                plain_ms=timed_ms(
                                    torch, lambda: griffin_spmm_ref(a, gw)),
                                library_ms=timed_ms(
                                    torch, lambda: torch.matmul(a, w_dense)),
                                bound_ms=b_ms, bound_by=b_by)
                            if dtype == "bfloat16" and m == 4 and \
                                    (k, n) == (2048, 8192):
                                summary["griffin_spmm"] = row
                            print(f"[kernels] {json.dumps(row)}")
                        rows.append(row)
    print(f"[kernels] {len(rows)} checks against the plain versions passed")
    return rows, summary


def dense_twin(torch, params):
    """The served params with every compacted leaf decompacted back to its
    stacked block-pruned dense weights (plain torch matmuls then serve it)."""
    from repro_torch.kernels import GriffinWeights, decompact_weights
    layers = {}
    for name, leaf in params["layers"].items():
        if isinstance(leaf, GriffinWeights):
            leaf = torch.stack([decompact_weights(leaf[i])
                                for i in range(leaf.b_comp.shape[0])])
        layers[name] = leaf
    return dict(params, layers=layers)


def phase_serve(torch):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve as launch
    from repro_torch.models.common import sparse_execution

    reset_launch_counts()
    run = launch.serve("llama3.2-1b", slots=4, requests=8,
                       prompt_lens=(8, 16, 32), gen_lens=(4, 8, 16),
                       sparsity=0.8, use_kernels=True, decode_chunk=8,
                       device="cuda")
    launches = launch_counts()
    eng = run.engine
    st = eng.stats
    calls = st["prefill_calls"] + st["decode_steps"]
    print(f"[serve] llama3.2-1b full width bf16, weight sparsity "
          f"{eng.b_sparsity:.3f}, mode {eng.mode.value}: "
          f"{len(run.requests)} requests / {st['emitted']} tokens in "
          f"{run.seconds:.3f}s = {run.tokens_per_second:.1f} tok/s; "
          f"{st['decode_steps']} decode steps in {st['chunk_calls']} chunks, "
          f"{st['prefill_calls']} prefills, {run.syncs_per_token:.4f} host "
          f"syncs/token; launches {launches}; dispatch {run.dispatch}")
    if run.dispatch.get("plain", 0) != 0:
        fail(f"plain GEMMs on the main path: {run.dispatch}")
    if launches["griffin_spmm"] != 112 * calls:
        fail(f"griffin_spmm launched {launches['griffin_spmm']} times, "
             f"expected 112 x {calls}")
    if launches["dense_gemm"] != calls:
        fail(f"dense_gemm launched {launches['dense_gemm']} times, expected "
             f"{calls}")
    if run.syncs_per_token > 0.25:
        fail(f"{run.syncs_per_token:.3f} host syncs per token > 0.25")
    n = launch.check_parity(run)
    print(f"[serve] parity OK: all {n} requests token-identical to the "
          "batch-1 greedy oracle")

    # no hidden host sync on the hot path: a bucketed prefill and a fused
    # chunk under CUDA's sync debug mode, which raises on any synchronising
    # call (the engine's one transfer per tick happens outside the chunk)
    req = run.requests[0]
    batch = req.as_batch(eng.device, eng.bucket_for(req.prompt_len))
    prefill_fn, chunk_for = eng._fns()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with eng._scope():
            prefill_fn(run.params, batch)
            chunk_for(eng.decode_chunk)(run.params, eng.cache, eng._tokens,
                                        eng._remaining)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("[serve] a prefill and a fused chunk ran with no host sync")

    # what comes out is right: the kernel route's prefill logits against
    # the same pruned model through plain torch matmuls
    with sparse_execution(use_kernels=True):
        _, logits = eng.api.prefill(run.params, batch, cache_len=64)
    with sparse_execution(use_kernels=False):
        _, ref = eng.api.prefill(dense_twin(torch, run.params), batch,
                                 cache_len=64)
    rel = float((logits.float() - ref.float()).norm() / ref.float().norm())
    if logits.shape != (1, 128256) or not bool(torch.isfinite(logits).all()):
        fail(f"prefill logits shape {tuple(logits.shape)} or not finite")
    if rel > 2e-2:
        fail(f"kernel-route logits differ from the plain route by {rel:.4f}")
    print(f"[serve] prefill logits finite, relative L2 gap to the plain "
          f"route {rel:.5f}")
    return run, launches


def phase_profile(torch, run):
    """``--profile``: where the serving time goes.  Serves a fresh 8-request
    trace on the same weights under torch.profiler (engine.run only) and
    prints the device's busy share of the wall time, device time by kernel,
    and kernel launches per model call."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.engine import ServeEngine, synthetic_trace

    eng0 = run.engine
    eng = ServeEngine(eng0.api, run.params, eng0.config)
    reqs = synthetic_trace(eng0.api.cfg, num_requests=8, seed=2,
                           prompt_lens=(8, 16, 32), gen_lens=(4, 8, 16))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.device_time_total / 1e3, n + 1)
    busy_ms = sum(t for t, _ in by_name.values())
    st = eng.stats
    calls = st["prefill_calls"] + st["decode_steps"]
    print(f"[profile] engine run {wall_ms:.1f} ms wall (profiled), "
          f"{st['emitted']} tokens, {calls} model calls; device busy "
          f"{busy_ms:.1f} ms = {busy_ms / wall_ms:.3f} of wall; "
          f"{len(kernels) / calls:.0f} device ops per model call")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"[profile] {ms:9.3f} ms {n:7d}x  {name[:100]}")


def main() -> None:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail("run from a checkout of the repository (src/repro_torch "
             "missing)")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    card = card_line()
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}"
          f", cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    build_s = phase_build(build)
    rows, summary = phase_kernels(torch)
    run, launches = phase_serve(torch)
    if "--profile" in sys.argv[1:]:
        phase_profile(torch, run)

    kernels = []
    sources = {"dense_gemm": ("src/repro_torch/csrc/dense_gemm.cu",
                              "src/repro/kernels/dense_gemm/kernel.py:35"),
               "griffin_spmm": ("src/repro_torch/csrc/griffin_spmm.cu",
                                "src/repro/kernels/griffin_spmm/kernel.py:63")}
    for name, (src, replaces) in sources.items():
        row = summary[name]
        errs = [r["max_abs_err"] for r in rows if r["kernel"] == name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(errs), "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "timed_shape": [row["m"], row["k"], row["n"], row["dtype"]]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    st = run.engine.stats
    report = {"card": card, "build_s": build_s, "checks": rows,
              "serve": {"stats": st, "seconds": run.seconds,
                        "tokens_per_second": run.tokens_per_second,
                        "syncs_per_token": run.syncs_per_token,
                        "launches": launches, "dispatch": run.dispatch},
              "kernels": kernels,
              "wall_s": time.perf_counter() - t0}
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"[done] wall {report['wall_s']:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
