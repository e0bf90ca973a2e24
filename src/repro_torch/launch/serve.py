"""Serving driver: block-prune (and with ``--use-kernels`` compact) a
model's weights, serve a synthetic request trace through the
continuous-batching engine, and optionally check every request against the
batch-1 greedy oracle — the counterpart of ``repro/launch/serve.py``'s
single-engine path.

    python -m repro_torch.launch.serve --arch llama3.2-1b --sparsity 0.8 \\
        --use-kernels --parity

runs full-width llama3.2-1b on the CUDA card; ``--reduced --device cpu``
runs the reduced config on the host (the kernels' plain versions).
``--page-size 16`` serves from the paged KV arena (``--num-pages`` sizes
its pool, ``--kv-dtype int8`` quantizes its pages), ``--policy static``
admits only into a drained pool, and ``--length-dist heavy`` draws
heavy-tailed generation lengths.  The stepwise decode path is chosen
through the config file (``{"sched": {"fused": false}}``), as in the
reference.
``--config engine.json`` reads an ``EngineConfig`` (explicit flags beat
the file); its ``kernels.a_sparsity`` declares the activation sparsity of
the workload category, which with ``--use-kernels`` selects Sparse.A
(dense weights, ``--sparsity 0``) or Sparse.AB (compacted weights).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..configs import get_config
from ..models import build_model
from ..models.common import kernel_dispatch_counts
from ..runtime.config import EngineConfig
from ..runtime.engine import ServeEngine, synthetic_trace
from ..runtime.serve import greedy_generate
from ..sparsity import sparsify_params


def _lens(spec: str):
    return tuple(int(x) for x in spec.split(",") if x)


@dataclasses.dataclass
class ServeRun:
    """What :func:`serve` did: the engine (its ``stats``, outputs and
    ``mode_history``), the trace, the served params and the wall time."""

    engine: ServeEngine
    requests: List
    params: Dict
    seconds: float
    dispatch: Dict[str, int]

    @property
    def tokens_per_second(self) -> float:
        return self.engine.stats["emitted"] / max(self.seconds, 1e-9)

    @property
    def syncs_per_token(self) -> float:
        return self.engine.stats["host_syncs"] / \
            max(self.engine.stats["emitted"], 1)


def serve(arch: str = "llama3.2-1b", *, reduced: bool = False,
          requests: int = 8, prompt_lens: Sequence[int] = (8, 16, 32),
          gen_lens: Sequence[int] = (4, 8, 16), arrival_every: int = 0,
          length_dist: str = "choice", sparsity: float = 0.8, seed: int = 0,
          device: Optional[str] = "cuda",
          config: Optional[EngineConfig] = None) -> ServeRun:
    """Build the model with seeded random weights on ``device``, prune
    (compact with ``config.kernels.use_kernels``), and serve a synthetic
    trace.  With ``sparsity > 0`` the full-width pruning blocks are
    128/128/32 and the reduced config's 16/16/8, as in the reference.
    ``config`` (default ``EngineConfig()``) sets the slots, the chunk, the
    kernels and the declared activation sparsity
    (``kernels.a_sparsity``) and the arena, fixed or paged; its
    ``cache_len`` defaults to the trace's bound.  ``length_dist="heavy"``
    draws Pareto generation lengths capped at
    ``EngineConfig.heavy_gen_cap(gen_lens)``."""
    econf = config or EngineConfig()
    if econf.arena.cache_len is None:
        econf = econf.with_fields(cache_len=EngineConfig.derive_cache_len(
            prompt_lens, gen_lens, length_dist))
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    api = build_model(cfg, device=device)
    params = api.init(api.generator(seed))
    if sparsity > 0:
        prune = (dict(block_k=16, block_n=16, unit=8) if reduced else {})
        params = sparsify_params(params, sparsity,
                                 compact=econf.kernels.use_kernels, **prune)
    max_gen = (EngineConfig.heavy_gen_cap(gen_lens)
               if length_dist == "heavy" else None)
    reqs = synthetic_trace(cfg, num_requests=requests, seed=1,
                           prompt_lens=prompt_lens, gen_lens=gen_lens,
                           arrival_every=arrival_every,
                           length_dist=length_dist, max_gen=max_gen)
    engine = ServeEngine(api, params, econf)
    before = kernel_dispatch_counts()
    if api.device.type == "cuda":
        torch.cuda.synchronize(api.device)
    t0 = time.perf_counter()
    engine.run(reqs)
    if api.device.type == "cuda":
        torch.cuda.synchronize(api.device)
    dt = time.perf_counter() - t0
    after = kernel_dispatch_counts()
    dispatch = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    return ServeRun(engine, reqs, params, dt, dispatch)


def check_parity(run: ServeRun) -> int:
    """Replay every request through the batch-1 greedy oracle under the
    engine's scope; raise on the first divergence.  Returns the number of
    requests checked.  An int8-paged run is refused: its pages are gated
    by a logit tolerance, not by token equality."""
    eng = run.engine
    if eng._paged is not None and eng._paged.kv_dtype == "int8":
        raise ValueError("int8 KV pages are gated by a logit tolerance, "
                         "not by token parity with the greedy oracle")
    if len(eng.mode_history) > 1:
        raise RuntimeError("execution mode changed mid-run: "
                           f"{eng.mode_history}; a single-mode oracle "
                           "replay would compare across categories")
    for r in run.requests:
        with eng._scope():
            ref = greedy_generate(
                eng.api, run.params, r.as_batch(eng.device),
                steps=r.max_new_tokens, cache_len=eng.cache_len,
                prompt_bucket=eng.bucket_for(r.prompt_len))
        got = eng.outputs[r.rid].tokens
        want = ref[0].tolist()
        if got != want:
            raise AssertionError(f"request {r.rid} diverged from the greedy "
                                 f"oracle: {got} vs {want}")
    return len(run.requests)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, metavar="PATH",
                    help="EngineConfig JSON (runtime.config.EngineConfig"
                         ".to_json); flags set explicitly override it")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=None,
                    help="serve from the paged KV arena: power-of-two "
                         "tokens per page; default keeps the fixed "
                         "num_slots x cache_len arena")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="physical page-pool size (default: the fixed "
                         "arena's capacity + the DUMP page)")
    ap.add_argument("--kv-dtype", choices=("fp32", "int8"), default="fp32",
                    help="paged KV page dtype: int8 stores quantized pages "
                         "with per-token-row scales (gated logit "
                         "tolerance; fp32, the cache's own dtype, stays "
                         "token-exact)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-lens", default="8,16,32")
    ap.add_argument("--gen-lens", default="4,8,16")
    ap.add_argument("--arrival-every", type=int, default=0)
    ap.add_argument("--length-dist", choices=("choice", "heavy"),
                    default="choice",
                    help="'heavy' draws Pareto generation lengths (tail "
                         "stragglers) instead of a uniform choice over "
                         "--gen-lens")
    ap.add_argument("--sparsity", type=float, default=0.8)
    ap.add_argument("--use-kernels", action="store_true",
                    help="compact pruned weights into GriffinWeights and "
                         "run every GEMM through the hand-written kernels; "
                         "default keeps the pruned-dense twin on plain "
                         "torch matmuls")
    ap.add_argument("--policy", choices=("continuous", "static"),
                    default="continuous")
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="fused decode steps per host round-trip")
    ap.add_argument("--measure-every", type=int, default=8)
    ap.add_argument("--max-syncs-per-token", type=float, default=0.0,
                    help="fail when host_syncs/token exceeds this "
                         "(0 disables)")
    ap.add_argument("--parity", action="store_true",
                    help="check engine tokens == greedy_generate per request")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    econf = EngineConfig.from_args(
        args, defaults={d: ap.get_default(d) for d in vars(args)})
    run = serve(args.arch, reduced=args.reduced, requests=args.requests,
                prompt_lens=_lens(args.prompt_lens),
                gen_lens=_lens(args.gen_lens),
                arrival_every=args.arrival_every,
                length_dist=args.length_dist, sparsity=args.sparsity,
                seed=args.seed, device=args.device, config=econf)
    eng = run.engine
    spec = eng._paged
    arena = ("fixed" if spec is None else
             f"paged, {spec.num_pages} pages of {spec.page_size}")
    kv = "" if spec is None else f", {spec.kv_dtype} pages"
    print(f"engine: {eng.num_slots} slots x cache_len {eng.cache_len} "
          f"({arena}){kv} on {eng.device}, policy {eng.sched.policy}, "
          f"{'fused' if eng.fused else 'stepwise'}, peak "
          f"{eng.peak_active} slots active, "
          f"weight sparsity {eng.b_sparsity:.2f}, "
          f"declared activation sparsity {eng.a_declared} -> mode "
          f"{eng.mode.value}")
    st = eng.stats
    print(f"served {len(run.requests)} requests / {st['emitted']} tokens in "
          f"{run.seconds:.2f}s ({run.tokens_per_second:.1f} tok/s); "
          f"{st['decode_steps']} decode steps in {st['chunk_calls']} fused "
          f"chunks, {st['prefill_calls']} prefills over buckets "
          f"{sorted(eng.prefill_buckets)}, {run.syncs_per_token:.3f} host "
          f"syncs/token, dispatch {run.dispatch}")
    print("request 0 token ids:",
          np.asarray(eng.outputs[run.requests[0].rid].tokens[:12]))
    if args.max_syncs_per_token > 0 and \
            run.syncs_per_token > args.max_syncs_per_token:
        raise SystemExit(f"host syncs/token {run.syncs_per_token:.3f} "
                         f"exceeds {args.max_syncs_per_token}")
    if args.parity:
        if spec is not None and spec.kv_dtype == "int8":
            print("parity SKIPPED: int8 KV pages are gated by logit "
                  "tolerance, not token equality")
            return
        n = check_parity(run)
        print(f"parity OK: all {n} requests token-identical to "
              "greedy_generate")


if __name__ == "__main__":
    main()
