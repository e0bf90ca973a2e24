"""Measured-tok/s validation of shortlisted candidates — the counterpart of
``repro/tuning/measure.py``: warm runs of the real serving engine.

The analytical scores (``tuning.search``) only *rank*; every plan that
ships was validated here — engine built with the candidate's compacted
weights and thresholds, a first throwaway pass, then best-of-N timed
replays of a deterministic trace.  The same run yields the token streams,
so candidate-vs-default token identity is asserted in the loop, not
trusted.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Tuple

import torch

from ..configs import get_config
from ..models import build_model
from ..runtime.config import EngineConfig
from ..runtime.engine import ServeEngine, synthetic_trace

# Representative arch per model family (the reference's mapping).
FAMILY_ARCHS: Dict[str, str] = {
    "dense": "llama3.2-1b", "moe": "mixtral-8x7b", "audio":
    "whisper-large-v3", "ssm": "xlstm-1.3b", "hybrid": "recurrentgemma-9b",
    "vlm": "chameleon-34b",
}

# The tuning engine: 4 slots, fused decode chunks of 8, every GEMM
# through the kernels (the reference's settings).
TUNE_SLOTS = 4
TUNE_DECODE_CHUNK = 8
TUNE_PROMPT_LENS = (6, 10)
TUNE_GEN_LENS = (4, 8, 16)


def tuning_workload(family: str, *, requests: int = 6, seed: int = 7,
                    reduced: bool = False, device: Any = "cuda"
                    ) -> Tuple[Any, Any, Any, int, Callable]:
    """(cfg, api, params, cache_len, trace_fn) for one family's tuning
    workload: the registry config (full width unless ``reduced``) with
    random weights from seed 0 on ``device`` (the card unless
    ``device="cpu"``), on a deterministic mixed prompt/gen trace."""
    if family not in FAMILY_ARCHS:
        raise ValueError(f"unknown family {family!r}")
    cfg = get_config(FAMILY_ARCHS[family])
    if reduced:
        cfg = cfg.reduced()
    api = build_model(cfg, device=device)
    params = api.init(api.generator(0))
    cache_len = max(TUNE_PROMPT_LENS) + max(TUNE_GEN_LENS) + 1
    trace = lambda: synthetic_trace(cfg, num_requests=requests, seed=seed,
                                    prompt_lens=TUNE_PROMPT_LENS,
                                    gen_lens=TUNE_GEN_LENS,
                                    arrival_every=1)
    return cfg, api, params, cache_len, trace


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_plan(api, params, cache_len: int, trace_fn: Callable, *,
                 plan=None, repeats: int = 3) -> Dict[str, Any]:
    """Warm measured run of one engine configuration.

    Builds the tuning engine (``TUNE_SLOTS`` slots, decode chunks of
    ``TUNE_DECODE_CHUNK``, every GEMM through the kernels) once (``plan``
    steers its Mode thresholds; the weight compaction was already applied
    by the caller through ``sparsify_params(plan=...)``), runs a first
    throwaway pass, then times
    ``repeats`` fresh replays and keeps the best (least-contended) wall
    clock, the card synchronised before each clock read.  Returns tok/s,
    the deterministic tok/step twin, the full per-request token streams
    for parity checks, and ``model_calls`` (prefills + decode steps over
    every pass, warm one included)."""
    config = EngineConfig().with_fields(
        num_slots=TUNE_SLOTS, cache_len=cache_len,
        decode_chunk=TUNE_DECODE_CHUNK, use_kernels=True)
    eng = ServeEngine(api, params, config, plan=plan)
    outs = eng.run(trace_fn())                      # warm pass
    tokens = tuple(tuple(int(t) for t in outs[r].tokens)
                   for r in sorted(outs))
    calls = eng.stats["prefill_calls"] + eng.stats["decode_steps"]
    best = float("inf")
    for _ in range(max(1, repeats)):
        eng.stats = {k: 0 for k in eng.stats}
        reqs = trace_fn()
        _sync(eng.device)
        t0 = time.perf_counter()
        outs = eng.run(reqs)
        _sync(eng.device)
        best = min(best, time.perf_counter() - t0)
        if not all(o.finished >= 0 for o in outs.values()):
            raise RuntimeError("a request did not finish")
        calls += eng.stats["prefill_calls"] + eng.stats["decode_steps"]
    toks = eng.stats["emitted"]
    steps = max(eng.stats["decode_steps"], 1)
    return {"tok_s": toks / best, "tok_per_step": toks / steps,
            "emitted": int(toks), "decode_steps": int(steps),
            "wall_s": best, "mode": eng.mode.value, "tokens": tokens,
            "model_calls": int(calls)}
