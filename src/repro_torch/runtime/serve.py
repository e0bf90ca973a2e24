"""Serving runtime: prompt-bucket padding, the fused multi-step decode chunk
and the batch-1 greedy oracle — the counterpart of
``repro/runtime/serve.py`` (single device).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..models.registry import ModelApi


def pad_prompt_batch(batch: Dict[str, torch.Tensor],
                     bucket: Optional[int]) -> Dict[str, torch.Tensor]:
    """Right-pad ``batch["tokens"]`` to ``bucket`` and record the true
    prompt lengths under ``"lengths"``; ``bucket=None`` is the identity
    (exact-length prefill).  Other inputs (an encoder-decoder's
    ``"frames"``) pass through, so ``greedy_generate`` and the engine
    prefill with them alike."""
    if bucket is None:
        return batch
    toks = batch["tokens"]
    B, S = toks.shape
    if bucket < S:
        raise ValueError(f"bucket {bucket} shorter than prompt {S}")
    out = dict(batch)
    out["tokens"] = torch.nn.functional.pad(toks, (0, bucket - S))
    out["lengths"] = torch.full((B,), S, dtype=torch.int32,
                                device=toks.device)
    return out


def make_chunk_ladder(api: ModelApi, decode_chunk: int) -> Callable:
    """``chunk_for(n)``: the fused n-step chunk function for each length on
    the engine's power-of-two ladder 1..``decode_chunk``, memoized; lengths
    outside the ladder raise, as in the reference."""
    cache: Dict[int, Callable] = {}

    def chunk_for(n: int) -> Callable:
        if n < 1 or n > decode_chunk:
            raise ValueError(f"chunk length {n} outside the configured "
                             f"ladder 1..{decode_chunk}")
        fn = cache.get(n)
        if fn is None:
            fn = cache[n] = make_decode_chunk_fn(api, n)
        return fn

    return chunk_for


def make_decode_chunk_fn(api: ModelApi, decode_chunk: int) -> Callable:
    """The fused multi-step decode tick: ``decode_chunk`` pooled decode
    steps with argmax, token feedback and per-slot bookkeeping all on the
    device, and no host transfer.

    ``chunk_fn(params, cache, tokens (B, 1), remaining (B,))`` updates
    ``cache``, ``tokens`` and ``remaining`` in place (the reference donates
    them) and returns them with the (chunk, B) token ring and the two
    measurement counts (int64): the exact-zero logits of the live rows
    (``remaining > 0``) and their logits, so the measured share is exact
    and counts from several ranks add up exactly (the reference sums
    float fractions).  Finished and unadmitted rows keep decoding garbage,
    excluded from the ring drain and the measurement.
    """

    def chunk_fn(params, cache, tokens, remaining):
        B = tokens.shape[0]
        ring = torch.empty((decode_chunk, B), dtype=tokens.dtype,
                           device=tokens.device)
        zf_num = torch.zeros((), dtype=torch.int64, device=tokens.device)
        zf_den = torch.zeros((), dtype=torch.int64, device=tokens.device)
        for t in range(decode_chunk):
            logits, cache = api.decode_step(params, cache, tokens)
            toks = torch.argmax(logits, dim=-1).to(tokens.dtype)
            live = remaining > 0
            zf_num += ((logits == 0).sum(dim=-1) * live).sum()
            zf_den += live.sum() * logits.shape[-1]
            remaining -= live.to(remaining.dtype)
            tokens.copy_(toks[:, None])
            ring[t] = toks
        return cache, tokens, remaining, ring, zf_num, zf_den

    return chunk_fn


def greedy_generate(api: ModelApi, params, batch: Dict, steps: int,
                    cache_len: int, prompt_bucket: Optional[int] = None
                    ) -> torch.Tensor:
    """Reference generation loop, one static batch in lockstep — the parity
    oracle for the serving engine.  ``prompt_bucket`` replays the engine's
    bucketed prefill (pass ``engine.bucket_for(prompt_len)``).  Returns the
    (B, steps) generated tokens."""
    batch = pad_prompt_batch(batch, prompt_bucket)
    cache, logits = api.prefill(params, batch, cache_len=cache_len)
    toks = [torch.argmax(logits, dim=-1)[:, None]]
    for _ in range(steps - 1):
        logits, cache = api.decode_step(params, cache, toks[-1])
        toks.append(torch.argmax(logits, dim=-1)[:, None])
    return torch.cat(toks, dim=1)
