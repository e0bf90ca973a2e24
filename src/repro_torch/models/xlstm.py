"""xLSTM blocks [arXiv:2405.04517] — the counterpart of
``repro/models/xlstm.py``: mLSTM (matrix memory, chunkwise-parallel over a
prompt, one chunk of one token per decode step) and sLSTM (scalar memory
with exponential gating and block-diagonal recurrence).

The 48 blocks follow the 7:1 mLSTM:sLSTM pattern as groups of (7 mLSTM + 1
sLSTM).  Parameters keep the reference's layout: ``m_blocks`` and
``s_blocks`` hold every per-block leaf stacked along (group, block) axes,
compacted leaves as a ``GriffinWeights`` with the same two-axis lead.  The
Griffin technique applies to the projection GEMMs, which go through
``common.griffin_linear``; the recurrent state path is not a weight GEMM.
``lax.scan`` over groups, blocks and chunks becomes Python loops.

Batch invariance: the engine decodes several rows at once while its greedy
oracle decodes one, and their tokens must match bit for bit.  Every
contraction outside the kernels (the per-head ``wq``/``wk``/``wv``, the
chunk's ``q k``, ``P v``, ``q C`` and ``q n``, the chunk-end state sums
and sLSTM's ``h R``) is a broadcast product reduced with
``common.tree_sum``, whose order depends only on the reduced length.  A
product larger than ``TILE_BYTES`` is made in tiles along an axis it is not
reduced over, so the tiling never changes a bit.  The within-chunk prefix
sum of the forget gates is a masked ``tree_sum`` too (:func:`_prefix_sum`),
so pad steps leave it exactly unchanged.

Recurrent state: ``{"mC" (G, n_m, B, H, hd, hd), "mn" (G, n_m, B, H, hd),
"mm" (G, n_m, B, H), "sc"/"sn"/"sh"/"sm" (G, n_s, B, H, hd) fp32, "pos"}``,
independent of the sequence length.  ``decode_step`` writes the new state
into the cache tensors in place (the reference's donated update) and
returns the cache with the advanced position.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .common import (dense_init, gather_heads, griffin_linear,
                     head_share, length_mask, remat_fn, rms_norm,
                     shared_activation_meta, stack_layers, stack_slice,
                     take_heads, take_last, tree_sum, unstack)

Params = Dict[str, Any]
MIN_NORM = 1e-6
# log-space initial stabiliser, and the gate pre-activations that make a
# pad step an exact state no-op (the reference's constants)
M_INIT = -1e30
PAD_GATE = 1e30
# the most one broadcast product of a contraction may hold: 16 token rows
# of xlstm-1.3b's per-head projection (4 heads of 1024 x 1024, fp32)
TILE_BYTES = 256 << 20
MLSTM_STATE = ("mC", "mn", "mm")
SLSTM_STATE = ("sc", "sn", "sh", "sm")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def group_counts(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(groups, mLSTM blocks per group, sLSTM blocks per group)."""
    pat = cfg.xlstm_pattern
    n_m = sum(1 for b in pat if b == "m")
    return cfg.num_layers // len(pat), n_m, len(pat) - n_m


# ---------------------------------------------------------------------------
# batch-invariant contractions
# ---------------------------------------------------------------------------

def _tiled(part: Callable[[int, int], torch.Tensor], n: int,
           slice_bytes: int, dim: int) -> torch.Tensor:
    """``part(lo, hi)`` over slices ``[lo, hi)`` of an axis of ``n`` that
    the product is not reduced over, at most ``TILE_BYTES`` of product
    each (``slice_bytes`` a slice), concatenated along ``dim``."""
    step = max(1, TILE_BYTES // max(slice_bytes, 1))
    if step >= n:
        return part(0, n)
    return torch.cat([part(lo, min(lo + step, n))
                      for lo in range(0, n, step)], dim=dim)


def _headwise(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """out[b, l, h, e] = sum_d x[b, l, h, d] * w[.., h, d, e] in fp32.
    ``x`` (B, L, H, d); ``wt`` the transposed weight, (H, e, d) shared by
    every row or (B, 1, H, e, d) per batch row (a carried state)."""
    B, L, H, d = x.shape
    e = wt.shape[-2]
    xf = x.float()

    def part(lo, hi):
        return tree_sum(xf[:, lo:hi, :, None, :] * wt)

    return _tiled(part, L, 4 * B * H * e * d, dim=1)


def _blockdiag_t(w: torch.Tensor) -> torch.Tensor:
    """A per-head (H, d, e) weight as :func:`_headwise` takes it."""
    return w.float().transpose(-1, -2).contiguous()


def _prefix_sum(x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of x (B, L, H) along L: position t is the
    ``tree_sum`` of the whole axis with the entries after t zeroed
    (``causal`` the (L, L) lower-triangular mask).  A run of exact zeros
    at the end (pad steps) then leaves every later position with exactly
    the last real position's bits, and an unpadded sequence gives the
    same bits, since a tree over a zero-padded power of two equals the
    tree over the shorter one."""
    return tree_sum(torch.where(causal[None, :, :, None], x[:, None], 0.0),
                    dim=2)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(cfg: ModelConfig, gen: torch.Generator) -> Params:
    dt, dev = _dtype(cfg), gen.device
    D = cfg.d_model
    din = int(cfg.proj_factor * D)
    H = cfg.num_heads
    hd = din // H

    def blockdiag():
        # per-head projections (block-diagonal), as in the official xLSTM
        return dense_init(gen, (H, hd, hd), hd, dt)

    return {
        "ln": torch.zeros((D,), dtype=dt, device=dev),
        "w_up": dense_init(gen, (D, 2 * din), D, dt),
        "wq": blockdiag(), "wk": blockdiag(), "wv": blockdiag(),
        "wi": dense_init(gen, (din, H), din, dt),
        "wf": dense_init(gen, (din, H), din, dt),
        "gn": torch.zeros((din,), dtype=dt, device=dev),
        "w_down": dense_init(gen, (din, D), din, dt),
    }


def _mlstm_chunk(q, k, v, i_pre, f_pre, state, heads=None):
    """One chunk of stabilised chunkwise mLSTM, in fp32.

    q, k, v: (B, L, H, hd) (k pre-scaled by 1/sqrt(hd)); i_pre, f_pre:
    (B, L, H) gate pre-activations; state: (C (B, H, hd, hd), n (B, H,
    hd), m (B, H)), or None for the zero state (a prefill's first chunk),
    whose inter-chunk terms are exact zeros and are not computed.

    ``heads`` (``common.head_share``): q, k, v, C and n hold those heads
    alone, while the gates and the stabiliser m hold every head.  m is a
    function of the gates alone, so it is computed for every head here and
    the rest on the share; returns the share's h, C and n beside the whole
    m."""
    B, L, _, hd = q.shape
    H = i_pre.shape[-1]
    qf, kf, vf = q.float(), k.float(), v.float()
    tmask = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    lf = F.logsigmoid(f_pre.float())                         # (B, L, H)
    b = _prefix_sum(lf, tmask)                               # inclusive
    total = b[:, -1]                                         # (B, H)
    i32 = i_pre.float()
    # intra-chunk log decay D[t, s] = b[t] - b[s] + i[s], s <= t
    Dlog = b[:, :, None, :] - b[:, None, :, :] + i32[:, None, :, :]
    Dlog = torch.where(tmask[None, :, :, None], Dlog, -math.inf)
    m_intra = Dlog.amax(dim=2)                               # (B, L, H)
    if state is None:
        m_prev = torch.full((B, H), M_INIT, device=q.device)
    else:
        C_prev, n_prev, m_prev = state
    a = m_prev[:, None, :] + b                               # (B, L, H)
    m_t = torch.maximum(m_intra, a)
    # the state's stabiliser at the end of the chunk, every head
    w = total[:, None, :] - b + i32                          # (B, L, H)
    m_next = torch.maximum(m_prev + total, w.amax(dim=1))
    if heads is not None:
        Dlog, a, m_t, w, total, m_prev = (
            take_heads(t, heads, t.dim() - 1)
            for t in (Dlog, a, m_t, w, total, m_prev))
        H = heads.stop - heads.start

    def qk_part(lo, hi):                                     # (B, l, S, H)
        return tree_sum(qf[:, lo:hi, None] * kf[:, None])

    qk = _tiled(qk_part, L, 4 * B * L * H * hd, dim=1)
    P = torch.exp(Dlog - m_t[:, :, None, :]) * qk            # (B, L, S, H)
    Pt = P.permute(0, 1, 3, 2)                               # (B, L, H, S)
    vt = vf.permute(0, 2, 3, 1)                              # (B, H, e, S)

    def pv_part(lo, hi):                                     # (B, l, H, e)
        return tree_sum(Pt[:, lo:hi, :, None, :] * vt[:, None])

    h = _tiled(pv_part, L, 4 * B * H * hd * L, dim=1)
    qn = tree_sum(Pt)                                        # (B, L, H)
    if state is not None:
        scale_inter = torch.exp(a - m_t)
        h = h + _headwise(qf, C_prev.transpose(-1, -2)[:, None]) * \
            scale_inter[..., None]
        qn = qn + tree_sum(qf * n_prev[:, None]) * scale_inter
    denom = torch.maximum(qn.abs(), torch.exp(-m_t)) + MIN_NORM
    h = h / denom[..., None]
    # state update to the end of the chunk
    m_share = take_heads(m_next, heads, 1)
    ks = (torch.exp(w - m_share[:, None, :])[..., None] * kf) \
        .permute(0, 2, 3, 1)                                 # (B, H, d, L)

    def kv_part(lo, hi):                                     # (B, H, d, e)
        return tree_sum(ks[:, :, lo:hi, None, :] * vt[:, :, None])

    C_next = _tiled(kv_part, hd, 4 * B * H * hd * L, dim=2)
    n_next = tree_sum(ks)
    if state is not None:
        decay_old = torch.exp(m_prev + total - m_share)      # (B, H)
        C_next = decay_old[:, :, None, None] * C_prev + C_next
        n_next = decay_old[:, :, None] * n_prev + n_next
    return h, (C_next, n_next, m_next)


def mlstm_seq(cfg: ModelConfig, p: Params, x: torch.Tensor, state=None,
              chunk: int = 64, mask: Optional[torch.Tensor] = None):
    """Full mLSTM block over a sequence.  x: (B, S, D).  Returns (out,
    (C, n, m)); ``state`` None is the zero state.

    ``mask``: optional (B, S) validity mask of a right-padded batch
    (bucketed prefill).  Pad positions are made exact state no-ops through
    the gate pre-activations alone: the input gate is driven to -1e30 (its
    exp vanishes from both the intra-chunk decay matrix and the chunk state
    update) and the forget gate to +1e30 (log-sigmoid exactly 0, identity
    decay), so (C, n, m) after the padded sequence equal the state at the
    last real token.  S must be a multiple of min(chunk, S), as in the
    reference; nothing is padded or cut.

    A ``state`` whose C holds fewer heads than the model's is a rank's
    share on a serving mesh (``common.head_share``): the block runs its
    heads' state, with their blocks of the per-head mats, and gathers
    every model rank's heads before ``gn`` (an ``rms_norm`` across them);
    the stabiliser m stays whole."""
    B, S, D = x.shape
    H = cfg.num_heads
    din = int(cfg.proj_factor * D)
    hd = din // H
    dt = x.dtype
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"mlstm_seq: sequence length {S} is not a multiple "
                         f"of the chunk {L}")
    heads = None if state is None else head_share(state[0].shape[1], H)
    h_in = rms_norm(x, p["ln"], cfg.norm_eps)
    up = griffin_linear(h_in, p["w_up"])
    xm, z = up[..., :din], up[..., din:]
    xh = take_heads(xm.reshape(B, S, H, hd), heads, 2)
    # k is divided by sqrt(hd) rounded to the model's dtype, as in the
    # reference (a host scalar: no device work)
    root = torch.tensor(math.sqrt(hd), dtype=dt).item()

    def mats(name):
        return _blockdiag_t(take_heads(p[name], heads, 0))

    q = _headwise(xh, mats("wq")).to(dt)
    k = _headwise(xh, mats("wk")).to(dt) / root
    v = _headwise(xh, mats("wv")).to(dt)
    meta = shared_activation_meta(xm, p["wi"], p["wf"])
    i_pre = griffin_linear(xm, p["wi"], meta=meta)
    f_pre = griffin_linear(xm, p["wf"], meta=meta)
    if mask is not None:
        m3 = mask[:, :, None]
        i_pre = torch.where(m3, i_pre, -PAD_GATE)
        f_pre = torch.where(m3, f_pre, PAD_GATE)
    hs = []
    for c in range(S // L):
        cs = slice(c * L, (c + 1) * L)
        h, state = _mlstm_chunk(q[:, cs], k[:, cs], v[:, cs], i_pre[:, cs],
                                f_pre[:, cs], state, heads)
        hs.append(h)
    h = torch.cat(hs, dim=1)
    if heads is not None:
        h = gather_heads(h, 2)
    h = h.reshape(B, S, din)
    h = rms_norm(h, p["gn"], cfg.norm_eps)
    # h is fp32, so w_down takes an fp32 A against its bf16 weight and the
    # residual add rounds once, as in the reference
    out = griffin_linear(h * F.silu(z.float()).to(dt), p["w_down"])
    return (x + out).to(dt), state


def mlstm_zero_state(cfg: ModelConfig, batch: int, device=None):
    din = int(cfg.proj_factor * cfg.d_model)
    H = cfg.num_heads
    hd = din // H
    return (torch.zeros((batch, H, hd, hd), device=device),
            torch.zeros((batch, H, hd), device=device),
            torch.full((batch, H), M_INIT, device=device))


def mlstm_step(cfg: ModelConfig, p: Params, x: torch.Tensor, state):
    """O(1) decode step.  x: (B, 1, D)."""
    return mlstm_seq(cfg, p, x, state=state, chunk=1)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(cfg: ModelConfig, gen: torch.Generator) -> Params:
    dt, dev = _dtype(cfg), gen.device
    D = cfg.d_model
    H = cfg.num_heads
    hd = D // H
    ff = int(4 * D / 3)

    def rmat():
        return dense_init(gen, (H, hd, hd), hd, dt)

    p = {"ln": torch.zeros((D,), dtype=dt, device=dev)}
    for g in ("z", "i", "f", "o"):
        p["w" + g] = dense_init(gen, (D, D), D, dt)
        p["r" + g] = rmat()
    p.update(gn=torch.zeros((D,), dtype=dt, device=dev),
             ln2=torch.zeros((D,), dtype=dt, device=dev),
             w_ff1=dense_init(gen, (D, ff), D, dt),
             w_ff2=dense_init(gen, (ff, D), ff, dt))
    return p


def slstm_zero_state(cfg: ModelConfig, batch: int, device=None):
    D, H = cfg.d_model, cfg.num_heads
    shape = (batch, H, D // H)
    return (torch.zeros(shape, device=device),
            torch.zeros(shape, device=device),
            torch.zeros(shape, device=device),
            torch.full(shape, M_INIT, device=device))


def slstm_seq(cfg: ModelConfig, p: Params, x: torch.Tensor, state=None,
              mask: Optional[torch.Tensor] = None):
    """sLSTM block: strict recurrence over time, one step at a time.
    Returns (out, (c, n, h, m)); ``state`` None is the zero state.

    ``mask``: optional (B, S) validity mask of a right-padded batch
    (bucketed prefill).  The hidden state feeds back into the gates, so pad
    steps must hold the *entire* carried state — each step computes
    normally and then selects old-vs-new per row, leaving (c, n, h, m)
    after the padded sequence exactly the state at the last real token.

    A ``state`` of fewer heads than the model's is a rank's share on a
    serving mesh (``common.head_share``): the recurrence runs its heads
    (the recurrent mats are block-diagonal) and every model rank's heads
    of h are gathered before ``gn``."""
    B, S, D = x.shape
    H = cfg.num_heads
    hd = D // H
    dt = x.dtype
    heads = None if state is None else head_share(state[0].shape[1], H)
    xin = rms_norm(x, p["ln"], cfg.norm_eps)
    # input contributions of the four gates, (B, S, H, hd) each
    pre = [take_heads(griffin_linear(xin, p["w" + g]).reshape(B, S, H, hd)
                      .float(), heads, 2)
           for g in ("z", "i", "f", "o")]
    if state is None:
        state = slstm_zero_state(cfg, B, x.device)
    # the four recurrent mats side by side, transposed: (H, 4 hd, hd)
    rt = _blockdiag_t(torch.cat([take_heads(p["r" + g], heads, 0)
                                 for g in ("z", "i", "f", "o")], dim=-1))
    c, n, h, m = state
    hs = []
    for t in range(S):
        rec = _headwise(h[:, None], rt)[:, 0].split(hd, dim=-1)
        zt = torch.tanh(pre[0][:, t] + rec[0])
        it = pre[1][:, t] + rec[1]                           # log-space
        ft = F.logsigmoid(pre[2][:, t] + rec[2])
        ot = torch.sigmoid(pre[3][:, t] + rec[3])
        m_new = torch.maximum(ft + m, it)
        i_s = torch.exp(it - m_new)
        f_s = torch.exp(ft + m - m_new)
        c_new = f_s * c + i_s * zt
        n_new = f_s * n + i_s
        h_new = ot * c_new / torch.clamp(n_new, min=MIN_NORM)
        if mask is not None:
            sel = mask[:, t, None, None]
            c_new = torch.where(sel, c_new, c)
            n_new = torch.where(sel, n_new, n)
            h_new = torch.where(sel, h_new, h)
            m_new = torch.where(sel, m_new, m)
        c, n, h, m = c_new, n_new, h_new, m_new
        hs.append(h)
    hseq = torch.stack(hs, dim=1)
    if heads is not None:
        hseq = gather_heads(hseq, 2)
    hseq = hseq.reshape(B, S, D)
    x = x + rms_norm(hseq.to(dt), p["gn"], cfg.norm_eps)
    f = rms_norm(x, p["ln2"], cfg.norm_eps)
    f = F.gelu(griffin_linear(f, p["w_ff1"]).float(),
               approximate="tanh").to(dt)
    return (x + griffin_linear(f, p["w_ff2"])).to(dt), (c, n, h, m)


# ---------------------------------------------------------------------------
# model assembly: groups of (n_m mLSTM + n_s sLSTM)
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random weights from ``gen`` on ``gen.device``: normal / sqrt(fan_in)
    GEMMs and per-head mats, unit-normal embeddings, zero norm scales, an
    untied head (the reference's scheme; the draws themselves differ from
    ``jax.random``'s)."""
    if cfg.family != "ssm":
        raise ValueError(f"xlstm builds the ssm family, not {cfg.family!r}")
    dt = _dtype(cfg)
    G, n_m, n_s = group_counts(cfg)
    D, V = cfg.d_model, cfg.vocab_size

    def group(init_one, n):
        return lambda g: stack_layers(lambda g1: init_one(cfg, g1), g, n)

    return {
        "embed": dense_init(gen, (V, D), V, dt, scale=1.0),
        "final_norm": torch.zeros((D,), dtype=dt, device=gen.device),
        "m_blocks": stack_layers(group(init_mlstm, n_m), gen, G),
        "s_blocks": stack_layers(group(init_slstm, n_s), gen, G),
        "head": dense_init(gen, (D, V), D, dt),
    }


def init_cache(cfg: ModelConfig, batch: int, length: int,
               device: torch.device) -> Params:
    """Zeroed recurrent state: O(1) in the sequence length (``length`` is
    ignored), fp32, with the (groups, blocks) lead of the weights."""
    G, n_m, n_s = group_counts(cfg)
    mstate = mlstm_zero_state(cfg, batch, device)
    sstate = slstm_zero_state(cfg, batch, device)
    cache = {}
    for key, lead, x in zip(MLSTM_STATE + SLSTM_STATE,
                            [(G, n_m)] * 3 + [(G, n_s)] * 4,
                            mstate + sstate):
        cache[key] = x.expand(lead + x.shape).clone()
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


def _scan_groups_with_state(cfg: ModelConfig, params: Params, cache: Params,
                            x: torch.Tensor, chunk: int,
                            mask: Optional[torch.Tensor] = None,
                            fresh: bool = False) -> torch.Tensor:
    """Every block over ``x`` in order, each carrying its state from
    ``cache`` (the zero state when ``fresh``) and writing its new state
    back into ``cache`` in place.  Returns the last block's output."""
    G, n_m, n_s = group_counts(cfg)
    for g in range(G):
        for j in range(n_m):
            st = None if fresh else tuple(cache[k][g, j] for k in MLSTM_STATE)
            x, st = mlstm_seq(cfg, stack_slice(params["m_blocks"], g, j), x,
                              state=st, chunk=chunk, mask=mask)
            for key, t in zip(MLSTM_STATE, st):
                cache[key][g, j].copy_(t)
        for j in range(n_s):
            st = None if fresh else tuple(cache[k][g, j] for k in SLSTM_STATE)
            x, st = slstm_seq(cfg, stack_slice(params["s_blocks"], g, j), x,
                              state=st, mask=mask)
            for key, t in zip(SLSTM_STATE, st):
                cache[key][g, j].copy_(t)
    return x


def forward_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   chunk: int = 64):
    """Every block over ``tokens`` from the zero state, the states thrown
    away (nothing is written in place): (final-normed hidden, aux 0), the
    loss side of the reference's ``forward_hidden``.  Each (mLSTM...,
    sLSTM...) group runs under ``common.remat_fn``, as the reference
    checkpoints each group."""
    x = params["embed"][tokens]

    def group(mp, sp, x):
        for lp in unstack(mp):
            x, _ = mlstm_seq(cfg, lp, x, chunk=chunk)
        for lp in unstack(sp):
            x, _ = slstm_seq(cfg, lp, x)
        return x

    group = remat_fn(cfg, group)
    for mp, sp in zip(unstack(params["m_blocks"]),
                      unstack(params["s_blocks"])):
        x = group(mp, sp, x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), device=x.device)


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            cache_len: Optional[int] = None, chunk: int = 64,
            lengths: Optional[torch.Tensor] = None
            ) -> Tuple[Params, torch.Tensor]:
    """Process a prompt from the zero state; returns (cache, last-token
    logits).  ``lengths``: optional (B,) true prompt lengths of a
    right-padded batch (bucketed prefill).  Pad steps are exact state
    no-ops (see ``mlstm_seq`` / ``slstm_seq``), so the carried recurrent
    state equals the state at each row's last real token."""
    B, S = tokens.shape
    cache = init_cache(cfg, B, 0, device=tokens.device)
    x = params["embed"][tokens]
    mask = None if lengths is None else length_mask(lengths, S)
    x = _scan_groups_with_state(cfg, params, cache, x, chunk, mask=mask,
                                fresh=True)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if lengths is None:
        last = x[:, -1]
        pos = torch.full((), S - 1, dtype=torch.int32, device=tokens.device)
    else:
        last = take_last(x, lengths)
        pos = (lengths - 1).to(torch.int32)          # per-row (B,) vector
    cache["pos"] = pos
    return cache, griffin_linear(last, params["head"])


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                token: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """One recurrent step for the whole batch.  token: (B, 1).  The state
    tensors are updated in place; the returned cache shares them.  The
    state math is position-free, so ``pos`` advances elementwise whether
    it is the lockstep scalar or a (B,) per-slot vector."""
    x = params["embed"][token]
    x = _scan_groups_with_state(cfg, params, cache, x, chunk=1)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = griffin_linear(x[:, 0], params["head"])
    return logits, dict(cache, pos=cache["pos"] + 1)
