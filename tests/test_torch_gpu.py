"""The port's CUDA kernels and serving path on the card.

Every test here needs a CUDA card and nvcc (the kernels have no CPU mode)
and skips elsewhere; the file imports neither JAX nor the JAX package, so
it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances (as in chip_smoke.py): fp32 |err| <= 1e-5 * max|ref| (sums in
another order), fp32 A against a bf16 weight too (the weight widens
exactly); bf16 |err| <= one bf16 ulp of the output plus that term (both
round one fp32 sum).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.scheduler import schedule, schedule_batched
from repro_torch.kernels import (ActivationMeta, compact_activations,
                                 decompact_weights, dense_matmul,
                                 griffin_matmul, launch_counts,
                                 preprocess_weights, sparse_a_matmul)
from repro_torch.kernels.batch_eval import schedule_cycles
from repro_torch.kernels.batch_eval import kernel as batch_eval_kernel
from repro_torch.kernels.batch_eval.ref import schedule_cycles_ref
from repro_torch.kernels.dense_gemm import kernel as dense_gemm_kernel
from repro_torch.kernels.dense_gemm.ref import dense_matmul_ref
from repro_torch.kernels.sparse_a import kernel as k3
from repro_torch.kernels.sparse_a.ref import (compact_activations_ref,
                                              sparse_a_ref)
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model
from repro_torch.models.common import sparse_execution
from repro_torch.runtime.config import EngineConfig
from repro_torch.runtime.engine import (ServeEngine, int8_logit_gap,
                                        synthetic_trace)
from repro_torch.runtime.fault import FaultInjector
from repro_torch.runtime.serve import greedy_generate
from repro_torch.sparsity import (block_prune, init_sparse_params,
                                  sparsify_params)
from torch_helpers import TwoPass

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (A, weight) dtypes the kernels take; "mixed" is the mLSTM block's w_down
# input: fp32 activations against a bf16 weight, an fp32 output
PAIRS = {"float32": (torch.float32, torch.float32),
         "bfloat16": (torch.bfloat16, torch.bfloat16),
         "mixed": (torch.float32, torch.bfloat16)}


def assert_close(out, ref, dtype):
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    allowed = 1e-5 * float(r.abs().max())
    if dtype == "bfloat16":
        mag = torch.maximum(o.abs(), r.abs()).clamp(min=1e-30)
        allowed = torch.exp2(torch.floor(torch.log2(mag)) - 7) + allowed
    assert bool((err <= allowed).all()), float(err.max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 2048, 4096), (4, 2048, 1000),
                                   (33, 70, 17), (40, 256, 300)])
def test_dense_gemm_kernel_matches_plain(cuda, dtype, shape):
    m, k, n = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(m, k, generator=g, device=cuda).to(DTYPES[dtype])
    embed = torch.randn(n, k, generator=g, device=cuda).to(a.dtype)
    before = launch_counts()["dense_gemm"]
    for b in (embed.T, embed.T.contiguous()):       # both stride layouts
        out = dense_matmul(a, b)
        torch.cuda.synchronize()
        ref = (a.float() @ b.float()).to(a.dtype)
        assert_close(out, ref, dtype)
    assert launch_counts()["dense_gemm"] == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("balance", [False, True])
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(1, 2048, 512, 128, 128, 32),
                                  (4, 2048, 512, 128, 128, 32),
                                  (5, 8192, 1024, 128, 128, 32),
                                  (16, 2048, 2048, 128, 128, 32),
                                  (17, 8192, 512, 128, 128, 32),
                                  (32, 2048, 8192, 128, 128, 32),
                                  (33, 2000, 512, 128, 128, 32),
                                  (19, 200, 96, 16, 32, 8),
                                  (7, 70, 48, 16, 16, 8)])
def test_griffin_spmm_kernel_matches_plain(cuda, dtype, dual, balance, case):
    """Every M around the kernel's 16-row MMA tiles and 32-row passes, the
    cluster split of a narrow N (512) and a deep K (8192), A narrower than
    the padded K (2000 of 2048; 200 of 208; 70, which takes the CUDA-core
    route), a tile with no live block, and all-zero K blocks for dual."""
    m, k, n, bk, bn, unit = case
    g = torch.Generator(device=cuda).manual_seed(1)
    w = block_prune(torch.randn(k, n, generator=g, device=cuda), 0.8, bk,
                    unit)
    w[:, :bn] = 0                         # one tile with cnt 0
    gw = preprocess_weights(w.to(DTYPES[dtype]), block_k=bk, block_n=bn,
                            unit=unit, balance=balance)
    assert int((gw.cnt == 0).sum()) >= 1
    a = torch.randn(m, k, generator=g, device=cuda).to(DTYPES[dtype])
    a[:, :2 * bk] = 0                     # all-zero A blocks for dual
    before = launch_counts()["griffin_spmm"]
    out = griffin_matmul(a, gw, dual=dual)
    torch.cuda.synchronize()
    assert launch_counts()["griffin_spmm"] == before + 1
    assert out.shape == (m, n) and out.is_contiguous()
    ref = (a.float() @ decompact_weights(gw)[:k].float()).to(a.dtype)
    assert_close(out, ref, dtype)
    if dual:     # the skipped products are exact zeros: same values
        assert torch.equal(out, griffin_matmul(a, gw, dual=False))


@pytest.mark.gpu
def test_griffin_spmm_card_path_gathers_nothing(cuda, monkeypatch):
    """The kernel stores the balance shuffle's columns in place: one launch
    per call, no index_select, and griffin_matmul returns the kernel's own
    (M, n) output, with nothing run on it after the launch."""
    from repro_torch.kernels.griffin_spmm import kernel

    g = torch.Generator(device=cuda).manual_seed(6)
    gw = preprocess_weights(block_prune(
        torch.randn(2048, 1000, generator=g, device=cuda), 0.8).bfloat16())
    assert gw.perm is not None and gw.b_comp.shape[1] == 1024
    a = torch.randn(4, 2048, generator=g, device=cuda).bfloat16()
    launched = []

    def recording(*args, **kwargs):
        launched.append(kernel_griffin_spmm(*args, **kwargs))
        return launched[-1]

    def no_gather(*args, **kwargs):
        raise AssertionError("index_select on the card path")

    kernel_griffin_spmm = kernel.griffin_spmm
    monkeypatch.setattr(kernel, "griffin_spmm", recording)
    monkeypatch.setattr(torch.Tensor, "index_select", no_gather)
    before = launch_counts()["griffin_spmm"]
    out = griffin_matmul(a, gw)
    torch.cuda.synchronize()
    assert launch_counts()["griffin_spmm"] == before + 1
    assert len(launched) == 1 and out is launched[0]
    assert out.shape == (4, 1000) and out.is_contiguous()
    ref = (a.float() @ decompact_weights(gw).float()).bfloat16()
    assert_close(out, ref, "bfloat16")


def _zero_blocks(a, bm, bk, every):
    """Zero the (bm x bk) blocks (i, j) of ``a`` with (i + j) % every == 0,
    so M tiles see different live K blocks."""
    for i in range(-(-a.shape[0] // bm)):
        for j in range(-(-a.shape[1] // bk)):
            if (i + j) % every == 0:
                a[i * bm:(i + 1) * bm, j * bk:(j + 1) * bk] = 0
    return a


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["embed.T", "row-major"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(4, 2048, 1000, 128, 128),
                                  (32, 2048, 512, 8, 128),
                                  (33, 70, 17, 16, 16),
                                  (19, 256, 300, 8, 32)])
def test_sparse_a_kernel_matches_plain(cuda, dtype, layout, case):
    m, k, n, bm, bk = case
    g = torch.Generator(device=cuda).manual_seed(4)
    a = torch.randn(m, k, generator=g, device=cuda).to(DTYPES[dtype])
    a = _zero_blocks(a, bm, bk, 3)
    if m > bm:
        a[:bm] = 0                                   # a tile with cnt = 0
    w = torch.randn(n, k, generator=g, device=cuda).to(a.dtype)
    w = w.T if layout == "embed.T" else w.T.contiguous()
    meta = compact_activations(a, block_m=bm, block_k=bk)
    before = launch_counts()["sparse_a"]
    out = sparse_a_matmul(a, w, block_m=bm, block_k=bk)
    torch.cuda.synchronize()
    assert launch_counts()["sparse_a"] == before + 1
    ref = sparse_a_ref(a, w, meta.kidx, meta.cnt, block_m=meta.block_m,
                       block_k=meta.block_k)
    assert_close(out, ref, dtype)
    assert_close(out, (a.float() @ w.float()).to(a.dtype), dtype)
    # hand-cut metadata that drops a live block: the kernel must honour it
    cut_cnt = meta.cnt.clone()
    live_tile = int(torch.nonzero(cut_cnt).flatten()[-1])
    cut_cnt[live_tile] -= 1
    cut = ActivationMeta(meta.kidx, cut_cnt, meta.m, meta.k, meta.block_m,
                         meta.block_k)
    full = out
    out = sparse_a_matmul(a, w, meta=cut)
    ref = sparse_a_ref(a, w, cut.kidx, cut.cnt, block_m=cut.block_m,
                       block_k=cut.block_k)
    torch.cuda.synchronize()
    assert_close(out, ref, dtype)
    assert not torch.equal(out, full)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(7, 300, 8, 16), (32, 2048, 8, 128),
                                   (4, 8192, 128, 128)])
def test_compact_activations_on_card_equals_cpu(cuda, shape):
    """The metadata kernel: one launch, bit-equal to the plain metadata on
    the card and on the CPU, fp32 and bf16, -0 counted as zero."""
    m, k, bm, bk = shape
    g = torch.Generator(device=cuda).manual_seed(5)
    for dtype in (torch.float32, torch.bfloat16):
        a = _zero_blocks(torch.randn(m, k, generator=g, device=cuda), bm,
                         bk, 2).to(dtype)
        a[:, :bk] = -0.0                  # a block of negative zeros: dead
        before = launch_counts()
        meta = compact_activations(a, block_m=bm, block_k=bk)
        torch.cuda.synchronize()
        after = launch_counts()
        assert after["sparse_a_meta"] == before["sparse_a_meta"] + 1
        assert after["sparse_a"] == before["sparse_a"]
        want = compact_activations(a.cpu(), block_m=bm, block_k=bk)
        assert torch.equal(meta.kidx.cpu(), want.kidx)
        assert torch.equal(meta.cnt.cpu(), want.cnt)
        kidx, cnt = compact_activations_ref(a, block_m=meta.block_m,
                                            block_k=meta.block_k)
        assert torch.equal(meta.kidx, kidx) and torch.equal(meta.cnt, cnt)
        assert int(meta.cnt.max()) < meta.k // meta.block_k


def _meta_input(g, cuda, m, k, bk, dtype, lda, offset):
    """A (m, k) view of ``dtype`` with row stride ``lda``, ``offset``
    elements into its storage (unaligned for offset 1): some (tile, K
    block) pairs zero, a block of -0, a block live only through one NaN."""
    store = torch.randn(offset + m * lda, generator=g, device=cuda).to(dtype)
    a = store[offset:].view(m, lda)[:, :k]
    _zero_blocks(a, 128, bk, 3)
    kt = -(-k // bk)
    a[:, bk:2 * bk] = -0.0
    if kt > 2:
        a[:, 2 * bk:3 * bk] = 0
        a[-1, 2 * bk + 1] = float("nan")
    return a


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("k", [2048, 4096, 4100, 8192, 14336])
@pytest.mark.parametrize("m", [1, 4, 32, 128, 129, 512])
def test_sparse_a_meta_v2_bit_equal_to_plain(cuda, m, k, bk, dtype):
    """The cluster metadata kernel (``meta_slices`` blocks a tile) on a
    contiguous A, on rows wider than K (lda > K) and on an A one element
    off 16-byte alignment (the scalar path): bit-equal to the plain
    metadata, -0 dead, NaN live, one launch each."""
    g = torch.Generator(device=cuda).manual_seed(m + k + bk)
    dt = DTYPES[dtype]
    for lda, offset in ((k, 0), (k + 64, 0), (k, 1)):
        a = _meta_input(g, cuda, m, k, bk, dt, lda, offset)
        if lda != k or offset:
            # the wrapper takes only a contiguous A: launch on the view
            bm = min(128, -(-m // 8) * 8)
            mt, kt = -(-m // bm), -(-k // bk)
            before = launch_counts()["sparse_a_meta"]
            kidx, cnt = k3.sparse_a_meta(a, block_m=bm, block_k=bk,
                                         m_tiles=mt, k_tiles=kt)
        else:
            before = launch_counts()["sparse_a_meta"]
            meta = compact_activations(a, block_k=bk)
            kidx, cnt, bm = meta.kidx, meta.cnt, meta.block_m
        torch.cuda.synchronize()
        assert launch_counts()["sparse_a_meta"] == before + 1
        want = compact_activations_ref(a, block_m=bm, block_k=bk)
        assert torch.equal(kidx, want[0]) and torch.equal(cnt, want[1]), \
            (lda, offset)


@pytest.mark.gpu
@pytest.mark.parametrize("slices", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("shape", [(128, 8192), (32, 4096), (300, 14336)])
def test_sparse_a_meta_every_split_gives_the_same_bits(cuda, shape, slices):
    """Any power-of-two split up to the non-portable 16 gives the plain
    metadata: the flags are a pure function of A."""
    m, k = shape
    g = torch.Generator(device=cuda).manual_seed(slices)
    a = _meta_input(g, cuda, m, k, 128, torch.bfloat16, k, 0)
    kidx, cnt = k3.sparse_a_meta(a, block_m=128, block_k=128,
                                 m_tiles=-(-m // 128), k_tiles=k // 128,
                                 slices=slices)
    want = compact_activations_ref(a, block_m=128, block_k=128)
    torch.cuda.synchronize()
    assert torch.equal(kidx, want[0]) and torch.equal(cnt, want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["llama-mode-a", "xlstm-mode-ab"])
def test_shared_metadata_serve_paths_match_oracle_on_card(cuda, family):
    """With the metadata built once per distinct input (llama: 4 L + 1 a
    model call in Mode.A; xlstm: one per mLSTM block in Mode.AB), every
    request equals the batch-1 oracle's tokens."""
    arch = "llama3.2-1b" if family.startswith("llama") else "xlstm-1.3b"
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    api = build_model(cfg, device=cuda)
    params = api.init(api.generator(0))
    if arch == "xlstm-1.3b":
        params = sparsify_params(params, 0.6, block_k=16, block_n=16, unit=8)
        per_call = cfg.num_layers * sum(b == "m" for b in cfg.xlstm_pattern) \
            // len(cfg.xlstm_pattern)
    else:
        per_call = 4 * cfg.num_layers + 1
    eng = ServeEngine(api, params, EngineConfig().with_fields(
        num_slots=4, cache_len=40, decode_chunk=8, use_kernels=True,
        a_sparsity=0.5, measure_every=64))
    reqs = synthetic_trace(cfg, num_requests=6, seed=1,
                           prompt_lens=(8, 16, 23), gen_lens=(4, 8, 16))
    before = launch_counts()["sparse_a_meta"]
    outs = eng.run(reqs)
    calls = eng.stats["prefill_calls"] + eng.stats["decode_steps"]
    assert launch_counts()["sparse_a_meta"] - before == calls * per_call
    for r in reqs:
        with eng._scope():
            ref = greedy_generate(api, params, r.as_batch(cuda),
                                  steps=r.max_new_tokens, cache_len=40,
                                  prompt_bucket=eng.bucket_for(r.prompt_len))
        assert outs[r.rid].tokens == ref[0].tolist(), r.rid


@pytest.mark.gpu
def test_kernels_are_batch_invariant(cuda):
    """A row's output bits do not depend on the other rows (engine vs
    oracle token parity rests on it).  griffin_spmm at the serving shapes
    with a narrow N (its cluster split) and a deep K, M up to 32, dual and
    not.  For sparse_a the other rows have live blocks row 0 lacks, so the
    4-row tile visits blocks the 1-row call skips."""
    g = torch.Generator(device=cuda).manual_seed(2)
    a = torch.randn(32, 2048, generator=g, device=cuda).bfloat16()
    embed = torch.randn(5000, 2048, generator=g, device=cuda).bfloat16()
    w = torch.randn(2048, 2048, generator=g, device=cuda).bfloat16()
    slices = (slice(0, 1), slice(0, 4), slice(3, 7), slice(8, 16),
              slice(16, 32))
    full = dense_matmul(a, embed.T)
    for rows in slices:
        assert torch.equal(dense_matmul(a[rows].contiguous(), embed.T),
                           full[rows])
    for k, n in ((2048, 2048), (2048, 512), (8192, 2048)):
        gw = preprocess_weights(block_prune(
            torch.randn(k, n, generator=g, device=cuda), 0.8).bfloat16())
        x = torch.randn(32, k, generator=g, device=cuda).bfloat16()
        x[:16, :256] = 0                  # a dead chunk in the first rows
        for dual in (False, True):
            full = griffin_matmul(x, gw, dual=dual)
            for rows in slices:
                one = griffin_matmul(x[rows].contiguous(), gw, dual=dual)
                assert torch.equal(one, full[rows]), (k, n, dual, rows)
    a4 = a[:4].clone()
    a4[0, 128:1024] = 0                   # K blocks 1..7 dead in row 0 only
    a4[1:, 1536:] = 0                     # and blocks 12..15 dead elsewhere
    for b in (embed.T, w):
        full = sparse_a_matmul(a4, b, block_m=8)
        one = sparse_a_matmul(a4[:1].contiguous(), b, block_m=8)
        assert torch.equal(one, full[:1])
    assert int(compact_activations(a4[:1], block_m=8).cnt[0]) < \
        int(compact_activations(a4, block_m=8).cnt[0])
    # sparse_a's tensor-core rows and k-major routes at the full-width
    # shapes: the rows have different live blocks, and row 3 is live only
    # in the last eighth of K, so with a split of 8 every rank but the last
    # has nothing live for it alone
    embed = torch.randn(128256, 2048, generator=g, device=cuda).bfloat16()
    for k, n in ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
                 (2048, 128256)):
        b = embed.T if n == 128256 else torch.randn(
            k, n, generator=g, device=cuda).bfloat16()
        x = torch.randn(32, k, generator=g, device=cuda).bfloat16()
        for r in range(32):
            x[r, (r % 4) * (k // 4):(r % 4 + 1) * (k // 4)] = 0
        x[3, :k - k // 8] = 0
        path, plan = k3.route(x, b, 128)
        assert path == (k3.KMAJOR if n == 128256 else k3.ROWS)
        for block_m in (8, 128):
            full = sparse_a_matmul(x, b, block_m=block_m)
            for rows in slices:
                one = sparse_a_matmul(x[rows].contiguous(), b,
                                      block_m=block_m)
                assert torch.equal(one, full[rows]), (k, n, block_m, rows)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["embed.T", "row-major"])
def test_sparse_a_fp32_takes_the_cuda_core_route(cuda, layout):
    """fp32 keeps the CUDA-core kernels (fmaf, no TF32): within 1e-5 of
    the fp32 product, which a tensor-core route in TF32 or bf16 would not
    meet; bf16 at the same shape takes a tensor-core route."""
    g = torch.Generator(device=cuda).manual_seed(8)
    a = torch.randn(4, 2048, generator=g, device=cuda)
    w = torch.randn(512, 2048, generator=g, device=cuda).T
    if layout == "row-major":
        w = w.contiguous()
    assert k3.route(a, w, 128) == (k3.CORE, None)
    assert k3.route(a.bfloat16(), w.bfloat16(), 128)[0] != k3.CORE
    out = sparse_a_matmul(a, w)
    torch.cuda.synchronize()
    assert_close(out, a @ w, "float32")


@pytest.mark.gpu
def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    a = torch.zeros(4, 64, device=cuda, dtype=torch.float64)
    b = torch.zeros(64, 8, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        dense_matmul(a, b)
    with pytest.raises(TypeError):
        sparse_a_matmul(a, b)
    with pytest.raises(ValueError):        # operands on two devices
        sparse_a_matmul(a.float(), b.float().cpu())


@pytest.mark.gpu
def test_sparse_a_unembedding_reads_embed_t_in_place(cuda):
    """No allocation the size of ``embed.T``: the kernel reads the view."""
    embed = torch.randn(128256, 2048, device=cuda).bfloat16()
    a = torch.randn(4, 2048, device=cuda).bfloat16()
    sparse_a_matmul(a, embed.T)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = sparse_a_matmul(a, embed.T)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < \
        embed.numel() * embed.element_size() // 100
    assert out.shape == (4, 128256)


@pytest.mark.gpu
def test_prefill_and_decode_chunk_never_sync(cuda):
    """The hot path makes no hidden host sync: CUDA's sync debug mode
    raises on any synchronising call."""
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              dtype="bfloat16")
    api = build_model(cfg, device=cuda)
    params = sparsify_params(api.init(api.generator(0)), 0.6, block_k=16,
                             block_n=16, unit=8)
    eng = ServeEngine(api, params, EngineConfig().with_fields(
        num_slots=4, cache_len=32, decode_chunk=4, use_kernels=True))
    req = synthetic_trace(cfg, num_requests=1, seed=3,
                          prompt_lens=(11,), gen_lens=(4,))[0]
    batch = req.as_batch(cuda, eng.bucket_for(req.prompt_len))
    prefill_fn, _, chunk_for = eng._fns()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with eng._scope():
            prefill_fn(params, batch)
            chunk_for(4)(params, eng.cache, eng._tokens, eng._remaining)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_mode_a_prefill_and_chunk_never_sync(cuda):
    """Sparse.A builds its metadata on the card every GEMM: no argsort or
    count may read a value back to the host."""
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              dtype="bfloat16")
    api = build_model(cfg, device=cuda)
    params = api.init(api.generator(0))
    eng = ServeEngine(api, params, EngineConfig().with_fields(
        num_slots=4, cache_len=32, decode_chunk=4, use_kernels=True,
        a_sparsity=0.5))
    req = synthetic_trace(cfg, num_requests=1, seed=3,
                          prompt_lens=(11,), gen_lens=(4,))[0]
    batch = req.as_batch(cuda, eng.bucket_for(req.prompt_len))
    prefill_fn, _, chunk_for = eng._fns()
    before = launch_counts()["sparse_a"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with eng._scope():
            prefill_fn(params, batch)
            chunk_for(4)(params, eng.cache, eng._tokens, eng._remaining)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # 7 GEMMs x 2 layers + the unembedding, per prefill and decode step
    assert launch_counts()["sparse_a"] - before == 15 * 5


@pytest.mark.gpu
@pytest.mark.parametrize("sparsity", [0.0, 0.6], ids=["mode-a", "mode-ab"])
def test_activation_sparse_engine_matches_oracle_on_card(cuda, sparsity):
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              dtype="bfloat16")
    api = build_model(cfg, device=cuda)
    params = api.init(api.generator(0))
    if sparsity:
        params = sparsify_params(params, sparsity, block_k=16, block_n=16,
                                 unit=8)
    eng = ServeEngine(api, params, EngineConfig().with_fields(
        num_slots=4, cache_len=40, decode_chunk=8, use_kernels=True,
        a_sparsity=0.5))
    reqs = synthetic_trace(cfg, num_requests=6, seed=1,
                           prompt_lens=(8, 16, 23), gen_lens=(4, 8, 16))
    outs = eng.run(reqs)
    assert eng.mode.value == ("AB" if sparsity else "A")
    for r in reqs:
        with eng._scope():
            ref = greedy_generate(api, params, r.as_batch(cuda),
                                  steps=r.max_new_tokens, cache_len=40,
                                  prompt_bucket=eng.bucket_for(r.prompt_len))
        assert outs[r.rid].tokens == ref[0].tolist(), r.rid


@pytest.mark.gpu
def test_engine_matches_oracle_bf16_on_card(cuda):
    cfg = get_config("llama3.2-1b").reduced()
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    api = build_model(cfg, device=cuda)
    params = sparsify_params(api.init(api.generator(0)), 0.6, block_k=16,
                             block_n=16, unit=8)
    eng = ServeEngine(api, params, EngineConfig().with_fields(
        num_slots=4, cache_len=40, decode_chunk=8, use_kernels=True))
    reqs = synthetic_trace(cfg, num_requests=8, seed=1,
                           prompt_lens=(8, 16, 23), gen_lens=(4, 8, 16))
    outs = eng.run(reqs)
    assert eng.stats["host_syncs"] / eng.stats["emitted"] <= 0.25
    for r in reqs:
        with eng._scope():
            ref = greedy_generate(api, params, r.as_batch(cuda),
                                  steps=r.max_new_tokens, cache_len=40,
                                  prompt_bucket=eng.bucket_for(r.prompt_len))
        assert outs[r.rid].tokens == ref[0].tolist(), r.rid


@pytest.mark.gpu
def test_long_prefill_at_full_width_stays_under_3_gib(cuda):
    """A 4096-token prompt through full-width llama3.2-1b (compacted 0.8,
    kernels on): prefill attention walks 512-key chunks in 64-row query
    tiles, so the memory rise over the level before the call stays within
    3 GiB (the S x S product of one layer alone would need ~137 GB)."""
    api = build_model(get_config("llama3.2-1b"), device=cuda)
    params = sparsify_params(api.init(api.generator(0)), 0.8, compact=True)
    toks = torch.randint(1, api.cfg.vocab_size, (1, 4096), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = launch_counts()
    with sparse_execution(use_kernels=True):
        cache, logits = api.prefill(params, {"tokens": toks}, cache_len=4096)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= 3 << 30
    after = launch_counts()
    assert after["griffin_spmm"] - before["griffin_spmm"] == 112
    assert after["dense_gemm"] - before["dense_gemm"] == 1
    assert logits.shape == (1, 128256) and bool(torch.isfinite(logits).all())
    assert cache["k"].shape == (16, 1, 4096, 8, 64)


def _paged_pair(cuda, **kw):
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              dtype="bfloat16")
    api = build_model(cfg, device=cuda)
    params = sparsify_params(api.init(api.generator(0)), 0.6, block_k=16,
                             block_n=16, unit=8)
    conf = EngineConfig().with_fields(num_slots=2, cache_len=32,
                                      use_kernels=True, **kw)
    return api, params, conf


@pytest.mark.gpu
@pytest.mark.parametrize("decode_chunk", [1, 3])
def test_paged_tokens_bit_equal_fixed_on_card(cuda, decode_chunk):
    """At the same page-multiple cache_len the gathered paged view has the
    fixed arena's shape, so tokens are equal; 8 requests on 2 slots reuse
    slots and pages."""
    api, params, conf = _paged_pair(cuda, decode_chunk=decode_chunk)
    reqs = lambda: synthetic_trace(api.cfg, num_requests=8, seed=11,  # noqa
                                   prompt_lens=(6, 10, 17),
                                   gen_lens=(2, 4, 7), arrival_every=1)
    fixed = ServeEngine(api, params, conf).run(reqs())
    eng = ServeEngine(api, params, conf.with_fields(page_size=4))
    assert eng._paged is not None and eng.cache_len == 32
    paged = eng.run(reqs())
    for r in reqs():
        assert paged[r.rid].tokens == fixed[r.rid].tokens, r.rid


@pytest.mark.gpu
def test_paged_admission_prefill_and_chunk_never_sync(cuda):
    """A paged admission (page-table row from pinned host memory, pages
    scattered on the card), a prefill and a fused chunk on the paged cache
    run under CUDA's sync debug mode, which raises on any synchronising
    call."""
    api, params, conf = _paged_pair(cuda, decode_chunk=4, page_size=4)
    eng = ServeEngine(api, params, conf)
    req = synthetic_trace(api.cfg, num_requests=1, seed=3,
                          prompt_lens=(11,), gen_lens=(4,))[0]
    batch = req.as_batch(cuda, eng.bucket_for(req.prompt_len))
    ids = eng._page_alloc.reserve(4)
    prefill_fn, _, chunk_for = eng._fns()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with eng._scope():
            cache1, logits = prefill_fn(params, batch)
            eng._insert(1, cache1, logits, 3, ids)
            chunk_for(4)(params, eng.cache, eng._tokens, eng._remaining)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert eng.cache["pages"][1].tolist() == ids + [0] * 4
    assert eng._remaining.tolist() == [0, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2048, 2048), (2048, 512), (2048, 8192),
                                   (8192, 2048)])
@pytest.mark.parametrize("unit", ["8", "block"])
@pytest.mark.parametrize("block", [16, 32, 64, 128, 512])
def test_griffin_spmm_at_candidate_granularities(cuda, block, unit, shape):
    """griffin_spmm on the four layer shapes of llama3.2-1b, pruned 0.8 at
    the serving path's 128 / unit 32 and compacted at each block size of
    the autotune candidate grid (unit 8, or the block: a whole 512-wide
    N tile of wk/wv is then left unbalanced, as in the reference), M 4
    and 32, bf16, against its plain version, and bit-equal to the default
    128 x 128 / unit 32 compaction's output, dual and not (A has two
    all-zero 128-row K blocks); fp32 (the CUDA-core route) at M 4 too."""
    k, n = shape
    g = torch.Generator(device=cuda).manual_seed(2)
    w = block_prune(torch.randn(k, n, generator=g, device=cuda), 0.8)
    bk, bn = min(block, k), min(block, n)
    for dt, rows in ((torch.bfloat16, (4, 32)), (torch.float32, (4,))):
        gw = preprocess_weights(w.to(dt), block_k=bk, block_n=bn,
                                unit=8 if unit == "8" else bn)
        default = preprocess_weights(w.to(dt))
        for m in rows:
            a = torch.randn(m, k, generator=g, device=cuda).to(dt)
            a[:, 256:512] = 0
            before = launch_counts()["griffin_spmm"]
            out = griffin_matmul(a, gw)
            torch.cuda.synchronize()
            assert launch_counts()["griffin_spmm"] == before + 1
            ref = (a.float() @ decompact_weights(gw)[:k].float()).to(dt)
            assert_close(out, ref, str(dt).split(".")[1])
            want = griffin_matmul(a, default)
            assert torch.equal(out, want)
            assert torch.equal(griffin_matmul(a, gw, dual=True), want)


def _witness_logits(api, params, cuda):
    """(9, 8, vocab) logits: a prefill of 8 prompts of 12 seeded ids, then
    8 decode steps fed seeded ids, every GEMM through the kernels."""
    g = torch.Generator(device=cuda).manual_seed(5)
    ids = torch.randint(0, api.cfg.vocab_size, (8, 20), generator=g,
                        device=cuda)
    out = []
    with torch.no_grad(), sparse_execution(use_kernels=True):
        cache, logits = api.prefill(params, {"tokens": ids[:, :12]},
                                    cache_len=20)
        out.append(logits)
        for t in range(12, 20):
            logits, cache = api.decode_step(params, cache, ids[:, t:t + 1])
            out.append(logits)
    return torch.stack(out)


@pytest.mark.gpu
@pytest.mark.parametrize("block", [16, 512])
def test_full_width_plan_token_identity(cuda, block):
    """A fine (16 x 16) and a coarse (512 x 512) compaction plan serve
    full-width llama3.2-1b on the autotuner's trace with the default
    engine's tokens, every GEMM through griffin_spmm; and the model's
    logits under the plan are bit-equal to the default's on seeded,
    varied inputs (a prefill and 8 decode steps), a witness the random
    model's repetitive greedy tokens cannot give."""
    from repro_torch.sparsity import PRUNE_FULL
    from repro_torch.tuning.measure import tuning_workload
    from repro_torch.tuning.search import Candidate

    _, api, params, cache_len, trace = tuning_workload("dense",
                                                       device=cuda)
    conf = EngineConfig().with_fields(num_slots=4, cache_len=cache_len,
                                      decode_chunk=8, use_kernels=True)
    base = sparsify_params(params, 0.8, compact=True, **PRUNE_FULL)
    want = {r: o.tokens for r, o in
            ServeEngine(api, base, conf).run(trace()).items()}
    want_logits = _witness_logits(api, base, cuda)
    del base
    plan = Candidate(block_k=block, block_n=block, unit=8, fanin=8,
                     a_threshold=0.05).family_plan("dense")
    tuned = sparsify_params(params, 0.8, compact=True, plan=plan,
                            **PRUNE_FULL)
    assert tuned["layers"]["w_up"].block_k == block
    before = launch_counts()
    eng = ServeEngine(api, tuned, conf, plan=plan)
    got = {r: o.tokens for r, o in eng.run(trace()).items()}
    after = launch_counts()
    calls = eng.stats["prefill_calls"] + eng.stats["decode_steps"]
    assert after["griffin_spmm"] - before["griffin_spmm"] == 112 * calls
    assert after["dense_gemm"] - before["dense_gemm"] == calls
    assert got == want
    assert torch.equal(_witness_logits(api, tuned, cuda), want_logits)


def _full_width_sparse_b(cuda):
    api = build_model(get_config("llama3.2-1b"), device=cuda)
    params = sparsify_params(api.init(api.generator(0)), 0.8, compact=True)
    reqs = lambda: synthetic_trace(api.cfg, num_requests=8, seed=1,  # noqa
                                   prompt_lens=(8, 16, 32),
                                   gen_lens=(4, 8, 16))
    return api, params, reqs


@pytest.mark.gpu
def test_int8_pages_at_full_width(cuda):
    """Full-width llama3.2-1b (compacted 0.8, kernels on) from int8 pages:
    a four-slot engine gives each request the tokens a one-slot engine
    gives it alone (row quantization reads only its own row), and the
    teacher-forced relative logit gap to same-dtype pages stays within the
    reference's 0.02."""
    api, params, reqs = _full_width_sparse_b(cuda)
    conf = EngineConfig().with_fields(cache_len=49, page_size=16,
                                      kv_dtype="int8", use_kernels=True,
                                      max_admissions_per_step=4)
    four = ServeEngine(api, params, conf).run(reqs())
    one = ServeEngine(api, params, conf.with_fields(num_slots=1)).run(reqs())
    for r in reqs():
        assert four[r.rid].tokens == one[r.rid].tokens, r.rid
    gap = int8_logit_gap(api, params, conf.with_fields(cache_len=128))
    assert 0 < gap <= 0.02


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_stepwise_at_full_width_equals_fused(cuda, policy):
    """The stepwise path (fused=False, one decode step per tick) serves
    full-width llama3.2-1b with the fused path's tokens."""
    api, params, reqs = _full_width_sparse_b(cuda)
    conf = EngineConfig().with_fields(cache_len=49, use_kernels=True,
                                      policy=policy)
    fused = ServeEngine(api, params, conf).run(reqs())
    eng = ServeEngine(api, params, conf.with_fields(fused=False,
                                                    decode_chunk=1))
    stepwise = eng.run(reqs())
    assert eng.stats["chunk_calls"] == 0
    for r in reqs():
        assert stepwise[r.rid].tokens == fused[r.rid].tokens, r.rid


def _router_setup(cuda, **fields):
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              dtype="bfloat16")
    api = build_model(cfg, device=cuda)
    params = sparsify_params(api.init(api.generator(0)), 0.6, block_k=16,
                             block_n=16, unit=8)
    conf = EngineConfig().with_fields(num_slots=2, cache_len=40,
                                      use_kernels=True, **fields)
    return api, params, conf


@pytest.mark.gpu
def test_two_replica_router_matches_oracle_on_card(cuda):
    """Two replicas of a reduced-depth bf16 model behind the bounded
    router with the degradation ladder, on a bursty SLO trace: every
    completed request token-identical to the batch-1 oracle, every engine
    in Mode B throughout."""
    api, params, conf = _router_setup(cuda, replicas=2, queue_bound=3,
                                      shed_policy="degrade", decode_chunk=4)
    router, engines = serve_cli.build_router(api, params, conf)
    reqs = synthetic_trace(api.cfg, num_requests=16, seed=11,
                           prompt_lens=(8, 16, 23), gen_lens=(4, 8, 16),
                           arrival_process="bursty", rate=1.0,
                           burst_rate=8.0, priorities=(0, 1),
                           deadline_slack=4.0, ttft_deadline=6)
    router.run(reqs)
    assert router.stats["completed"] > 0
    assert router.stats["completed"] + router.stats["shed"] == 16
    run = serve_cli.RouteRun(router, engines, reqs, params, 0.0, {}, None)
    assert serve_cli.check_route_parity(run) == router.stats["completed"]
    assert all(e.mode_history == [(0, e.mode)] and e.mode.value == "B"
               for e in engines)


@pytest.mark.gpu
@pytest.mark.parametrize("page_size", [None, 8], ids=["fixed", "paged"])
def test_cancel_running_request_never_syncs(cuda, page_size):
    """``ServeEngine.cancel`` of a running request on a CUDA engine is a
    device write with no host sync: it runs under sync debug mode
    "error", frees the slot and zeroes the slot's owed-token counter.  The
    next request is admitted into the freed slot (on a paged arena with
    the slot's page-table row rewritten) and equals the batch-1 oracle."""
    api, params, conf = _router_setup(cuda, decode_chunk=2,
                                      page_size=page_size)
    eng = ServeEngine(api, params, conf)
    req, nxt = synthetic_trace(api.cfg, num_requests=2, seed=3,
                               prompt_lens=(11,), gen_lens=(8,))
    eng.add(req)
    eng.step()
    (slot,) = [s for s, r in eng.sched.running.items() if r.rid == req.rid]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert eng.cancel(req.rid)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not eng.sched.has_work() and eng.load == 0
    assert eng._remaining.tolist() == [0, 0]
    assert eng.outputs[req.rid].finished < 0
    assert not eng.cancel(req.rid)
    eng.add(dataclasses.replace(nxt, arrival=eng.clock))
    eng.step()
    assert eng.sched.running[slot].rid == nxt.rid
    while eng.sched.has_work():
        eng.step()
    run = serve_cli.ServeRun(eng, [nxt], params, 0.0, {})
    assert serve_cli.check_parity(run) == 1


@pytest.mark.gpu
def test_router_replicas_share_the_weights(cuda):
    """Full-width llama3.2-1b (compacted 0.8): building two replicas
    raises the card's allocated memory by their arenas only, less than
    half of one copy of the weights."""
    api = build_model(get_config("llama3.2-1b"), device=cuda)
    params = sparsify_params(api.init(api.generator(0)), 0.8, compact=True)
    weights = sum(t.numel() * t.element_size()
                  for t in _tensors(params))
    conf = EngineConfig().with_fields(num_slots=4, cache_len=137,
                                      use_kernels=True, replicas=2)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    router, engines = serve_cli.build_router(api, params, conf)
    rise = torch.cuda.memory_allocated() - base
    assert len(engines) == 2 and all(e.params is params for e in engines)
    assert 0 < rise < weights / 2, (rise, weights)


@pytest.mark.gpu
@pytest.mark.parametrize("arena,phase", [
    ({}, "admission"), ({}, "prefill"), ({}, "decode"),
    ({"page_size": 8, "kv_dtype": "int8"}, "decode")],
    ids=["fixed-admission", "fixed-prefill", "fixed-decode",
         "int8-pages-decode"])
def test_fault_kill_recovers_token_exact_on_card(cuda, arena, phase):
    """A device kill at an engine step rolls back to the tick-start
    snapshot (copied off the card) and replays the tick: the finished
    trace gives the unfaulted engine's tokens and stats, and the launches
    count every model call made, the replayed ones too."""
    api, params, conf = _router_setup(cuda, decode_chunk=4, **arena)
    conf = conf.with_fields(num_slots=3)
    reqs = lambda: synthetic_trace(api.cfg, num_requests=6, seed=11,  # noqa
                                   prompt_lens=(6, 10, 17),
                                   gen_lens=(2, 4, 7), arrival_every=1)
    plain = ServeEngine(api, params, conf)
    want = plain.run(reqs())
    inj = FaultInjector(kill_devices=(0,), at_step=2, phase=phase)
    eng = ServeEngine(api, params, conf, fault_injector=inj)
    before = launch_counts()["griffin_spmm"]
    got = eng.run(reqs())
    assert inj.fired and eng.recoveries == 1
    assert eng.recovery_log == [{"step": inj.fired_at, "lost": [0],
                                 "mesh": "unsharded"}]
    assert eng.stats == plain.stats
    for r in reqs():
        assert got[r.rid].tokens == want[r.rid].tokens, r.rid
    calls = eng.stats["prefill_calls"] + eng.stats["decode_steps"]
    assert launch_counts()["griffin_spmm"] - before == \
        14 * (calls + eng.replayed_calls)
    assert (eng.replayed_calls > 0) == (phase != "admission")


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


# (d1, d2, d3, shuffle): the Figure 8 sweep's configs (SparTen's 128-deep
# window among them) and the reference test's
SCHEDULE_CONFIGS = [(0, 0, 0, False), (2, 1, 0, False), (4, 0, 2, True),
                    (2, 0, 0, True), (2, 1, 1, True), (8, 1, 1, False),
                    (127, 0, 0, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", SCHEDULE_CONFIGS, ids=str)
@pytest.mark.parametrize("shape", [(70, 84, 16, 1), (33, 19, 8, 3),
                                   (20, 40, 16, 2), (5, 400, 16, 1),
                                   (9, 1, 16, 2)],
                         ids=["fig8", "n24-bytes", "n32", "scratch", "T1"])
def test_batch_eval_kernel_matches_numpy_engine(cuda, cfg, shape):
    """Integer cycles equal to the numpy engine's: 16-, 24- and 32-byte
    chunks, a T too long for shared memory (global scratch) and T = 1;
    densities spread over the tiles, one tile all empty."""
    rng = np.random.default_rng(sum(shape) + cfg[0])
    dens = np.linspace(0.02, 0.9, shape[0])[:, None, None, None]
    mask = rng.random(shape) < dens
    mask[0] = False
    d1, d2, d3, sh = cfg
    before = launch_counts()["batch_eval"]
    got = schedule_batched(mask, d1, d2, d3, shuffle=sh,
                           backend="torch").cycles
    assert launch_counts()["batch_eval"] == before + 1
    np.testing.assert_array_equal(
        got, schedule(mask, d1, d2, d3, shuffle=sh).cycles)
    assert got.dtype == np.int64


@pytest.mark.gpu
def test_batch_eval_kernel_matches_plain_and_is_batch_invariant(cuda):
    """The kernel equals its plain version on the card, and a tile's count
    does not depend on the tiles launched beside it (one thread a tile)."""
    rng = np.random.default_rng(3)
    mask = rng.random((150, 60, 16, 2)) < 0.4
    dev = torch.from_numpy(mask).to(cuda)
    for d1, d2, d3, _ in SCHEDULE_CONFIGS:
        full = batch_eval_kernel.batch_eval(dev, d1, d2, d3)
        torch.testing.assert_close(full, schedule_cycles_ref(dev, d1, d2,
                                                             d3))
        for sl in (slice(0, 1), slice(0, 64), slice(61, 130)):
            part = batch_eval_kernel.batch_eval(dev[sl].contiguous(), d1,
                                                d2, d3)
            torch.testing.assert_close(part, full[sl])


@pytest.mark.gpu
def test_batch_eval_empty_streams_launch_nothing(cuda):
    before = launch_counts()["batch_eval"]
    for shape in [(0, 5, 16, 1), (4, 0, 16, 1)]:
        out = schedule_cycles(np.zeros(shape, dtype=bool), 2, 1, 0)
        np.testing.assert_array_equal(out, np.zeros(shape[0], np.int64))
    assert launch_counts()["batch_eval"] == before
    # all chunks empty: no placement, the window just travels
    out = schedule_cycles(np.zeros((3, 10, 16, 1), dtype=bool), 2, 1, 0)
    np.testing.assert_array_equal(out, [4, 4, 4])


@pytest.mark.gpu
@pytest.mark.parametrize("kg", [(16, 1), (16, 4)], ids=["16x1", "16x4"])
@pytest.mark.parametrize("route", ["scan", "chain"])
@pytest.mark.parametrize("d1", [0, 31, 127])
@pytest.mark.parametrize("T", [1, 31, 32, 33, 84, 200])
def test_batch_eval_v2_routes_match_engine_and_plain(cuda, T, d1, route, kg):
    """Both routes (scan: (d1, 0, 0); chain: (d1, 1, 1)) give the numpy
    engine's cycles and, where its loop is short enough to run here
    (T x window <= 3000 steps), the plain version's; 16- and 64-bit chunks,
    one tile empty, one with empty chunks, shuffle on."""
    cfg = (d1, 0, 0) if route == "scan" else (d1, 1, 1)
    assert batch_eval_kernel.route(*cfg) == route
    rng = np.random.default_rng(T + d1)
    mask = rng.random((40, T) + kg) < \
        np.linspace(0.02, 0.9, 40)[:, None, None, None]
    mask[0] = False
    mask[1, ::2] = False
    for sh in (False, True):
        got = schedule_cycles(mask, *cfg, shuffle=sh)
        np.testing.assert_array_equal(got,
                                      schedule(mask, *cfg, shuffle=sh).cycles)
    if T * min(d1 + 1, T) <= 3000:
        dev = torch.from_numpy(mask).to(cuda)
        torch.testing.assert_close(batch_eval_kernel.batch_eval(dev, *cfg),
                                   schedule_cycles_ref(dev, *cfg))


# ---------------------------------------------------------------------------
# the dense family's other configs: K2's route known in Python, and the
# configs served at full width (depth cut) on the card
# ---------------------------------------------------------------------------

# K x N of every K2 leaf of stablelm-1.6b, minitron-8b,
# command-r-plus-104b and chameleon-34b (as chip_smoke.K2_LEAVES), and
# mixtral-8x7b's w_down and head
ROUTE_SHAPES = {
    "stablelm wq/wk/wv/wo": (2048, 2048), "stablelm w_gate/w_up": (2048, 5632),
    "stablelm w_down": (5632, 2048), "stablelm head": (2048, 100352),
    "minitron wq/wo": (4096, 4096), "minitron wk/wv": (4096, 1024),
    "minitron w_gate/w_up": (4096, 16384), "minitron w_down": (16384, 4096),
    "minitron head": (4096, 256000), "command-r wq/wo": (12288, 12288),
    "command-r wk/wv": (12288, 1024), "command-r w_gate/w_up": (12288, 33792),
    "command-r w_down": (33792, 12288), "command-r head": (12288, 256000),
    "mixtral w_down": (14336, 4096), "mixtral head": (4096, 32000),
    "chameleon wq/wo": (8192, 8192), "chameleon wk/wv": (8192, 1024),
    "chameleon w_gate/w_up": (8192, 22016),
    "chameleon w_down": (22016, 8192), "chameleon head": (8192, 65536)}
K2_KERNELS = {"tc": "spmm_tc_kernel", "core": "spmm_core_kernel"}


def _k2_kernels_run(fn):
    """The names of the griffin_spmm kernels the profiler sees ``fn``
    launch on the card (a session that records no device kernel at all,
    which the profiler now and then gives, is tried again)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        if names:
            break
    return {name for name in names if "spmm_" in name}


@pytest.mark.gpu
@pytest.mark.parametrize("leaf", list(ROUTE_SHAPES))
def test_k2_route_mirror_names_the_kernel_the_card_runs(cuda, leaf):
    """At each K2 leaf shape of the three dense configs and chameleon-34b,
    and at mixtral's w_down and head (pruned 0.8 at 128 x 128 / unit 32,
    bf16), the route
    ``griffin_spmm.kernel.route`` predicts from the weight's grid depth is
    the kernel the profiler sees run and the route the C++ entry counts
    (``route_launches``), at M 4 and 32, dual and not; the
    output agrees with the plain version; an fp32 A takes the CUDA-core
    route, as the mirror says."""
    from repro_torch.kernels.griffin_spmm.kernel import route, route_launches
    k, n = ROUTE_SHAPES[leaf]
    g = torch.Generator(device=cuda).manual_seed(k + n)
    gw = preprocess_weights(block_prune(
        torch.randn(k, n, generator=g, device=cuda), 0.8).bfloat16())
    torch.cuda.empty_cache()
    kw = dict(n=n, block_k=gw.block_k, block_n=gw.block_n)
    for m in (4, 32):
        a = torch.randn(m, k, generator=g, device=cuda).bfloat16()
        want = route(a, gw.b_comp, gw.kidx, **kw)
        for dual in (False, True):
            before = route_launches()
            seen = _k2_kernels_run(lambda: griffin_matmul(a, gw, dual=dual))
            assert len(seen) == 1 and K2_KERNELS[want.name] in \
                next(iter(seen)), (want, gw.kidx.shape, seen)
            after = route_launches()
            assert after[want.name] > before[want.name] and \
                sum(after.values()) - sum(before.values()) == \
                after[want.name] - before[want.name]
        if m == 4:
            out = griffin_matmul(a, gw)
            ref = (a.float() @ decompact_weights(gw)[:k].float()).bfloat16()
            assert_close(out, ref, "bfloat16")
    a = torch.randn(4, k, generator=g, device=cuda)
    assert route(a, gw.b_comp, gw.kidx, **kw).name == "core"
    seen = _k2_kernels_run(lambda: griffin_matmul(a, gw))
    assert len(seen) == 1 and "spmm_core_kernel" in next(iter(seen))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "minitron-8b",
                                  "command-r-plus-104b", "chameleon-34b"])
def test_dense_config_at_full_width_matches_oracle_on_card(cuda, arch):
    """Each dense config and chameleon-34b (QK-norm, its weights in the
    vlm draw order) at full width, cut to 2 layers, pruned 0.8 and
    compacted: the engine (4 slots, chunks of 4) launches griffin_spmm 7 x
    2 + 1 = 15 times and dense_gemm never per model call, and every
    request equals the batch-1 greedy oracle; the prefill logits are
    within 2 % (relative L2) of the plain route on the same weights."""
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.griffin_spmm.ref import griffin_spmm_ref
    from repro_torch.models import common
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    api = build_model(cfg, device=cuda)
    params = sparsify_params(api.init(api.generator(0)), 0.8)
    eng = ServeEngine(api, params, EngineConfig().with_fields(
        num_slots=4, cache_len=40, decode_chunk=4, use_kernels=True))
    reqs = synthetic_trace(cfg, num_requests=6, seed=5, prompt_lens=(8, 16),
                           gen_lens=(4, 12))
    reset_launch_counts()
    outs = eng.run(reqs)
    calls = eng.stats["prefill_calls"] + eng.stats["decode_steps"]
    got = launch_counts()
    assert eng.mode.value == "B"
    assert (got["griffin_spmm"], got["dense_gemm"]) == (15 * calls, 0)
    for r in reqs:
        with eng._scope():
            want = greedy_generate(api, params, r.as_batch(eng.device),
                                   steps=r.max_new_tokens,
                                   cache_len=eng.cache_len,
                                   prompt_bucket=eng.bucket_for(
                                       r.prompt_len))
        assert outs[r.rid].tokens == want[0].tolist(), r.rid
    batch = reqs[0].as_batch(eng.device)
    with sparse_execution(use_kernels=True):
        _, logits = api.prefill(params, batch, cache_len=40)
    real = common.griffin_matmul
    common.griffin_matmul = lambda a, gw, dual=False: griffin_spmm_ref(a, gw)
    try:
        with sparse_execution(use_kernels=False):
            _, ref = api.prefill(params, batch, cache_len=40)
    finally:
        common.griffin_matmul = real
    rel = float((logits.float() - ref.float()).norm() / ref.float().norm())
    assert bool(torch.isfinite(logits).all()) and rel <= 2e-2, rel


def _assert_trees_equal(got, ref, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for key in ref:
            _assert_trees_equal(got[key], ref[key], f"{path}/{key}")
        return
    if hasattr(ref, "b_comp"):
        for f in ("b_comp", "kidx", "cnt", "inv_perm", "perm"):
            assert torch.equal(getattr(got, f), getattr(ref, f)), (path, f)
        return
    assert torch.equal(got, ref), path


@pytest.mark.gpu
def test_chameleon_streamed_build_on_card_equals_sparsify_of_init(cuda):
    """On the card, chameleon-34b at full width cut to 2 layers (which
    fits twice): the streamed build equals ``sparsify_params(init_params(
    ...))`` bit for bit, every leaf (``qn``/``kn`` included), and leaves
    the generator where ``init`` leaves it."""
    cfg = dataclasses.replace(get_config("chameleon-34b"), num_layers=2)
    api = build_model(cfg, device=cuda)
    g1, g2 = api.generator(0), api.generator(0)
    got = init_sparse_params(api, g1, 0.8)
    _assert_trees_equal(got, sparsify_params(api.init(g2), 0.8))
    assert torch.equal(g1.get_state(), g2.get_state())
    assert got["layers"]["qn"].shape == (2, 128)


# every chameleon-34b GEMM leaf (K x N), B row-major, as Mode.A serves it
CHAMELEON_K3 = {"wq/wo": (8192, 8192), "wk/wv": (8192, 1024),
                "w_gate/w_up": (8192, 22016), "w_down": (22016, 8192),
                "head": (8192, 65536)}


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 32])
@pytest.mark.parametrize("leaf", list(CHAMELEON_K3))
def test_sparse_a_and_meta_at_chameleon_shapes(cuda, leaf, m):
    """sparse_a and its metadata kernel at each chameleon-34b leaf (bf16,
    B row-major), with two all-zero K blocks and with every block live:
    one metadata launch bit-equal to the plain metadata, one sparse_a
    launch within tolerance of its plain version and of the dense
    product."""
    k, n = CHAMELEON_K3[leaf]
    g = torch.Generator(device=cuda).manual_seed(k + n + m)
    w = (torch.randn(k, n, generator=g, device=cuda) / k ** 0.5).bfloat16()
    a = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    dead = a.clone()
    dead[:, 128:384] = 0
    for x in (a, dead):
        before = launch_counts()
        meta = compact_activations(x)
        out = sparse_a_matmul(x, w, meta=meta)
        torch.cuda.synchronize()
        after = launch_counts()
        assert (after["sparse_a_meta"] - before["sparse_a_meta"],
                after["sparse_a"] - before["sparse_a"]) == (1, 1)
        kidx, cnt = compact_activations_ref(x, block_m=meta.block_m,
                                            block_k=meta.block_k)
        assert torch.equal(meta.kidx, kidx) and torch.equal(meta.cnt, cnt)
        live = k // meta.block_k - (2 if x is dead else 0)
        assert int(meta.cnt.max()) == live
        ref = sparse_a_ref(x, w, meta.kidx, meta.cnt, block_m=meta.block_m,
                           block_k=meta.block_k)
        assert_close(out, ref, "bfloat16")
        assert_close(out, (x.float() @ w.float()).bfloat16(), "bfloat16")


# ---------------------------------------------------------------------------
# the ssm family: xlstm-1.3b's shapes and its full-width serving rows
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 32])
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("shape", [(2048, 2730), (2730, 2048)],
                         ids=["w_ff1", "w_ff2"])
def test_griffin_spmm_at_xlstm_ragged_shapes(cuda, shape, dual, m):
    """sLSTM's w_ff1 (N 2730, padded to 2816) and w_ff2 (K 2730: an A row
    2730 wide, not a multiple of 8, so the CUDA-core route, the padded K
    tail zero-filled), pruned 0.8 at 128 x 128 / unit 32: against the
    plain version, and rows 0:1 and 0:4 bit-equal alone and in the
    call."""
    k, n = shape
    g = torch.Generator(device=cuda).manual_seed(8)
    gw = preprocess_weights(block_prune(
        torch.randn(k, n, generator=g, device=cuda), 0.8).bfloat16())
    assert gw.k == 2816 if k == 2730 else gw.b_comp.shape[1] == 2816
    a = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    a[:, :256] = 0
    out = griffin_matmul(a, gw, dual=dual)
    torch.cuda.synchronize()
    assert out.shape == (m, n)
    ref = (a.float() @ decompact_weights(gw)[:k].float()).bfloat16()
    assert_close(out, ref, "bfloat16")
    for rows in (1, 4):
        assert torch.equal(griffin_matmul(a[:rows].contiguous(), gw,
                                          dual=dual), out[:rows])


@pytest.mark.gpu
@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("k", [4096, 4100])
@pytest.mark.parametrize("m", [1, 4, 32, 128])
@pytest.mark.parametrize("n", [1, 4, 8])
def test_dense_gemm_skinny_route_matches_plain(cuda, n, m, k, pair):
    """K1's skinny route (N <= 8, K split across a cluster by K alone):
    against the plain version in fp32, bf16 and fp32 A x bf16 weight, with
    a ragged last chunk at K 4100 (and A rows that are not 16-byte
    aligned there), and rows 0 and 0:4 bit-equal to 1- and 4-row calls."""
    da, dw = PAIRS[pair]
    assert dense_gemm_kernel.route(n) == "skinny"
    g = torch.Generator(device=cuda).manual_seed(n * 1000 + m + k)
    a = torch.randn(m, k, generator=g, device=cuda).to(da)
    w = torch.randn(k, n, generator=g, device=cuda).to(dw)
    before = launch_counts()["dense_gemm"]
    out = dense_matmul(a, w)
    torch.cuda.synchronize()
    assert launch_counts()["dense_gemm"] == before + 1
    assert out.dtype == da and out.shape == (m, n)
    assert_close(out, dense_matmul_ref(a, w),
                 "bfloat16" if da == torch.bfloat16 else "float32")
    for rows in (1, min(m, 4)):
        assert torch.equal(dense_matmul(a[:rows].contiguous(), w),
                           out[:rows]), rows


@pytest.mark.gpu
@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("k", [4096, 4100])
def test_dense_gemm_skinny_reads_any_layout_with_the_same_bits(cuda, k,
                                                               pair):
    """A k-major B (a transposed view, 16-byte vectors per column at K
    4096, scalar loads at 4100) and a strided B (every other column of a
    wider matrix) give the row-major call's bits: the summation order
    does not follow the layout."""
    da, dw = PAIRS[pair]
    g = torch.Generator(device=cuda).manual_seed(k)
    a = torch.randn(32, k, generator=g, device=cuda).to(da)
    w = torch.randn(k, 4, generator=g, device=cuda).to(dw)
    want = dense_matmul(a, w)
    kmajor = w.T.contiguous().T
    strided = torch.zeros(k, 8, device=cuda, dtype=dw)
    strided[:, ::2] = w
    assert kmajor.stride() == (1, k) and strided[:, ::2].stride() == (8, 2)
    for b in (kmajor, strided[:, ::2]):
        assert torch.equal(dense_matmul(a, b), want)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 32])
@pytest.mark.parametrize("leaf", ["w_down", "gate"])
def test_mixed_pair_at_xlstm_shapes(cuda, leaf, m):
    """fp32 A against a bf16 weight at w_down's shape (4096 x 2048, pruned
    0.8 at 128 x 128 / unit 32 and compacted) and the gates' (4096 x 4):
    griffin_spmm (dual too), sparse_a and dense_gemm against their plain
    versions within the fp32 tolerance, fp32 outputs, rows 0 and 0:4
    bit-equal to 1- and 4-row calls, dual bit-equal to the plain walk."""
    k, n = (4096, 2048) if leaf == "w_down" else (4096, 4)
    g = torch.Generator(device=cuda).manual_seed(m + n)
    w = torch.randn(k, n, generator=g, device=cuda)
    if leaf == "w_down":
        w = block_prune(w, 0.8)
    w = w.bfloat16()
    gw = preprocess_weights(w)
    a = torch.randn(m, k, generator=g, device=cuda)
    a[:, :256] = 0                       # two all-zero K blocks (dual)
    plain = a @ w.float()
    calls = {"griffin_spmm": lambda x: griffin_matmul(x, gw),
             "griffin_spmm dual": lambda x: griffin_matmul(x, gw, dual=True),
             "sparse_a": lambda x: sparse_a_matmul(x, w),
             "dense_gemm": lambda x: dense_matmul(x, w)}
    outs = {}
    for name, call in calls.items():
        out = outs[name] = call(a)
        torch.cuda.synchronize()
        assert out.dtype == torch.float32 and out.shape == (m, n), name
        assert_close(out, plain, "float32")
        for rows in (1, 4):
            assert torch.equal(call(a[:rows].contiguous()), out[:rows]), \
                (name, rows)
    assert torch.equal(outs["griffin_spmm"], outs["griffin_spmm dual"])


@pytest.mark.gpu
def test_other_mixed_pairs_raise_on_the_card(cuda):
    a = torch.zeros(4, 64, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(64, 8, device=cuda)
    gw = preprocess_weights(torch.randn(64, 64, device=cuda), block_k=16,
                            block_n=16, unit=8)
    for call in (lambda: dense_matmul(a, w), lambda: sparse_a_matmul(a, w),
                 lambda: griffin_matmul(a, gw),
                 lambda: dense_matmul(a.half(), w.half())):
        with pytest.raises(TypeError):
            call()


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 4, 32])
def test_dense_gemm_and_sparse_a_at_xlstm_gates(cuda, m):
    """The mLSTM's (4096 x 4) gate leaves: dense_gemm (its skinny route,
    K split across a cluster) and sparse_a (its masked N edge) with its
    metadata kernel, against their plain versions, row slices bit-equal
    to the full call."""
    g = torch.Generator(device=cuda).manual_seed(9)
    w = torch.randn(4096, 4, generator=g, device=cuda).bfloat16()
    a = torch.randn(m, 4096, generator=g, device=cuda).bfloat16()
    a[:, 1024:1280] = 0
    plain = (a.float() @ w.float()).bfloat16()
    k1 = dense_matmul(a, w)
    meta = compact_activations(a)
    kidx, cnt = compact_activations_ref(a, block_m=meta.block_m,
                                        block_k=meta.block_k)
    assert torch.equal(meta.kidx, kidx) and torch.equal(meta.cnt, cnt)
    k3 = sparse_a_matmul(a, w, meta=meta)
    torch.cuda.synchronize()
    assert_close(k1, plain, "bfloat16")
    assert_close(k3, sparse_a_ref(a, w, kidx, cnt, block_m=meta.block_m,
                                  block_k=meta.block_k), "bfloat16")
    for rows in (1, min(m, 4)):
        part = a[:rows].contiguous()
        assert torch.equal(dense_matmul(part, w), k1[:rows])
        assert torch.equal(sparse_a_matmul(part, w), k3[:rows])


def _free_card() -> None:
    """Return this process's cached card memory before ranks are spawned
    on the same card (the module-scoped models further down hold their
    own, so the mesh tests come before them)."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


@pytest.mark.gpu
def test_reduced_mesh_1x2_on_one_card_equals_unsharded(cuda):
    """Two ranks on one card over gloo (CUDA tensors), reduced llama3.2-1b
    compacted at 0.8: the unsharded engine's tokens and counters, every
    GEMM through a shard entry."""
    _free_card()
    conf = EngineConfig().with_fields(num_slots=4, cache_len=49,
                                      decode_chunk=8, use_kernels=True)
    kw = dict(arch="llama3.2-1b", reduced=True, sparsity=0.8, config=conf,
              requests=8)
    ref = serve_cli.serve(device="cuda", **kw)
    recs = serve_cli.serve_on_mesh("1x2", device="cuda", **kw)
    want = {r: o.tokens for r, o in ref.engine.outputs.items()}
    for rec in recs:
        assert rec["backend"] == "gloo" and rec["device"] == "cuda:0"
        assert rec["tokens"] == want and rec["stats"] == ref.engine.stats
        assert rec["dispatch"].get("shard", 0) > 0
        assert rec["dispatch"].get("spmd_oracle", 0) == 0
        calls = rec["prefills_here"] + rec["stats"]["decode_steps"]
        assert rec["launches"]["griffin_spmm"] == 14 * calls
        assert rec["launches"]["dense_gemm"] == calls


@pytest.mark.gpu
def test_serve_cli_mesh_1x2_full_width_parity(cuda, capsys):
    """Full-width llama3.2-1b on a 1x2 mesh of two ranks sharing the card,
    then the CLI's parity pass on the whole weights in this process."""
    _free_card()
    serve_cli.main(["--arch", "llama3.2-1b", "--sparsity", "0.8",
                    "--use-kernels", "--mesh", "1x2", "--parity"])
    out = capsys.readouterr().out
    assert "gloo on CUDA tensors" in out
    assert out.strip().splitlines()[-1].startswith("parity OK")


@pytest.mark.gpu
@pytest.mark.parametrize("arena", ["fixed", "paged"])
def test_remesh_hands_a_row_over_bit_for_bit(cuda, arena):
    """Two ranks on the card (gloo on CUDA tensors), reduced llama3.2-1b
    compacted at 0.8 on a 2x1 mesh: rank 1's device is lost at decode step
    3, so its host snapshot, the only copy of data row 1, goes to rank 0
    and arrives bit for bit (each leaf's bytes and CRC-32 as sent and as
    received), rank 1 launches nothing after the loss, and the 1x1
    survivor gives the unfaulted engine's tokens through the whole
    kernels."""
    _free_card()
    fields = dict(num_slots=4, cache_len=49, decode_chunk=8,
                  use_kernels=True)
    if arena == "paged":
        fields.update(page_size=16)
    conf = EngineConfig().with_fields(**fields)
    kw = dict(arch="llama3.2-1b", reduced=True, sparsity=0.8, requests=8)
    ref = serve_cli.serve(device="cuda", config=conf, **kw)
    kept, lost = serve_cli.serve_on_mesh(
        "2x1", device="cuda", config=conf.with_fields(
            inject="kill:1@3:decode"), **kw)
    assert (kept["status"], lost["status"]) == ("served", "lost")
    assert kept["tokens"] == {r: o.tokens
                              for r, o in ref.engine.outputs.items()}
    assert kept["recoveries"] == 1 and kept["final_mesh"] == "1x1"
    (got,) = kept["remesh"][0]["transfers"]
    (sent,) = lost["remesh"][0]["transfers"]
    assert (got["row"], got["src"], got["dst"]) == (1, 1, 0)
    assert got["crc32"] == sent["crc32"] and got["bytes"] == sent["bytes"]
    assert not any(lost["launches_after_loss"].values())
    calls = kept["calls_after"]
    assert kept["launches_after"]["griffin_spmm"] == 14 * calls
    assert kept["launches_after"]["dense_gemm"] == calls


@pytest.mark.gpu
def test_remesh_1x2_to_1x1_gives_the_unfaulted_tokens(cuda):
    """Reduced llama3.2-1b compacted at 0.8 on a 1x2 mesh of two ranks on
    the card: rank 1's device lost at decode step 3, rank 0 serves on
    alone (1x1, the whole weights cut from its host copy; the arena's
    heads put together from its own share and lost rank 1's host copy of
    the other) and finishes with the unfaulted tokens; rank 1 launches
    nothing after the loss."""
    _free_card()
    conf = EngineConfig().with_fields(num_slots=4, cache_len=49,
                                      decode_chunk=8, use_kernels=True)
    kw = dict(arch="llama3.2-1b", reduced=True, sparsity=0.8, requests=8)
    ref = serve_cli.serve(device="cuda", config=conf, **kw)
    kept, lost = serve_cli.serve_on_mesh(
        "1x2", device="cuda", config=conf.with_fields(
            inject="kill:1@3:decode"), **kw)
    assert (kept["status"], lost["status"]) == ("served", "lost")
    assert kept["tokens"] == {r: o.tokens
                              for r, o in ref.engine.outputs.items()}
    assert kept["recovery_log"][-1]["mesh"] == "1x1"
    (got,) = kept["remesh"][0]["transfers"]     # rank 0 held share 0
    (sent,) = lost["remesh"][0]["transfers"]
    assert (got["row"], got["share"], got["src"], got["dst"]) == (0, 1, 1, 0)
    assert got["crc32"] == sent["crc32"] and got["bytes"] == sent["bytes"]
    assert not any(lost["launches_after_loss"].values())
    assert kept["dispatch_after"].get("kernel", 0) == 15 * kept["calls_after"]


@pytest.mark.gpu
@pytest.mark.parametrize("arena", ["fixed", "paged", "paged_int8"])
@pytest.mark.parametrize("cache_len", [49, 4096])
@pytest.mark.parametrize("shards", [2, 4])
def test_head_share_decode_layer_bit_equal_on_card(cuda, shards, cache_len,
                                                   arena):
    """One full-width llama3.2-1b decode layer (32 query heads on 8 KV
    heads of 64, bf16, dense weights through K1) on CUDA tensors, four
    rows at different positions of a ``cache_len`` arena: on each of
    ``shards`` model ranks' share of the KV heads the layer writes the
    token's K and V into its share (int8 pages: the row's scale over all 8
    heads, its heads' values), attends with its 32 / ``shards`` query
    heads and gathers the attention output over the ranks before ``wo``.
    Every rank's layer output equals the whole layer's bit for bit, and
    its share of the cache, pools and scales included, equals the whole
    write's heads."""
    from functools import partial

    from repro_torch.models import transformer as tr
    from repro_torch.models.common import head_share, paged_slot
    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=1)
    api = build_model(cfg, device="cuda")
    lp = tr._layer(api.init(api.generator(0)), 0)
    gen = torch.Generator(device=cuda).manual_seed(7)
    B, KVH, hd = 4, cfg.num_kv_heads, cfg.hd
    x = torch.randn(B, 1, cfg.d_model, generator=gen,
                    device=cuda).bfloat16()
    pos = torch.tensor([0, 17, cache_len // 2, cache_len - 1],
                       dtype=torch.int32, device=cuda)
    if arena == "fixed":
        cache = {k: torch.randn(B, cache_len, KVH, hd, generator=gen,
                                device=cuda).bfloat16() for k in ("k", "v")}
    else:
        page = 7 if cache_len == 49 else 16
        maxp = cache_len // page
        pages = (torch.randperm(B * maxp, generator=gen, device=cuda)
                 + 1).reshape(B, maxp)
        shape = (B * maxp + 1, page, KVH, hd)
        if arena == "paged_int8":
            cache = {k: torch.randint(-127, 128, shape, generator=gen,
                                      device=cuda).to(torch.int8)
                     for k in ("k", "v")}
            cache.update({f"{k}_scale": torch.rand(
                shape[:2], generator=gen, device=cuda) for k in ("k", "v")})
        else:
            cache = {k: torch.randn(shape, generator=gen,
                                    device=cuda).bfloat16()
                     for k in ("k", "v")}
        slot = paged_slot(pages, pos, page)

    def block(c, heads):
        if arena == "fixed":
            kv = partial(tr._fixed_kv, pos, heads, c["k"], c["v"])
        else:
            kv = partial(tr._paged_kv, pages, slot, x.dtype, heads, c["k"],
                         c["v"], c.get("k_scale"), c.get("v_scale"))
        return tr.block_decode(cfg, lp, x, pos, kv, pos, None, heads)

    ref = {k: v.clone() for k, v in cache.items()}
    with sparse_execution(use_kernels=True):
        want = block(ref, None)
    n = KVH // shards
    rec: dict = {}
    for replay in (False, True):
        for m in range(shards):
            mine = {k: (v.narrow(2, m * n, n).clone() if k in ("k", "v")
                        else v.clone()) for k, v in cache.items()}
            with sparse_execution(use_kernels=True, spmd_mesh=TwoPass(
                    m, shards, rec, replay)):
                got = block(mine, head_share(n, KVH))
            if replay:
                assert torch.equal(got, want), m
                for k, v in mine.items():
                    full = ref[k] if k.endswith("_scale") else \
                        ref[k].narrow(2, m * n, n)
                    assert torch.equal(v, full), (m, k)


@pytest.fixture(scope="module")
def xlstm_full():
    """Full-width xlstm-1.3b on the card, seed 0, pruned 0.8 and compacted
    at 128 x 128 / unit 32 (what launch.serve serves)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    api = build_model(get_config("xlstm-1.3b"), device="cuda")
    params = sparsify_params(api.init(api.generator(0)), 0.8, compact=True)
    return api, params


def _scope(mode):
    return sparse_execution(use_kernels=True,
                            a_sparsity=0.5 if mode == "AB" else 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["B", "AB"])
def test_xlstm_rows_bit_equal_to_batch_one_at_full_width(xlstm_full, mode):
    """Batch invariance at full width: four prompts prefilled alone (the
    engine's admissions), their states stacked into one 4-row batch, then
    4 decode steps batched and each row alone (the batch-1 oracle): every
    row's logits bit-equal, in Sparse.B and in Mode.AB."""
    api, params = xlstm_full
    g = torch.Generator(device="cuda").manual_seed(3)
    ids = torch.randint(1, api.cfg.vocab_size, (4, 16), generator=g,
                        device="cuda")
    with _scope(mode):
        solo = [api.prefill(params, {"tokens": ids[i:i + 1]})[0]
                for i in range(4)]
        batch = {k: (torch.cat([c[k] for c in solo], dim=2) if k != "pos"
                     else torch.stack([c[k] for c in solo]))
                 for k in solo[0]}
        feed = ids[:, -1:]
        for _ in range(4):
            logits, batch = api.decode_step(params, batch, feed)
            for i in range(4):
                one, solo[i] = api.decode_step(params, solo[i],
                                               feed[i:i + 1])
                assert torch.equal(one[0], logits[i]), i
            feed = torch.argmax(logits, dim=-1)[:, None]
    assert bool(torch.isfinite(logits).all())


@pytest.mark.gpu
def test_xlstm_padded_prefill_bit_equal_at_full_width(xlstm_full):
    """A 13-token prompt prefilled in its 16-token bucket carries exactly
    the exact-length prefill's state and last-token logits."""
    api, params = xlstm_full
    g = torch.Generator(device="cuda").manual_seed(4)
    ids = torch.randint(1, api.cfg.vocab_size, (1, 13), generator=g,
                        device="cuda")
    with _scope("B"):
        exact, want = api.prefill(params, {"tokens": ids})
        cache, got = api.prefill(params, {
            "tokens": torch.nn.functional.pad(ids, (0, 3)),
            "lengths": torch.tensor([13], dtype=torch.int32,
                                    device="cuda")})
    assert torch.equal(got, want)
    for key in ("mC", "mn", "mm", "sc", "sn", "sh", "sm"):
        assert torch.equal(cache[key], exact[key]), key


# ---------------------------------------------------------------------------
# the hybrid family: recurrentgemma-9b's shapes and a reduced-depth model
# at full width
# ---------------------------------------------------------------------------

HYBRID_SPMM = {"w_gate": (4096, 12288), "w_down": (12288, 4096),
               "wq": (4096, 4096), "wk": (4096, 256),
               "head": (4096, 256000)}


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 32])
@pytest.mark.parametrize("leaf", list(HYBRID_SPMM))
def test_griffin_spmm_at_hybrid_shapes(cuda, leaf, m):
    """griffin_spmm at recurrentgemma-9b's five compacted shapes (pruned
    0.8 at 128 x 128 / unit 32, bf16): against the plain version, dual
    bit-equal to the plain walk, rows 0:1 and 0:4 bit-equal alone and in
    the call."""
    k, n = HYBRID_SPMM[leaf]
    g = torch.Generator(device=cuda).manual_seed(k + n + m)
    gw = preprocess_weights(block_prune(
        torch.randn(k, n, generator=g, device=cuda), 0.8).bfloat16())
    a = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    a[:, :256] = 0
    out = griffin_matmul(a, gw)
    torch.cuda.synchronize()
    ref = (a.float() @ decompact_weights(gw)[:k].float()).bfloat16()
    assert_close(out, ref, "bfloat16")
    assert torch.equal(griffin_matmul(a, gw, dual=True), out)
    for rows in (1, 4):
        assert torch.equal(griffin_matmul(a[:rows].contiguous(), gw),
                           out[:rows])


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 4, 32])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dense_leaves_at_hybrid_shapes(cuda, dtype, m):
    """The rec blocks' dense 4096 x 4096 leaves (w_x/w_out in bf16, the
    gates w_rg/w_ig in fp32): dense_gemm's wide route and sparse_a with
    its metadata kernel against their plain versions, row slices
    bit-equal to the full call."""
    dt = DTYPES[dtype]
    g = torch.Generator(device=cuda).manual_seed(m)
    w = torch.randn(4096, 4096, generator=g, device=cuda).to(dt)
    a = torch.randn(m, 4096, generator=g, device=cuda).to(dt)
    a[:, 1024:1280] = 0
    assert dense_gemm_kernel.route(4096) == "wide"
    k1 = dense_matmul(a, w)
    meta = compact_activations(a)
    kidx, cnt = compact_activations_ref(a, block_m=meta.block_m,
                                        block_k=meta.block_k)
    assert torch.equal(meta.kidx, kidx) and torch.equal(meta.cnt, cnt)
    k3 = sparse_a_matmul(a, w, meta=meta)
    torch.cuda.synchronize()
    assert_close(k1, dense_matmul_ref(a, w), dtype)
    assert_close(k3, sparse_a_ref(a, w, kidx, cnt, block_m=meta.block_m,
                                  block_k=meta.block_k), dtype)
    for rows in (1, min(m, 4)):
        part = a[:rows].contiguous()
        assert torch.equal(dense_matmul(part, w), k1[:rows])
        assert torch.equal(sparse_a_matmul(part, w), k3[:rows])


@pytest.fixture(scope="module")
def hybrid_shallow():
    """recurrentgemma-9b at full width cut to 5 layers (one (rec, rec,
    attn) group and the tail of 2 rec blocks), seed 0, pruned 0.8 and
    compacted at 128 x 128 / unit 32 (what launch.serve serves)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), num_layers=5)
    api = build_model(cfg, device="cuda")
    params = sparsify_params(api.init(api.generator(0)), 0.8, compact=True)
    return api, params


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["B", "AB"])
def test_hybrid_rows_bit_equal_to_batch_one(hybrid_shallow, mode):
    """Four prompts prefilled alone, their caches stacked into one 4-row
    batch, then 4 decode steps batched and each row alone: every row's
    logits bit-equal, in Sparse.B and in Mode.AB."""
    api, params = hybrid_shallow
    g = torch.Generator(device="cuda").manual_seed(3)
    ids = torch.randint(1, api.cfg.vocab_size, (4, 16), generator=g,
                        device="cuda")
    with _scope(mode):
        solo = [api.prefill(params, {"tokens": ids[i:i + 1]},
                            cache_len=32)[0] for i in range(4)]
        # the batch axis: 2 for the groups' (G, 2, B, ...) rec state, 1
        # for the tail's state and the (G, B, clen, ...) K/V
        batch = {k: (torch.cat([c[k] for c in solo],
                               dim=2 if k.startswith("rec_") else 1)
                     if k != "pos" else torch.stack([c[k] for c in solo]))
                 for k in solo[0]}
        feed = ids[:, -1:]
        for _ in range(4):
            logits, batch = api.decode_step(params, batch, feed)
            for i in range(4):
                one, solo[i] = api.decode_step(params, solo[i],
                                               feed[i:i + 1])
                assert torch.equal(one[0], logits[i]), i
            feed = torch.argmax(logits, dim=-1)[:, None]
    assert bool(torch.isfinite(logits).all())


@pytest.mark.gpu
def test_hybrid_padded_prefill_bit_equal(hybrid_shallow):
    """A 13-token prompt prefilled in its 16-token bucket carries exactly
    the exact-length prefill's recurrent and conv state, the same K/V
    rows and last-token logits."""
    api, params = hybrid_shallow
    g = torch.Generator(device="cuda").manual_seed(4)
    ids = torch.randint(1, api.cfg.vocab_size, (1, 13), generator=g,
                        device="cuda")
    with _scope("B"):
        exact, want = api.prefill(params, {"tokens": ids}, cache_len=32)
        cache, got = api.prefill(params, {
            "tokens": torch.nn.functional.pad(ids, (0, 3)),
            "lengths": torch.tensor([13], dtype=torch.int32,
                                    device="cuda")}, cache_len=32)
    assert torch.equal(got, want)
    for key in ("rec_h", "rec_conv", "tail_h", "tail_conv"):
        assert torch.equal(cache[key], exact[key]), key
    for key in ("k", "v"):
        assert torch.equal(cache[key][:, :, :13], exact[key][:, :, :13])


@pytest.mark.gpu
@pytest.mark.parametrize("arena", ["fixed", "paged"])
@pytest.mark.parametrize("mode", ["B", "AB"])
def test_hybrid_engine_matches_oracle_on_card(hybrid_shallow, mode, arena):
    """The reduced-depth full-width model served by the engine (4 slots,
    chunks of 4; the paged arena pages k/v beside the fixed recurrent
    state): every request token-identical to the batch-1 greedy oracle,
    and the paged run's tokens equal to the fixed run's."""
    api, params = hybrid_shallow
    fields = dict(num_slots=4, cache_len=40, decode_chunk=4,
                  use_kernels=True, a_sparsity=0.5 if mode == "AB" else None)
    if arena == "paged":
        fields["page_size"] = 8
    eng = ServeEngine(api, params, EngineConfig().with_fields(**fields))
    assert (eng._paged is not None) == (arena == "paged")
    reqs = synthetic_trace(api.cfg, num_requests=6, seed=5,
                           prompt_lens=(8, 16), gen_lens=(4, 12))
    outs = eng.run(reqs)
    assert eng.mode.value == mode
    for r in reqs:
        with eng._scope():
            want = greedy_generate(api, params, r.as_batch(eng.device),
                                   steps=r.max_new_tokens,
                                   cache_len=eng.cache_len,
                                   prompt_bucket=eng.bucket_for(
                                       r.prompt_len))
        assert outs[r.rid].tokens == want[0].tolist(), r.rid


# ---------------------------------------------------------------------------
# the moe family: the kernels at mixtral-8x7b's shapes, a depth-cut
# full-width mixtral, reduced mixtral against its CPU run
# ---------------------------------------------------------------------------

MOE_SPMM = {"w_gate": (4096, 14336), "w_down": (14336, 4096),
            "wq": (4096, 4096), "wk": (4096, 1024), "head": (4096, 32000)}


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 32])
@pytest.mark.parametrize("leaf", list(MOE_SPMM))
def test_griffin_spmm_at_moe_shapes(cuda, leaf, m):
    """griffin_spmm at mixtral-8x7b's five compacted shapes (pruned 0.8 at
    128 x 128 / unit 32, bf16): against the plain version, dual bit-equal
    to the plain walk, rows 0:1 and 0:4 bit-equal alone and in the call,
    and dual on an all-zero A (an expert no token chose) exactly zero."""
    k, n = MOE_SPMM[leaf]
    g = torch.Generator(device=cuda).manual_seed(k + n + m)
    gw = preprocess_weights(block_prune(
        torch.randn(k, n, generator=g, device=cuda), 0.8).bfloat16())
    a = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    a[:, :256] = 0
    out = griffin_matmul(a, gw)
    torch.cuda.synchronize()
    ref = (a.float() @ decompact_weights(gw)[:k].float()).bfloat16()
    assert_close(out, ref, "bfloat16")
    assert torch.equal(griffin_matmul(a, gw, dual=True), out)
    for rows in (1, 4):
        assert torch.equal(griffin_matmul(a[:rows].contiguous(), gw),
                           out[:rows])
    zero = griffin_matmul(torch.zeros_like(a), gw, dual=True)
    assert zero.shape == (m, n) and not bool(zero.any())


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 4, 32])
def test_router_at_moe_shape(cuda, m):
    """The router's fp32 4096 x 8 GEMM: dense_gemm's skinny route and
    sparse_a with its metadata kernel against their plain versions, row
    slices bit-equal to the full call."""
    g = torch.Generator(device=cuda).manual_seed(m)
    w = torch.randn(4096, 8, generator=g, device=cuda)
    a = torch.randn(m, 4096, generator=g, device=cuda)
    assert dense_gemm_kernel.route(8) == "skinny"
    k1 = dense_matmul(a, w)
    meta = compact_activations(a)
    kidx, cnt = compact_activations_ref(a, block_m=meta.block_m,
                                        block_k=meta.block_k)
    assert torch.equal(meta.kidx, kidx) and torch.equal(meta.cnt, cnt)
    k3 = sparse_a_matmul(a, w, meta=meta)
    torch.cuda.synchronize()
    assert_close(k1, dense_matmul_ref(a, w), "float32")
    assert_close(k3, sparse_a_ref(a, w, kidx, cnt, block_m=meta.block_m,
                                  block_k=meta.block_k), "float32")
    for rows in (1, min(m, 4)):
        part = a[:rows].contiguous()
        assert torch.equal(dense_matmul(part, w), k1[:rows])
        assert torch.equal(sparse_a_matmul(part, w), k3[:rows])


@pytest.fixture(scope="module")
def moe_shallow():
    """mixtral-8x7b at full width cut to 2 layers, seed 0, pruned 0.8 and
    compacted at 128 x 128 / unit 32 through the streamed build (what
    launch.serve serves)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=2)
    api = build_model(cfg, device="cuda")
    return api, init_sparse_params(api, api.generator(0), 0.8)


@pytest.mark.gpu
def test_moe_streamed_build_on_card_equals_sparsify_of_init(moe_shallow):
    """On the card, at full width cut to 2 layers (which fits twice), the
    streamed build equals ``sparsify_params(init_params(...))`` bit for
    bit: every leaf, the (L, E) expert stacks included."""
    api, params = moe_shallow
    want = sparsify_params(api.init(api.generator(0)), 0.8)

    def walk(got, ref, path=""):
        if isinstance(ref, dict):
            assert set(got) == set(ref), path
            for key in ref:
                walk(got[key], ref[key], f"{path}/{key}")
            return
        if hasattr(ref, "b_comp"):
            for f in ("b_comp", "kidx", "cnt", "inv_perm", "perm"):
                assert torch.equal(getattr(got, f), getattr(ref, f)), \
                    (path, f)
            return
        assert torch.equal(got, ref), path

    walk(params, want)
    assert params["layers"]["moe"]["w_down"].b_comp.shape[:2] == (2, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("arena", ["fixed", "paged"])
@pytest.mark.parametrize("mode", ["B", "AB"])
def test_moe_engine_matches_oracle_on_card(moe_shallow, mode, arena):
    """The depth-cut full-width mixtral served by the engine (4 slots,
    chunks of 4): every request token-identical to the batch-1 greedy
    oracle, in Sparse.B and Mode.AB, on the fixed and the paged arena."""
    api, params = moe_shallow
    fields = dict(num_slots=4, cache_len=40, decode_chunk=4,
                  use_kernels=True, a_sparsity=0.5 if mode == "AB" else None)
    if arena == "paged":
        fields["page_size"] = 8
    eng = ServeEngine(api, params, EngineConfig().with_fields(**fields))
    assert (eng._paged is not None) == (arena == "paged")
    reqs = synthetic_trace(api.cfg, num_requests=6, seed=5,
                           prompt_lens=(8, 16), gen_lens=(4, 12))
    outs = eng.run(reqs)
    assert eng.mode.value == mode
    for r in reqs:
        with eng._scope():
            want = greedy_generate(api, params, r.as_batch(eng.device),
                                   steps=r.max_new_tokens,
                                   cache_len=eng.cache_len,
                                   prompt_bucket=eng.bucket_for(
                                       r.prompt_len))
        assert outs[r.rid].tokens == want[0].tolist(), r.rid


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["B", "AB"])
def test_reduced_moe_on_card_equals_its_cpu_run(cuda, mode):
    """Reduced mixtral-8x7b (fp32, 4 experts top-2, window 32), pruned 0.8
    and compacted at 16 x 16 / unit 8: the same weights on the card
    (kernels) and on the CPU (their plain versions) give prefill and
    decode logits within relative L2 1e-5 (summation orders differ) and
    the same greedy tokens, past the window too."""
    from repro_torch.sparsity import PRUNE
    cfg = get_config("mixtral-8x7b").reduced()
    cpu = build_model(cfg, device="cpu")
    params = init_sparse_params(cpu, cpu.generator(0), 0.8, **PRUNE)
    card = build_model(cfg, device="cuda")
    moved = _to(params, cuda)
    ids = torch.randint(1, cfg.vocab_size, (2, 40),
                        generator=torch.Generator().manual_seed(9))
    a = 0.5 if mode == "AB" else None
    outs = {}
    for api, p, dev in ((cpu, params, "cpu"), (card, moved, "cuda")):
        with sparse_execution(use_kernels=True, a_sparsity=a or 0.0):
            cache, logits = api.prefill(p, {"tokens": ids.to(dev)},
                                        cache_len=48)
            seq = [logits.cpu()]
            for _ in range(4):
                tok = torch.argmax(logits, -1)[:, None]
                logits, cache = api.decode_step(p, cache, tok)
                seq.append(logits.cpu())
        outs[dev] = seq
    for got, want in zip(outs["cuda"], outs["cpu"]):
        rel = float((got - want).norm() / want.norm())
        assert rel <= 1e-5, rel
        assert torch.equal(got.argmax(-1), want.argmax(-1))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if hasattr(tree, "b_comp"):
        return dataclasses.replace(tree, **{
            f: None if getattr(tree, f) is None
            else getattr(tree, f).to(device)
            for f in ("b_comp", "kidx", "cnt", "inv_perm", "perm")})
    return tree.to(device)


# ---------------------------------------------------------------------------
# whisper-large-v3: its K2 shapes, a depth-cut full-width engine
# ---------------------------------------------------------------------------

WHISPER_SPMM = {"wq": (1280, 1280), "w_up": (1280, 5120),
                "w_down": (5120, 1280), "head": (1280, 51866)}


@pytest.mark.gpu
@pytest.mark.parametrize("leaf,m,label", [
    (leaf, m, "bfloat16") for leaf in WHISPER_SPMM for m in (4, 32)] + [
    (leaf, 1500, "mixed") for leaf in WHISPER_SPMM if leaf != "head"])
def test_griffin_spmm_at_whisper_shapes(cuda, leaf, m, label):
    """griffin_spmm at whisper-large-v3's compacted shapes (pruned 0.8 at
    128 x 128 / unit 32, bf16 weights): bf16 A at M 4 and 32 and, on the
    encoder's three shapes, its fp32 A at M 1500 (the head multiplies the
    decoder's bf16 stream only) against the plain version, dual bit-equal
    to the plain walk, and the head's 26-column partial last tile
    bit-equal to the plain version on exact integer products."""
    k, n = WHISPER_SPMM[leaf]
    g = torch.Generator(device=cuda).manual_seed(k + n + m)
    gw = preprocess_weights(block_prune(
        torch.randn(k, n, generator=g, device=cuda), 0.8).bfloat16())
    a = torch.randn(m, k, generator=g, device=cuda).to(PAIRS[label][0])
    a[:, :256] = 0
    out = griffin_matmul(a, gw)
    torch.cuda.synchronize()
    ref = (a.float() @ decompact_weights(gw)[:k].float()).to(a.dtype)
    assert out.dtype == a.dtype and out.shape == (m, n)
    assert_close(out, ref, label)
    assert torch.equal(griffin_matmul(a, gw, dual=True), out)
    if leaf == "head":
        w = block_prune(torch.randint(-3, 4, (k, n), generator=g,
                                      device=cuda).float(), 0.8)
        gw = preprocess_weights(w.bfloat16())
        ai = torch.randint(-2, 3, (m, k), generator=g,
                           device=cuda).bfloat16()
        exact = (ai.float() @ w).bfloat16()
        assert torch.equal(griffin_matmul(ai, gw), exact)
        assert torch.equal(griffin_matmul(ai, gw)[:, -26:], exact[:, -26:])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_griffin_spmm_batch_invariant_at_whisper_w_up(cuda, dtype):
    """Rows 0:1, 0:4 and 0:32 of a 1500-row A through w_up (1280 x 5120)
    bit-equal alone and in the full call, dual and not: the encoder's
    fp32 stream and the decoder's bf16 one."""
    g = torch.Generator(device=cuda).manual_seed(7)
    gw = preprocess_weights(block_prune(
        torch.randn(1280, 5120, generator=g, device=cuda), 0.8).bfloat16())
    a = torch.randn(1500, 1280, generator=g, device=cuda).to(dtype)
    a[:16, :256] = 0
    for dual in (False, True):
        full = griffin_matmul(a, gw, dual=dual)
        for rows in (1, 4, 32):
            assert torch.equal(griffin_matmul(a[:rows].contiguous(), gw,
                                              dual=dual), full[:rows])


@pytest.fixture(scope="module")
def whisper_shallow():
    """whisper-large-v3 at full width (1500 frames) cut to 2 encoder and 2
    decoder layers, seed 0, pruned 0.8 and compacted at 128 x 128 / unit
    32 (what launch.serve serves)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("whisper-large-v3"), num_layers=2,
                              encoder_layers=2)
    api = build_model(cfg, device="cuda")
    return api, sparsify_params(api.init(api.generator(0)), 0.8)


@pytest.mark.gpu
@pytest.mark.parametrize("arena", ["fixed", "paged"])
@pytest.mark.parametrize("mode", ["B", "AB"])
def test_whisper_engine_matches_cast_oracle_on_card(whisper_shallow, mode,
                                                    arena):
    """The depth-cut full-width whisper served by the engine (4 slots,
    chunks of 4, each request with its 1500 fp32 frames): every request
    token-identical to the batch-1 greedy loop decoding from its
    prefill's cache cast to ``init_cache``'s dtypes (bf16 cross K/V, as
    the engine's admission writes them), in Sparse.B and Mode.AB, on the
    fixed and the paged arena.  No activation sparsity is measured
    (``measure_every`` 64): the compacted head's exact-zero logits (10.7 %
    of its columns lose all 10 K blocks) would flip Sparse.B to Mode.AB,
    as in ``chip_smoke.WHISPER_PATHS``."""
    api, params = whisper_shallow
    fields = dict(num_slots=4, cache_len=40, decode_chunk=4,
                  use_kernels=True, measure_every=64,
                  a_sparsity=0.5 if mode == "AB" else None)
    if arena == "paged":
        fields["page_size"] = 8
    eng = ServeEngine(api, params, EngineConfig().with_fields(**fields))
    assert (eng._paged is not None) == (arena == "paged")
    assert eng.cache["xk"].dtype == torch.bfloat16
    reqs = synthetic_trace(api.cfg, num_requests=5, seed=5,
                           prompt_lens=(8, 16), gen_lens=(4, 12))
    outs = eng.run(reqs)
    assert eng.mode.value == mode
    dts = {k: v.dtype for k, v in api.init_cache(
        1, eng.cache_len, device=torch.device("meta")).items()}
    for r in reqs:
        batch = r.as_batch(eng.device, eng.bucket_for(r.prompt_len))
        with eng._scope():
            cache, logits = api.prefill(params, batch,
                                        cache_len=eng.cache_len)
            assert cache["xk"].dtype == torch.float32
            cache = {k: v.to(dts[k]) for k, v in cache.items()}
            toks = [logits.argmax(-1)[:, None]]
            for _ in range(r.max_new_tokens - 1):
                logits, cache = api.decode_step(params, cache, toks[-1])
                toks.append(logits.argmax(-1)[:, None])
        assert outs[r.rid].tokens == [int(t) for t in toks], r.rid


# ---------------------------------------------------------------------------
# training: the flash backward, one reduced train step per family
# ---------------------------------------------------------------------------

def _materialised_attention(q, k, v, window):
    S, hd = q.shape[1], q.shape[-1]
    G = q.shape[2] // k.shape[2]
    kk, vv = (x.repeat_interleave(G, dim=2) for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / hd ** 0.5
    pos = torch.arange(S, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= pos[:, None] - pos[None, :] < window
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vv)


@pytest.mark.gpu
@pytest.mark.parametrize("S,window", [(512, None), (1024, 300), (700, None)])
def test_flash_backward_on_card_matches_materialised(cuda, S, window):
    """llama3.2-1b's head shapes (H 32, KVH 8, hd 64), kv_chunk 512, fp32:
    dq, dk and dv within relative L2 1e-4 of autograd through the
    materialised causal attention (windowed; 700 leaves a ragged
    chunk)."""
    from repro_torch.models.attention import attention
    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn(2, S, 32, 64, generator=g, device=cuda)
    k, v = (torch.randn(2, S, 8, 64, generator=g, device=cuda)
            for _ in range(2))
    do = torch.randn(2, S, 32, 64, generator=g, device=cuda)
    leaves = [x.requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(attention(*leaves, causal=True, window=window,
                                        kv_chunk=512), leaves, do)
    want = torch.autograd.grad(_materialised_attention(*leaves, window),
                               leaves, do)
    for a, b in zip(got, want):
        assert float((a - b).norm() / b.norm()) <= 1e-4


TRAIN_FAMILIES = ("llama3.2-1b", "mixtral-8x7b", "xlstm-1.3b",
                  "recurrentgemma-9b", "whisper-large-v3")


def _train_batch(cfg, device):
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.runtime.train import to_device
    return to_device(synth_batch(cfg, ShapeConfig("t", 16, 2, "train"),
                                 DataConfig(seed=1), 0), device)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", TRAIN_FAMILIES)
def test_reduced_train_step_on_card_equals_its_cpu_run(cuda, arch):
    """One reduced() train step (fp32, remat on) of each family on the
    card against the same step on the CPU from the same weights: the loss
    within 1e-5 relative, every gradient leaf within relative L2 1e-4,
    the grad norm within 1e-5 (summation orders differ)."""
    from repro_torch.checkpoint import keyed_leaves
    from repro_torch.optim import adamw
    from repro_torch.runtime.train import (TrainState, make_train_step,
                                           value_and_grad)
    cfg = dataclasses.replace(get_config(arch).reduced(), remat=True)
    cpu, card = build_model(cfg, device="cpu"), build_model(cfg,
                                                             device="cuda")
    params = cpu.init(cpu.generator(0))
    on_card = _to(params, cuda)
    results = {}
    for api, p, dev in ((cpu, params, "cpu"), (card, on_card, "cuda")):
        loss, grads = value_and_grad(api.loss, p, _train_batch(cfg, dev))
        results[dev] = (float(loss), grads)
    (l_cpu, g_cpu), (l_card, g_card) = results["cpu"], results["cuda"]
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    for (path, a), (_, b) in zip(keyed_leaves(g_card), keyed_leaves(g_cpu)):
        assert a.device.type == "cuda", path
        rel = float((a.cpu() - b).norm() / b.norm().clamp(min=1e-30))
        assert rel <= 1e-4, (path, rel)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=4)
    metrics = {}
    for api, p, dev in ((cpu, params, "cpu"), (card, on_card, "cuda")):
        state = TrainState(p, adamw.init(p),
                           torch.zeros((), dtype=torch.int32))
        _, m = make_train_step(api, opt)(state, _train_batch(cfg, dev))
        metrics[dev] = (float(m["loss"]), float(m["grad_norm"]))
    assert metrics["cuda"][0] == pytest.approx(metrics["cpu"][0], rel=1e-5)
    assert metrics["cuda"][1] == pytest.approx(metrics["cpu"][1], rel=1e-5)


@pytest.mark.gpu
def test_train_step_is_deterministic_on_card(cuda):
    """Two value_and_grad calls of reduced llama3.2-1b (bf16) on the same
    inputs give bit-equal losses and gradients on the card: the
    embedding gather's backward and every reduction run in a fixed order,
    which the restart's bit-equality needs."""
    from repro_torch.checkpoint import keyed_leaves
    from repro_torch.runtime.train import value_and_grad
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              dtype="bfloat16")
    api = build_model(cfg, device="cuda")
    params = api.init(api.generator(0))
    batch = _train_batch(cfg, "cuda")
    l1, g1 = value_and_grad(api.loss, params, batch)
    l2, g2 = value_and_grad(api.loss, params, batch)
    assert torch.equal(l1, l2)
    for (path, a), (_, b) in zip(keyed_leaves(g1), keyed_leaves(g2)):
        assert torch.equal(a, b), path


# ---------------------------------------------------------------------------
# mesh serving: the shard entries (the mesh runs, above, come before the
# module-scoped models)
# ---------------------------------------------------------------------------

def _shards_of(gw, shards):
    from repro_torch.runtime.sharding import _griffin_share
    return [_griffin_share(gw, r, shards) for r in range(shards)]


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 512), (2048, 8192),
                                 (8192, 2048), (22016, 8192)])
def test_shard_entries_bit_equal_to_the_whole_kernel(cuda, k, n, shards):
    """Every rank's columns gathered equal the whole kernel bit for bit:
    griffin_spmm (Sparse.B and dual, balanced, 128 x 128 / unit 32 at 0.8;
    22016 x 8192 takes the CUDA-core route, and its shards with it),
    sparse_a and dense_gemm on the dense weight, at M 4 and 32."""
    from repro_torch.kernels.dense_gemm.ops import (DenseShard,
                                                    dense_matmul_shard)
    from repro_torch.kernels.griffin_spmm import kernel as k2
    from repro_torch.kernels.griffin_spmm.ops import griffin_matmul_shard
    from repro_torch.kernels.sparse_a.ops import sparse_a_matmul_shard
    g = torch.Generator(device=cuda).manual_seed(k + n)
    w = (torch.randn((k, n), generator=g, device=cuda) / k ** 0.5).to(
        torch.bfloat16)
    wp = block_prune(w, 0.8, 128, 32)
    gw = preprocess_weights(wp, block_k=128, block_n=128, unit=32)
    per = n // shards
    cols = [DenseShard(wp[:, r * per:(r + 1) * per].contiguous(), n, shards)
            for r in range(shards)]
    for m in (4, 32):
        a = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
        a[:, 128:256] = 0
        route = k2.route(a, gw.b_comp, gw.kidx, n=n, block_k=128,
                         block_n=128).name
        assert route == ("core" if k == 22016 else "tc")
        for dual in (False, True):
            out = torch.cat([griffin_matmul_shard(a, s, dual=dual)
                             for s in _shards_of(gw, shards)], 1)
            out = out.index_select(1, gw.inv_perm.long())[:, :n]
            assert torch.equal(out, griffin_matmul(a, gw, dual=dual))
        if k == 22016:
            continue
        assert torch.equal(
            torch.cat([sparse_a_matmul_shard(a, c) for c in cols], 1),
            sparse_a_matmul(a, wp))
        assert torch.equal(
            torch.cat([dense_matmul_shard(a, c) for c in cols], 1),
            dense_matmul(a, wp))


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4])
def test_tied_head_shards_bit_equal_to_the_whole_kernel(cuda, shards):
    """The tied 2048 x 128256 head, each rank's vocab rows read as embed.T,
    through dense_gemm's and sparse_a's shard entries."""
    from repro_torch.kernels.dense_gemm.ops import (DenseShard,
                                                    dense_matmul_shard)
    from repro_torch.kernels.sparse_a.ops import sparse_a_matmul_shard
    g = torch.Generator(device=cuda).manual_seed(shards)
    V, D = 128256, 2048
    emb = (torch.randn((V, D), generator=g, device=cuda) * 0.02).to(
        torch.bfloat16)
    rows = V // shards
    heads = [DenseShard(emb[r * rows:(r + 1) * rows].T, V, shards)
             for r in range(shards)]
    for m in (4, 32):
        a = torch.randn((m, D), generator=g, device=cuda).to(torch.bfloat16)
        assert torch.equal(torch.cat([dense_matmul_shard(a, h)
                                      for h in heads], 1),
                           dense_matmul(a, emb.T))
        assert torch.equal(torch.cat([sparse_a_matmul_shard(a, h)
                                      for h in heads], 1),
                           sparse_a_matmul(a, emb.T))
