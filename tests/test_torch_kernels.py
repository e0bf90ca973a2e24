"""The port's kernel ops (repro_torch.kernels) against the JAX package's.

On the CPU each wrapper runs its kernel's plain PyTorch version; the JAX ops
run their Pallas kernels in interpret mode, as tests/test_kernels.py does.
Inputs are made with numpy from a seed and handed to both.  Tolerances:
fp32 rtol = atol = 1e-5 (summation orders differ), bf16 rtol = atol = 2e-2
(about two bf16 ulps: both sides round an fp32 sum once); fp32 A against a
bf16 weight (the mixed pair) as fp32: both sides widen the weight exactly
and sum fp32 products.  Preprocessing is pure data movement and must be
bitwise equal.
"""
import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dense_matmul as jax_dense_matmul
from repro.kernels import griffin_matmul as jax_griffin_matmul
from repro.kernels import preprocess_weights as jax_preprocess
from repro.kernels import stack_weights as jax_stack
from repro.sparsity import block_prune as jax_block_prune
from repro_torch import bridge
from repro_torch.kernels import (decompact_weights, dense_matmul,
                                 griffin_matmul, launch_counts,
                                 preprocess_weights, stack_weights)
from repro_torch.kernels.dense_gemm import kernel as k1
from repro_torch.kernels.griffin_spmm.kernel import (MAX_SMEM, Route,
                                                     SplitPlan, route,
                                                     split_plan, tc_smem)
from repro_torch.kernels.sparse_a.ops import sparse_a_matmul
from repro_torch.models.common import griffin_linear, sparse_execution

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=1e-5, atol=1e-5)


def _np(x):
    """Any array (jax, numpy, torch) as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bits(x):
    a = bridge.tensor_to_array(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    return a.view(np.uint8)


def assert_gw_bitwise(jgw, tgw):
    for f in ("b_comp", "kidx", "cnt", "inv_perm"):
        ja, ta = getattr(jgw, f), getattr(tgw, f)
        assert (ja is None) == (ta is None), f
        if ja is None:
            continue
        assert tuple(ja.shape) == tuple(ta.shape), f
        assert np.asarray(ja).dtype == bridge.tensor_to_array(ta).dtype, f
        np.testing.assert_array_equal(_bits(ja), _bits(ta), err_msg=f)
    for f in ("k", "n", "block_k", "block_n", "a_thr"):
        assert getattr(jgw, f) == getattr(tgw, f), f


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 16, 8), (48, 96, 80), (33, 70, 17),
                                   (128, 256, 128)])
def test_dense_matmul_matches_jax(dtype, shape):
    m, k, n = shape
    rng = np.random.RandomState(0)
    a = jnp.asarray(rng.randn(m, k), dtype=JAX_DTYPES[dtype])
    b = jnp.asarray(rng.randn(k, n), dtype=JAX_DTYPES[dtype])
    want = jax_dense_matmul(a, b, interpret=True)
    got = dense_matmul(bridge.array_to_tensor(a), bridge.array_to_tensor(b))
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == (m, n)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_dense_matmul_reads_strided_b_in_place():
    """The tied unembedding hands the wrapper ``embed.T``, a strided view."""
    rng = np.random.RandomState(5)
    a = torch.from_numpy(rng.randn(4, 64).astype(np.float32))
    embed = torch.from_numpy(rng.randn(200, 64).astype(np.float32))
    out = dense_matmul(a, embed.T)
    np.testing.assert_allclose(out.numpy(), a.numpy() @ embed.numpy().T,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contig", "device"])
def test_dense_matmul_rejects_what_the_kernel_does_not_take(bad):
    a = torch.zeros(4, 8)
    b = torch.zeros(8, 16)
    if bad == "dtype":
        a, b = a.double(), b.double()
    elif bad == "shape":
        b = torch.zeros(9, 16)
    elif bad == "contig":
        a = torch.zeros(8, 4).T
    else:
        a, b = a.to("meta"), b.to("meta")
    with pytest.raises((ValueError, TypeError)):
        dense_matmul(a, b)


def _pruned(rng, k, n, bk, unit, sparsity=0.6):
    w = rng.randn(k, n).astype(np.float32)
    return np.array(jax_block_prune(jnp.asarray(w), sparsity, block_k=bk,
                                    unit=unit))


@pytest.mark.parametrize("balance", [False, True])
@pytest.mark.parametrize("case", [(128, 96, 16, 32, 8), (256, 256, 16, 64, 16),
                                  (70, 33, 16, 16, 8), (64, 200, 32, 64, 16)])
def test_preprocess_weights_bitwise(balance, case):
    k, n, bk, bn, unit = case
    w = _pruned(np.random.RandomState(1), k, n, bk, unit)
    jgw = jax_preprocess(w, block_k=bk, block_n=bn, unit=unit,
                         balance=balance)
    tgw = preprocess_weights(torch.from_numpy(w), block_k=bk, block_n=bn,
                             unit=unit, balance=balance)
    assert_gw_bitwise(jgw, tgw)


def test_preprocess_bf16_bitwise_and_decompact_exact():
    w = _pruned(np.random.RandomState(9), 96, 80, 16, 8)
    wb = jnp.asarray(w, jnp.bfloat16)
    jgw = jax_preprocess(np.asarray(wb), block_k=16, block_n=32, unit=8)
    tw = bridge.array_to_tensor(wb)
    tgw = preprocess_weights(tw, block_k=16, block_n=32, unit=8)
    assert_gw_bitwise(jgw, tgw)
    # decompaction reconstructs every surviving value exactly
    np.testing.assert_array_equal(_np(decompact_weights(tgw)[:96]), _np(tw))


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("balance", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_griffin_matmul_matches_jax(dtype, balance, dual):
    rng = np.random.RandomState(1)
    m, k, n = 32, 128, 96
    w = jax_block_prune(jnp.asarray(rng.randn(k, n), jnp.float32), 0.6,
                        block_k=16, unit=8).astype(JAX_DTYPES[dtype])
    jgw = jax_preprocess(np.asarray(w.astype(jnp.float32)), block_k=16,
                         block_n=32, unit=8, balance=balance)
    jgw.b_comp = jgw.b_comp.astype(JAX_DTYPES[dtype])
    a = jnp.asarray(rng.randn(m, k), dtype=JAX_DTYPES[dtype])
    want = jax_griffin_matmul(a, jgw, dual=dual, interpret=True)
    tgw = bridge.to_torch(jgw)
    got = griffin_matmul(bridge.array_to_tensor(a), tgw, dual=dual)
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == (m, n)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_dual_skips_zero_a_blocks_exactly():
    rng = np.random.RandomState(2)
    a = rng.randn(16, 64).astype(np.float32)
    a[:, 16:48] = 0                       # two all-zero K blocks
    w = _pruned(rng, 64, 32, 16, 8, 0.5)
    gw = preprocess_weights(torch.from_numpy(w), block_k=16, block_n=16,
                            unit=8, balance=False)
    ta = torch.from_numpy(a)
    out_b = griffin_matmul(ta, gw, dual=False)
    out_ab = griffin_matmul(ta, gw, dual=True)
    np.testing.assert_array_equal(out_b.numpy(), out_ab.numpy())
    want = jax_griffin_matmul(jnp.asarray(a), jax_preprocess(
        w, block_k=16, block_n=16, unit=8, balance=False), dual=True,
        interpret=True)
    np.testing.assert_allclose(out_ab.numpy(), _np(want), rtol=1e-5,
                               atol=1e-5)


def test_griffin_matmul_narrow_a_masks_padded_k():
    """``kidx`` counts padded K blocks; A may be narrower than gw.k."""
    rng = np.random.RandomState(4)
    w = _pruned(rng, 70, 48, 16, 8, 0.5)
    gw = preprocess_weights(torch.from_numpy(w), block_k=16, block_n=16,
                            unit=8)
    assert gw.k == 80
    a = rng.randn(3, 70).astype(np.float32)
    got = griffin_matmul(torch.from_numpy(a), gw)
    np.testing.assert_allclose(got.numpy(), a @ w, rtol=1e-5, atol=1e-5)


def _toy(seed, k=64, n=64, density=0.4, bk=16, bn=32):
    rng = np.random.RandomState(seed)
    w = rng.randn(k, n).astype(np.float32)
    mask = rng.rand(k // bk, n // 8) < density
    w *= np.repeat(np.repeat(mask, bk, 0), 8, 1)
    return w


def test_stack_weights_clamp_padding_bitwise_and_parity():
    w0, w1 = _toy(0, density=0.2), _toy(1, density=0.9)
    kw = dict(block_k=16, block_n=32, unit=8, balance=False)
    jstacked = jax_stack([jax_preprocess(w0, **kw), jax_preprocess(w1, **kw)])
    g0 = preprocess_weights(torch.from_numpy(w0), **kw)
    g1 = preprocess_weights(torch.from_numpy(w1), **kw)
    assert g0.kidx.shape[-1] < g1.kidx.shape[-1]   # forces padding of g0
    stacked = stack_weights([g0, g1])
    assert_gw_bitwise(jstacked, stacked)
    pad = stacked.kidx[0, :, g0.kidx.shape[-1]:]
    assert bool((pad == g0.kidx[:, -1:]).all())
    assert not bool(stacked.b_comp[0, g0.b_comp.shape[0]:].any())
    a = np.random.RandomState(7).randn(8, 64).astype(np.float32)
    for i, w in enumerate((w0, w1)):
        out = griffin_matmul(torch.from_numpy(a), stacked[i])
        np.testing.assert_allclose(out.numpy(), a @ w, rtol=2e-4, atol=2e-4)


def test_stack_weights_balanced_bitwise():
    kw = dict(block_k=16, block_n=32, unit=8, balance=True)
    ws = [_toy(s, n=96, density=d) for s, d in ((3, 0.3), (4, 0.7))]
    jstacked = jax_stack([jax_preprocess(w, **kw) for w in ws])
    stacked = stack_weights([preprocess_weights(torch.from_numpy(w), **kw)
                             for w in ws])
    assert_gw_bitwise(jstacked, stacked)


def test_density_memo_and_compaction():
    gw = preprocess_weights(torch.from_numpy(_toy(4)), block_k=16,
                            block_n=32, unit=8, balance=False)
    d = gw.density
    assert gw.__dict__["_density_memo"] == d
    assert d == pytest.approx(float(gw.cnt.sum()) / (4 * gw.cnt.numel()))
    assert gw.compaction == gw.kidx.shape[-1] / 4


def test_cpu_wrappers_launch_no_kernel():
    before = launch_counts()
    a = torch.randn(4, 32)
    dense_matmul(a, torch.randn(32, 16))
    griffin_matmul(a, preprocess_weights(torch.randn(32, 32), block_k=16,
                                         block_n=16, unit=8))
    assert launch_counts() == before


def _argsort_i32(inv_perm):
    return np.argsort(np.asarray(inv_perm), axis=-1, kind="stable") \
        .astype(np.int32)


@pytest.mark.parametrize("route", ["preprocess", "stack", "getitem",
                                   "bridge", "round_trip"])
def test_forward_perm_is_argsort_of_reference_inv_perm(route):
    """The card's kernel stores b_comp column p at output column perm[p]:
    perm must be the inverse of the reference's inv_perm, bit for bit, on
    every way a GriffinWeights is made."""
    kw = dict(block_k=16, block_n=32, unit=8, balance=True)
    ws = [_toy(s, n=96, density=d) for s, d in ((3, 0.3), (4, 0.7))]
    jgws = [jax_preprocess(w, **kw) for w in ws]
    if route == "preprocess":
        pairs = [(preprocess_weights(torch.from_numpy(w), **kw), j.inv_perm)
                 for w, j in zip(ws, jgws)]
    elif route in ("stack", "getitem"):
        stacked = stack_weights([preprocess_weights(torch.from_numpy(w), **kw)
                                 for w in ws])
        jstacked = jax_stack(jgws)
        pairs = [(stacked, jstacked.inv_perm)] if route == "stack" else \
            [(stacked[i], np.asarray(jstacked.inv_perm)[i])
             for i in range(len(ws))]
    elif route == "bridge":
        pairs = [(bridge.to_torch(j), j.inv_perm) for j in jgws]
    else:
        pairs = [(bridge.to_torch(bridge.to_numpy(
            preprocess_weights(torch.from_numpy(w), **kw))), j.inv_perm)
            for w, j in zip(ws, jgws)]
    for tgw, inv_perm in pairs:
        assert tgw.perm is not None and tgw.perm.dtype == torch.int32
        assert tgw.perm.shape == tgw.inv_perm.shape
        np.testing.assert_array_equal(tgw.perm.numpy(),
                                      _argsort_i32(inv_perm))


def test_unbalanced_weights_have_no_perm():
    gw = preprocess_weights(torch.from_numpy(_toy(5)), block_k=16,
                            block_n=32, unit=8, balance=False)
    assert gw.inv_perm is None and gw.perm is None
    assert stack_weights([gw, gw]).perm is None


def test_griffin_matmul_rejects_a_mismatched_perm():
    gw = preprocess_weights(torch.from_numpy(_toy(6, n=96)), block_k=16,
                            block_n=32, unit=8)
    bad = dataclasses.replace(gw, perm=gw.perm[:-1])
    with pytest.raises(ValueError):
        griffin_matmul(torch.randn(2, 64), bad)


def test_split_plan_depends_only_on_the_weight_shape():
    """The bf16 route's split (cluster size, slice width, chunk rows) is a
    function of the weight's shape: M is not among its inputs, so no row's
    summation order can depend on how many rows are in the call.  The
    cluster size S, which with the kernel's rank shares fixed by absolute K
    sets every output's summation order, is a function of (K, N) alone:
    the same at every compaction granularity of the autotune grid."""
    params = inspect.signature(split_plan).parameters
    assert list(params) == ["k", "n", "n_tiles", "block_k", "block_n"]
    # llama3.2-1b: wq/wo, wk/wv, w_gate/w_up, w_down at 128 x 128
    assert split_plan(2048, 2048, 16, 128, 128) == SplitPlan(8, 64, 64)
    assert split_plan(2048, 512, 4, 128, 128) == SplitPlan(8, 16, 64)
    assert split_plan(2048, 8192, 64, 128, 128) == SplitPlan(2, 64, 64)
    assert split_plan(8192, 2048, 16, 128, 128) == SplitPlan(8, 64, 64)
    assert split_plan(48, 30, 3, 16, 30) is None   # no tensor-core route
    for k, n in ((2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
                 (64, 96), (256, 48)):
        splits = set()
        for bk, bn in ((16, 16), (32, 32), (32, 48), (64, 64), (128, 128),
                       (512, 512), (64, 256)):
            s, cols, chunk = split_plan(k, n, -(-n // bn), bk, bn)
            assert s in (1, 2, 4, 8) and bn % cols == 0
            assert bk % chunk == 0 and chunk % 16 == 0
            assert s == 1 or -(-k // 64) >= s
            splits.add(s)
        assert len(splits) == 1, (k, n, splits)


def _meta_operands(m, k, n, depth, dtype=torch.bfloat16):
    """A (m, k) and a compacted weight's b_comp and kidx at grid depth
    ``depth`` (128 x 128 blocks) on the meta device: shapes, no bytes."""
    nt = -(-n // 128)
    return (torch.empty(m, k, dtype=dtype, device="meta"),
            torch.empty(depth * 128, nt * 128, dtype=torch.bfloat16,
                        device="meta"),
            torch.empty(nt, depth, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("k,n,depth,smem,name", [
    (4096, 256000, 25, 230_340, "tc"),      # minitron-8b's head, S 1
    (4096, 256000, 26, 238_560, "core"),
    (4096, 16384, 25, 230_340, "tc"),       # its w_gate/w_up, S 1
    (4096, 16384, 26, 238_560, "core"),
    (14336, 4096, 76, 255_192, "core"),     # mixtral-8x7b's w_down, S 4
    (16384, 4096, 90, 288_112, "core"),     # minitron-8b's w_down, S 4
    (2048, 100352, 15, 148_140, "tc"),      # stablelm-1.6b's head, S 1
    (5632, 2048, 36, 70_172, "tc"),         # stablelm-1.6b's w_down, S 8
    (33792, 12288, 176, 1_110_056, "core"),  # command-r-plus's w_down, S 2
], ids=lambda v: str(v))
def test_route_mirror_bytes_equal_the_tclayout_arithmetic(k, n, depth, smem,
                                                          name):
    """``route`` and ``tc_smem`` mirror csrc/griffin_spmm.cu: the bytes of
    ``TcLayout(cols, 2, chunk, max_cnt, chunk_cap)`` (the B ring of 3
    stages, the staged A of ``chunk_cap`` 32 x 64 chunks, the int lists)
    against ``kMaxSmem`` = 232,448 B, at the figures worked out by hand
    from the C++ (K 4096 at S 1: depth 25 fits by 2,108 B, depth 26 does
    not); the route is the same at every M."""
    plan = split_plan(k, n, -(-n // 128), 128, 128)
    assert tc_smem(k, depth, 128, plan) == smem
    assert MAX_SMEM == 232_448
    for m in (1, 4, 32, 4096):
        assert route(*_meta_operands(m, k, n, depth), n=n, block_k=128,
                     block_n=128) == Route(name, smem)


def test_route_takes_the_cuda_cores_off_the_tensor_core_terms():
    """The CUDA-core route wherever griffin_spmm's C++ entry leaves the
    tensor cores: fp32 A (no plan), a block no multiple of 16 (no plan),
    A or b_comp not 16-byte aligned, A's row stride or K no multiple of
    8; a fitting bf16 launch takes the tensor cores."""
    rng = np.random.RandomState(3)
    w = torch.from_numpy(_toy(9, k=64, n=96)).to(torch.bfloat16)
    gw = preprocess_weights(w, block_k=16, block_n=32, unit=8)
    kw = dict(n=gw.n, block_k=16, block_n=32)
    a = torch.from_numpy(rng.randn(4, 68).astype(np.float32)).to(
        torch.bfloat16)
    assert route(a[:, :64], gw.b_comp, gw.kidx, **kw).name == "core"  # lda
    a = a[:, :64].contiguous()
    fits = route(a, gw.b_comp, gw.kidx, **kw)
    assert fits.name == "tc" and 0 < fits.smem <= MAX_SMEM
    assert route(a.float(), gw.b_comp, gw.kidx, **kw) == Route("core", 0)
    odd = torch.empty(4 * 64 + 1, dtype=torch.bfloat16)[1:].view(4, 64)
    assert odd.data_ptr() % 16 and \
        route(odd, gw.b_comp, gw.kidx, **kw).name == "core"
    assert route(a[:, :60].contiguous(), gw.b_comp, gw.kidx,
                 **kw).name == "core"                             # K % 8
    gw48 = preprocess_weights(w, block_k=16, block_n=24, unit=8)
    assert route(a, gw48.b_comp, gw48.kidx, n=gw48.n, block_k=16,
                 block_n=24) == Route("core", 0)


# ---------------------------------------------------------------------------
# the mixed pair: fp32 A against a bf16 weight (the mLSTM block's w_down)
# ---------------------------------------------------------------------------

def _mixed_gw(rng, k, n):
    w = jax_block_prune(jnp.asarray(rng.randn(k, n), jnp.float32), 0.6,
                        block_k=16, unit=8).astype(jnp.bfloat16)
    jgw = jax_preprocess(np.asarray(w.astype(jnp.float32)), block_k=16,
                         block_n=32, unit=8)
    jgw.b_comp = jgw.b_comp.astype(jnp.bfloat16)
    return jgw


@pytest.mark.parametrize("op", ["dense_matmul", "griffin_matmul",
                                "griffin_matmul_dual"])
@pytest.mark.parametrize("shape", [(4, 128, 96), (33, 96, 4), (1, 64, 8)])
def test_mixed_pair_matches_jax(op, shape):
    """fp32 A with a bf16 weight gives an fp32 C equal (fp32 tolerance) to
    the reference's kernel in interpret mode, which takes the same pair
    and returns A's dtype."""
    m, k, n = shape
    rng = np.random.RandomState(11)
    a = jnp.asarray(rng.randn(m, k), jnp.float32)
    a = a.at[:, :16].set(0)                    # an all-zero K block (dual)
    ta = bridge.array_to_tensor(a)
    if op == "dense_matmul":
        b = jnp.asarray(rng.randn(k, n), jnp.bfloat16)
        want = jax_dense_matmul(a, b, interpret=True)
        got = dense_matmul(ta, bridge.array_to_tensor(b))
    else:
        dual = op.endswith("dual")
        jgw = _mixed_gw(rng, k, n)
        want = jax_griffin_matmul(a, jgw, dual=dual, interpret=True)
        got = griffin_matmul(ta, bridge.to_torch(jgw), dual=dual)
    assert want.dtype == jnp.float32
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(_np(got), _np(want), **_tol("float32"))


BAD_PAIRS = [(torch.bfloat16, torch.float32), (torch.float16, torch.float16),
             (torch.float32, torch.float16), (torch.float64, torch.float64),
             (torch.float64, torch.bfloat16), (torch.float16, torch.bfloat16)]


@pytest.mark.parametrize("op", ["dense_matmul", "griffin_matmul",
                                "sparse_a_matmul"])
@pytest.mark.parametrize("pair", BAD_PAIRS, ids=lambda p: str(p))
def test_every_other_mixed_pair_raises(op, pair):
    da, dw = pair
    a = torch.randn(4, 32).to(da)
    w = torch.randn(32, 32)
    if op == "griffin_matmul":
        gw = preprocess_weights(w.to(dw), block_k=16, block_n=16, unit=8)
        call = lambda: griffin_matmul(a, gw)           # noqa: E731
    else:
        fn = dense_matmul if op == "dense_matmul" else sparse_a_matmul
        call = lambda: fn(a, w.to(dw))                 # noqa: E731
    with pytest.raises(TypeError):
        call()


def test_taken_pairs_are_exactly_the_kernels_codes():
    assert set(k1.PAIR_CODES) == {(torch.float32, torch.float32),
                                  (torch.bfloat16, torch.bfloat16),
                                  (torch.float32, torch.bfloat16)}
    assert sorted(k1.PAIR_CODES.values()) == [0, 1, 2]


@pytest.mark.parametrize("pair", [("float32", "bfloat16"),
                                  ("bfloat16", "float32"),
                                  ("bfloat16", "bfloat16"),
                                  ("float32", "float32")])
def test_plain_route_promotes_as_jnp(pair):
    """``griffin_linear`` without kernels computes ``x @ w`` in the wider
    dtype, as jnp does; equal dtypes are the unpromoted product, bit for
    bit."""
    da, dw = pair
    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(2, 3, 64), JAX_DTYPES[da])
    w = jnp.asarray(rng.randn(64, 24), JAX_DTYPES[dw])
    want = x @ w
    tx, tw = bridge.array_to_tensor(x), bridge.array_to_tensor(w)
    with sparse_execution(use_kernels=False):
        got = griffin_linear(tx, tw)
    assert got.dtype == TORCH_DTYPES[str(want.dtype)]
    if da == dw:
        assert torch.equal(got, tx @ tw)
    else:
        np.testing.assert_allclose(_np(got), _np(want), **_tol("float32"))


@pytest.mark.parametrize("k", [1, 7, 8, 64, 100, 1024, 2048, 4096, 4100,
                               8192, 8200, 16384, 50000])
def test_skinny_split_depends_on_k_alone_and_covers_k_once(k):
    """K1's skinny route cuts K into 8-row chunks and the chunks into S
    consecutive slices: S is a function of K alone (M and N are not among
    its inputs), a power of two up to the cluster size, and the slices
    cover every chunk of K exactly once, in order."""
    assert list(inspect.signature(k1.skinny_slices).parameters) == ["k"]
    s = k1.skinny_slices(k)
    assert s in (1, 2, 4, 8)
    chunks = -(-k // k1.SKINNY_CHUNK)
    ranges = k1.slice_chunks(k, s)
    assert len(ranges) == s
    assert [c for r in ranges for c in r] == list(range(chunks))
    # the least split that leaves a slice no more chunks than threads
    assert s == k1.MAX_SLICES or max(map(len, ranges)) <= k1.SKINNY_THREADS
    assert s == 1 or -(-chunks // (s // 2)) > k1.SKINNY_THREADS


def test_skinny_route_is_chosen_by_n_alone():
    assert k1.skinny_slices(4096) == 4       # xlstm's wi / wf
    assert [k1.route(n) for n in (1, 4, 8, 9, 128256)] == \
        ["skinny"] * 3 + ["wide"] * 2
