"""The port's Sparse.A ops (repro_torch.kernels.sparse_a, auto_matmul)
against the JAX package's.

On the CPU ``sparse_a_matmul`` runs its kernel's plain PyTorch version; the
JAX side runs its Pallas kernel in interpret mode, as tests/test_sparse_a.py
does.  Inputs are made with numpy from a seed and handed to both.
Tolerances: fp32 rtol = atol = 1e-5 (summation orders differ), fp32 A
against a bf16 weight too (both sides widen the weight exactly); bf16 one
bf16 ulp of the output (both sides round one fp32 sum).  The activation
metadata is pure data movement and must be bitwise equal to the
reference's traced (jit) metadata.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import auto_matmul as jax_auto_matmul
from repro.kernels import compact_activations as jax_compact
from repro.kernels import preprocess_weights as jax_preprocess
from repro.kernels import sparse_a_matmul as jax_sparse_a_matmul
from repro.sparsity import block_prune as jax_block_prune
from repro_torch import bridge
from repro_torch.kernels import (ActivationMeta, auto_matmul,
                                 compact_activations, launch_counts,
                                 sparse_a_matmul)
from repro_torch.kernels.sparse_a import kernel as k3
from repro_torch.kernels.sparse_a.ref import (compact_activations_ref,
                                              sparse_a_ref)

JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, dtype):
    """fp32: rtol = atol = 1e-5; bf16: within one bf16 ulp of the larger
    magnitude."""
    g, w = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        return
    mag = np.maximum(np.abs(g), np.abs(w))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(g - w) <= ulp), float(np.max(np.abs(g - w) - ulp))


def _sparse_a(rng, m, k, bm, bk, sparsity):
    """Activations with randomly zeroed (bm x bk) blocks (the reference
    test's generator)."""
    a = rng.randn(m, k).astype(np.float32)
    pm, pk = -(-m // bm) * bm, -(-k // bk) * bk
    mask = rng.rand(pm // bm, pk // bk) >= sparsity
    for i in range(pm // bm):
        for j in range(pk // bk):
            if not mask[i, j]:
                a[i * bm:(i + 1) * bm, j * bk:(j + 1) * bk] = 0
    return a


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(x, JAX_DTYPES[dtype])
    return j, bridge.array_to_tensor(np.asarray(j))


# ---------------------------------------------------------------------------
# metadata
# ---------------------------------------------------------------------------

META_CASES = [(16, 64, 16, 16, 0.4), (33, 70, 16, 16, 0.5),
              (4, 2048, 128, 128, 0.5), (32, 300, 8, 32, 0.6),
              (7, 9, 128, 128, 0.0), (40, 48, 16, 16, 1.0)]


@pytest.mark.parametrize("case", META_CASES)
def test_compact_activations_bitwise_vs_traced_reference(case):
    m, k, bm, bk, sp = case
    a = _sparse_a(np.random.RandomState(m + k), m, k, bm, bk, sp)
    statics = {}

    def traced(x):
        meta = jax_compact(x, block_m=bm, block_k=bk)
        statics.update(m=meta.m, k=meta.k, block_m=meta.block_m,
                       block_k=meta.block_k)
        return meta.kidx, meta.cnt

    want = jax.jit(traced)(jnp.asarray(a))
    got = compact_activations(torch.from_numpy(a), block_m=bm, block_k=bk)
    assert dict(m=got.m, k=got.k, block_m=got.block_m,
                block_k=got.block_k) == statics
    for ta, ja in zip((got.kidx, got.cnt), want):
        ja = np.asarray(ja)
        assert ta.dtype == torch.int32 and ja.dtype == np.int32
        np.testing.assert_array_equal(ta.numpy(), ja)


@pytest.mark.parametrize("case", META_CASES)
def test_plain_metadata_bitwise_vs_traced_reference(case):
    """The plain version of the metadata kernel (what a CPU ``a`` runs and
    what the card's kernel is held against) is the reference's traced
    metadata, bit for bit."""
    m, k, bm, bk, sp = case
    a = _sparse_a(np.random.RandomState(m + 2 * k), m, k, bm, bk, sp)
    blocks = {}

    def traced(x):
        meta = jax_compact(x, block_m=bm, block_k=bk)
        blocks.update(block_m=meta.block_m, block_k=meta.block_k)
        return meta.kidx, meta.cnt

    want_kidx, want_cnt = jax.jit(traced)(jnp.asarray(a))
    kidx, cnt = compact_activations_ref(torch.from_numpy(a), **blocks)
    assert kidx.dtype == torch.int32 and cnt.dtype == torch.int32
    np.testing.assert_array_equal(kidx.numpy(), np.asarray(want_kidx))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))


def test_compact_activations_on_cpu_launches_nothing():
    before = launch_counts()
    meta = compact_activations(torch.randn(33, 300), block_m=16,
                               block_k=32)
    assert launch_counts() == before
    assert meta.kidx.shape == (3, 10) and meta.cnt.tolist() == [10] * 3


@pytest.mark.parametrize("case", META_CASES)
def test_compact_activations_live_prefix_vs_concrete_reference(case):
    m, k, bm, bk, sp = case
    a = _sparse_a(np.random.RandomState(m * k), m, k, bm, bk, sp)
    want = jax_compact(jnp.asarray(a), block_m=bm, block_k=bk)
    got = compact_activations(torch.from_numpy(a), block_m=bm, block_k=bk)
    cnt = np.asarray(want.cnt)
    np.testing.assert_array_equal(got.cnt.numpy(), cnt)
    for i, c in enumerate(cnt):
        np.testing.assert_array_equal(got.kidx[i, :c].numpy(),
                                      np.asarray(want.kidx)[i, :c])
    assert got.compaction == 1.0 and got.density == pytest.approx(
        want.density)


# ---------------------------------------------------------------------------
# the GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparsity", [0.0, 0.4, 0.8])
@pytest.mark.parametrize("shape", [(16, 64, 32), (33, 70, 17)])
def test_sparse_a_matmul_matches_jax(dtype, sparsity, shape):
    m, k, n = shape
    rng = np.random.RandomState(0)
    ja, ta = _pair(_sparse_a(rng, m, k, 16, 16, sparsity), dtype)
    jw, tw = _pair(rng.randn(k, n), dtype)
    want = jax_sparse_a_matmul(ja, jw, block_m=16, block_k=16, block_n=16,
                               interpret=True)
    got = sparse_a_matmul(ta, tw, block_m=16, block_k=16, block_n=16)
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == (m, n)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("layout", ["rows", "embed_t"])
@pytest.mark.parametrize("sparsity", [0.0, 0.5])
@pytest.mark.parametrize("shape", [(16, 64, 32), (33, 70, 17), (4, 128, 4)])
def test_sparse_a_matmul_mixed_pair_matches_jax(shape, sparsity, layout):
    """fp32 A with a bf16 weight (row-major, or the strided view embed.T)
    gives an fp32 C equal (fp32 tolerance) to the reference's kernel in
    interpret mode, which takes the same pair and returns A's dtype."""
    m, k, n = shape
    rng = np.random.RandomState(12)
    ja, ta = _pair(_sparse_a(rng, m, k, 16, 16, sparsity), "float32")
    if layout == "rows":
        jw, tw = _pair(rng.randn(k, n), "bfloat16")
    else:
        je, te = _pair(rng.randn(n, k), "bfloat16")
        jw, tw = je.T, te.T
    want = jax_sparse_a_matmul(ja, jw, block_m=16, block_k=16, block_n=16,
                               interpret=True)
    got = sparse_a_matmul(ta, tw, block_m=16, block_k=16, block_n=16)
    assert want.dtype == jnp.float32
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert_close(got, want, "float32")


@pytest.mark.parametrize("pair", [("bfloat16", "float32"),
                                  ("float16", "float16"),
                                  ("float32", "float16")])
def test_sparse_a_matmul_rejects_every_other_mixed_pair(pair):
    a = torch.randn(4, 32).to(getattr(torch, pair[0]))
    w = torch.randn(32, 16).to(getattr(torch, pair[1]))
    with pytest.raises(TypeError):
        sparse_a_matmul(a, w, block_k=16)
    with pytest.raises(TypeError):
        auto_matmul(a, w, a_sparsity=0.9)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_all_zero_activations(dtype):
    _, ta = _pair(np.zeros((16, 32)), dtype)
    _, tw = _pair(np.random.RandomState(3).randn(32, 16), dtype)
    out = sparse_a_matmul(ta, tw, block_m=16, block_k=16, block_n=16)
    assert not bool(out.any())
    meta = compact_activations(ta, block_m=16, block_k=16)
    assert int(meta.cnt.sum()) == 0 and meta.density == 0.0


@pytest.mark.parametrize("drop", ["count", "id"])
def test_ref_honours_hand_cut_metadata(drop):
    """Metadata that leaves a live block out changes the product: the
    plain version reads the metadata, so it catches a kernel that ignores
    ``cnt`` or misreads ``kidx``."""
    rng = np.random.RandomState(6)
    a = torch.from_numpy(_sparse_a(rng, 24, 64, 8, 16, 0.3))
    w = torch.from_numpy(rng.randn(64, 12).astype(np.float32))
    meta = compact_activations(a, block_m=8, block_k=16)
    kidx, cnt = meta.kidx.clone(), meta.cnt.clone()
    # a tile with live and dead blocks
    tile = [i for i, c in enumerate(cnt.tolist()) if 0 < c < 4][0]
    dropped = int(kidx[tile, 0])
    if drop == "count":
        dropped = int(kidx[tile, cnt[tile] - 1])
        cnt[tile] -= 1
    else:
        # list the tile's last dead id in place of its first live one
        kidx[tile, 0] = kidx[tile, -1]
    cut = ActivationMeta(kidx, cnt, meta.m, meta.k, meta.block_m,
                         meta.block_k)
    got = sparse_a_matmul(a, w, meta=cut)
    masked = a.clone()
    masked[tile * 8:(tile + 1) * 8, dropped * 16:(dropped + 1) * 16] = 0
    np.testing.assert_allclose(got.numpy(), (masked @ w).numpy(), rtol=1e-5,
                               atol=1e-5)
    assert not np.allclose(got.numpy(), (a @ w).numpy(), rtol=1e-3)
    np.testing.assert_array_equal(
        got.numpy(), sparse_a_ref(a, w, kidx, cnt, block_m=8,
                                  block_k=16).numpy())


def test_ref_clamp_padded_dead_entries_do_not_unlist():
    """The reference's concrete metadata repeats the last live id in its
    dead entries; the plain version must still count the block once."""
    rng = np.random.RandomState(8)
    a = _sparse_a(rng, 32, 64, 16, 16, 0.5)
    w = rng.randn(64, 8).astype(np.float32)
    meta = jax_compact(jnp.asarray(a), block_m=16, block_k=16)
    got = sparse_a_ref(torch.from_numpy(a), torch.from_numpy(w),
                       torch.from_numpy(np.array(meta.kidx)),
                       torch.from_numpy(np.array(meta.cnt)), block_m=16,
                       block_k=16)
    np.testing.assert_allclose(got.numpy(), a @ w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_a_matmul_reads_strided_embed_t(dtype):
    """The tied unembedding hands the wrapper ``embed.T``, a strided
    view; the result equals the reference on the materialised matrix."""
    rng = np.random.RandomState(5)
    ja, ta = _pair(_sparse_a(rng, 4, 64, 8, 16, 0.5), dtype)
    je, te = _pair(rng.randn(200, 64), dtype)
    assert te.T.stride() == (1, 64)
    want = jax_sparse_a_matmul(ja, je.T, block_k=16, interpret=True)
    got = sparse_a_matmul(ta, te.T, block_k=16)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contig", "device",
                                 "meta"])
def test_sparse_a_matmul_rejects_what_the_kernel_does_not_take(bad):
    a = torch.zeros(4, 32)
    w = torch.zeros(32, 16)
    meta = None
    if bad == "dtype":
        a, w = a.double(), w.double()
    elif bad == "shape":
        w = torch.zeros(31, 16)
    elif bad == "contig":
        a = torch.zeros(32, 4).T
    elif bad == "device":
        a, w = a.to("meta"), w.to("meta")
    else:
        meta = compact_activations(torch.zeros(12, 32), block_m=8,
                                   block_k=16)
    with pytest.raises((ValueError, TypeError)):
        sparse_a_matmul(a, w, block_k=16, meta=meta)


def test_cpu_wrapper_launches_no_kernel():
    before = launch_counts()
    sparse_a_matmul(torch.randn(4, 32), torch.randn(32, 16))
    assert launch_counts() == before


# ---------------------------------------------------------------------------
# the card's routes and split plan (pure functions of shapes and strides)
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(2048, 2048, 128, False), (2048, 512, 128, False),
               (2048, 8192, 128, False), (8192, 2048, 128, False),
               (2048, 128256, 128, True), (2048, 1000, 128, True),
               (256, 300, 32, True), (70, 17, 16, False),
               (8192, 96, 64, False)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_split_plan_is_a_function_of_the_shape_and_covers_each_block_once(
        shape):
    """K3's split depends on (K, N, bk, layout) alone, and its ranks' K
    ranges cover every K block exactly once, each rank at least one."""
    k, n, bk, kmajor = shape
    plan = k3.split_plan(k, n, bk, kmajor)
    k3.split_plan.cache_clear()
    assert k3.split_plan(k, n, bk, kmajor) == plan
    assert 1 <= plan.splits <= 8 and bk % plan.chunk == 0
    assert plan.cols in ((16, 32, 64, 128) if kmajor else (16, 32, 64))
    ranges = plan.ranges(k, bk)
    assert [kb for r in ranges for kb in r] == list(range(-(-k // bk)))
    assert all(len(r) >= 1 for r in ranges)
    # the route never looks at M
    w = torch.zeros(n, k, dtype=torch.bfloat16)
    w = w.T if kmajor else w.T.contiguous()
    routes = {k3.route(torch.zeros(m, k, dtype=torch.bfloat16), w, bk)
              for m in (1, 4, 17, 32, 33)}
    assert len(routes) == 1


def test_split_plan_at_the_serving_shapes():
    """About two blocks per SM: 256 blocks per 32-row pass at every
    llama3.2-1b shape, with 128-column slices and no split at the
    unembedding."""
    assert k3.split_plan(2048, 2048, 128) == (8, 64, 64)
    assert k3.split_plan(2048, 512, 128) == (8, 16, 64)
    assert k3.split_plan(2048, 8192, 128) == (2, 64, 64)
    assert k3.split_plan(8192, 2048, 128) == (8, 64, 64)
    assert k3.split_plan(2048, 128256, 128, True) == (1, 128, 64)
    assert k3.split_plan(2048, 2048, 8) is None


@pytest.mark.parametrize("case", ["rows", "kmajor", "fp32", "block_k",
                                  "odd_k", "strided"])
def test_route_by_dtype_layout_and_alignment(case):
    k, n, bk, dtype = 2048, 512, 128, torch.bfloat16
    if case == "fp32":
        dtype = torch.float32
    elif case == "block_k":
        bk = 8
    elif case == "odd_k":
        k = 2044
    a = torch.zeros(4, k, dtype=dtype)
    w = torch.zeros(k, n, dtype=dtype)
    if case == "kmajor":
        w = torch.zeros(n, k, dtype=dtype).T
    elif case == "strided":
        w = torch.zeros(k, 2 * n, dtype=dtype)[:, ::2]
    path, plan = k3.route(a, w, bk)
    want = {"rows": k3.ROWS, "kmajor": k3.KMAJOR}.get(case, k3.CORE)
    assert path == want and (plan is None) == (want == k3.CORE)


# ---------------------------------------------------------------------------
# auto_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["dense", "A", "B", "AB"])
def test_auto_matmul_matches_jax(mode, dtype):
    rng = np.random.RandomState(7)
    m, k, n = 24, 128, 96
    a_sp = 0.5 if mode in ("A", "AB") else 0.0
    b_sp = 0.6 if mode in ("B", "AB") else 0.0
    a = _sparse_a(rng, m, k, 8, 16, a_sp)
    w = rng.randn(k, n).astype(np.float32)
    gw = None
    if b_sp:
        w = np.array(jax_block_prune(jnp.asarray(w), b_sp, block_k=16,
                                     unit=8))
        gw = jax_preprocess(w, block_k=16, block_n=32, unit=8)
        gw.b_comp = gw.b_comp.astype(JAX_DTYPES[dtype])
    ja, ta = _pair(a, dtype)
    jw, tw = _pair(w, dtype)
    want = jax_auto_matmul(ja, jw, gw, a_sparsity=a_sp, b_sparsity=b_sp,
                           interpret=True)
    got = auto_matmul(ta, tw, None if gw is None else bridge.to_torch(gw),
                      a_sparsity=a_sp, b_sparsity=b_sp)
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == (m, n)
    assert_close(got, want, dtype)
