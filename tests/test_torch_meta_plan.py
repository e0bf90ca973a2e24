"""The plan of the card's activation-metadata kernel (``sparse_a_meta`` in
``csrc/sparse_a.cu``): each M tile is a cluster of ``meta_slices`` blocks,
rank r ORing the whole K blocks ``meta_ranges(kt, S)[r]`` into its own
flags and writing them into rank 0's.

A numpy model of that split, run unit by unit as the kernel's threads run
it (16-byte units, the value bits of each element: -0 is zero, NaN and
denormals are live), with the per-rank flags written into rank 0's in rank
order, must equal the plain metadata (``compact_activations_ref``) and the
JAX package's traced ``compact_activations`` bit for bit.  XLA on the CPU
reads denormals as zero, so the JAX side is given A with its one denormal
zeroed (the port keeps a denormal's block live, as the card's kernel
does).  The kernel itself runs only on the card
(``tests/test_torch_gpu.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import compact_activations as jax_compact
from repro_torch.kernels.sparse_a import kernel as k3
from repro_torch.kernels.sparse_a.ref import compact_activations_ref

ROWS = (1, 4, 33, 128, 300)
KS = (2048, 4100, 8192)
BLOCK_KS = (64, 128)
ITEMSIZE = {"float32": 4, "bfloat16": 2}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BLOCK_M = 128


@pytest.mark.parametrize("cap", [8, 16])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("block_k", BLOCK_KS)
@pytest.mark.parametrize("k", KS + (300, 64))
@pytest.mark.parametrize("rows", ROWS)
def test_meta_slices_is_a_power_of_two_that_owns_whole_blocks(
        rows, k, block_k, itemsize, cap):
    s = k3.meta_slices(rows, k, block_k, itemsize, cap)
    kt = -(-k // block_k)
    units = rows * -(-k * itemsize // k3.META_UNIT)
    assert s & (s - 1) == 0 and 1 <= s <= min(cap, kt)
    # one block under the split threshold; above it the largest split that
    # leaves every thread a unit
    assert s == 1 or units // s >= k3.META_THREADS
    if rows * k * itemsize < k3.META_MIN_SPLIT_BYTES:
        assert s == 1
    else:
        assert 2 * s > min(cap, kt) or units // (2 * s) < k3.META_THREADS
    assert s == k3.meta_slices(rows, k, block_k, itemsize, cap)
    ranges = k3.meta_ranges(kt, s)
    owned = [j for r in ranges for j in r]
    assert owned == list(range(kt))                 # each block once
    assert all(len(r) >= 1 for r in ranges)


def test_meta_slices_at_the_serving_shapes():
    """Decode's slabs (4 x 2048, xlstm's 4 x 4096, fp32 too) on one block;
    a 32 x 2048 bf16 bucket (128 KB) on 8; 32 x 4096 and a full 128 x 8192
    tile on 16 blocks (the portable 8 with that cap)."""
    assert k3.MAX_META_SLICES == 16
    assert k3.META_MIN_SPLIT_BYTES == 128 << 10
    assert k3.meta_slices(4, 2048, 128, 2) == 1
    assert k3.meta_slices(4, 4096, 128, 2) == 1
    assert k3.meta_slices(4, 4096, 128, 4) == 1
    assert k3.meta_slices(8, 4096, 128, 2) == 1
    assert k3.meta_slices(32, 2048, 128, 2) == 8
    assert k3.meta_slices(32, 4096, 128, 2) == 16
    assert k3.meta_slices(32, 4096, 128, 2, cap=8) == 8
    assert k3.meta_slices(128, 8192, 128, 2) == 16
    assert k3.meta_slices(128, 8192, 128, 2, cap=8) == 8


def value_bits(a: np.ndarray, dtype: str) -> np.ndarray:
    """Per element the bits that make it nonzero, as the kernel reads
    them: the sign masked off (fp32 as uint32, bf16 as the top half)."""
    if dtype == "float32":
        return a.view(np.uint32) & np.uint32(0x7fffffff)
    return (a.view(np.uint32) >> np.uint32(16)) & np.uint32(0x7fff)


def split_model(a: np.ndarray, dtype: str, block_m: int, block_k: int,
                slices: int):
    """(kidx, cnt) of ``a`` (fp32 values, rounded to ``dtype``) through the
    cluster split: per tile, each rank ORs its 16-byte units (elements
    where K or bk is not a whole number of them) of the tile's rows into
    its own flags (-1 where it owns nothing, so a write or read
    outside its blocks shows), writes its own blocks into rank 0's flags,
    rank by rank, and rank 0 writes live ids then dead ids ascending."""
    m, k = a.shape
    per = 16 // ITEMSIZE[dtype]                    # elements per unit
    if k % per or block_k % per:                   # the scalar path
        per = 1
    bits = value_bits(a, dtype)
    kt = -(-k // block_k)
    mt = -(-m // block_m)
    ranges = k3.meta_ranges(kt, slices)
    kidx = np.zeros((mt, kt), np.int32)
    cnt = np.zeros(mt, np.int32)
    for tile in range(mt):
        slab = bits[tile * block_m:(tile + 1) * block_m]
        merged = np.full(kt, -1)
        for r in ranges:
            live = np.full(kt, -1)
            live[r.start:r.stop] = 0
            k0, k1 = r.start * block_k, min(r.stop * block_k, k)
            units = slab[:, k0:k1].reshape(len(slab), -1, per)
            hit = (units != 0).any(axis=(0, 2))
            ids = (k0 + np.arange(units.shape[1]) * per) // block_k
            assert (live[ids] == 0).all(), "a rank wrote outside its blocks"
            np.maximum.at(live, ids[hit], 1)
            assert (merged[r.start:r.stop] == -1).all(), "a block written twice"
            merged[r.start:r.stop] = live[r.start:r.stop]
        assert (merged >= 0).all(), "a block no rank wrote"
        on = np.flatnonzero(merged == 1)
        cnt[tile] = len(on)
        kidx[tile] = np.concatenate([on, np.flatnonzero(merged == 0)])
    return kidx, cnt


def _activations(rng, m, k, block_k, dtype):
    """Random A with some (tile, K block) pairs zero, a -0 block, a block
    live only through one NaN and one live only through a denormal (fp32)
    or the smallest bf16 denormal, rounded to ``dtype`` and back; and the
    denormal's index."""
    a = rng.standard_normal((m, k)).astype(np.float32)
    kt = -(-k // block_k)
    for i in range(-(-m // BLOCK_M)):
        for j in range(kt):
            if rng.random() < 0.4:
                a[i * BLOCK_M:(i + 1) * BLOCK_M,
                  j * block_k:(j + 1) * block_k] = 0
    j = rng.integers(kt)
    a[:, j * block_k:(j + 1) * block_k] = -0.0
    j = (j + 1) % kt
    a[:, j * block_k:(j + 1) * block_k] = 0
    a[-1, j * block_k] = np.nan
    j = (j + 1) % kt
    a[:, j * block_k:(j + 1) * block_k] = 0
    tiny = (0, min(j * block_k + 3, k - 1))
    a[tiny] = np.float32(1e-40 if dtype == "float32" else 9.2e-41)
    if dtype == "bfloat16":
        a = torch.from_numpy(a).bfloat16().float().numpy()
    return a, tiny


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_k", BLOCK_KS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("m", ROWS)
def test_split_model_equals_plain_and_traced_metadata(m, k, block_k, dtype):
    rng = np.random.default_rng(m * 7 + k + block_k)
    a, tiny = _activations(rng, m, k, block_k, dtype)
    bm = min(BLOCK_M, -(-m // 8) * 8)          # the wrappers' clamp
    slices = k3.meta_slices(min(m, bm), k, block_k, ITEMSIZE[dtype],
                            cap=16)
    kidx, cnt = split_model(a, dtype, bm, block_k, slices)
    ref_kidx, ref_cnt = compact_activations_ref(
        torch.from_numpy(a).to(TORCH_DTYPES[dtype]), block_m=bm,
        block_k=block_k)
    np.testing.assert_array_equal(kidx, ref_kidx.numpy())
    np.testing.assert_array_equal(cnt, ref_cnt.numpy())

    def traced(x):
        meta = jax_compact(x, block_m=bm, block_k=block_k)
        return meta.kidx, meta.cnt

    flushed = a.copy()
    flushed[tiny] = 0
    kidx, cnt = split_model(flushed, dtype, bm, block_k, slices)
    want_kidx, want_cnt = jax.jit(traced)(jnp.asarray(flushed,
                                                      JAX_DTYPES[dtype]))
    np.testing.assert_array_equal(kidx, np.asarray(want_kidx))
    np.testing.assert_array_equal(cnt, np.asarray(want_cnt))


@pytest.mark.parametrize("slices", [1, 2, 4, 8, 16])
def test_split_model_bits_do_not_depend_on_the_split(slices):
    """Every split gives the same metadata: the flags are a pure function
    of A."""
    rng = np.random.default_rng(slices)
    a, _ = _activations(rng, 128, 8192, 128, "bfloat16")
    base = split_model(a, "bfloat16", BLOCK_M, 128, 1)
    got = split_model(a, "bfloat16", BLOCK_M, 128, slices)
    for g, b in zip(got, base):
        np.testing.assert_array_equal(g, b)
