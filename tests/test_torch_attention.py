"""The port's prefill attention (repro_torch.models.attention.attention)
against the JAX package's flash-style ``attention`` on numpy-made inputs at
reduced widths (head_dim 16, kv_chunk 16): one KV chunk, three, and seven
with a ragged tail, with and without a sliding window.  Outputs agree
within rtol 1e-4 / atol 1e-5 (summation orders differ).  Within the port,
tiling and padding are exact: rows followed by whole masked chunks, and
rows computed in smaller query tiles, are bit-equal to the plain call; and
the largest tensor any op makes grows linearly in the prompt length."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models.attention import attention as jax_attention
from repro_torch.models import attention as att

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Eager torch ops at these sizes gain nothing from threads, and with
    pytest-xdist's parallel workers OpenMP's pools oversubscribe the cores
    (a test of seconds then takes minutes): one thread for the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(seed, S, H=4, KVH=4, hd=16, B=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, h, hd)).astype(np.float32)
            for h in (H, KVH, KVH)]


@pytest.mark.parametrize("kvh", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("window", [None, 24], ids=["causal", "window24"])
@pytest.mark.parametrize("S", [11, 40, 100],
                         ids=["1chunk", "3chunks", "7chunks-ragged"])
def test_attention_matches_reference(S, window, kvh):
    q, k, v = _qkv(S, S, KVH=kvh)
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, window=window, kv_chunk=16)
    got = att.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=True, window=window,
                        kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_non_causal_attention_matches_reference():
    q, k, v = _qkv(5, 40, KVH=2)
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=False, kv_chunk=16)
    got = att.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=False, kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [None, 9])
def test_padding_is_exact_inside_attention(window):
    """Rows 0:20 of a length-20 input are bit-equal to the same rows of
    that input zero-padded to 64: with kv_chunk 16, chunks 2 and 3 are
    wholly masked for those rows, and chunk 1 differs only in masked
    keys."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(7, 20, KVH=2, B=1))
    pad = [torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 44)) for x in (q, k, v)]
    alone = att.attention(q, k, v, window=window, kv_chunk=16)
    padded = att.attention(*pad, window=window, kv_chunk=16)
    assert torch.equal(padded[:, :20], alone)


@pytest.mark.parametrize("window", [None, 24])
def test_query_tiling_is_exact(monkeypatch, window):
    """Tiles of 4 and 1 query rows give the bits of one whole tile: each
    tile computes only its own rows."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(9, 100, KVH=2))
    whole = att.attention(q, k, v, window=window, kv_chunk=16)
    assert att.q_tile(2, 4, 16, 16) >= 100
    for budget, rows in ((4 * 2 * 4 * 16 * 16 * 4, 4), (1, 1)):
        monkeypatch.setattr(att, "TILE_BYTES", budget)
        assert att.q_tile(2, 4, 16, 16) == rows
        assert torch.equal(att.attention(q, k, v, window=window,
                                         kv_chunk=16), whole)


def test_full_width_tile_is_64_rows_of_256_mib():
    # llama3.2-1b: 32 query heads of 64, a 512-key chunk, batch 1
    rows = att.q_tile(1, 32, 512, 64)
    assert rows == 64
    assert rows * 32 * 512 * 64 * 4 == att.TILE_BYTES == 256 << 20


class _LargestTensor(TorchDispatchMode):
    """Records the largest tensor (in bytes) any op produces."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest,
                                   t.numel() * t.element_size())
        return out


def _largest(S, kv_chunk):
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, S, H=4, KVH=2, B=1))
    with _LargestTensor() as mode:
        att.attention(q, k, v, kv_chunk=kv_chunk)
    return mode.largest


@pytest.mark.parametrize("kv_chunk,budget", [(16, None), (512, 1 << 20)],
                         ids=["chunk16", "chunk512-tiled"])
def test_attention_memory_grows_linearly(monkeypatch, kv_chunk, budget):
    """Doubling S from 1024 to 2048 grows the largest intermediate by at
    most 2.2x (the S x S score matrix would grow 4x), and no intermediate
    exceeds the tile budget; with 512-key chunks and a 1 MiB budget the
    query tiling is what holds it."""
    if budget is not None:
        monkeypatch.setattr(att, "TILE_BYTES", budget)
    small, large = _largest(1024, kv_chunk), _largest(2048, kv_chunk)
    assert large <= 2.2 * small, (small, large)
    assert large <= att.TILE_BYTES
