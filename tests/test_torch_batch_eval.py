"""The batch_eval wrapper and its plain PyTorch version on the CPU, held
against the JAX package's ``jax.vmap`` twin (``repro.kernels.batch_eval``)
and the numpy engine on the same masks: equal integer cycles; and the
kernel's plan: the route of each config, the chain route's tiles a block,
and a lane-by-lane model of the scan route (``scan_cycles_model``) held
against both.  The kernel itself (``csrc/batch_eval.cu``) runs only
on the card (``tests/test_torch_gpu.py``)."""
from typing import Sequence

import numpy as np
import pytest
import torch

from repro.core.scheduler import schedule as ref_schedule
from repro.kernels.batch_eval import schedule_cycles as jax_schedule_cycles
from repro_torch.core.scheduler import (schedule, schedule_batched,
                                        shuffle_lanes)
from repro_torch.kernels.batch_eval import MAX_UNROLL, schedule_cycles
from repro_torch.kernels.batch_eval import kernel
from repro_torch.kernels.batch_eval.ref import schedule_cycles_ref

# tests/test_batched_parity.py's jax-backend configs, then a ring of two PE
# groups (G = 2, d3 = 1) and the Figure 8 sweep's other shallow configs;
# SparTen's 128-deep window has a test of its own (the jax twin takes ~10 s
# to trace and compile it per shape)
CONFIGS = [(0, 0, 0, False), (2, 1, 0, False), (4, 0, 2, True),
           (2, 1, 1, True), (2, 0, 0, True), (2, 1, 0, True)]
SPARTEN = (127, 0, 0, False)
CASES = {
    "ref-8x3": lambda: np.random.default_rng(11).random((6, 19, 8, 3)) < 0.3,
    "fig8-16x1": lambda: np.random.default_rng(4).random(
        (12, 30, 16, 1)) < np.linspace(0.05, 0.9, 12)[:, None, None, None],
    "ring-16x2": lambda: np.random.default_rng(5).random((9, 21, 16, 2))
    < 0.45,
    "T1": lambda: np.random.default_rng(6).random((7, 1, 16, 2)) < 0.5,
    "empty-chunks": lambda: np.zeros((3, 10, 16, 1), dtype=bool),
}


@pytest.mark.parametrize("cfg", CONFIGS, ids=str)
@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_equals_jax_twin_and_numpy_engine(case, cfg):
    mask = CASES[case]()
    d1, d2, d3, sh = cfg
    got = schedule_cycles(mask, d1, d2, d3, shuffle=sh, device="cpu")
    assert got.dtype == np.int64 and got.shape == (mask.shape[0],)
    np.testing.assert_array_equal(
        got, jax_schedule_cycles(mask, d1, d2, d3, shuffle=sh))
    np.testing.assert_array_equal(
        got, ref_schedule(mask, d1, d2, d3, shuffle=sh).cycles)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_with_sparten_window(case):
    """d1 = 127: a 128-chunk window, capped at T.  Against the jax twin on
    the Figure 8-like mask, against the numpy engine on every mask."""
    mask = CASES[case]()
    got = schedule_cycles(mask, *SPARTEN[:3], device="cpu")
    np.testing.assert_array_equal(got, ref_schedule(mask, *SPARTEN[:3]).cycles)
    if case == "fig8-16x1":
        np.testing.assert_array_equal(
            got, jax_schedule_cycles(mask, *SPARTEN[:3]))


def test_empty_chunks_only_travel():
    """No placement: every tile pays ceil(T / (1 + d1)) cycles."""
    out = schedule_cycles(np.zeros((4, 10, 16, 1), bool), 2, 1, 0,
                          device="cpu")
    np.testing.assert_array_equal(out, [4, 4, 4, 4])


@pytest.mark.parametrize("shape", [(3, 0, 8, 1), (0, 5, 8, 1), (0, 0, 16, 2)])
def test_empty_streams_give_zeros(shape):
    mask = np.zeros(shape, dtype=bool)
    got = schedule_cycles(mask, 2, 1, 0, device="cpu")
    np.testing.assert_array_equal(got, np.zeros(shape[0], np.int64))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jax_schedule_cycles(mask, 2, 1, 0))
    np.testing.assert_array_equal(got, schedule(mask, 2, 1, 0).cycles)


def test_plain_version_on_tensors_is_batched_over_tiles():
    """Every tile's count is independent of the tiles beside it: finished
    tiles are frozen while the others run on."""
    mask = np.random.default_rng(8).random((40, 25, 8, 2)) < \
        np.linspace(0.02, 0.9, 40)[:, None, None, None]
    t = torch.from_numpy(mask)
    full = schedule_cycles_ref(t, 2, 1, 1)
    for sl in (slice(0, 1), slice(5, 23), slice(39, 40)):
        torch.testing.assert_close(
            schedule_cycles_ref(t[sl].contiguous(), 2, 1, 1), full[sl])
    np.testing.assert_array_equal(full.numpy(),
                                  schedule(mask, 2, 1, 1).cycles)


def test_torch_backend_raises_as_the_jax_backend_does():
    mask = np.zeros((2, 4, 8, 1), dtype=bool)
    with pytest.raises(ValueError, match="one shared config"):
        schedule_batched(mask, [1, 2], 0, 0, backend="torch")
    with pytest.raises(ValueError, match="cycles-only"):
        schedule_batched(mask, 1, 0, 0, record=True, backend="torch")
    with pytest.raises(ValueError, match="cycles-only"):
        schedule_batched(mask, 1, 0, 0, t_len=[2, 3], backend="torch")
    with pytest.raises(ValueError, match="unknown backend"):
        schedule_batched(mask, 1, 0, 0, backend="jax")
    with pytest.raises(ValueError):
        schedule_batched(mask[0], 1, 0, 0, backend="torch")


def test_wrapper_limits():
    assert MAX_UNROLL == 512
    mask = np.zeros((2, 4, 16, 2), dtype=bool)
    # (d1 + 1)(1 + d2)(1 + d3) past the reference's unroll budget
    for cfg in ((127, 1, 2), (512, 0, 0)):
        with pytest.raises(ValueError, match="unrolls past"):
            schedule_cycles(mask, *cfg, device="cpu")
        with pytest.raises(ValueError, match="unrolls past"):
            jax_schedule_cycles(mask, *cfg)
    schedule_cycles(mask, 127, 1, 1, device="cpu")     # 512 is allowed
    # port only: a chunk's K0 x G bits must fit one 64-bit word
    with pytest.raises(ValueError, match="64-bit word"):
        schedule_cycles(np.zeros((2, 4, 16, 5), dtype=bool), 1, 0, 0,
                        device="cpu")
    schedule_cycles(np.zeros((2, 4, 16, 4), dtype=bool), 1, 0, 0,
                    device="cpu")
    with pytest.raises(ValueError, match="tiles, T, K0, G"):
        schedule_cycles(np.zeros((4, 16, 2), dtype=bool), 1, 0, 0,
                        device="cpu")


def test_default_device_is_the_card():
    """The wrapper runs on the card unless asked for the CPU: without one
    it raises rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernel tests run in "
                    "tests/test_torch_gpu.py")
    mask = np.random.default_rng(0).random((3, 5, 8, 1)) < 0.5
    with pytest.raises(RuntimeError, match="no CUDA device"):
        schedule_cycles(mask, 1, 0, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        schedule_batched(mask, 1, 0, 0, backend="torch")


# ---------------------------------------------------------------------------
# the kernel's routes
# ---------------------------------------------------------------------------

# the Figure 8 sweep's (d1, d2, d3) configs and the route each takes
FIG8_ROUTES = {(127, 0, 0): "scan", (2, 0, 0): "scan",
               (4, 0, 1): "chain", (2, 5, 0): "chain", (2, 1, 0): "chain",
               (2, 0, 1): "chain", (2, 1, 1): "chain", (8, 0, 1): "chain"}


def test_route_by_config():
    for cfg, want in FIG8_ROUTES.items():
        assert kernel.route(*cfg) == want, cfg
    for cfg in ((0, 0, 0), (31, 0, 0), (32, 0, 0), (500, 0, 0)):
        assert kernel.route(*cfg) == "scan"
    for cfg in ((0, 1, 0), (0, 0, 1), (127, 3, 0), (127, 0, 2)):
        assert kernel.route(*cfg) == "chain"


@pytest.mark.parametrize("tiles", [1, 7, 64, 132, 133, 256, 568, 4224,
                                   5000])
def test_chain_tiles_spread_a_stream_over_the_sms(tiles):
    per = kernel.chain_tiles(tiles)
    assert per & (per - 1) == 0 and 1 <= per <= kernel.CHAIN_MAX_TILES
    blocks = -(-tiles // per)
    assert blocks <= kernel.SMS or per == kernel.CHAIN_MAX_TILES
    assert per == 1 or -(-tiles // (per // 2)) > kernel.SMS
    assert kernel.chain_tiles(256) == 2


def test_pack_words_lays_bits_out_as_the_kernel():
    """Bit g * K0 + l of a chunk's word is lane l of PE group g."""
    mask = np.zeros((1, 2, 16, 4), bool)
    mask[0, 0, 3, 2] = True
    mask[0, 1, 15, 3] = mask[0, 1, 0, 0] = True
    np.testing.assert_array_equal(
        pack_words(mask),
        np.array([[1 << (2 * 16 + 3), (1 << 63) | 1]], np.uint64))


def pack_words(mask: np.ndarray) -> np.ndarray:
    """(tiles, T, K0, G) bool -> (tiles, T) uint64, chunk bits g * K0 + l as
    the kernel packs them."""
    tiles, T, K0, G = mask.shape
    bits = np.transpose(mask, (0, 1, 3, 2)).reshape(tiles, T, K0 * G)
    weights = np.left_shift(np.uint64(1), np.arange(K0 * G, dtype=np.uint64))
    return (bits.astype(np.uint64) * weights).sum(axis=2, dtype=np.uint64)


def scan_cycles_model(words: Sequence[int], d1: int) -> int:
    """The scan route's executed cycles for one tile's packed words, lane by
    lane as the kernel runs them: per cycle, lane l holds the P = ceil(len
    / 32) window words [f + l P, f + (l + 1) P) (capped at the window's
    end), ORs them, takes the exclusive prefix across lanes from a 5-step
    shuffle-up scan, and keeps in each word c & (the OR before it); the
    front is the first word left nonempty (the lowest lane holding one),
    else the window's end.  Raises if a cycle clears nothing while words
    remain (a scan that does not converge)."""
    w = [int(x) for x in words]
    T, win = len(w), d1 + 1
    nz = sum(1 for x in w if x)
    f = cycles = 0
    while nz > 0:
        if cycles > 2 * T + 1:
            raise RuntimeError("the scan route does not converge")
        end = min(f + win, T)
        P = -(-(end - f) // kernel.LANES)
        spans = [(min(f + lane * P, end), min(f + (lane + 1) * P, end))
                 for lane in range(kernel.LANES)]
        local = []
        for b, e in spans:
            acc = 0
            for t in range(b, e):
                acc |= w[t]
            local.append(acc)
        inc, off = list(local), 1
        while off < kernel.LANES:                       # __shfl_up_sync steps
            inc = [inc[i] | (inc[i - off] if i >= off else 0)
                   for i in range(kernel.LANES)]
            off *= 2
        before = [0] + inc[:-1]                  # exclusive
        emptied, first = 0, end
        for lane, (b, e) in enumerate(spans):
            acc = before[lane]
            for t in range(b, e):
                c = w[t]
                kept = c & acc
                acc |= c
                if kept != c:
                    w[t] = kept
                    emptied += kept == 0
                if kept and first == end:
                    first = t
        nz -= emptied
        cycles += 1
        f = first
    return cycles + (T - f + win - 1) // win


def _scan_masks(d1):
    """Masks around the window: T below, at and above 1 + d1, and longer;
    a tile with no bits, a tile with empty chunks; K0 x G of 16 x 1, 8 x 3
    and 16 x 4 (a full 64-bit word)."""
    rng = np.random.default_rng(d1)
    win = d1 + 1
    masks = []
    for i, T in enumerate(sorted({1, max(win - 1, 1), win, win + 1,
                                  2 * win + 3})):
        shape = ((16, 1), (8, 3), (16, 4))[i % 3]
        mask = rng.random((4, T) + shape) < \
            np.array([0.0, 0.05, 0.3, 0.8])[:, None, None, None]
        mask[1, ::3] = False
        masks.append(mask)
    return masks


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("d1", [0, 2, 31, 32, 127])
def test_scan_route_model_equals_numpy_engine_and_jax_twin(d1, shuffle):
    """The scan route (d2 = d3 = 0) run lane by lane gives the numpy
    engine's cycles on every mask and the JAX twin's on the deepest one
    (the twin compiles once a shape)."""
    masks = _scan_masks(d1)
    for mask in masks:
        host = shuffle_lanes(mask, 1, 2) if shuffle else mask
        got = [scan_cycles_model(w, d1)
               for w in pack_words(host)]
        want = ref_schedule(mask, d1, 0, 0, shuffle=shuffle).cycles
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, schedule(mask, d1, 0, 0, shuffle=shuffle).cycles)
    mask = masks[-2]                             # T above the window
    got = [scan_cycles_model(w, d1) for w in pack_words(
        shuffle_lanes(mask, 1, 2) if shuffle else mask)]
    np.testing.assert_array_equal(
        got, jax_schedule_cycles(mask, d1, 0, 0, shuffle=shuffle))


def test_scan_model_is_exclusive():
    """Chunk t keeps only the bits an older chunk of the window already
    holds: two chunks of one bit drain in two cycles, the second chunk
    waiting one; an all-zero window costs only its travel."""
    words = [0b1, 0b1, 0, 0]
    assert scan_cycles_model(words, 3) == 2
    assert scan_cycles_model([0b1, 0b10, 0, 0], 3) == 1
    assert scan_cycles_model([0, 0, 0, 0, 0], 1) == 3
