"""The batch_eval wrapper and its plain PyTorch version on the CPU, held
against the JAX package's ``jax.vmap`` twin (``repro.kernels.batch_eval``)
and the numpy engine on the same masks: equal integer cycles.  The kernel
itself (``csrc/batch_eval.cu``) runs only on the card
(``tests/test_torch_gpu.py``)."""
import numpy as np
import pytest
import torch

from repro.core.scheduler import schedule as ref_schedule
from repro.kernels.batch_eval import schedule_cycles as jax_schedule_cycles
from repro_torch.core.scheduler import schedule, schedule_batched
from repro_torch.kernels.batch_eval import MAX_UNROLL, schedule_cycles
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
