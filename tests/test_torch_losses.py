"""The port's losses and gradients against the JAX package's, on the CPU:
``models.losses.chunked_cross_entropy``, the flash-attention backward
(``models.attention._FlashAttention``) and every ported family's ``loss``
with every gradient leaf, on the reference's own weights bridged through
numpy.

Tolerances: fp32 cross entropy within 1e-5 relative (value) and 1e-5
relative L2 (gradients); the flash backward within 1e-5 relative L2 of
``jax.grad`` through the reference's ``custom_vjp`` (the forward's sums are
``tree_sum`` trees, the backward's matmuls, the reference's einsums: three
orders); a family's fp32 loss within 1e-5 relative and each gradient leaf
within 1e-4 relative L2, remat on and off.  The families' bf16 dtype-flow
cases are in tests/test_torch_train.py (its reference runs spread the
two files' time evenly over the test workers).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.attention import attention as jax_attention
from repro.models.losses import chunked_cross_entropy as jax_ce
from repro_torch import bridge
from repro_torch.checkpoint import keyed_leaves
from repro_torch.configs import get_config
from repro_torch.kernels.griffin_spmm.ops import preprocess_weights
from repro_torch.models import build_model
from repro_torch.models.attention import attention
from repro_torch.models.common import griffin_linear, sparse_execution
from repro_torch.models.losses import chunked_cross_entropy
from repro_torch.runtime.train import value_and_grad

FAMILIES = {"dense": "llama3.2-1b", "moe": "mixtral-8x7b",
            "ssm": "xlstm-1.3b", "hybrid": "recurrentgemma-9b",
            "audio": "whisper-large-v3"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Eager torch ops at these sizes gain nothing from threads, and with
    pytest-xdist's parallel workers OpenMP's pools oversubscribe the cores
    (a test of seconds then takes minutes): one thread for the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# chunked cross entropy
# ---------------------------------------------------------------------------

def _ce_case(S=10, D=8, V=32):
    rng = np.random.RandomState(0)
    h = rng.randn(2, S, D).astype(np.float32)
    u = rng.randn(D, V).astype(np.float32)
    lab = rng.randint(0, V, (2, S)).astype(np.int32)
    lab[0, :3] = -1                    # masked positions
    lab[1, -1] = -1
    return h, u, lab


@pytest.mark.parametrize("chunk", [3, 5, 10, 16])
def test_chunked_ce_matches_reference_and_unchunked(chunk):
    """S = 10 in chunks of 3 (ragged: padded to 12), 5, 10 and 16 (one
    chunk): the value against the reference's and the unchunked loss, and
    the gradients with respect to hidden and unembed against
    ``jax.grad``."""
    h, u, lab = _ce_case()
    jl, (jgh, jgu) = jax.value_and_grad(jax_ce, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(u), jnp.asarray(lab), chunk)
    th, tu = _t(h).requires_grad_(), _t(u).requires_grad_()
    tl = chunked_cross_entropy(th, tu, _t(lab), chunk)
    tgh, tgu = torch.autograd.grad(tl, (th, tu))
    tl = tl.detach()
    full = torch.log_softmax(_t(h) @ _t(u), dim=-1)
    keep = _t(lab) >= 0
    gold = full.gather(-1, _t(lab).long().clamp(min=0)[..., None])[..., 0]
    unchunked = -(gold * keep).sum() / keep.sum()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tl), float(unchunked), rtol=1e-5)
    assert rel_l2(tgh.numpy(), jgh) < 1e-5
    assert rel_l2(tgu.numpy(), jgu) < 1e-5
    # masked positions take no gradient
    assert torch.equal(tgh[0, :3], torch.zeros_like(tgh[0, :3]))


def test_chunked_ce_through_a_tied_unembedding():
    """The tied head passes ``embed.T``, a strided view: its gradient lands
    in the embedding."""
    h, u, lab = _ce_case()
    embed = _t(u.T.copy()).requires_grad_()
    tl = chunked_cross_entropy(_t(h), embed.T, _t(lab), 4)
    g, = torch.autograd.grad(tl, embed)
    jg = jax.grad(jax_ce, argnums=1)(jnp.asarray(h), jnp.asarray(u),
                                     jnp.asarray(lab), 4)
    assert rel_l2(g.numpy(), np.asarray(jg).T) < 1e-5


def test_chunked_ce_all_masked_is_zero():
    h, u, lab = _ce_case()
    lab[:] = -1
    assert float(chunked_cross_entropy(_t(h), _t(u), _t(lab), 4)) == 0.0


# ---------------------------------------------------------------------------
# flash-attention backward
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, KVH, causal, window, kv_chunk)
FLASH = {
    "causal": (2, 40, 40, 4, 4, True, None, 16),
    "windowed": (1, 48, 48, 4, 2, True, 7, 16),
    "non_causal": (2, 24, 24, 4, 4, False, None, 8),
    "gqa": (2, 33, 33, 8, 2, True, None, 16),
    "ragged_sk": (2, 9, 23, 4, 2, False, None, 8),
    "one_chunk": (1, 12, 12, 4, 1, True, None, 64),
}


def _flash_inputs(case, dtype=np.float32):
    B, Sq, Sk, H, KVH, causal, window, chunk = FLASH[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    q = rng.randn(B, Sq, H, 16).astype(dtype)
    k = rng.randn(B, Sk, KVH, 16).astype(dtype)
    v = rng.randn(B, Sk, KVH, 16).astype(dtype)
    do = rng.randn(B, Sq, H, 16).astype(dtype)
    return (q, k, v, do), dict(causal=causal, window=window, kv_chunk=chunk)


@pytest.mark.parametrize("case", sorted(FLASH))
def test_flash_backward_matches_reference(case):
    (q, k, v, do), kw = _flash_inputs(case)

    def jf(q, k, v):
        return (jax_attention(q, k, v, **kw) * do).sum()

    jgrads = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = attention(tq, tk, tv, **kw)
    tgrads = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    for name, got, want in zip("qkv", tgrads, jgrads):
        assert rel_l2(got.numpy(), want) < 1e-5, name


@pytest.mark.parametrize("case", sorted(FLASH))
def test_flash_forward_bits_do_not_depend_on_grad(case):
    """The serve paths (no grad) and training run the same forward: its
    output is bit-equal with and without ``requires_grad``, in fp32 and
    bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        (q, k, v, _), kw = _flash_inputs(case)
        q, k, v = (_t(x).to(dtype) for x in (q, k, v))
        plain = attention(q, k, v, **kw)
        graded = attention(q.requires_grad_(), k, v, **kw)
        assert graded.requires_grad
        assert graded.dtype == plain.dtype == dtype
        assert torch.equal(graded.detach(), plain)


def test_flash_backward_stores_nothing_quadratic():
    """S = 256 in chunks of 32: no tensor saved for the backward holds
    (Sq x Sk) entries of a head; everything saved is O(S * hd)."""
    B, S, H, hd = 1, 256, 4, 16
    q, k, v = (torch.randn(B, S, h, hd, requires_grad=True)
               for h in (H, 2, 2))
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = attention(q, k, v, causal=True, kv_chunk=32)
    out.sum().backward()
    assert saved and max(saved) <= B * S * H * hd < S * S
    assert q.grad.shape == q.shape and k.grad.shape == k.shape


def test_flash_backward_in_bf16_keeps_input_dtypes():
    """bf16 q, k, v get bf16 gradients (the reference's casts back), within
    2e-2 relative L2 of the fp32 backward on the same values."""
    (q, k, v, do), kw = _flash_inputs("gqa")
    q, k, v, do = (_t(x).bfloat16() for x in (q, k, v, do))
    leaves16 = [x.clone().requires_grad_() for x in (q, k, v)]
    leaves32 = [x.float().requires_grad_() for x in (q, k, v)]
    g16 = torch.autograd.grad(attention(*leaves16, **kw), leaves16, do)
    g32 = torch.autograd.grad(attention(*leaves32, **kw), leaves32,
                              do.float())
    for a, b in zip(g16, g32):
        assert a.dtype == torch.bfloat16
        assert rel_l2(a.float().numpy(), b.numpy()) < 2e-2


# ---------------------------------------------------------------------------
# every family's loss and gradient
# ---------------------------------------------------------------------------

def _batch(cfg, seed=0, B=2, S=16):
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(1, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    batch["labels"][0, :2] = -1
    if cfg.is_encdec:
        batch["frames"] = rng.randn(B, cfg.enc_frames,
                                    cfg.d_model).astype(np.float32)
    return batch


_REFERENCE = {}


def reference_loss(family, dtype):
    """The reference's (loss, gradient tree as torch, its params as torch,
    the batch) at ``reduced()`` in ``dtype``, computed once a module."""
    key = (family, dtype)
    if key not in _REFERENCE:
        jcfg = dataclasses.replace(jax_get_config(FAMILIES[family]).reduced(),
                                   dtype=dtype)
        japi = jax_build_model(jcfg)
        jp = japi.init(jax.random.PRNGKey(0))
        batch = _batch(jcfg)
        jl, jg = jax.jit(jax.value_and_grad(japi.loss))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
        _REFERENCE[key] = (float(jl),
                           bridge.to_torch(jax.tree.map(np.asarray, jg)),
                           bridge.to_torch(jax.tree.map(np.asarray, jp)),
                           batch)
    return _REFERENCE[key]


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_loss_and_grads_match_reference(family, remat):
    jl, jg, params, batch = reference_loss(family, "float32")
    cfg = dataclasses.replace(get_config(FAMILIES[family]).reduced(),
                              remat=remat)
    api = build_model(cfg, device="cpu")
    tl, tg = value_and_grad(api.loss, params, bridge.to_torch(batch))
    assert abs(float(tl) - jl) <= 1e-5 * abs(jl)
    got, want = list(keyed_leaves(tg)), list(keyed_leaves(jg))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype == torch.float32, path
        assert rel_l2(a.numpy(), b.numpy()) <= 1e-4, path


# ---------------------------------------------------------------------------
# the kernels refuse a gradient
# ---------------------------------------------------------------------------

def test_kernel_routes_refuse_a_gradient():
    """Inside a kernel scope (dense kernel) and on compacted weights
    (Sparse.B) ``griffin_linear`` raises where a gradient is wanted, and
    runs where none is (grad mode off); the plain route differentiates."""
    x = torch.randn(4, 32)
    w = torch.randn(32, 16)
    gw = preprocess_weights(w, block_k=16, block_n=16)
    with sparse_execution(use_kernels=True):
        with pytest.raises(RuntimeError, match="no backward"):
            griffin_linear(x.requires_grad_(), w)
        with pytest.raises(RuntimeError, match="no backward"):
            griffin_linear(x.detach(), w.requires_grad_())
        with torch.no_grad():
            griffin_linear(x, w)
    with pytest.raises(RuntimeError, match="no backward"):
        griffin_linear(x, gw)
    griffin_linear(x.detach(), gw)
    out = griffin_linear(x, w)
    g, = torch.autograd.grad(out.sum(), w)
    torch.testing.assert_close(g, x.detach().sum(0)[:, None].expand(32, 16))
    assert math.isfinite(float(g.sum()))
