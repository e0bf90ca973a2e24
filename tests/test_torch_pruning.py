"""The port's pruning (repro_torch.sparsity) against the JAX package's:
the same numpy weights must give bitwise-equal pruned weights and
compacted leaves, including signed zeros and the ``norms >= thresh`` tie
rule."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.sparsity import block_prune as jax_block_prune
from repro.sparsity import magnitude_prune as jax_magnitude_prune
from repro.sparsity import sparsify_params as jax_sparsify
from repro_torch import bridge
from repro_torch.kernels import GriffinWeights
from repro_torch.sparsity import (block_prune, magnitude_prune,
                                  sparsify_params, sparsity_of)


def _bits(x):
    a = bridge.tensor_to_array(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    return a.view(np.uint8)


def assert_tree_bitwise(jtree, ttree):
    jtree = jax.tree.map(np.asarray, jtree)
    if isinstance(ttree, GriffinWeights):
        for f in ("b_comp", "kidx", "cnt", "inv_perm"):
            ja, ta = getattr(jtree, f), getattr(ttree, f)
            assert (ja is None) == (ta is None), f
            if ja is not None:
                assert ja.shape == tuple(ta.shape), f
                np.testing.assert_array_equal(_bits(ja), _bits(ta), f)
        for f in ("k", "n", "block_k", "block_n", "a_thr"):
            assert getattr(jtree, f) == getattr(ttree, f), f
    elif isinstance(ttree, dict):
        assert set(jtree) == set(ttree)
        for k in ttree:
            assert_tree_bitwise(jtree[k], ttree[k])
    else:
        assert jtree.shape == tuple(ttree.shape)
        np.testing.assert_array_equal(_bits(jtree), _bits(ttree))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(128, 96, 32, 16, 0.75),
                                  (70, 33, 16, 8, 0.6),
                                  (256, 128, 128, 32, 0.8)])
def test_block_prune_bitwise(dtype, case):
    k, n, bk, unit, s = case
    w = jnp.asarray(np.random.RandomState(3).randn(k, n), jnp.dtype(dtype))
    want = jax_block_prune(w, s, block_k=bk, unit=unit)
    got = block_prune(bridge.array_to_tensor(w), s, bk, unit)
    assert got.dtype == bridge.array_to_tensor(w).dtype
    np.testing.assert_array_equal(_bits(want), _bits(got))


def test_block_prune_ties_keep_every_block_at_the_threshold():
    """Equal-norm blocks at the threshold all survive (``>=``)."""
    w = np.ones((64, 64), np.float32)          # every block has one norm
    got = block_prune(torch.from_numpy(w), 0.75, 16, 16)
    want = jax_block_prune(jnp.asarray(w), 0.75, block_k=16, unit=16)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert float(sparsity_of(got)) == 0.0


@pytest.mark.parametrize("s", [0.0, 0.5, 0.8])
def test_magnitude_prune_bitwise(s):
    w = np.random.RandomState(4).randn(128, 96).astype(np.float32)
    want = jax_magnitude_prune(jnp.asarray(w), s)
    got = magnitude_prune(torch.from_numpy(w), s)
    np.testing.assert_array_equal(_bits(want), _bits(got))


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("balance", [False, True])
def test_sparsify_params_bitwise_on_reduced_llama(compact, balance):
    cfg = jax_get_config("llama3.2-1b").reduced()
    params = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    kw = dict(block_k=16, block_n=16, unit=8, balance=balance,
              compact=compact)
    want = jax_sparsify(params, 0.6, **kw)
    got = sparsify_params(bridge.to_torch(jax.tree.map(np.asarray, params)),
                          0.6, **kw)
    assert_tree_bitwise(want, got)
    if compact:
        assert isinstance(got["layers"]["wq"], GriffinWeights)
        assert got["layers"]["wq"].b_comp.dim() == 3    # stacked layers
    assert isinstance(got["embed"], torch.Tensor)       # never touched


def test_sparsify_params_default_blocks_bf16():
    """The serving path's blocks (128/128/32) on bf16 stacked weights."""
    rng = np.random.RandomState(6)
    w = jnp.asarray(rng.randn(2, 256, 384), jnp.bfloat16)
    tree = {"layers": {"w_up": w, "ln1": jnp.zeros((2, 256), jnp.bfloat16)}}
    want = jax_sparsify(tree, 0.8)
    got = sparsify_params(bridge.to_torch(jax.tree.map(np.asarray, tree)),
                          0.8)
    assert_tree_bitwise(want, got)


def test_sparsify_params_plan_not_ported():
    """A tuned plan (``plan=``, anything with ``rule_for``) steers only the
    compaction: the result is bitwise the reference's under the same rule,
    and a name the plan does not match keeps the call's blocks.  (The name
    dates from when the port's ``plan=`` raised.)"""
    from repro.tuning import FamilyPlan as JaxFamilyPlan
    from repro.tuning import GemmRule as JaxGemmRule
    from repro_torch.tuning import FamilyPlan, GemmRule

    rng = np.random.RandomState(8)
    tree = {"layers": {"wq": jnp.asarray(rng.randn(2, 64, 96), jnp.float32),
                       "wo": jnp.asarray(rng.randn(96, 64), jnp.float32)}}
    rule = dict(match="wq", block_k=32, block_n=48, unit=24,
                a_threshold=0.3)
    want = jax_sparsify(tree, 0.5, block_k=16, block_n=16, unit=8,
                        plan=JaxFamilyPlan("dense", (JaxGemmRule(**rule),)))
    got = sparsify_params(bridge.to_torch(jax.tree.map(np.asarray, tree)),
                          0.5, block_k=16, block_n=16, unit=8,
                          plan=FamilyPlan("dense", (GemmRule(**rule),)))
    assert_tree_bitwise(want, got)
    assert (got["layers"]["wq"].block_k, got["layers"]["wq"].a_thr) == \
        (32, 0.3)
    assert (got["layers"]["wo"].block_k, got["layers"]["wo"].a_thr) == \
        (16, None)
