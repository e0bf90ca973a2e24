"""Parameter trees cross between the JAX package and the port through
numpy, both ways, bit for bit — bf16 and compacted leaves included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import GriffinWeights as JaxGriffinWeights
from repro.kernels import griffin_matmul as jax_griffin_matmul
from repro.models import build_model as jax_build_model
from repro.sparsity import sparsify_params as jax_sparsify
from repro_torch import bridge
from repro_torch.kernels import GriffinWeights


def _as_jax_gw(ng):
    return JaxGriffinWeights(
        b_comp=jnp.asarray(ng.b_comp), kidx=jnp.asarray(ng.kidx),
        cnt=jnp.asarray(ng.cnt),
        inv_perm=None if ng.inv_perm is None else jnp.asarray(ng.inv_perm),
        k=ng.k, n=ng.n, block_k=ng.block_k, block_n=ng.block_n,
        a_thr=ng.a_thr)


def _flat(tree):
    """Path -> numpy array, compacted leaves split into their arrays."""
    def compacted(x):
        return isinstance(x, (bridge.NumpyGriffin, JaxGriffinWeights))

    leaves = jax.tree_util.tree_leaves_with_path(tree, is_leaf=compacted)
    out = {}
    for path, leaf in leaves:
        key = jax.tree_util.keystr(path)
        if compacted(leaf):
            for f in ("b_comp", "kidx", "cnt", "inv_perm"):
                if getattr(leaf, f) is not None:
                    out[key + f] = np.asarray(getattr(leaf, f))
        else:
            out[key] = np.asarray(leaf)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_array_round_trip_bitwise(dtype):
    a = jnp.asarray(np.random.RandomState(0).randn(5, 7), jnp.dtype(dtype))
    a = a.at[0, 0].set(-0.0)
    t = bridge.array_to_tensor(a)
    assert t.dtype == getattr(torch, dtype) and t.shape == (5, 7)
    back = bridge.tensor_to_array(t)
    assert back.dtype == np.asarray(a).dtype
    np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                  back.view(np.uint8))


@pytest.mark.parametrize("compact", [False, True])
def test_jax_tree_round_trip(compact):
    cfg = jax_get_config("llama3.2-1b").reduced()
    params = jax_build_model(cfg).init(jax.random.PRNGKey(1))
    params = jax_sparsify(params, 0.6, block_k=16, block_n=16, unit=8,
                          compact=compact)
    host = jax.tree.map(np.asarray, params)
    tt = bridge.to_torch(host)
    if compact:
        gw = tt["layers"]["wq"]
        assert isinstance(gw, GriffinWeights)
        assert gw.kidx.dtype == torch.int32 and gw.b_comp.dim() == 3
    want, got = _flat(host), _flat(bridge.to_numpy(tt))
    assert set(want) == set(got)
    for key, vw in want.items():
        vg = got[key]
        assert vw.dtype == vg.dtype and vw.shape == vg.shape, key
        np.testing.assert_array_equal(vw.view(np.uint8), vg.view(np.uint8))


def test_port_tree_back_into_jax_computes_the_same():
    """Port-compacted weights converted back run through the JAX kernel."""
    from repro_torch.kernels import preprocess_weights
    rng = np.random.RandomState(2)
    w = rng.randn(64, 48).astype(np.float32)
    w[16:32] = 0
    gw = preprocess_weights(torch.from_numpy(w), block_k=16, block_n=16,
                            unit=8)
    jgw = _as_jax_gw(bridge.to_numpy(gw))
    a = rng.randn(4, 64).astype(np.float32)
    out = jax_griffin_matmul(jnp.asarray(a), jgw, interpret=True)
    np.testing.assert_allclose(np.asarray(out), a @ w, rtol=1e-5, atol=1e-5)


def test_to_torch_places_on_device_and_keeps_meta():
    ng = bridge.NumpyGriffin(b_comp=np.zeros((16, 16), np.float32),
                             kidx=np.zeros((1, 1), np.int32),
                             cnt=np.ones((1,), np.int32), inv_perm=None,
                             k=16, n=10, block_k=16, block_n=16, a_thr=0.3)
    gw = bridge.to_torch({"x": [ng]}, device="cpu")["x"][0]
    assert gw.inv_perm is None and (gw.k, gw.n, gw.a_thr) == (16, 10, 0.3)
    assert gw.b_comp.device.type == "cpu"
