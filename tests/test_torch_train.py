"""The port's training path (repro_torch.optim.adamw, data, sparsity's
PruneSchedule and stats, runtime.train, checkpoint's TrainState and
PreemptionGuard, launch.train) against the JAX package's, on the CPU.

The reference's own weights and states cross through repro_torch.bridge.
Tolerances: the data pipeline, the prune schedule's sparsity and its zero
pattern, the parameter counts and the input specs are exact; AdamW in fp32
within rtol 1e-6 (XLA and torch round ``pow`` and ``cos`` of the schedule
independently, a last-bit matter); a multi-step train step in fp32 within
1e-5 relative on loss and grad norm (gradients are summed in other
orders), rtol 1e-4 on parameters and moments with an absolute floor for
parameters of 5e-5, half a percent of one lr = 1e-2 update (AdamW divides
each element's update by its own gradient scale, so an element whose
gradient is near zero carries the summation-order difference into its
update almost whole); the CLI's restart is bit-equal to the uninterrupted
run.  Each family's bf16 dtype flow: every gradient leaf in its
parameter's dtype, as the reference's (recurrentgemma's fp32 ``lam`` in
fp32), the loss within 2e-3 relative and each leaf within 5e-2 relative
L2 of the reference's bf16 gradient (the measured worst is 2.3e-2,
recurrentgemma's ``lam``: bf16 activations rounded in other places).
"""
import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save as jax_save
from repro.configs import get_config as jax_get_config
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import ShapeConfig as JaxShape
from repro.configs.base import applicable_shapes as jax_applicable
from repro.data import pipeline as jpipe
from repro.models import build_model as jax_build_model
from repro.models.registry import input_specs as jax_input_specs
from repro.optim import adamw as jadamw
from repro.runtime import train as jtrain
from repro.sparsity import pruning as jpruning
from repro.sparsity import stats as jstats
from repro_torch import bridge
from repro_torch.checkpoint import (PreemptionGuard, keyed_leaves,
                                    latest_step, restore, save)
from repro_torch.configs import (SHAPES, ShapeConfig, applicable_shapes,
                                 get_config)
from repro_torch.data import (CorpusDataset, DataConfig, make_iterator,
                              synth_batch)
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model, input_specs
from repro_torch.optim import adamw
from repro_torch.runtime.train import (TrainState, apply_prune, init_state,
                                       make_train_step, to_device,
                                       value_and_grad)
from repro_torch.sparsity import PruneSchedule, stats
from test_torch_losses import FAMILIES, reference_loss, rel_l2

ARCHS = ("llama3.2-1b", "llama4-scout-17b-a16e", "mixtral-8x7b",
         "xlstm-1.3b", "recurrentgemma-9b", "whisper-large-v3")
SMALL = ShapeConfig("small", 16, 4, "train")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Eager torch ops at these sizes gain nothing from threads, and with
    pytest-xdist's parallel workers OpenMP's pools oversubscribe the cores
    (a test of seconds then takes minutes); one thread also keeps the
    CPU's embedding-gradient accumulation in one order, which the
    bit-equal restart needs.  One thread for the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(got, want, **tol):
    got, want = list(keyed_leaves(got)), list(keyed_leaves(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        a = a.float().numpy() if isinstance(a, torch.Tensor) else a
        b = b.float().numpy() if isinstance(b, torch.Tensor) else b
        np.testing.assert_allclose(a, b, err_msg=path, **tol)


# ---------------------------------------------------------------------------
# configs, counts, specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    japi = jax_build_model(jax_get_config(arch))
    tapi = build_model(get_config(arch), device="cpu")
    assert tapi.param_count() == japi.param_count()
    assert tapi.param_count_total() == japi.param_count_total()


def test_llama_param_count_is_the_published_size():
    """1.236 B parameters of which the tied 128256 x 2048 embedding is
    262.7 M."""
    cfg = get_config("llama3.2-1b")
    n = build_model(cfg, device="cpu").param_count()
    total = n + cfg.vocab_size * cfg.d_model + (2 * cfg.num_layers + 1) * \
        cfg.d_model
    assert total == 1_235_814_400


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_shapes_match_reference(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert applicable_shapes(tcfg) == jax_applicable(jcfg)
    assert tcfg.sub_quadratic == jcfg.sub_quadratic
    for name in applicable_shapes(tcfg):
        want = jax_input_specs(jcfg, JAX_SHAPES[name])
        got = input_specs(tcfg, SHAPES[name])
        assert sorted(got) == sorted(want)
        for k, spec in got.items():
            assert spec.device.type == "meta"
            assert tuple(spec.shape) == tuple(want[k].shape), (name, k)
            assert str(spec.dtype).split(".")[-1] == str(want[k].dtype), k


def test_shapes_and_training_knobs_match_reference():
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JAX_SHAPES.items()}
    for arch in ARCHS:
        for t, j in ((get_config(arch), jax_get_config(arch)),
                     (get_config(arch).reduced(),
                      jax_get_config(arch).reduced())):
            assert (t.remat, t.remat_policy, t.loss_chunk, t.kv_chunk) == \
                (j.remat, j.remat_policy, j.loss_chunk, j.kv_chunk), arch


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _opt_case(rng, dtype):
    shapes = {"a": (6, 5), "b": {"c": (7,), "d": (2, 3, 4)}}

    def draw(tree, scale):
        if isinstance(tree, dict):
            return {k: draw(v, scale) for k, v in tree.items()}
        return (rng.randn(*tree) * scale).astype(np.float32)

    params = draw(shapes, 1.0)
    grads = [draw(shapes, s) for s in (0.1, 3.0, 0.5, 2.0)]
    if dtype == "bfloat16":
        params = jax.tree.map(lambda x: np.asarray(x, jnp.bfloat16), params)
        grads = [jax.tree.map(lambda x: np.asarray(x, jnp.bfloat16), g)
                 for g in grads]
    return params, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_over_steps(dtype):
    """Four steps, two of them clipped (global norm above clip_norm), with
    warmup and the cosine: parameters, both moments, lr and grad norm.
    bf16 parameters round each update once, as the reference does: equal
    within one bf16 ulp."""
    params, grads = _opt_case(np.random.RandomState(0), dtype)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    jp = jax.tree.map(jnp.asarray, params)
    js = jadamw.init(jp)
    tp = bridge.to_torch(params)
    ts = adamw.init(tp)
    ptol = dict(rtol=1e-6, atol=1e-7) if dtype == "float32" else \
        dict(rtol=2 ** -7, atol=0)
    for g in grads:
        jp, js, jm = jadamw.apply(jcfg, jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, tm = adamw.apply(tcfg, tp, bridge.to_torch(g), ts)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6)
        assert int(ts.count) == int(js.count)
        _assert_tree_close(tp, bridge.to_torch(_np(jp)), **ptol)
        _assert_tree_close(ts.mu, bridge.to_torch(_np(js.mu)), rtol=1e-6,
                           atol=1e-8)
        _assert_tree_close(ts.nu, bridge.to_torch(_np(js.nu)), rtol=1e-6,
                           atol=1e-10)
    assert all(leaf.dtype == torch.float32
               for _, leaf in keyed_leaves((ts.mu, ts.nu)))


def test_schedule_matches_reference():
    cfg = dict(lr=3e-3, warmup_steps=6, total_steps=30)
    steps = np.arange(0, 40, dtype=np.int32)
    want = [float(jadamw.schedule(jadamw.AdamWConfig(**cfg), jnp.int32(s)))
            for s in steps]
    got = [float(adamw.schedule(adamw.AdamWConfig(**cfg),
                                torch.tensor(int(s), dtype=torch.int32)))
           for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == 0.0 and got[6] == pytest.approx(3e-3)


def test_decay_only_on_matrices():
    """A zero gradient leaves a vector untouched and shrinks a matrix by
    lr * weight_decay (the decay is not clipped or bias-corrected)."""
    cfg = adamw.AdamWConfig(lr=0.5, warmup_steps=0, total_steps=10,
                            weight_decay=0.1)
    params = {"m": torch.ones(2, 2), "v": torch.ones(3)}
    grads = {"m": torch.zeros(2, 2), "v": torch.zeros(3)}
    params, _, m = adamw.apply(cfg, params, grads, adamw.init(params))
    assert torch.equal(params["v"], torch.ones(3))
    lr = float(m["lr"])
    torch.testing.assert_close(params["m"], torch.full((2, 2),
                                                       1 - lr * 0.1))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-large-v3"])
def test_synth_batch_bit_equal(arch):
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jshape = JaxShape("s", 12, 4, "train")
    for seed, step, shard in ((0, 0, 0), (0, 7, 0), (3, 2, 1), (5, 1000, 3)):
        jdc = jpipe.DataConfig(seed=seed, num_shards=4, shard_id=shard)
        tdc = DataConfig(seed=seed, num_shards=4, shard_id=shard)
        want = jpipe.synth_batch(jcfg, jshape, jdc, step)
        got = synth_batch(tcfg, ShapeConfig("s", 12, 4, "train"), tdc, step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_make_iterator_starts_at_its_step():
    cfg = get_config("llama3.2-1b").reduced()
    it = make_iterator(cfg, SMALL, DataConfig(seed=1), start_step=5)
    try:
        for step in range(5, 9):
            got = next(it)
            want = synth_batch(cfg, SMALL, DataConfig(seed=1), step)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    finally:
        it.close()


def test_corpus_dataset_matches_reference(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_bytes(bytes(np.random.RandomState(2).randint(0, 256, 5000,
                                                            dtype=np.uint8)))
    jcfg, tcfg = (jax_get_config("llama3.2-1b").reduced(),
                  get_config("llama3.2-1b").reduced())
    jds, tds = jpipe.CorpusDataset(str(path), jcfg), \
        CorpusDataset(str(path), tcfg)
    np.testing.assert_array_equal(tds.data, jds.data)
    for step in (0, 3):
        want = jds.batch(JaxShape("s", 32, 4, "train"),
                         jpipe.DataConfig(seed=9, corpus=str(path)), step)
        got = tds.batch(ShapeConfig("s", 32, 4, "train"),
                        DataConfig(seed=9, corpus=str(path)), step)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["labels"][:, :-1],
                                      got["tokens"][:, 1:])
    it = make_iterator(tcfg, ShapeConfig("s", 32, 4, "train"),
                       DataConfig(seed=9, corpus=str(path)))
    try:
        np.testing.assert_array_equal(next(it)["tokens"], tds.batch(
            ShapeConfig("s", 32, 4, "train"),
            DataConfig(seed=9, corpus=str(path)), 0)["tokens"])
    finally:
        it.close()


# ---------------------------------------------------------------------------
# pruning schedule, sparsity stats
# ---------------------------------------------------------------------------

def test_prune_schedule_matches_reference():
    """The ramp's float32 value at every step, and ``apply`` on a stacked
    (L, K, N) leaf, block-granular and unstructured: the same zeros."""
    for args in ((0.5, 7, 15, 128, 32), (0.8, 0, 10, 16, 8),
                 (0.3, 2, 1, 0, 32)):
        js, ts = jpruning.PruneSchedule(*args), PruneSchedule(*args)
        for step in range(0, 30):
            assert ts.sparsity_at(step) == float(
                js.sparsity_at(jnp.asarray(step, jnp.int32))), (args, step)
    w = np.random.RandomState(4).randn(3, 64, 48).astype(np.float32)
    for args in ((0.5, 0, 4, 16, 8), (0.6, 1, 3, 0, 32),
                 (0.5, 7, 15, 128, 32)):
        js, ts = jpruning.PruneSchedule(*args), PruneSchedule(*args)
        for step in (2, 3, 26):
            want = np.asarray(js.apply(jnp.asarray(w), step))
            got = ts.apply(torch.from_numpy(w), step).numpy()
            np.testing.assert_array_equal(got, want)


def test_sparsity_stats_match_reference():
    rng = np.random.RandomState(5)
    tree = {"a": rng.randn(8, 8).astype(np.float32),
            "b": {"c": np.where(rng.rand(16) < 0.7, 0.0,
                                1.0).astype(np.float32)}}
    tree["a"][:4] = 0.0
    want = jstats.tensor_report(jax.tree.map(jnp.asarray, tree))
    got = stats.tensor_report(bridge.to_torch(tree))
    assert got == pytest.approx(want, abs=0) and list(got) == list(want)
    for a_sp in (0.0, 0.6):
        assert stats.model_mode(bridge.to_torch(tree), a_sp).value == \
            jstats.model_mode(jax.tree.map(jnp.asarray, tree), a_sp).value
    x = torch.tensor([[-1.0, 2.0], [0.5, -3.0]])
    assert stats.activation_sparsity(torch.relu, x) == 0.5


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _reference_pair(arch="llama3.2-1b"):
    jcfg = jax_get_config(arch).reduced()
    japi = jax_build_model(jcfg)
    jstate = jtrain.init_state(japi, jax.random.PRNGKey(0))
    tapi = build_model(get_config(arch).reduced(), device="cpu")
    return jcfg, japi, jstate, tapi, bridge.to_torch(_np(jstate))


def _match(key: str) -> bool:
    return train_cli.prune_match(key)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_reference(n_micro):
    """Five steps of reduced llama3.2-1b with a block-prune milestone after
    the second (16 x 8 blocks at the ramp's sparsity): loss, grad norm,
    lr, and then the whole state (params, mu, nu, count, step)."""
    jcfg, japi, jstate, tapi, tstate = _reference_pair()
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=5)
    jstep = jax.jit(jtrain.make_train_step(
        japi, jadamw.AdamWConfig(**cfg), n_micro=n_micro))
    tstep = make_train_step(tapi, adamw.AdamWConfig(**cfg), n_micro=n_micro)
    jsched = jpruning.PruneSchedule(0.5, 1, 4, block_k=16, unit=8)
    tsched = PruneSchedule(0.5, 1, 4, block_k=16, unit=8)
    for step in range(5):
        batch = synth_batch(tapi.cfg, SMALL, DataConfig(seed=0), step)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, to_device(batch, "cpu"))
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=k)
        if step == 1:
            jstate = jtrain.apply_prune(jstate, jsched, _match)
            tstate = apply_prune(tstate, tsched, _match)
            for path, leaf in keyed_leaves(tstate.params["layers"]):
                if _match(path):
                    assert float((leaf == 0).float().mean()) > 0.2, path
    want = bridge.to_torch(_np(jstate))
    assert int(tstate.step) == int(want.step) == 5
    assert int(tstate.opt.count) == int(want.opt.count) == 5
    _assert_tree_close(tstate.params, want.params, rtol=1e-4, atol=5e-5)
    _assert_tree_close(tstate.opt.mu, want.opt.mu, rtol=1e-4, atol=1e-7)
    _assert_tree_close(tstate.opt.nu, want.opt.nu, rtol=1e-4, atol=1e-9)


def test_train_step_descends_tiny_model():
    """The reference's own tiny-model descent test, as the port's twin:
    eight steps on one batch drop the loss by more than 0.2."""
    cfg = get_config("llama3.2-1b").reduced()
    api = build_model(cfg, device="cpu")
    state = init_state(api, api.generator(0))
    step = make_train_step(api, adamw.AdamWConfig(lr=1e-2, warmup_steps=0,
                                                  total_steps=50))
    batch = to_device(synth_batch(cfg, SMALL, DataConfig(seed=0), 0), "cpu")
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_bf16_dtype_flow(family):
    """bf16 parameters: every gradient leaf comes back in its parameter's
    dtype, as the reference's (recurrentgemma's fp32 ``lam`` in fp32), and
    the loss and gradients agree within the bf16 tolerances above."""
    jl, jg, params, batch = reference_loss(family, "bfloat16")
    cfg = dataclasses.replace(get_config(FAMILIES[family]).reduced(),
                              dtype="bfloat16")
    api = build_model(cfg, device="cpu")
    tl, tg = value_and_grad(api.loss, params, bridge.to_torch(batch))
    assert tl.dtype == torch.float32
    assert abs(float(tl) - jl) <= 2e-3 * abs(jl)
    dtypes = set()
    for (path, a), (_, b), (_, p) in zip(keyed_leaves(tg), keyed_leaves(jg),
                                         keyed_leaves(params)):
        assert a.dtype == b.dtype == p.dtype, path
        dtypes.add(a.dtype)
        assert rel_l2(a.float().numpy(), b.float().numpy()) <= 5e-2, path
    assert torch.bfloat16 in dtypes


# ---------------------------------------------------------------------------
# checkpoint, preemption, bridge
# ---------------------------------------------------------------------------

def test_train_state_save_restore_round_trip(tmp_path):
    """A state after two steps, saved and restored onto a fresh state's
    template: every leaf bit-equal, counters 0-dim on the CPU, and the
    checkpoint keyed as the reference keys its TrainState."""
    _, _, _, tapi, tstate = _reference_pair()
    step = make_train_step(tapi, adamw.AdamWConfig(lr=1e-2, warmup_steps=0,
                                                   total_steps=5))
    for i in range(2):
        tstate, _ = step(tstate, to_device(
            synth_batch(tapi.cfg, SMALL, DataConfig(), i), "cpu"))
    save(str(tmp_path), 2, tstate)
    assert latest_step(str(tmp_path)) == 2
    back = restore(str(tmp_path), init_state(tapi, tapi.generator(3)))
    assert isinstance(back, TrainState)
    assert isinstance(back.opt, adamw.OptState)
    got, want = list(keyed_leaves(back)), list(keyed_leaves(tstate))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    assert back.step.shape == () and back.opt.count.shape == ()
    paths = [p for p, _ in got]
    assert "[<flat index 0>]['layers']['wq']" in paths
    assert "[<flat index 1>].mu['embed']" in paths
    assert "[<flat index 1>].count" in paths and "[<flat index 2>]" in paths


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """The reference's ``save`` of its TrainState, read by the port's
    ``restore``: the key strings agree, so every leaf lands in place."""
    _, _, jstate, tapi, tstate = _reference_pair()
    jax_save(str(tmp_path), 0, jstate)
    back = restore(str(tmp_path), init_state(tapi, tapi.generator(1)))
    for (path, a), (_, b) in zip(keyed_leaves(back), keyed_leaves(tstate)):
        assert torch.equal(a, b), path


def test_bridge_carries_train_state_both_ways():
    _, _, jstate, _, tstate = _reference_pair()
    assert isinstance(tstate, TrainState)
    assert tstate.step.device.type == "cpu" and tstate.step.shape == ()
    back = bridge.to_numpy(tstate)
    for (path, a), (_, b) in zip(keyed_leaves(back),
                                 keyed_leaves(_np(jstate))):
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_preemption_guard_on_sigterm():
    previous = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard()
    guard.install()
    try:
        assert not guard.should_stop
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.should_stop
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) is previous


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI = ["--reduced", "--device", "cpu", "--steps", "12", "--batch", "4",
       "--seq", "16", "--prune-sparsity", "0.5", "--log-every", "4"]


def test_cli_restart_is_bit_equal(tmp_path, capsys):
    """The CLI with a checkpoint every 5 steps and the prune schedule
    (milestones at steps 0 and 25, the ramp over steps 3..9): a second run
    in the same directory resumes at step 10 and its losses and final
    state equal the uninterrupted run's bit for bit."""
    ckpt = str(tmp_path / "ckpt")
    args = CLI + ["--ckpt-dir", ckpt, "--ckpt-every", "5"]
    first = train_cli.main(args)
    assert first["start"] == 0 and len(first["losses"]) == 12
    assert [s for s, _, _ in first["saves"]] == [5, 10]
    assert all(np.isfinite(first["losses"]))
    second = train_cli.main(args)
    assert "restored step 10" in capsys.readouterr().out
    assert second["start"] == 10
    assert second["losses"] == first["losses"][10:]
    assert second["grad_norms"] == first["grad_norms"][10:]
    for (path, a), (_, b) in zip(keyed_leaves(second["state"]),
                                 keyed_leaves(first["state"])):
        assert torch.equal(a, b), path


def test_cli_preemption_saves_and_resumes(tmp_path):
    """SIGTERM during step 3: the CLI checkpoints step 4 and stops; run
    again, it resumes there and ends where an unpreempted run ends."""
    ckpt = str(tmp_path / "ckpt")
    args = CLI + ["--ckpt-dir", ckpt, "--ckpt-every", "100"]

    def kill(step, state, metrics):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    cut = train_cli.main(args, on_step=kill)
    assert cut["preempted"] and len(cut["losses"]) == 4
    assert latest_step(ckpt) == 4
    rest = train_cli.main(args)
    whole = train_cli.main(CLI)
    assert cut["losses"] + rest["losses"] == whole["losses"]


def test_cli_descends_and_prunes(capsys):
    """The CLI's own schedule on the reduced model, 30 steps with
    --prune-sparsity 0.5 (block_k 128 / unit 32 clamp to the reduced 64 x
    128 leaves): the mean loss of the last five steps is below the first
    five's by more than 30 % (PERF.md states this margin beside the card's
    run), and after the step-25 milestone every pruned leaf holds half
    its blocks at zero."""
    seen = {}

    def check(step, state, metrics):
        if step == 25:
            for path, leaf in keyed_leaves(state.params["layers"]):
                if train_cli.prune_match(path):
                    seen[path] = float((leaf == 0).float().mean())

    out = train_cli.main(["--reduced", "--device", "cpu", "--steps", "30",
                          "--prune-sparsity", "0.5", "--log-every", "10"],
                         on_step=check)
    first, last = np.mean(out["losses"][:5]), np.mean(out["losses"][-5:])
    assert last < 0.7 * first, (first, last)
    assert sorted(seen) == sorted(
        f"['{n}']" for n in train_cli.PRUNED)
    assert all(v == pytest.approx(0.5, abs=0.02) for v in seen.values())
    assert "final loss" in capsys.readouterr().out


def test_cli_refuses_model_parallel():
    with pytest.raises(SystemExit, match="1.18"):
        train_cli.main(CLI + ["--model-parallel", "2"])
