"""Atomic, self-describing checkpoints of tensor trees — the port's own copy
of ``repro/checkpoint/checkpoint.py``, with the same on-disk layout:

- atomic: written to ``<dir>/tmp.<step>`` then ``os.replace``d to
  ``step_NNNNNNNNNN`` (a crash mid-save never corrupts the latest
  checkpoint);
- self-describing: ``arrays.npz`` holds one array per leaf under the
  leaf's path (``['cache']['k']``, ``['params']['layers']['wq'].b_comp``:
  the reference's key strings, dict keys sorted), and ``manifest.json``
  records ``step``, ``keys``, ``shapes``, the true ``dtypes`` and the
  caller's ``extra`` dict;
- retention: ``save`` keeps the newest ``keep`` checkpoints.

Trees are dicts, lists, tuples, named tuples and dataclasses of
``torch.Tensor`` (or numpy) leaves, with compacted ``GriffinWeights``
leaves stored field by field; ``None`` is an empty subtree.  A named
tuple's fields are keyed by name (``.mu``) and another dataclass's by
position (``[<flat index 0>]``), as ``jax.tree_util.keystr`` keys the
reference's ``OptState`` and ``TrainState``, so a trainer's checkpoint has
the reference's keys.  numpy has no bfloat16 (nor float8), so those
tensors round-trip through a same-width unsigned integer view, their true
dtype in the manifest.  ``restore`` rebuilds the structure of a template
tree and places every leaf on an explicit ``device`` (default: the
template leaf's own, the CPU for a ``meta`` template).

The serving engine writes its tick-start snapshots through ``save`` (its
scheduler and paging state in ``extra``, which ``read_manifest`` returns)
and recovers through ``restore`` (``runtime.engine.ServeEngine``,
``FaultConfig.snapshot_dir``); on a serving mesh each data row keeps its
own checkpoints under :func:`row_dir`, one a head share (share 0 alone
where the arena's heads are not split), the first row's first share the
weights too, so a smaller mesh restores any row it takes over, whole
(``runtime.mesh_serve``); the trainer saves its whole ``TrainState``
(parameters, AdamW moments and counters) and polls
:class:`PreemptionGuard`, which SIGTERM flips, to save and exit.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..kernels.griffin_spmm.ops import GriffinWeights

# dtypes numpy cannot hold -> (numpy storage dtype, the signed integer
# type of the same width that both numpy and torch carry the bits in)
_EXOTIC = {torch.bfloat16: (np.uint16, torch.int16, np.int16),
           torch.float8_e4m3fn: (np.uint8, torch.int8, np.int8),
           torch.float8_e5m2: (np.uint8, torch.int8, np.int8)}
# GriffinWeights fields that are arrays (the rest are metadata; ``perm`` is
# derived from ``inv_perm`` when the weights are built)
_GW_ARRAYS = ("b_comp", "kidx", "cnt", "inv_perm")


def _children(tree: Any) -> Iterator[Tuple[str, Any]]:
    """(key suffix, child) pairs of an inner node, in the reference's
    order and key syntax; nothing for a leaf."""
    if isinstance(tree, GriffinWeights):
        return ((f".{f}", getattr(tree, f)) for f in _GW_ARRAYS)
    if isinstance(tree, dict):
        return ((f"[{k!r}]", tree[k]) for k in sorted(tree))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return ((f".{f}", getattr(tree, f)) for f in tree._fields)
    if isinstance(tree, (list, tuple)):
        return ((f"[{i}]", v) for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree):
        return ((f"[<flat index {i}>]", getattr(tree, f.name))
                for i, f in enumerate(dataclasses.fields(tree)))
    return iter(())


def _is_leaf(tree: Any) -> bool:
    return not (isinstance(tree, (dict, list, tuple, GriffinWeights))
                or dataclasses.is_dataclass(tree))


def keyed_leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in the reference's order and key syntax
    (``jax.tree_util.keystr`` of its pytree paths)."""
    if tree is None:
        return
    if _is_leaf(tree):
        yield path, tree
        return
    for key, child in _children(tree):
        yield from keyed_leaves(child, path + key)


def _dtype_name(leaf: Any) -> str:
    return str(leaf.dtype).removeprefix("torch.")


def _to_numpy(leaf: Any) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach()
    if t.dtype in _EXOTIC:
        store, bits, _ = _EXOTIC[t.dtype]
        return t.view(bits).cpu().numpy().view(store)
    return t.cpu().numpy()


def save(ckpt_dir: str, step: int, state: Any, keep: int = 3,
         extra: Optional[Dict] = None) -> str:
    """Write ``state`` as checkpoint ``step`` under ``ckpt_dir``; returns
    its directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = list(keyed_leaves(state))
    arrs = {k: _to_numpy(v) for k, v in flat}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrs)
    manifest = {
        "step": step,
        "keys": sorted(arrs),
        "shapes": {k: list(v.shape) for k, v in arrs.items()},
        "dtypes": {k: _dtype_name(v) for k, v in flat},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _retain(ckpt_dir, keep)
    return final


def _steps(ckpt_dir: str):
    return sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))


def _retain(ckpt_dir: str, keep: int) -> None:
    for d in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def row_dir(ckpt_dir: str, row: int, share: int) -> str:
    """The checkpoint directory of head share ``share`` of data row
    ``row`` of a serving mesh: ``<ckpt_dir>/row<row>-share<share>`` (share
    0 alone where the row's arena splits no head axis)."""
    return os.path.join(ckpt_dir, f"row{row}-share{share}")


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return int(steps[-1].split("_")[1]) if steps else None


def _step_dir(ckpt_dir: str, step: Optional[int]) -> str:
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    return os.path.join(ckpt_dir, f"step_{step:010d}")


def read_manifest(ckpt_dir: str, step: Optional[int] = None) -> Dict:
    """The manifest of checkpoint ``step`` (latest by default): keys,
    shapes, dtypes and the ``extra`` dict ``save`` recorded."""
    with open(os.path.join(_step_dir(ckpt_dir, step), "manifest.json")) as f:
        return json.load(f)


def restore(ckpt_dir: str, template: Any, step: Optional[int] = None,
            device: Any = None) -> Any:
    """Checkpoint ``step`` (latest by default) in the structure of
    ``template``, whose leaves give each array's shape and dtype (tensors
    on any device, ``meta`` included).  A template may be a subtree of
    what was saved: only its keys are read.  Leaves land on ``device``, or
    on the template leaf's device."""
    with np.load(os.path.join(_step_dir(ckpt_dir, step),
                              "arrays.npz")) as data:
        return _rebuild(template, "", data, device)


def _rebuild(tmpl: Any, path: str, data, device: Any) -> Any:
    if tmpl is None:
        return None
    if isinstance(tmpl, dict):
        return {k: _rebuild(v, f"{path}[{k!r}]", data, device)
                for k, v in tmpl.items()}
    if not _is_leaf(tmpl):
        kids = [_rebuild(child, path + key, data, device)
                for key, child in _children(tmpl)]
        if isinstance(tmpl, GriffinWeights):
            return dataclasses.replace(tmpl, **dict(zip(_GW_ARRAYS, kids)),
                                       perm=None)
        if isinstance(tmpl, list) or type(tmpl) is tuple:
            return type(tmpl)(kids)
        return type(tmpl)(*kids)      # a named tuple or a dataclass
    arr = data[path]
    if tuple(arr.shape) != tuple(tmpl.shape):
        raise ValueError(f"shape mismatch for {path}: {arr.shape} vs "
                         f"{tuple(tmpl.shape)}")
    dtype = tmpl.dtype
    if dtype in _EXOTIC and arr.dtype == _EXOTIC[dtype][0]:
        t = torch.from_numpy(arr.view(_EXOTIC[dtype][2])).view(dtype)
    else:
        t = torch.from_numpy(np.asarray(arr, order="C")).to(dtype)
    if device is None:
        device = tmpl.device if tmpl.device.type != "meta" else "cpu"
    return t.to(device)


class PreemptionGuard:
    """SIGTERM-aware flag for checkpoint-on-preemption: :meth:`install`
    makes SIGTERM set it, the train loop polls :attr:`should_stop`, and
    :meth:`uninstall` gives SIGTERM back its previous handler."""

    def __init__(self) -> None:
        self.requested = threading.Event()
        self._previous = None

    def install(self) -> None:
        self._previous = signal.signal(signal.SIGTERM, self._handler)

    def uninstall(self) -> None:
        if self._previous is not None:
            signal.signal(signal.SIGTERM, self._previous)
            self._previous = None

    def _handler(self, signum, frame) -> None:
        self.requested.set()

    @property
    def should_stop(self) -> bool:
        return self.requested.is_set()
