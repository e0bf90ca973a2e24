"""Parameter trees between the reference and the port, through numpy.

The reference's weights are drawn with ``jax.random``, which torch cannot
reproduce, so parity tests hand the reference's own (pruned, compacted)
parameters to the port.  This module never imports JAX: it takes a tree of
numpy arrays (``jax.tree.map(np.asarray, params)`` on the reference side)
and gives one back.

* Arrays become tensors on ``device`` and back.  numpy has no bfloat16:
  JAX hands over ``ml_dtypes.bfloat16`` arrays, which cross as their
  ``uint16`` bits and are viewed as ``torch.bfloat16``; the way back views
  the bits as ``ml_dtypes.bfloat16`` (the package JAX itself depends on).
* Compacted weights are matched by their fields (``b_comp``, ``kidx``,
  ``cnt``, ``inv_perm``, ``k``, ``n``, ``block_k``, ``block_n``, ``a_thr``),
  so the reference's ``GriffinWeights`` with numpy leaves converts without
  importing its class, and :class:`NumpyGriffin` carries them back.
  Stacked leaves keep their leading axis.
* A training state is matched by its fields too: the reference's
  ``TrainState`` (``params``, ``opt``, ``step``) with its AdamW
  ``OptState`` (``mu``, ``nu``, ``count``) becomes the port's
  ``runtime.train.TrainState``, its counters 0-dim int32 tensors on the
  CPU, and the way back gives the port's classes with numpy leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .kernels.griffin_spmm.ops import GriffinWeights
from .optim.adamw import OptState
from .runtime.train import TrainState

_GW_ARRAYS = ("b_comp", "kidx", "cnt", "inv_perm")
_GW_META = ("k", "n", "block_k", "block_n", "a_thr")


@dataclasses.dataclass
class NumpyGriffin:
    """A ``GriffinWeights`` with numpy leaves: what :func:`to_numpy` gives
    for compacted weights, field for field the reference's class."""

    b_comp: np.ndarray
    kidx: np.ndarray
    cnt: np.ndarray
    inv_perm: Optional[np.ndarray]
    k: int
    n: int
    block_k: int
    block_n: int
    a_thr: Optional[float] = None


def _is_griffin(x: Any) -> bool:
    return all(hasattr(x, f) for f in _GW_ARRAYS + _GW_META)


def _is_state(x: Any) -> bool:
    return all(hasattr(x, f) for f in ("params", "opt", "step"))


def _is_opt(x: Any) -> bool:
    return all(hasattr(x, f) for f in ("mu", "nu", "count"))


def array_to_tensor(a: Any, device: Any = "cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_torch(tree: Any, device: Any = "cpu") -> Any:
    """Numpy tree (dicts, lists, tuples, arrays, compacted weights) -> the
    port's tree on ``device``."""
    if _is_griffin(tree):
        arrays = {f: (None if getattr(tree, f) is None
                      else array_to_tensor(getattr(tree, f), device))
                  for f in _GW_ARRAYS}
        return GriffinWeights(**arrays, **{f: getattr(tree, f)
                                           for f in _GW_META})
    if _is_state(tree):
        return TrainState(to_torch(tree.params, device),
                          to_torch(tree.opt, device),
                          array_to_tensor(tree.step))
    if _is_opt(tree):
        return OptState(to_torch(tree.mu, device), to_torch(tree.nu, device),
                        array_to_tensor(tree.count))
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)) or hasattr(tree,
                                                             "__array__"):
        return array_to_tensor(tree, device)
    return tree


def to_numpy(tree: Any) -> Any:
    """The port's tree -> numpy tree (compacted weights as
    :class:`NumpyGriffin`)."""
    if isinstance(tree, GriffinWeights):
        arrays = {f: (None if getattr(tree, f) is None
                      else tensor_to_array(getattr(tree, f)))
                  for f in _GW_ARRAYS}
        return NumpyGriffin(**arrays, **{f: getattr(tree, f)
                                         for f in _GW_META})
    if isinstance(tree, TrainState):
        return TrainState(to_numpy(tree.params), to_numpy(tree.opt),
                          to_numpy(tree.step))
    if isinstance(tree, OptState):
        return OptState(*(to_numpy(x) for x in tree))
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tensor_to_array(tree)
    return tree
