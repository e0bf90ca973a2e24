"""Train step: loss, gradient, AdamW and metrics — the counterpart of
``repro/runtime/train.py``.

``make_train_step`` returns a (state, batch) -> (state, metrics) function.
Sparsity is a first-class feature: a ``PruneSchedule`` applies
Griffin-style weight pruning at ramp milestones (:func:`apply_prune`, host
side, between steps), keeping the weight tensors in the exactly-zero form
the sparse kernels consume.  Gradients come from the plain route (dense
weights, no kernel scope: the kernels have no backward).

The state's tensors are updated in place, as the reference donates its
state to the jitted step: a step's input state must not be used after
it.  The reference's ``state_shardings`` and ``jit_train_step`` place the
state on a mesh; they come with the training layout (ROADMAP 1.18).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ..checkpoint.checkpoint import keyed_leaves
from ..models.registry import ModelApi
from ..optim import adamw
from ..sparsity.pruning import PruneSchedule


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: adamw.OptState
    step: torch.Tensor          # 0-dim int32 on the CPU


def init_state(api: ModelApi, gen: torch.Generator) -> TrainState:
    params = api.init(gen)
    return TrainState(params=params, opt=adamw.init(params),
                      step=torch.zeros((), dtype=torch.int32))


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    """A host batch (``data.synth_batch``) as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def value_and_grad(loss_fn: Callable[..., torch.Tensor], params: Any,
                   batch: Dict) -> Tuple[torch.Tensor, Any]:
    """(loss, gradient tree) of ``loss_fn(params, batch)``: the reference's
    ``jax.value_and_grad``.  Gradients come back in each parameter's
    dtype; a leaf the loss does not use gets zeros."""
    views = adamw.tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = adamw.tree_leaves(views)
    with torch.enable_grad():
        loss = loss_fn(views, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(v): torch.zeros_like(v) if g is None else g
             for v, g in zip(leaves, grads)}
    return loss.detach(), adamw.tree_map(lambda v: by_id[id(v)], views)


def make_train_step(api: ModelApi, opt_cfg: adamw.AdamWConfig,
                    n_micro: int = 1
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """(state, batch) -> (state, metrics {"loss", "grad_norm", "lr"}).

    ``n_micro > 1`` splits the batch into microbatches run one after
    another with float32 gradient accumulation: peak activation memory
    drops ~n_micro x at the same math."""
    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        if n_micro == 1:
            loss, grads = value_and_grad(api.loss, state.params, batch)
        else:
            micro = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            loss = torch.zeros((), device=api.device)
            grads = adamw.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), state.params)
            for i in range(n_micro):
                li, gi = value_and_grad(api.loss, state.params,
                                        {k: v[i] for k, v in micro.items()})
                adamw.tree_map(lambda a, b: a.add_(b.float()), grads, gi)
                loss = loss + li
            loss = loss / n_micro
            grads = adamw.tree_map(lambda g: g / n_micro, grads)
        params, opt, metrics = adamw.apply(opt_cfg, state.params, grads,
                                           state.opt)
        metrics["loss"] = loss
        return TrainState(params, opt, state.step + 1), metrics

    return train_step


def apply_prune(state: TrainState, schedule: PruneSchedule,
                match: Callable[[str], bool]) -> TrainState:
    """Host-side pruning at ramp milestones (keeps zeros exact): every
    parameter leaf of two or more dims whose path (``['layers']['wq']``)
    ``match`` accepts is pruned to the schedule's sparsity at the state's
    step, in place.  The moments are left as they are."""
    step = int(state.step)
    for path, leaf in keyed_leaves(state.params):
        if leaf.dim() >= 2 and match(path):
            leaf.copy_(schedule.apply(leaf, step))
    return state
