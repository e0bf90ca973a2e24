"""AdamW with global-norm clipping and a warmup-cosine schedule — the
counterpart of ``repro/optim/adamw.py``, its formulas exactly (not
``torch.optim.AdamW``, whose decay is placed differently).

Parameters and moments are trees (dicts) of tensors mirroring each other;
the moments are float32 whatever the parameter dtype, and each update is
computed in float32 and rounded once to the parameter's dtype.  ``apply``
writes the new parameters and moments into their tensors in place (the
reference donates them to its jitted step) and returns them.  The step
counter and the schedule are host scalars (0-dim CPU tensors), so reading
them never waits for the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor        # 0-dim int32 on the CPU


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of (nested) dicts of the same
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def init(params: Any) -> OptState:
    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return OptState(mu=tree_map(f32, params), nu=tree_map(f32, params),
                    count=torch.zeros((), dtype=torch.int32))


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int tensor), in float32 as the
    reference computes it: linear warmup, then cosine to
    ``min_lr_ratio * lr``."""
    warm = torch.minimum(step / max(cfg.warmup_steps, 1), _f32(1.0))
    prog = ((step - cfg.warmup_steps) /
            max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * \
        0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares,
    leaves in sorted-key order (the reference's ``jax.tree.leaves``)."""
    total = None
    for g in tree_leaves(tree):
        sq = (g.float() ** 2).sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / norm.clamp(min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def apply(cfg: AdamWConfig, params: Any, grads: Any, state: OptState
          ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW update: (params, OptState, {"grad_norm", "lr"}).  The
    parameter and moment tensors are updated in place; ``grad_norm`` stays
    on the device, ``lr`` is a host scalar."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    count = state.count + 1
    lr = schedule(cfg, count)
    b1c = 1 - _f32(cfg.b1) ** count.float()
    b2c = 1 - _f32(cfg.b2) ** count.float()

    def upd(p, g, m, v):
        g = g.float()
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.dim() >= 2:
            step = step + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))

    tree_map(upd, params, grads, state.mu, state.nu)
    return params, OptState(state.mu, state.nu, count), \
        {"grad_norm": gnorm, "lr": lr}
