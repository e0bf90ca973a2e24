"""End-to-end training driver — the counterpart of
``repro/launch/train.py`` on one device: deterministic synthetic data,
AdamW, checkpoint/restart (atomic, with retention; a run finds the latest
checkpoint in ``--ckpt-dir`` and resumes from it), preemption handling
(SIGTERM saves and exits), the straggler detector's hooks and the optional
Griffin pruning schedule.

    python -m repro_torch.launch.train --arch llama3.2-1b --steps 30 \\
        --batch 8 --seq 128 --prune-sparsity 0.5 --ckpt-dir build/ckpt \\
        --ckpt-every 20

trains full-width llama3.2-1b on the CUDA card (bf16 parameters, float32
moments); run again, it resumes from step 20.  ``--reduced --device cpu``
trains the reduced config on the host.  ``--model-parallel`` other than 1
needs the training layout on a mesh (ROADMAP 1.18; the serving mesh is
``launch/serve.py --mesh``).
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, Optional

import torch

from ..checkpoint import PreemptionGuard, latest_step, restore, save
from ..configs import ShapeConfig, get_config
from ..data import DataConfig, make_iterator
from ..device import resolve_device
from ..models import build_model
from ..optim.adamw import AdamWConfig
from ..runtime.straggler import StragglerDetector
from ..runtime.train import (TrainState, apply_prune, init_state,
                             make_train_step, to_device)
from ..sparsity.pruning import PruneSchedule

# the leaves the pruning schedule prunes (the reference CLI's list)
PRUNED = ("w_gate", "w_up", "w_down", "wq", "wk", "wv", "wo")


def prune_match(path: str) -> bool:
    return any(name in path for name in PRUNED)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--prune-sparsity", type=float, default=0.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, on_step: Optional[Callable] = None) -> Dict:
    """Run the CLI.  Returns what it measured: ``start`` (the step it
    began at), ``restore_s`` (the restore's seconds, or None), per-step
    ``losses``, ``grad_norms`` and ``step_ms`` (host clock around a step
    that ends in a synchronize), the final ``state``, each checkpoint's
    ``(step, seconds, bytes)`` under ``saves`` and whether it was
    ``preempted``.  ``on_step(step, state, metrics)`` is called after
    each step and its pruning."""
    args = parse_args(argv)
    if args.model_parallel != 1:
        raise SystemExit("--model-parallel > 1 needs the training layout "
                         "on a mesh, not ported yet (ROADMAP 1.18)")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = build_model(cfg, device=device)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    opt = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                      total_steps=args.steps)
    step_fn = make_train_step(api, opt)

    state = init_state(api, api.generator(0))
    start, restore_s = 0, None
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        t0 = time.perf_counter()
        state = restore(args.ckpt_dir, state)
        _sync(device)
        restore_s = time.perf_counter() - t0
        start = int(state.step)
        print(f"restored step {start} from {args.ckpt_dir} in "
              f"{restore_s:.2f}s")

    prune = (PruneSchedule(args.prune_sparsity, begin_step=args.steps // 4,
                           ramp_steps=args.steps // 2, block_k=128, unit=32)
             if args.prune_sparsity > 0 else None)

    out = {"start": start, "restore_s": restore_s, "losses": [],
           "grad_norms": [], "step_ms": [], "saves": [], "preempted": False}

    def checkpoint(step: int) -> None:
        t0 = time.perf_counter()
        path = save(args.ckpt_dir, step, state)
        seconds = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        out["saves"].append((step, seconds, nbytes))
        print(f"checkpoint step {step}: {nbytes} bytes in {seconds:.2f}s")

    guard = PreemptionGuard()
    guard.install()
    it = make_iterator(cfg, shape, DataConfig(seed=0), start_step=start)
    detector = StragglerDetector(num_hosts=1)
    try:
        for step in range(start, args.steps):
            t0 = time.perf_counter()
            batch = to_device(next(it), device)
            state, metrics = step_fn(state, batch)
            if prune is not None and step % 25 == 0:
                state = apply_prune(state, prune, match=prune_match)
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            _sync(device)
            dt = time.perf_counter() - t0
            detector.record(0, dt)
            out["losses"].append(loss)
            out["grad_norms"].append(gnorm)
            out["step_ms"].append(dt * 1e3)
            if on_step is not None:
                on_step(step, state, metrics)
            if step % args.log_every == 0:
                print(f"step {step}: loss={loss:.4f} gnorm={gnorm:.3f} "
                      f"lr={float(metrics['lr']):.2e} ({dt * 1e3:.0f} ms)")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                checkpoint(step + 1)
            if guard.should_stop:
                if args.ckpt_dir:
                    checkpoint(step + 1)
                out["preempted"] = True
                print("preemption requested: checkpointed and exiting")
                break
    finally:
        it.close()
        guard.uninstall()
    if out["losses"]:
        print(f"final loss: {out['losses'][-1]:.4f}")
    else:
        print(f"nothing to run: step {start} of {args.steps}")
    out["state"] = state
    return out


if __name__ == "__main__":
    main()
