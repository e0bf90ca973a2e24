"""Plain PyTorch version of the batch_eval kernel: the greedy schedule of
``repro_torch.core.scheduler`` for one shared (d1, d2, d3), batched over the
tiles with boolean tensors.  It follows the JAX package's
``kernels/batch_eval/ops.py::_schedule_cycles`` step by step: every tile
runs the loop body while any tile still has work, and a finished tile's
state is left as it was (the ``vmap`` of a ``while_loop``).  The wrapper
runs it on CPU tensors; on the card the kernel is held against it."""
from __future__ import annotations

import torch

from ...core.scheduler import _offsets


def schedule_cycles_ref(mask: torch.Tensor, d1: int, d2: int, d3: int
                        ) -> torch.Tensor:
    """Executed cycles per tile.  ``mask``: (tiles, T, K0, G) bool, lanes
    already shuffled; T and tiles nonzero.  Returns (tiles,) int64 on the
    mask's device."""
    tiles, T, K0, G = mask.shape
    dev = mask.device
    win = d1 + 1
    offs = _offsets(d2, d3)
    R = mask.clone()
    f = torch.zeros(tiles, dtype=torch.int64, device=dev)
    cycles = torch.zeros_like(f)
    t_grid = torch.arange(T, device=dev)
    rows = torch.arange(tiles, device=dev)
    while True:
        live = R.flatten(1).any(dim=1)             # the loop's condition
        if not bool(live.any()):
            break
        occ = torch.zeros((tiles, K0, G), dtype=torch.bool, device=dev)
        for dt in range(min(win, T)):              # oldest chunk first
            tt = f + dt
            valid = live & (tt < T)
            ttc = tt.clamp(max=T - 1)
            chunk = R[rows, ttc] & valid[:, None, None]
            for (dl, dg) in offs:
                # lanes: a one-sided window, no wrap; PE groups: a ring
                src = chunk[:, dl:] if dl else chunk
                src = torch.roll(src, -dg, dims=2) if dg else src
                occ_v = occ[:, :K0 - dl] if dl else occ
                put = src & ~occ_v
                if dl:
                    occ[:, :K0 - dl] |= put
                else:
                    occ |= put
                taken = torch.roll(put, dg, dims=2) if dg else put
                if dl:
                    chunk[:, dl:] &= ~taken
                else:
                    chunk &= ~taken
            R[rows, ttc] = torch.where(valid[:, None, None], chunk,
                                       R[rows, ttc])
        cycles += live.long()
        chunk_any = R.flatten(2).any(dim=2)
        cand = torch.where(chunk_any & (t_grid[None, :] >= f[:, None]),
                           t_grid[None, :], T).amin(dim=1)
        f = torch.where(live, torch.minimum(cand, f + win), f)  # front
    tail = (T - f).clamp(min=0)
    return cycles + (tail + win - 1) // win        # trailing travel
