"""Public wrapper of the schedule kernel: the port's counterpart of the JAX
package's ``kernels/batch_eval/ops.py::schedule_cycles``, with the same
limits, on the card or (asked for) the CPU."""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ...core.scheduler import shuffle_lanes
from ...device import resolve_device
from . import kernel
from .ref import schedule_cycles_ref

# the reference's window-chunks x offsets budget, kept so both packages
# accept the same configs (the kernel itself does not unroll)
MAX_UNROLL = 512
# a chunk's K0 x G bits are one 64-bit word in the kernel
MAX_CHUNK_BITS = 64


def schedule_cycles(mask: np.ndarray, d1: int, d2: int, d3: int,
                    shuffle: bool = False,
                    device: Optional[Union[str, torch.device]] = "cuda"
                    ) -> np.ndarray:
    """Executed-cycle counts of the greedy schedule for one config.

    mask: (tiles, T, K0, G) boolean.  Returns (tiles,) int64, equal to
    ``core.scheduler.schedule(mask, d1, d2, d3, shuffle).cycles``.  On the
    card it launches ``csrc/batch_eval.cu``; with ``device="cpu"`` it runs
    the plain PyTorch version.
    """
    mask = np.asarray(mask)
    if mask.ndim != 4:
        raise ValueError(f"mask must be (tiles, T, K0, G), got {mask.shape}")
    if (d1 + 1) * (1 + d2) * (1 + d3) > MAX_UNROLL:
        raise ValueError(
            f"config ({d1},{d2},{d3}) unrolls past {MAX_UNROLL} placement "
            "steps per cycle; use the numpy engine for deep windows")
    tiles, T, K0, G = mask.shape
    if K0 * G > MAX_CHUNK_BITS:
        raise ValueError(f"a chunk of K0 x G = {K0} x {G} bits does not fit "
                         f"the kernel's {MAX_CHUNK_BITS}-bit word")
    dev = resolve_device(device)
    if T == 0 or tiles == 0:
        return np.zeros(tiles, dtype=np.int64)
    if shuffle:
        mask = shuffle_lanes(mask, chunk_axis=1, lane_axis=2)
    m = torch.from_numpy(np.ascontiguousarray(mask, dtype=bool)).to(dev)
    if m.device.type == "cpu":
        out = schedule_cycles_ref(m, int(d1), int(d2), int(d3))
    else:
        out = kernel.batch_eval(m, int(d1), int(d2), int(d3))
    return out.cpu().numpy().astype(np.int64)
