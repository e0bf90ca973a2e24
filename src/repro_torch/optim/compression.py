"""Row-wise int8 quantization — the port's copy of ``quantize_rows`` and
``dequantize_rows`` from ``repro/optim/compression.py``.

The paged KV arena's int8 pools (``runtime/paging.py``) store one fp32
scale per written token row: ``max |x|`` over the row, floored at
``1e-12``, over 127; values are rounded half to even (``torch.round``, as
``jnp.round``) and clipped to +-127, so both packages give bit-equal
results on the same input.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_rows(x: torch.Tensor, ndim_keep: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One scale per index of the leading ``ndim_keep`` axes: ``x`` of
    shape ``(*lead, *rest)`` gives ``q`` (int8, x's shape) and ``scale``
    (fp32, shape ``lead``)."""
    red = tuple(range(ndim_keep, x.dim()))
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=red), min=1e-12) / 127.0
    s = scale[(...,) + (None,) * len(red)]
    q = torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8)
    return q, scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` (fp32 output)."""
    s = scale[(...,) + (None,) * (q.dim() - scale.dim())]
    return q.float() * s
