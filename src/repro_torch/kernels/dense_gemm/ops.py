"""Public wrapper of the dense GEMM kernel (K1): checks, then the kernel on
CUDA tensors or its plain version on CPU tensors; and its shard entry, the
kernel on one mesh rank's slice of the weight's output columns."""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from . import kernel
from .ref import dense_matmul_ref


def check_dtypes(op: str, a: torch.Tensor, w: torch.Tensor) -> None:
    """Raise unless (A, weight) is a dtype pair the kernels take: both
    float32, both bfloat16, or float32 A with a bfloat16 weight."""
    if (a.dtype, w.dtype) not in kernel.PAIR_CODES:
        raise TypeError(f"{op} dtypes {a.dtype} x {w.dtype}: both float32, "
                        "both bfloat16, or float32 x bfloat16")


def dense_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with an fp32 accumulator, C in ``a.dtype``.

    ``a``: contiguous (M, K); ``b``: (K, N) of the same dtype, or bf16
    against an fp32 ``a``, on the same device, any strides (the tied
    unembedding passes the view ``embed.T``).  Unlike the TPU wrapper
    nothing is padded: the kernel masks ragged edges.
    """
    _checked(a, b)
    if a.device.type == "cpu":
        return dense_matmul_ref(a, b)
    return kernel.dense_gemm(a, b)


def _checked(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"dense_matmul shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    check_dtypes("dense_matmul", a, b)
    if a.device != b.device:
        raise ValueError(f"dense_matmul devices {a.device} x {b.device}")
    if not a.is_contiguous():
        raise ValueError("dense_matmul needs a contiguous A")
    if min(a.shape[0], a.shape[1], b.shape[1]) < 1 or \
            max(a.shape[0], a.shape[1], b.shape[1]) >= 2 ** 31:
        raise ValueError(f"dense_matmul dims out of range: {tuple(a.shape)} "
                         f"x {tuple(b.shape)}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dense_matmul runs on cuda or cpu, not {a.device}")


@dataclasses.dataclass
class DenseShard:
    """One model rank's share of a dense weight leaf on a serving mesh
    (``runtime.sharding.shard_params``): ``local`` holds the leaf's output
    columns ``[rank * N / shards, (rank + 1) * N / shards)`` of every
    stacked matrix, ``n`` is the whole leaf's N.  ``griffin_linear`` runs
    the shard entries on it and gathers the columns over the model axis;
    a layer of a stacked leaf is ``shard[i]``, as for a tensor."""

    local: torch.Tensor
    n: int
    shards: int

    @property
    def shape(self) -> Tuple[int, ...]:
        """The whole leaf's shape."""
        return tuple(self.local.shape[:-1]) + (self.n,)

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    def __getitem__(self, i) -> "DenseShard":
        return dataclasses.replace(self, local=self.local[i])

    def unbind(self, dim: int = 0) -> List["DenseShard"]:
        if dim != 0:
            raise ValueError("a shard unbinds its stacked axis only")
        return [self[i] for i in range(self.local.shape[0])]


def shardable(b, n_shards: int) -> bool:
    """True when the weight's output axis splits evenly over the shards
    (the reference's predicate)."""
    return b.dim() == 2 and n_shards >= 1 and b.shape[1] % n_shards == 0


def dense_matmul_shard(a: torch.Tensor, w: DenseShard) -> torch.Tensor:
    """The shard entry: (M, N / shards) = A @ this rank's columns, the
    whole K on every rank (a serving mesh never splits a contraction).  On
    a CUDA ``a`` the kernel takes the route of the whole (K, N) weight, so
    each output's summation order, and so its bits, never depend on the
    mesh; on a CPU ``a`` the plain version runs."""
    b = w.local
    if b.dim() != 2 or w.n != b.shape[1] * w.shards:
        raise ValueError(f"dense_matmul_shard takes one matrix's shard, "
                         f"got {tuple(b.shape)} of N {w.n} / {w.shards}")
    if a.device.type == "cuda":
        _checked(a, b)
        return kernel.dense_gemm(a, b, full_n=w.n)
    return dense_matmul(a, b)
