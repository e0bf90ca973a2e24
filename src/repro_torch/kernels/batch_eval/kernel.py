"""Launch of the hand-written schedule kernel (``csrc/batch_eval.cu``), the
card's replacement for ``repro/kernels/batch_eval/ops.py``'s
``_schedule_cycles``, and the plan of its two routes."""
from __future__ import annotations

import ctypes

import torch

from .. import build

NAME = "batch_eval"
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
             + [ctypes.c_void_p])
# route codes of the C interface
CHAIN, SCAN = 0, 1
ROUTE_CODES = {"chain": CHAIN, "scan": SCAN}
LANES = 32                # a warp: the scan route's lanes
CHAIN_MAX_TILES = 32      # a chain block is one warp, a thread a tile
SMS = 132                 # the H100's streaming multiprocessors


def route(d1: int, d2: int, d3: int) -> str:
    """Which body schedules a config: ``scan`` where no borrow exists (d2 =
    d3 = 0), so a cycle's placement is an exclusive prefix OR over the
    window, a warp a tile; else ``chain``, a thread a tile walking its
    window chunk by chunk.  A function of the config alone, never of the
    data."""
    return "scan" if d2 == 0 and d3 == 0 else "chain"


def chain_tiles(tiles: int) -> int:
    """Tiles per one-warp block on the chain route: the least power of two
    that puts a stream on at most ``SMS`` blocks, up to 32 (a function of
    the tile count alone)."""
    per = 1
    while per < CHAIN_MAX_TILES and -(-tiles // per) > SMS:
        per *= 2
    return per


def _lib():
    lib = build.library(NAME)
    if lib.batch_eval.argtypes is None:
        lib.batch_eval.argtypes = _ARGTYPES
        lib.batch_eval.restype = ctypes.c_int
        lib.batch_eval_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.batch_eval_smem_bytes.restype = ctypes.c_int
    return lib


def batch_eval(mask: torch.Tensor, d1: int, d2: int, d3: int
               ) -> torch.Tensor:
    """Executed cycles per tile on the current stream, on the config's
    route.  ``mask`` is a contiguous CUDA (tiles, T, K0, G) bool tensor,
    lanes already shuffled, tiles and T nonzero, K0 * G <= 64; the caller
    (``ops.schedule_cycles``) has validated it.  Returns (tiles,) int64 on
    the card."""
    tiles, T, K0, G = mask.shape
    lib = _lib()
    code = ROUTE_CODES[route(d1, d2, d3)]
    per_block = chain_tiles(tiles)
    out = torch.empty(tiles, dtype=torch.int64, device=mask.device)
    # a tile's words live in shared memory unless T is too long for it
    scratch = None if lib.batch_eval_smem_bytes(T, code, per_block) else \
        torch.empty(tiles * T, dtype=torch.int64, device=mask.device)
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    err = lib.batch_eval(mask.data_ptr(), out.data_ptr(),
                         None if scratch is None else scratch.data_ptr(),
                         tiles, T, K0, G, d1, d2, d3, code, per_block,
                         stream)
    build.check_launch(NAME, err)
    build.count_launch(NAME)
    return out
