"""Paged KV arena: fixed-size pages drawn from one shared device pool and
indexed through an on-device page table — the port's copy of
``repro/runtime/paging.py``.

The fixed ``num_slots x cache_len`` arena provisions every slot for the
longest request.  Here a slot's rows become pages of ``page_size`` tokens,
reserved per request for its own prompt + generation only, so a
heavy-tailed trace holds more requests in the same KV rows.

Layout invariants:

* A cache leaf is *pageable* iff its sequence extent tracks ``cache_len``
  exactly, with layout ``(stack, batch, seq, ...)``.  The probe reads the
  shapes ``init_cache`` gives on the ``meta`` device, so it allocates
  nothing.  Rolling sliding-window caches (seq extent pinned at
  ``window < cache_len``) stay in the fixed arena; a family with no
  pageable leaf keeps the fixed arena whole.
* A pool leaf is ``(stack, num_pages, page_size, *rest)``, e.g.
  ``(L, num_pages, page_size, KVH, hd)``; the page table, an ``int32``
  ``(num_slots, max_pages)`` tensor under ``"pages"``, maps logical page
  ``j`` of a slot to a physical page.
* Page id 0 is the DUMP page: writes from dead or unreserved rows land
  there and it is never read.  A zeroed page table is therefore safe.
* ``cache_len`` is rounded up to a multiple of ``page_size``, so a slot's
  gathered view ``(batch, max_pages * page_size, *rest)`` has exactly the
  fixed arena's shape and paged decode equals the fixed arena bit for bit.
* ``kv_dtype="fp32"`` (the reference's name for unquantised pages) keeps
  pages in the cache's own dtype.  ``"int8"`` pools hold per-token-row
  quantized K/V (``optim.compression.quantize_rows``) beside a
  ``<key>_scale`` fp32 pool ``(stack, num_pages, page_size)``; the paged
  view dequantizes through it (a gated logit tolerance, not bit-exact).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DUMP_PAGE = 0
KV_DTYPES = ("fp32", "int8")


@dataclasses.dataclass(frozen=True)
class PagedSpec:
    """Static description of a paged arena."""
    page_size: int
    num_pages: int            # total physical pages, including DUMP page 0
    max_pages: int            # page-table width = cache_len // page_size
    cache_len: int            # rounded up to a multiple of page_size
    kv_dtype: str             # "fp32": the cache's own dtype; or "int8"
    paged_keys: Tuple[str, ...]

    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1

    def pages_needed(self, total_tokens: int) -> int:
        """Physical pages covering positions ``0..total_tokens-1``."""
        return -(-total_tokens // self.page_size)

    def page_row(self, ids: Sequence[int]) -> np.ndarray:
        """(max_pages,) int32 logical->physical row; unreserved -> DUMP."""
        row = np.zeros((self.max_pages,), np.int32)
        row[: len(ids)] = np.asarray(ids, np.int32)
        return row


def discover_paged_keys(api: Any, cache_len: int) -> Tuple[str, ...]:
    """Top-level cache keys whose seq extent tracks ``cache_len`` exactly.

    Probes ``init_cache`` shapes on the ``meta`` device at two lengths and
    two batch sizes: a leaf is pageable iff the only differing axis across
    lengths is axis 2, equal to the probe length at both probes, and its
    batch axis is axis 1."""
    if cache_len < 2:
        return ()
    meta = torch.device("meta")
    t1 = api.init_cache(2, cache_len, device=meta)
    t2 = api.init_cache(2, cache_len // 2, device=meta)
    tb = api.init_cache(1, cache_len, device=meta)
    keys = []
    for key, leaf in t1.items():
        s1, s2, sb = leaf.shape, t2[key].shape, tb[key].shape
        if len(s1) != len(s2) or len(s1) < 3:
            continue
        diff = [i for i in range(len(s1)) if s1[i] != s2[i]]
        if diff != [2] or s1[2] != cache_len or s2[2] != cache_len // 2:
            continue
        if [i for i in range(len(s1)) if s1[i] != sb[i]] != [1]:
            continue
        keys.append(key)
    return tuple(sorted(keys))


def build_spec(api: Any, num_slots: int, cache_len: int,
               page_size: Optional[int], num_pages: Optional[int] = None,
               kv_dtype: str = "fp32") -> Tuple[Optional[PagedSpec], int]:
    """Resolve (spec, effective cache_len) for an engine's arena.

    Returns ``(None, cache_len)`` when paging is off or the family exposes
    no pageable leaf.  Otherwise cache_len is rounded up to a multiple of
    page_size so pooled views match the fixed arena's shapes."""
    if not page_size:
        return None, cache_len
    if page_size < 1 or page_size & (page_size - 1):
        raise ValueError(f"page_size must be a power of two, got {page_size}")
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, "
                         f"got {kv_dtype!r}")
    clen = -(-cache_len // page_size) * page_size
    keys = discover_paged_keys(api, clen)
    if not keys:
        return None, cache_len
    maxp = clen // page_size
    if num_pages is None:
        num_pages = num_slots * maxp + 1          # fixed-arena capacity + DUMP
    if num_pages < maxp + 1:
        raise ValueError(
            f"num_pages={num_pages} cannot hold one full slot "
            f"({maxp} pages) plus the DUMP page")
    spec = PagedSpec(page_size=page_size, num_pages=num_pages,
                     max_pages=maxp, cache_len=clen, kv_dtype=kv_dtype,
                     paged_keys=keys)
    return spec, clen


def paged_tree(base: Dict[str, torch.Tensor], num_slots: int,
               spec: PagedSpec) -> Dict[str, torch.Tensor]:
    """Rewrite a (promoted) fixed arena tree into its paged form: paged
    leaves become zeroed pools ``(stack, num_pages, page_size, *rest)``
    in their own dtype, or int8 beside a ``<key>_scale`` fp32 leaf
    ``(stack, num_pages, page_size)``, and a zeroed (all-DUMP) ``"pages"``
    table is added.  ``base`` may live on the ``meta`` device."""
    out: Dict[str, torch.Tensor] = {}
    ref = None
    for key, leaf in base.items():
        if key in spec.paged_keys:
            shape = leaf.shape
            if shape[1] != num_slots or shape[2] != spec.cache_len:
                raise ValueError(f"leaf {key!r} of shape {tuple(shape)} is "
                                 "not a fixed arena of this spec")
            pool = (shape[0], spec.num_pages, spec.page_size)
            if spec.kv_dtype == "int8":
                out[key] = leaf.new_zeros(pool + tuple(shape[3:]),
                                          dtype=torch.int8)
                out[key + "_scale"] = leaf.new_zeros(pool,
                                                     dtype=torch.float32)
            else:
                out[key] = leaf.new_zeros(pool + tuple(shape[3:]))
            ref = leaf
        else:
            out[key] = leaf
            ref = ref if ref is not None else leaf
    out["pages"] = torch.zeros((num_slots, spec.max_pages),
                               dtype=torch.int32, device=ref.device)
    return out


class PageAllocator:
    """Host-side physical-page accounting: deterministic lowest-id-first.

    Pages ``1..num_pages-1`` are allocatable (0 is the DUMP page).  Reserve
    happens at admission time (head-of-line blocking when the pool is
    exhausted), free at finish."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: List[int] = list(range(1, num_pages))
        heapq.heapify(self._free)
        self._held: set = set()

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def reserve(self, n: int) -> Optional[List[int]]:
        """Lowest-id ``n`` free pages, or None if the pool can't cover it."""
        if n < 0 or n > len(self._free):
            return None
        ids = [heapq.heappop(self._free) for _ in range(n)]
        self._held.update(ids)
        return ids

    def free(self, ids: Sequence[int]) -> None:
        for i in ids:
            if i not in self._held:
                raise ValueError(f"freeing page {i} that is not reserved")
            self._held.discard(i)
            heapq.heappush(self._free, i)

    def state_dict(self) -> Dict[str, Any]:
        """JSON-serialisable snapshot (the held pages); the engine's
        tick-start snapshots and disk checkpoints carry it."""
        return {"num_pages": self.num_pages, "held": sorted(self._held)}

    @classmethod
    def from_state_dict(cls, state: Dict[str, Any]) -> "PageAllocator":
        """Inverse of ``state_dict``: the free heap is rebuilt from the
        held set, so later reservations (lowest id first) equal the
        original allocator's."""
        alloc = cls(int(state["num_pages"]))
        alloc._held = set(int(i) for i in state["held"])
        alloc._free = [i for i in range(1, alloc.num_pages)
                       if i not in alloc._held]
        heapq.heapify(alloc._free)
        return alloc
