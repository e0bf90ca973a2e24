"""Straggler detection — the port's own copy of
``repro/runtime/straggler.py`` (numpy only).

With synchronous data parallelism one slow host gates every step.  The
detector keeps per-host EMA step times; hosts slower than ``threshold x
median`` are flagged, and a host flagged ``evict_after`` steps in a row is
recommended for eviction.  The serving engine routes an eviction through
the same snapshot -> restore path as a detected device loss
(``runtime.engine.ServeEngine``).  A single-device engine has one host,
whose EMA is its own median, so it never evicts.

Observation and query are separate: ``record`` feeds one host's step time,
``observe`` closes the step (advancing the per-host flagged streaks
exactly once), and ``stragglers``/``evictions`` are side-effect-free
queries, callable any number of times per step.  ``reassign_shards`` is
the deterministic round-robin shard -> healthy-host map.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class StragglerConfig:
    ema: float = 0.9
    threshold: float = 1.5      # x median EMA step time
    evict_after: int = 20       # consecutive flagged steps


class StragglerDetector:
    def __init__(self, num_hosts: int,
                 cfg: StragglerConfig = StragglerConfig()):
        if num_hosts < 1:
            raise ValueError("need at least one host")
        self.cfg = cfg
        self.num_hosts = num_hosts
        self.ema = np.zeros(num_hosts)
        self.flagged_streak = np.zeros(num_hosts, dtype=int)
        self._seen = np.zeros(num_hosts, dtype=bool)

    def record(self, host: int, step_time: float) -> None:
        """Feed one host's measured step time (any number per step; the
        EMA absorbs them)."""
        if not self._seen[host]:
            self.ema[host] = step_time
            self._seen[host] = True
        else:
            self.ema[host] = (self.cfg.ema * self.ema[host] +
                              (1 - self.cfg.ema) * step_time)

    def stragglers(self) -> List[int]:
        """Hosts currently slower than ``threshold x median`` EMA — a pure
        query."""
        if not self._seen.any():
            return []
        med = float(np.median(self.ema[self._seen]))
        return [int(h) for h in np.nonzero(self._seen)[0]
                if self.ema[h] > self.cfg.threshold * med]

    def observe(self) -> List[int]:
        """Close one step: advance each flagged host's streak (reset the
        rest) exactly once, and return the flagged hosts."""
        flagged = self.stragglers()
        hit = np.zeros(self.num_hosts, dtype=bool)
        hit[flagged] = True
        self.flagged_streak = np.where(hit, self.flagged_streak + 1, 0)
        return flagged

    def evictions(self) -> List[int]:
        """Hosts whose flagged streak reached ``evict_after`` (a pure
        query)."""
        return [int(h) for h in
                np.nonzero(self.flagged_streak >= self.cfg.evict_after)[0]]


def reassign_shards(num_shards: int,
                    healthy: List[int]) -> Dict[int, List[int]]:
    """Round-robin shard -> healthy-host map (deterministic)."""
    if not healthy:
        raise ValueError("no healthy hosts")
    plan: Dict[int, List[int]] = {h: [] for h in healthy}
    for s in range(num_shards):
        plan[healthy[s % len(healthy)]].append(s)
    return plan
