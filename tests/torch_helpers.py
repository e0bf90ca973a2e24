"""Helpers shared by the port's tests (no JAX: the card's tests import
them too)."""
import torch


class TwoPass:
    """A model rank's mesh for one decode block run rank by rank in one
    process: the first pass records what the rank gathers over "model"
    (``rec``), the second returns every rank's recorded tensor."""

    def __init__(self, m: int, M: int, rec: dict, replay: bool):
        self.m, self.model, self.rec, self.replay = m, M, rec, replay
        self.size, self.shape = M, {"data": 1, "model": M}

    def index(self, axis: str) -> int:
        return self.m if axis == "model" else 0

    def gather(self, t, axis, site=None):
        assert axis == "model"
        if self.replay:
            return torch.stack([self.rec[j] for j in range(self.model)])
        self.rec[self.m] = t.clone()
        return torch.stack([t] * self.model)
