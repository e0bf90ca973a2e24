"""Mesh planning and resharding — the counterpart of
``repro/runtime/elastic.py``.

``plan_mesh_shape`` / ``plan_mesh`` pick the ("data", "model") mesh for a
number of devices and a tensor-parallel cap (``launch/serve.py
--model-parallel``), ``surviving`` lists a mesh's devices minus lost ones,
and ``reshard`` cuts a host parameter tree down to one rank's share on its
device (what ``MeshServeEngine`` serves).  After a device loss or a
straggler eviction the mesh engine plans the survivors' mesh with
``plan_mesh`` over ``surviving`` (``launch.mesh.regroup``) and cuts each
new rank's share from the whole host tree with ``reshard``, whatever the
new model axis (2x4 -> 2x2 doubles every share's width).
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple


def _pow2_floor(n: int) -> int:
    return 1 << (int(n).bit_length() - 1)


def plan_mesh_shape(n_devices: int, model_parallel: int) -> Tuple[int, int]:
    """The (data, model) shape :func:`plan_mesh` builds, with the
    reference's contract: both axes powers of two; the model axis the
    largest power of two <= ``model_parallel`` that fits ``n_devices`` (a
    lone survivor serves 1x1 whatever the requested degree); the data axis
    the largest power-of-two number of model-axis blocks; devices beyond
    ``data * model`` are dropped."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if model_parallel < 1:
        raise ValueError(f"model_parallel must be >= 1, got {model_parallel}")
    model = _pow2_floor(min(model_parallel, n_devices))
    data = _pow2_floor(max(n_devices // model, 1))
    return data, model


class PlannedMesh(NamedTuple):
    """A planned mesh: its shape and the devices (ranks or
    ``torch.device``s) it uses, in mesh order (row-major)."""
    data: int
    model: int
    devices: List[Any]

    @property
    def spec(self) -> str:
        """The ``"DxM"`` spec ``launch.mesh.serve_mesh`` takes."""
        return f"{self.data}x{self.model}"


def plan_mesh(n_devices: int, model_parallel: int,
              devices: Optional[Sequence] = None) -> PlannedMesh:
    """The largest ("data", "model") mesh that fits ``n_devices`` with a
    tensor-parallel degree of at most ``model_parallel``
    (:func:`plan_mesh_shape`) over ``devices`` (default the ranks
    0..n-1)."""
    data, model = plan_mesh_shape(n_devices, model_parallel)
    use = data * model
    devs = list(range(n_devices) if devices is None else devices)
    if len(devs) < use:
        raise ValueError(f"planned mesh {data}x{model} needs {use} devices, "
                         f"have {len(devs)}")
    return PlannedMesh(data, model, devs[:use])


def _device_id(d: Any) -> int:
    return int(d if isinstance(d, int) else d.index)


def surviving(mesh_devices: Sequence, lost_ids: Sequence[int]) -> List:
    """A mesh's devices (ranks, or ``torch.device``s by index) minus the
    lost ids, in mesh order."""
    lost = set(int(i) for i in lost_ids)
    return [d for d in mesh_devices if _device_id(d) not in lost]


def reshard(state: Any, mesh) -> Any:
    """This rank's share of a (host or device) parameter tree on ``mesh``:
    ``runtime.sharding.shard_params`` after a move to the rank's device
    (leaves moved one at a time; none for a mesh not placed on one)."""
    from .sharding import shard_params
    if mesh.device is not None:
        state = _to(state, mesh.device)
    return shard_params(state, mesh)


def _to(tree: Any, device) -> Any:
    import dataclasses

    import torch

    from ..kernels.griffin_spmm.ops import GriffinWeights
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, GriffinWeights):
        return dataclasses.replace(tree, **{
            f.name: _to(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree
