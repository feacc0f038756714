"""Device meshes over ``torch.distributed``.

Counterpart of ``repro/launch/mesh.py``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names, built over a process group the caller has already initialised
(``torch.distributed.init_process_group``: its backend, address, rank and
world size are the caller's); building one never starts a group. There is
no module-level mesh: importing this module touches no device and no
process group.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def production_shape(*, multi_pod: bool = False) -> Dict[str, int]:
    """The production mesh's axis sizes: 16 x 16 (one pod, 256 ranks) or 2
    x 16 x 16 (two pods, 512 ranks)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def host_shape(data: int = 1, model: int = 1, pod: int = 0
               ) -> Dict[str, int]:
    """A small mesh's axis sizes: (data, model), or (pod, data, model)."""
    if pod:
        return {"pod": pod, "data": data, "model": model}
    return {"data": data, "model": model}


def _mesh(sizes: Dict[str, int], device_type: str) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "torch.distributed.init_process_group first")
    n = math.prod(sizes.values())
    if dist.get_world_size() != n:
        raise ValueError(f"a {tuple(sizes.values())} mesh needs {n} ranks, "
                         f"the group has {dist.get_world_size()}")
    return DeviceMesh(device_type,
                      torch.arange(n).reshape(tuple(sizes.values())),
                      mesh_dim_names=tuple(sizes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The 16 x 16 (or 2 x 16 x 16) mesh over a group of as many ranks."""
    return _mesh(production_shape(multi_pod=multi_pod), device_type)


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0, *,
                   device_type: str = "cuda") -> DeviceMesh:
    """A small (data, model) or (pod, data, model) mesh over every rank of
    the initialised group, rank-major in that order (tests, examples)."""
    return _mesh(host_shape(data, model, pod), device_type)


def dp_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The mesh's batch axes, in its order."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
