"""Mesh topology, the single source of truth for the port's data and model
axes.

Port of ``repro/launch/mesh.py``.  Every topology is one
:class:`MeshDescriptor`: logical shape, axis names, which axes are
data-parallel and which cross the inter-pod interconnect (``dci_axes``).
``build()`` materialises it as a ``torch.distributed`` ``DeviceMesh`` over
the process group (one process a device, launched by ``torchrun``); the
sharding rules (``repro_torch/sharding.py``) take the descriptor itself
for their spec math, which needs no process group.

The production meshes (one pod of 16 × 16 and two pods of 2 × 16 × 16)
have a model axis of 16, which the dense family runs (``sharding.py``);
the host mesh ``(world, 1)`` is pure data parallelism.  ``build()``'s
rank order is ``jax.make_mesh``'s: row-major, the model axis fastest
(rank = data index · model size + model index).

Functions, not module constants: importing this module touches no
device and no process group.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class MeshDescriptor:
    """Logical description of one mesh topology.

    ``dci_axes``: axes whose collectives cross the inter-pod interconnect;
    collectives over the remaining ``ici_axes`` stay inside a pod.
    ``build()`` needs a process group of ``device_count`` ranks."""
    name: str
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    data_axes: tuple[str, ...]
    model_axis: str = "model"
    dci_axes: tuple[str, ...] = ()

    @property
    def device_count(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def ici_axes(self) -> tuple[str, ...]:
        return tuple(a for a in self.axis_names if a not in self.dci_axes)

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    @property
    def data_axis_size(self) -> int:
        n = 1
        for a in self.data_axes:
            n *= self.axis_size(a)
        return n

    def build(self, device_type: str = "cuda"):
        """The ``DeviceMesh`` of this topology over the initialised process
        group (its world size must be ``device_count``)."""
        from torch.distributed.device_mesh import init_device_mesh
        return init_device_mesh(device_type, self.shape,
                                mesh_dim_names=self.axis_names)


def production_descriptor(multi_pod: bool = False,
                          shape: tuple[int, ...] | None = None
                          ) -> MeshDescriptor:
    """The deployment topologies.  ``shape``: an optional (data, model)
    override for the 256 devices of one pod (e.g. (64, 4))."""
    if shape is not None:
        if multi_pod or len(shape) != 2:
            raise ValueError(f"shape {shape} overrides one pod's "
                             f"(data, model) only")
        return MeshDescriptor(name=f"pod{shape[0]}x{shape[1]}",
                              shape=tuple(shape),
                              axis_names=("data", "model"),
                              data_axes=("data",))
    if multi_pod:
        return MeshDescriptor(name="multi_pod", shape=(2, 16, 16),
                              axis_names=("pod", "data", "model"),
                              data_axes=("pod", "data"),
                              dci_axes=("pod",))
    return MeshDescriptor(name="single_pod", shape=(16, 16),
                          axis_names=("data", "model"),
                          data_axes=("data",))


def world_size() -> int:
    """The process group's world size; before the group is joined, the
    one ``torchrun`` gave this process (``WORLD_SIZE``), or 1 without
    ``torchrun``."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def join_from_env(device: torch.device) -> torch.device:
    """Join the process group ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``):
    NCCL on the card, each rank on ``cuda:LOCAL_RANK``; gloo on the CPU.
    Without ``torchrun`` (no ``WORLD_SIZE``) nothing is joined.  Returns
    this rank's device."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", device_id=device)
    else:
        dist.init_process_group("gloo")
    return device


def host_descriptor(n_devices: int | None = None) -> MeshDescriptor:
    """(world, 1) topology for the launchers: the data axis spans every
    rank of the process group (``torchrun``), or the one process without
    a group."""
    n = world_size() if n_devices is None else n_devices
    return MeshDescriptor(name=f"host{n}", shape=(n, 1),
                          axis_names=("data", "model"),
                          data_axes=("data",))


def data_axes(multi_pod: bool = False) -> tuple[str, ...]:
    return production_descriptor(multi_pod).data_axes


def data_axis_size(mesh, daxes: tuple[str, ...] = ("data",)) -> int:
    """Number of data-parallel replicas of a ``DeviceMesh`` or a
    descriptor: the product of its data axes, the row multiple the
    planner balances batches against."""
    if isinstance(mesh, MeshDescriptor):
        return mesh.data_axis_size
    n = 1
    for a in daxes:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n
