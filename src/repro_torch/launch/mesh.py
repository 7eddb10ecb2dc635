"""The host mesh: a ``(data, model)`` grid of ``torch.distributed`` ranks (port
of repro/launch/mesh.py's ``make_host_mesh``).

Rank ``r`` sits at ``(r // model, r % model)``, the device order of
``jax.make_mesh((data, model), ("data", "model"))``.  Each axis of size > 1
gets one process group per line of the grid: a ``model`` group per data
row (the ranks that hold one replica's shards) and a ``data`` group per
model column (the ranks that hold the same shard of different replicas).
Every rank makes every group, in the same order, as ``dist.new_group``
requires.  The reference's ``make_production_mesh`` (256 TPU chips) is
reference-only.
"""
from __future__ import annotations

import dataclasses

import torch.distributed as dist

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """A ``(data, model)`` rank grid: ``shape`` ({axis: size}), this rank's
    ``coords`` ({axis: index}) and ``groups`` ({axis: the process group of
    this rank's line along the axis}, None for an axis of size 1)."""

    shape: dict
    coords: dict
    groups: dict
    rank: int = 0
    axis_names: tuple = AXES

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]


def make_host_mesh(data: int = 1, model: int = 1) -> HostMesh:
    """The ``data x model`` grid over the default process group (which the
    caller has made: ``torch.distributed.run`` or ``init_process_group``); a
    1 x 1 mesh needs none.  Raises ``ValueError`` when the group's world size
    is not ``data * model``, as the reference's ``jax.make_mesh`` refuses a
    mesh its devices cannot fill."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data} model={model}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != data * model:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} ranks; WORLD_SIZE is "
                         f"{world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    coords = {"data": rank // model, "model": rank % model}
    groups: dict = {"data": None, "model": None}
    if model > 1:
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if d == coords["data"]:
                groups["model"] = g
    if data > 1:
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if m == coords["model"]:
                groups["data"] = g
    return HostMesh(shape={"data": data, "model": model}, coords=coords, groups=groups,
                    rank=rank)
