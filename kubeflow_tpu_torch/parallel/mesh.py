"""The device mesh of the port (port of kubeflow_tpu/parallel/mesh.py).

The reference's axis vocabulary, in its outer-to-inner order:

- ``dcn``    data parallelism across slices (here: across nodes);
- ``data``   data parallelism (gradient all-reduce);
- ``fsdp``   data parallelism with the parameters and the optimizer
             state sharded (FSDP2 `fully_shard`);
- ``pipe``   pipeline stages (parallel/pipeline.py: GPipe over
             send/recv);
- ``expert`` data parallelism that also splits the MoE experts (the
             sparse dispatch exchanges tokens over it, ops/moe.py);
- ``seq``    sequence parallelism: each rank holds L/seq positions of
             every row (ops/ring_attention.py, ops/ulysses.py);
- ``model``  tensor parallelism (Megatron-style column/row shards).

One process drives one device, so a mesh is an array of global ranks:
`rank_layout` lays them out (row-major in the canonical order, `dcn`
outermost, `model` innermost: the ranks of one model group are
neighbours on one node), `Mesh` wraps that array with the process
groups its axes need and the torch DeviceMesh FSDP2 takes
(`init_device_mesh(device_type, shape, mesh_dim_names=AXIS_NAMES)`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import numpy as np

AXIS_DCN = "dcn"
AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_PIPELINE = "pipe"
AXIS_EXPERT = "expert"
AXIS_SEQ = "seq"
AXIS_MODEL = "model"

_AXIS_ORDER = (AXIS_DCN, AXIS_DATA, AXIS_FSDP, AXIS_PIPELINE, AXIS_EXPERT,
               AXIS_SEQ, AXIS_MODEL)
AXIS_NAMES: tuple[str, ...] = _AXIS_ORDER

# the axes the global batch is sharded over
BATCH_AXES = (AXIS_DCN, AXIS_DATA, AXIS_FSDP, AXIS_EXPERT)



@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical parallelism spec, the reference's axes; data = -1 means
    "whatever is left over", resolved against the world size."""

    dcn: int = 1
    data: int = -1
    fsdp: int = 1
    pipe: int = 1
    expert: int = 1
    seq: int = 1
    model: int = 1

    def resolve(self, n_devices: int) -> "MeshSpec":
        """Resolve data=-1 against the device count; validate divisibility."""
        fixed = (self.dcn * self.fsdp * self.pipe * self.expert * self.seq
                 * self.model)
        data = self.data
        if data == -1:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"device count {n_devices} not divisible by non-data axes "
                    f"product {fixed} (spec={self})")
            data = n_devices // fixed
        total = data * fixed
        if total != n_devices:
            raise ValueError(
                f"mesh spec {self} needs {total} devices, have {n_devices}")
        return dataclasses.replace(self, data=data)

    def axis_sizes(self) -> dict[str, int]:
        return {a: getattr(self, a) for a in _AXIS_ORDER}

    @property
    def batch_axes(self) -> tuple[str, ...]:
        return BATCH_AXES

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "MeshSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; "
                             f"known: {sorted(known)}")
        return cls(**{k: int(v) for k, v in d.items()})


def _as_spec(spec) -> MeshSpec:
    if spec is None:
        return MeshSpec()
    return spec if isinstance(spec, MeshSpec) else MeshSpec.from_dict(spec)


def rank_layout(spec: MeshSpec | Mapping[str, Any] | None,
                n_devices: int) -> np.ndarray:
    """The ranks 0..n-1 in the canonical axis order, row-major: what
    the reference's build_mesh gives for devices with no topology."""
    sizes = _as_spec(spec).resolve(n_devices).axis_sizes()
    return np.arange(n_devices).reshape(tuple(sizes[a] for a in _AXIS_ORDER))


def _grouped() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _world() -> tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    import torch.distributed as dist

    if _grouped():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A rank array over AXIS_NAMES plus this process's place in it.

    `shape` maps each axis to its size (as jax's Mesh.shape); `group(axes)`
    is the process group of the ranks that differ only along `axes`
    (None when that group is this process alone), created collectively on
    first use: every rank asks for the same axes in the same order;
    `index(axes)` is this rank's position in it (row-major over `axes`);
    `device_mesh` is the torch DeviceMesh over the same array (None
    without a process group)."""

    def __init__(self, ranks: np.ndarray, device_type: str = "cuda",
                 device_mesh=None):
        self.ranks = np.asarray(ranks)
        if self.ranks.ndim != len(_AXIS_ORDER):
            raise ValueError(f"rank array of rank {self.ranks.ndim}, want "
                             f"{len(_AXIS_ORDER)} ({AXIS_NAMES})")
        self.device_type = device_type
        self.shape = dict(zip(_AXIS_ORDER, self.ranks.shape))
        self.size = int(self.ranks.size)
        self.rank, world = _world()
        if world != self.size:
            raise ValueError(f"a mesh of {self.size} ranks over a world "
                             f"of {world}")
        where = np.nonzero(self.ranks == self.rank)
        self.coords = dict(zip(_AXIS_ORDER, (int(c[0]) for c in where)))
        self.device_mesh = device_mesh
        self._groups: dict[tuple[str, ...], Any] = {}

    def extent(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.shape[a] for a in axes]))

    def index(self, axes: Sequence[str]) -> int:
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def group_ranks(self, axes: Sequence[str]) -> list[list[int]]:
        """Every group of ranks that differ only along `axes`, each in
        row-major order over `axes`."""
        axes = tuple(axes)
        rest = [a for a in _AXIS_ORDER if a not in axes]
        arr = self.ranks.transpose(
            [_AXIS_ORDER.index(a) for a in rest + list(axes)])
        return [list(map(int, g)) for g in arr.reshape(-1, self.extent(axes))]

    def group(self, axes: Sequence[str]):
        axes = tuple(a for a in _AXIS_ORDER if a in tuple(axes))
        if self.extent(axes) == 1:
            return None
        if axes not in self._groups:
            import torch.distributed as dist

            mine, _ = dist.new_subgroups_by_enumeration(self.group_ranks(axes))
            self._groups[axes] = mine
        return self._groups[axes]


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The ranks along some mesh axes that this rank exchanges with:
    the process group, this rank's index in it and its size. Ops take
    one (None when the axes have extent 1) in place of the reference's
    named axis inside shard_map."""

    group: Any
    rank: int
    size: int

    @property
    def ranks(self) -> list[int]:
        import torch.distributed as dist

        return dist.get_process_group_ranks(self.group)


def axis_group(mesh: "Mesh | None", axes: Sequence[str]) -> AxisGroup | None:
    """The AxisGroup of `axes` on `mesh` (None without a mesh or when
    their extent is 1). Collective on first use, as Mesh.group."""
    if mesh is None or mesh.extent(axes) == 1:
        return None
    return AxisGroup(mesh.group(axes), mesh.index(axes), mesh.extent(axes))


def mesh_from_ranks(ranks: np.ndarray, device_type: str = "cuda") -> Mesh:
    """A Mesh over `ranks`, with its DeviceMesh when a process group
    exists."""
    dm = None
    if _grouped():
        import torch
        from torch.distributed.device_mesh import DeviceMesh

        dm = DeviceMesh(device_type, torch.as_tensor(ranks),
                        mesh_dim_names=AXIS_NAMES)
    return Mesh(ranks, device_type, dm)


def build_mesh(spec: MeshSpec | Mapping[str, Any] | None = None,
               device_type: str = "cuda") -> Mesh:
    """The Mesh of `spec` over the process group's world (one process
    without one), in the canonical layout."""
    _, world = _world()
    ranks = rank_layout(spec, world)
    if _grouped():
        from torch.distributed.device_mesh import init_device_mesh

        dm = init_device_mesh(device_type, ranks.shape,
                              mesh_dim_names=AXIS_NAMES)
        return Mesh(ranks, device_type, dm)
    return Mesh(ranks, device_type)


def local_batch_size(mesh: Mesh, global_batch: int) -> int:
    n = mesh.extent(BATCH_AXES)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by dp={n}")
    return global_batch // n


def mesh_summary(mesh: Mesh) -> str:
    axes = ", ".join(f"{k}={v}" for k, v in mesh.shape.items() if v > 1) \
        or "single-device"
    return f"Mesh({axes}) on {mesh.size}x {mesh.device_type}"


def pad_to_multiple(x: int, m: int) -> int:
    return int(math.ceil(x / m) * m)
