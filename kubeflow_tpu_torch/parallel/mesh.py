"""The `mesh` key of a TrainConfig. The port runs on one device for now:
any axis above 1 raises until the multi-GPU slice lands (ROADMAP, Queue
1 slice 4, items 16-17)."""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical parallelism spec, same axes as the reference's MeshSpec;
    data = -1 means "whatever is left over"."""

    dcn: int = 1
    data: int = -1
    fsdp: int = 1
    pipe: int = 1
    expert: int = 1
    seq: int = 1
    model: int = 1

    def __post_init__(self) -> None:
        big = {k: v for k, v in dataclasses.asdict(self).items()
               if v != 1 and not (k == "data" and v == -1)}
        if big:
            raise NotImplementedError(
                f"mesh axes {big}: the port runs on one device; multi-GPU "
                "meshes are ROADMAP Queue 1 slice 4 (items 16-17)")

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "MeshSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; "
                             f"known: {sorted(known)}")
        return cls(**{k: int(v) for k, v in d.items()})
