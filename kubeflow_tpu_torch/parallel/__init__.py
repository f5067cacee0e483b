"""Parallelism of the port: meshes, shardings, the distributed world.

Re-exports are lazy, as the reference's: `from kubeflow_tpu_torch.parallel
import dist` pulls in neither numpy nor torch.distributed.
"""

_MESH_NAMES = {"AXIS_DATA", "AXIS_DCN", "AXIS_EXPERT", "AXIS_FSDP",
               "AXIS_MODEL", "AXIS_PIPELINE", "AXIS_SEQ", "BATCH_AXES",
               "MeshSpec", "build_mesh"}
_DIST_NAMES = {"DistConfig", "initialize_from_env", "is_coordinator",
               "slice_env"}

__all__ = sorted(_MESH_NAMES | _DIST_NAMES)


def __getattr__(name: str):
    if name in _MESH_NAMES:
        from kubeflow_tpu_torch.parallel import mesh

        return getattr(mesh, name)
    if name in _DIST_NAMES:
        from kubeflow_tpu_torch.parallel import dist

        return getattr(dist, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
