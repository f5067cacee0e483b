"""tpctl — the declarative deployment engine (bootstrap/kfctl analogue),
port of `kubeflow_tpu/tpctl/` that stands the platform up on a GKE GPU
cluster.

The reference's deployment plane is a Go HTTP server and router around
the external kfctl module: a KfDef YAML describes a deployment; apply
runs PLATFORM (cloud infra) then K8S (manifests) with retry; status
lands in KfDef conditions; a router spawns one worker per deployment
and a GC reaps expired ones. tpctl provides the same in-tree:

- ``tpudef``    — the TpuDef config type (KfDef analogue, versioned
  YAML); its platform is a GKE GPU node pool
- ``manifests`` — renders every platform component (CRDs, controllers,
  webhook, web apps, serving) as plain K8s objects with
  kustomize-style overlay patching
- ``apply``     — the coordinator: Apply(PLATFORM) -> Apply(K8S) with
  backoff, idempotent second apply, Available/Degraded conditions;
  ``GkeGpuPlatform`` creates the GPU node pool through gcloud
- ``cli``       — `tpctl {generate,apply,delete,status,doctor,server}`
- ``server``    — REST create/get endpoints, per-deployment workers, GC
"""

from kubeflow_tpu_torch.tpctl.tpudef import TpuDef  # noqa: F401
from kubeflow_tpu_torch.tpctl.apply import Coordinator  # noqa: F401
