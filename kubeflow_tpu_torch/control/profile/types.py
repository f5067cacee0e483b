"""Profile CRD types (reference: profile-controller/api/v1/profile_types.go:38).

Port of `kubeflow_tpu/control/profile/types.py`. The CRD, its finalizer,
roles and service accounts are the JAX package's; the quota a Profile
writes for its accelerators is ``requests.nvidia.com/gpu`` (the port's
``RESOURCE_GPU``) where the JAX package writes
``requests.google.com/tpu``.
"""

from __future__ import annotations

from kubeflow_tpu_torch.control.jaxjob.types import RESOURCE_GPU
from kubeflow_tpu_torch.control.k8s import objects as ob

GROUP = "kubeflow.org"
VERSION = "v1"
API_VERSION = f"{GROUP}/{VERSION}"
KIND = "Profile"

FINALIZER = "profile-finalizer"  # profile_controller.go:48
# ClusterRoles bound in the namespace (profile_controller.go:58-62)
ADMIN_CLUSTER_ROLE = "kubeflow-admin"
EDIT_CLUSTER_ROLE = "kubeflow-edit"
VIEW_CLUSTER_ROLE = "kubeflow-view"
SA_EDITOR = "default-editor"
SA_VIEWER = "default-viewer"
QUOTA_NAME = "kf-resource-quota"  # profile_controller.go:47
# the quota's GPU key (ResourceQuota's requests.<extended resource>)
QUOTA_GPU = f"requests.{RESOURCE_GPU}"
# annotation consumed by KFAM bindings (kfam/bindings.go)
ANNO_USER = "user"
ANNO_ROLE = "role"


def owner_name(profile: dict) -> str | None:
    """The owning user of a Profile. Canonical spec.owner is a Subject
    dict ({kind, name}, profile_types.go:38); a bare string is accepted
    for convenience."""
    owner = (profile.get("spec") or {}).get("owner")
    if isinstance(owner, dict):
        return owner.get("name")
    return owner


def new_profile(
    name: str,
    owner: str,
    *,
    gpu_quota: int | None = None,
    cpu_quota: str | None = None,
    memory_quota: str | None = None,
    plugins: list[dict] | None = None,
) -> dict:
    spec: dict = {"owner": {"kind": "User", "name": owner}}
    hard: dict = {}
    if gpu_quota is not None:
        hard[QUOTA_GPU] = gpu_quota
    if cpu_quota:
        hard["requests.cpu"] = cpu_quota
    if memory_quota:
        hard["requests.memory"] = memory_quota
    if hard:
        spec["resourceQuotaSpec"] = {"hard": hard}
    if plugins:
        spec["plugins"] = plugins
    prof = ob.new_object(API_VERSION, KIND, name, namespace=None, spec=spec)
    ob.meta(prof)["finalizers"] = [FINALIZER]
    return prof


def crd_manifest() -> dict:
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"profiles.{GROUP}"},
        "spec": {
            "group": GROUP,
            "names": {"kind": KIND, "listKind": "ProfileList",
                      "plural": "profiles", "singular": "profile"},
            "scope": "Cluster",
            "versions": [{
                "name": VERSION, "served": True, "storage": True,
                "subresources": {"status": {}},
                "schema": {"openAPIV3Schema": {
                    "type": "object",
                    "x-kubernetes-preserve-unknown-fields": True}},
            }],
        },
    }
