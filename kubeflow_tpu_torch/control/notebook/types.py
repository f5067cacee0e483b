"""Notebook CRD types + constants.

Port of `kubeflow_tpu/control/notebook/types.py`. Reference API:
notebook-controller/api/{v1alpha1,v1beta1,v1} — the spec is just a pod
template; all behavior (ports, routing, culling) is controller
convention. Constants mirror notebook_controller.go:44-52 and
culler.go:24-45. A notebook's accelerators are ``nvidia.com/gpu`` (the
port's ``RESOURCE_GPU``) where the JAX package's are ``google.com/tpu``
chips, and its default image is the port's (``NOTEBOOK_IMAGE``).
"""

from __future__ import annotations

from kubeflow_tpu_torch.control.jaxjob.types import NOTEBOOK_IMAGE, RESOURCE_GPU
from kubeflow_tpu_torch.control.k8s import objects as ob

GROUP = "kubeflow.org"
VERSION = "v1beta1"
API_VERSION = f"{GROUP}/{VERSION}"
KIND = "Notebook"

# notebook_controller.go:47: DefaultContainerPort = 8888; svc port 80
CONTAINER_PORT = 8888
SERVICE_PORT = 80
# label used for the pod->notebook watch mapping (notebook_controller.go:541-563)
LABEL_NOTEBOOK_NAME = "notebook-name"
# culler.go:37: stop annotation; value is an RFC3339 timestamp
STOP_ANNOTATION = "kubeflow-resource-stopped"
# notebook_controller.go:329-332: base-url env for Jupyter behind the proxy
ENV_NB_PREFIX = "NB_PREFIX"
# notebook_controller.go:318: mount point of the user volume
HOME_DIR = "/home/jovyan"


def new_notebook(
    name: str,
    namespace: str = "default",
    *,
    image: str = NOTEBOOK_IMAGE,
    cpu: str = "0.5",
    memory: str = "1Gi",
    gpus: int = 0,
    labels: dict | None = None,
) -> dict:
    """Constructor matching what JWA's template produces
    (jupyter-web-app/backend/.../yaml/notebook.yaml:1-25)."""
    container: dict = {
        "name": name,
        "image": image,
        "resources": {"requests": {"cpu": cpu, "memory": memory}},
    }
    if gpus:
        container["resources"].setdefault("limits", {})[RESOURCE_GPU] = gpus
    return ob.new_object(
        API_VERSION, KIND, name, namespace, labels=labels,
        spec={"template": {"spec": {"containers": [container]}}},
    )


def crd_manifest() -> dict:
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"notebooks.{GROUP}"},
        "spec": {
            "group": GROUP,
            "names": {"kind": KIND, "listKind": "NotebookList",
                      "plural": "notebooks", "singular": "notebook"},
            "scope": "Namespaced",
            "versions": [
                {"name": v, "served": True, "storage": v == VERSION,
                 "subresources": {"status": {}},
                 "schema": {"openAPIV3Schema": {
                     "type": "object",
                     "x-kubernetes-preserve-unknown-fields": True}}}
                for v in ("v1alpha1", "v1beta1", "v1")
            ],
        },
    }
