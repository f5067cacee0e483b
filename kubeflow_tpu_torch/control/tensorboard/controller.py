"""Tensorboard controller: CR -> Deployment + Service + VirtualService.

Port of `kubeflow_tpu/control/tensorboard/controller.py`. Reference:
tensorboard-controller/controllers/tensorboard_controller.go (:53
Reconcile, generateDeployment :129, generateService :208,
generateVirtualService :228, isCloudPath :277). The JAX package's image
reads the xprof traces its runtime writes under the logdir; the port's
counterpart is the Chrome traces `runtime/profiler.py` writes under a
training config's `profile_dir` (`trace_<pid>_<start>.json`), which
TensorBoard's profile plugin opens, so one CR fronts both scalars and
GPU kernel timelines. Its image is the port's `TENSORBOARD_IMAGE`
(`control/jaxjob/types.py`). Non-cloud logdir paths mount a PVC; cloud
paths (gs://, s3://) go straight to tensorboard --logdir. USE_ISTIO adds
the VirtualService (`utils/envflags.py`: "true" in any case).
"""

from __future__ import annotations

import os

from kubeflow_tpu_torch.control import reconcilehelper as rh
from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.control.jaxjob.types import TENSORBOARD_IMAGE
from kubeflow_tpu_torch.control.runtime import Controller, Reconciler, Request, Result
from kubeflow_tpu_torch.utils.envflags import env_flag

GROUP = "tensorboard.kubeflow.org"
VERSION = "v1alpha1"
API_VERSION = f"{GROUP}/{VERSION}"
KIND = "Tensorboard"

DEFAULT_IMAGE = TENSORBOARD_IMAGE


def new_tensorboard(name: str, namespace: str = "default", logspath: str = "") -> dict:
    return ob.new_object(API_VERSION, KIND, name, namespace, spec={"logspath": logspath})


def is_cloud_path(path: str) -> bool:
    """isCloudPath (:277): gs://, s3://, or /cns/ (legacy)."""
    return path.startswith(("gs://", "s3://", "/cns/"))


def crd_manifest() -> dict:
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"tensorboards.{GROUP}"},
        "spec": {
            "group": GROUP,
            "names": {"kind": KIND, "listKind": "TensorboardList",
                      "plural": "tensorboards", "singular": "tensorboard"},
            "scope": "Namespaced",
            "versions": [{
                "name": VERSION, "served": True, "storage": True,
                "subresources": {"status": {}},
                "schema": {"openAPIV3Schema": {
                    "type": "object",
                    "x-kubernetes-preserve-unknown-fields": True}},
            }],
        },
    }


class TensorboardReconciler(Reconciler):
    def generate_deployment(self, tb: dict) -> dict:
        m = ob.meta(tb)
        logspath = (tb.get("spec") or {}).get("logspath", "")
        container = {
            "name": "tensorboard",
            "image": (tb.get("spec") or {}).get("image", DEFAULT_IMAGE),
            "command": ["tensorboard", f"--logdir={logspath}", "--bind_all",
                        "--port=6006"],
            "ports": [{"containerPort": 6006, "name": "http"}],
        }
        pod_spec: dict = {"containers": [container]}
        if logspath and not is_cloud_path(logspath):
            # local/NFS path -> PVC mount (:184-206)
            container["volumeMounts"] = [{"name": "logs", "mountPath": logspath}]
            pod_spec["volumes"] = [{
                "name": "logs",
                "persistentVolumeClaim": {"claimName": f"{m['name']}-logs"},
            }]
        return ob.new_object(
            "apps/v1", "Deployment", m["name"], m["namespace"],
            spec={
                "replicas": 1,
                "selector": {"matchLabels": {"app": m["name"]}},
                "template": {
                    "metadata": {"labels": {"app": m["name"]}},
                    "spec": pod_spec,
                },
            },
        )

    def generate_service(self, tb: dict) -> dict:
        m = ob.meta(tb)
        return ob.new_object(
            "v1", "Service", m["name"], m["namespace"],
            spec={
                "selector": {"app": m["name"]},
                "ports": [{"name": f"http-{m['name']}", "port": 80,
                           "targetPort": 6006}],
            },
        )

    def generate_virtual_service(self, tb: dict) -> dict:
        m = ob.meta(tb)
        prefix = f"/tensorboard/{m['namespace']}/{m['name']}/"
        return ob.new_object(
            "networking.istio.io/v1alpha3", "VirtualService",
            f"tensorboard-{m['namespace']}-{m['name']}", m["namespace"],
            spec={
                "hosts": ["*"],
                "gateways": [os.environ.get("ISTIO_GATEWAY", "kubeflow/kubeflow-gateway")],
                "http": [{
                    "match": [{"uri": {"prefix": prefix}}],
                    "rewrite": {"uri": "/"},
                    "route": [{"destination": {
                        "host": f"{m['name']}.{m['namespace']}.svc.cluster.local",
                        "port": {"number": 80}}}],
                }],
            },
        )

    def reconcile(self, client, req: Request) -> Result | None:
        tb = client.get_or_none(API_VERSION, KIND, req.name, req.namespace)
        if tb is None or ob.meta(tb).get("deletionTimestamp"):
            return None
        rh.reconcile_child(client, tb, self.generate_deployment(tb))
        rh.reconcile_child(client, tb, self.generate_service(tb))
        if env_flag("USE_ISTIO", "false"):
            rh.reconcile_child(client, tb, self.generate_virtual_service(tb))
        dep = client.get_or_none("apps/v1", "Deployment", req.name, req.namespace)
        ready = bool(dep and (dep.get("status") or {}).get("readyReplicas"))
        ob.cond_set(tb, "Ready", "True" if ready else "False",
                    "DeploymentReady" if ready else "DeploymentNotReady")
        client.update_status(tb)
        return None


def build_controller(client) -> Controller:
    ctl = Controller("tensorboard", client, TensorboardReconciler())
    ctl.watches_primary(API_VERSION, KIND).owns("apps/v1", "Deployment").owns("v1", "Service")
    return ctl
