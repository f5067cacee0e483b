"""Jupyter web app backend: the notebook spawner REST API.

Port of `kubeflow_tpu/webapps/jwa.py`. Mirrors jupyter-web-app/backend
(SURVEY.md §2.3):
- GETs for namespaces / notebooks / PVCs / PodDefaults / storageclasses /
  events (common/base_app.py:23-131),
- POST notebook: form -> Notebook CR from a template
  (default/app.py:13, common/yaml/notebook.yaml:1-25),
- POST pvc (:140), DELETE notebook (:164), health probes (:170-175).

The GPU point: where the reference inserts `nvidia.com/gpu` limits from
the form (common/utils.py:262-277), so does this backend, with GKE's GPU
product selector and, when the form names one, its node pool
(`process_gpu`). The JAX package's inserts `google.com/tpu` chips and
the TPU accelerator and topology selectors there.
"""

from __future__ import annotations

import copy
import logging
import os

from kubeflow_tpu_torch.control.jaxjob.types import (
    NODESELECTOR_ACCEL,
    NODESELECTOR_POOL,
    NOTEBOOK_IMAGE,
    RESOURCE_GPU,
)
from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.control.notebook import types as NT
from kubeflow_tpu_torch.control.scheduler.topology import normalize_pool
from kubeflow_tpu_torch.utils import httpd, yaml_lite
from kubeflow_tpu_torch.utils.httpd import ApiHttpError, HttpReq, Router
from kubeflow_tpu_torch.utils.names import require_dns1123

log = logging.getLogger("kubeflow_tpu_torch.jwa")

USER_HEADER = "kubeflow-userid"

# spawner_ui_config.yaml analogue: what the form offers
DEFAULT_CONFIG = {
    "image": {
        "value": NOTEBOOK_IMAGE,
        "options": [NOTEBOOK_IMAGE],
    },
    "cpu": {"value": "0.5"},
    "memory": {"value": "1Gi"},
    "gpu": {
        "value": 0,
        "options": [0, 1, 4, 8],
        "products": ["nvidia-h100-80gb", "nvidia-a100-80gb"],
    },
    "workspaceVolume": {"value": {"size": "10Gi", "mountPath": NT.HOME_DIR}},
}


def process_gpu(container: dict, pod_spec: dict, form: dict) -> None:
    """utils.py:262-277 equivalent: insert GPU resources from the form,
    ``gpu: N`` or ``gpu: {count, product, nodePool}``: the
    ``nvidia.com/gpu`` limit, and GKE's product (and node-pool) selectors
    where the form names them."""
    gpu = form.get("gpu") or 0
    if isinstance(gpu, dict):
        count = int(gpu.get("count", 0) or 0)
    else:
        count, gpu = int(gpu), {}
    if not count:
        return
    limits = container.setdefault("resources", {}).setdefault("limits", {})
    limits[RESOURCE_GPU] = count
    product = gpu.get("product")
    if product:
        sel = pod_spec.setdefault("nodeSelector", {})
        sel[NODESELECTOR_ACCEL] = product
        if gpu.get("nodePool"):
            sel[NODESELECTOR_POOL] = normalize_pool(gpu["nodePool"])


def notebook_from_form(namespace: str, form: dict,
                       config: dict | None = None) -> dict:
    """The yaml template + form fill (notebook.yaml:1-25 + app.py:13)."""
    name = form.get("name")
    if not name:
        raise ApiHttpError(400, "notebook form requires 'name'")
    cfg = config or DEFAULT_CONFIG
    nb = NT.new_notebook(
        name, namespace,
        image=form.get("image", cfg["image"]["value"]),
        cpu=str(form.get("cpu", cfg["cpu"]["value"])),
        memory=form.get("memory", cfg["memory"]["value"]),
    )
    pod_spec = nb["spec"]["template"]["spec"]
    container = pod_spec["containers"][0]
    process_gpu(container, pod_spec, form)
    ws = form.get("workspaceVolume")
    if ws:
        claim = ws.get("name", f"workspace-{name}")
        container["volumeMounts"] = [
            {"name": "workspace", "mountPath": ws.get("mountPath", NT.HOME_DIR)}]
        pod_spec["volumes"] = [
            {"name": "workspace", "persistentVolumeClaim": {"claimName": claim}}]
    # Form labels go on the CR *and* the pod template: PodDefault
    # "configurations" match pod labels, so a label only on the Notebook
    # metadata would make the feature a silent no-op.
    pod_labels = (nb["spec"]["template"].setdefault("metadata", {})
                  .setdefault("labels", {}))
    for k, v in (form.get("labels") or {}).items():
        ob.set_label(nb, k, v)
        pod_labels[k] = v
    return nb


def notebook_status(nb: dict, events: list[dict]) -> dict:
    """The row JWA's UI renders (status + last event message)."""
    m = ob.meta(nb)
    ready = bool((nb.get("status") or {}).get("readyReplicas"))
    stopped = NT.STOP_ANNOTATION in ob.annotations_of(nb)
    phase = "stopped" if stopped else ("ready" if ready else "waiting")
    own = [e for e in events
           if (e.get("involvedObject") or {}).get("uid") == m.get("uid")]
    return {
        "name": m["name"],
        "namespace": m["namespace"],
        "image": nb["spec"]["template"]["spec"]["containers"][0].get("image"),
        "status": {"phase": phase, "ready": ready},
        "events": [{"reason": e.get("reason"), "message": e.get("message"),
                    "type": e.get("type")} for e in own[-5:]],
    }


def load_spawner_config(path: str | None = None) -> dict:
    """Admin-editable spawner options (spawner_ui_config.yaml contract:
    the form's defaults/options come from a YAML file the platform
    mounts, jupyter-web-app/backend main.py). `path` or $JWA_CONFIG
    points at the YAML; keys deep-merge over the built-in default so a
    config can override just one field."""
    path = path or os.environ.get("JWA_CONFIG")
    if not path:
        return DEFAULT_CONFIG
    loaded = yaml_lite.load(path) or {}
    # spawner_ui_config.yaml nests under spawnerFormDefaults
    loaded = loaded.get("spawnerFormDefaults", loaded)

    def merge(base, over):
        out = copy.deepcopy(base)
        for k, v in over.items():
            out[k] = merge(out[k], v) if (
                isinstance(v, dict) and isinstance(out.get(k), dict)) else v
        return out

    return merge(DEFAULT_CONFIG, loaded)


class JupyterWebApp:
    def __init__(self, client, config: dict | None = None,
                 flavor: str | None = None):
        from kubeflow_tpu_torch.webapps.jwa_flavors import (
            SnapshotFlavor, select_flavor)

        self.client = client
        self.config = config if config is not None else load_spawner_config()
        # UI-flavor dispatch (reference main.py:12-29 UI=default|rok);
        # the non-default flavor is object-store snapshots. Explicit args
        # validate through the same gate as $UI: an unknown flavor fails
        # loudly, never silently degrades to default.
        self.flavor_name = select_flavor(
            {"UI": flavor} if flavor is not None else None)
        self.flavor = (SnapshotFlavor(self)
                       if self.flavor_name == "snapshot" else None)

    def _user(self, req: HttpReq) -> str:
        return req.header(USER_HEADER, "anonymous@kubeflow.org")

    # -- GET surfaces -------------------------------------------------------

    def get_config(self, req: HttpReq):
        return {"config": self.config}

    def get_namespaces(self, req: HttpReq):
        return {"namespaces": [
            ob.meta(ns)["name"] for ns in self.client.list("v1", "Namespace")]}

    def get_notebooks(self, req: HttpReq):
        ns = req.params["ns"]
        events = self.client.list("v1", "Event", namespace=ns)
        return {"notebooks": [
            notebook_status(nb, events)
            for nb in self.client.list(NT.API_VERSION, NT.KIND, namespace=ns)]}

    def get_pvcs(self, req: HttpReq):
        ns = req.params["ns"]
        return {"pvcs": [
            {"name": ob.meta(p)["name"],
             "size": ((p.get("spec") or {}).get("resources") or {})
             .get("requests", {}).get("storage"),
             "mode": ((p.get("spec") or {}).get("accessModes") or [""])[0]}
            for p in self.client.list("v1", "PersistentVolumeClaim", namespace=ns)]}

    def get_poddefaults(self, req: HttpReq):
        ns = req.params["ns"]
        items = self.client.list("kubeflow.org/v1alpha1", "PodDefault", namespace=ns)
        return {"poddefaults": [
            {"name": ob.meta(p)["name"],
             "desc": (p.get("spec") or {}).get("desc", ob.meta(p)["name"]),
             # the labels a pod needs to match this PodDefault's selector —
             # the spawner's "configurations" control applies them
             "matchLabels": (((p.get("spec") or {}).get("selector") or {})
                             .get("matchLabels") or {})}
            for p in items]}

    def get_storageclasses(self, req: HttpReq):
        return {"storageclasses": [
            ob.meta(s)["name"]
            for s in self.client.list("storage.k8s.io/v1", "StorageClass")]}

    def get_events(self, req: HttpReq):
        ns, name = req.params["ns"], req.params["name"]
        nb = self.client.get_or_none(NT.API_VERSION, NT.KIND, name, ns)
        if nb is None:
            raise ApiHttpError(404, f"notebook {name} not found")
        uid = ob.meta(nb).get("uid")
        evs = [e for e in self.client.list("v1", "Event", namespace=ns)
               if (e.get("involvedObject") or {}).get("uid") == uid]
        return {"events": evs}

    # -- mutations ----------------------------------------------------------

    def post_notebook(self, req: HttpReq):
        ns = req.params["ns"]
        form = req.json() or {}
        # server-side name validation: the browser form is advisory; a
        # real apiserver rejects non-RFC1123 metadata.name opaquely
        require_dns1123(form.get("name", ""))
        nb = notebook_from_form(ns, form, self.config)
        if self.flavor is not None:  # flavor POST override (rok/app.py:56)
            nb = self.flavor.mutate_notebook(nb, form)
        try:
            self.client.create(nb)
        except ob.Conflict:
            raise ApiHttpError(409, f"notebook {ob.meta(nb)['name']} exists")
        log.info("user %s created notebook %s/%s", self._user(req), ns,
                 ob.meta(nb)["name"])
        return 200, {"status": "ok", "name": ob.meta(nb)["name"]}

    def post_pvc(self, req: HttpReq):
        ns = req.params["ns"]
        form = req.json() or {}
        require_dns1123(form.get("name", "workspace"))
        pvc = ob.new_object(
            "v1", "PersistentVolumeClaim", form.get("name", "workspace"), ns,
            spec={
                "accessModes": [form.get("mode", "ReadWriteOnce")],
                "resources": {"requests": {"storage": form.get("size", "10Gi")}},
                **({"storageClassName": form["class"]} if form.get("class") else {}),
            },
        )
        try:
            self.client.create(pvc)
        except ob.Conflict:
            raise ApiHttpError(409, f"pvc {ob.meta(pvc)['name']} exists")
        return 200, {"status": "ok"}

    def delete_notebook(self, req: HttpReq):
        ns, name = req.params["ns"], req.params["name"]
        try:
            self.client.delete(NT.API_VERSION, NT.KIND, name, ns)
        except ob.NotFound:
            raise ApiHttpError(404, f"notebook {name} not found")
        return 200, {"status": "ok"}

    def patch_notebook(self, req: HttpReq):
        """start/stop (the stop-annotation toggle the culler honors)."""
        ns, name = req.params["ns"], req.params["name"]
        body = req.json() or {}
        nb = self.client.get_or_none(NT.API_VERSION, NT.KIND, name, ns)
        if nb is None:
            raise ApiHttpError(404, f"notebook {name} not found")
        if body.get("stopped"):
            ob.set_annotation(nb, NT.STOP_ANNOTATION, ob.now_iso())
        else:
            ob.annotations_of(nb).pop(NT.STOP_ANNOTATION, None)
        self.client.update(nb)
        return 200, {"status": "ok"}

    # -- wiring -------------------------------------------------------------

    def router(self) -> Router:
        from kubeflow_tpu_torch.webapps.jwa_ui import add_ui_routes

        r = Router("jwa")
        r.route("GET", "/api/config", self.get_config)
        r.route("GET", "/api/namespaces", self.get_namespaces)
        r.route("GET", "/api/namespaces/{ns}/notebooks", self.get_notebooks)
        r.route("POST", "/api/namespaces/{ns}/notebooks", self.post_notebook)
        r.route("GET", "/api/namespaces/{ns}/notebooks/{name}/events", self.get_events)
        r.route("PATCH", "/api/namespaces/{ns}/notebooks/{name}", self.patch_notebook)
        r.route("DELETE", "/api/namespaces/{ns}/notebooks/{name}", self.delete_notebook)
        r.route("GET", "/api/namespaces/{ns}/pvcs", self.get_pvcs)
        r.route("POST", "/api/namespaces/{ns}/pvcs", self.post_pvc)
        r.route("GET", "/api/namespaces/{ns}/poddefaults", self.get_poddefaults)
        r.route("GET", "/api/storageclasses", self.get_storageclasses)
        # browser spawner UI (the JWA frontend equivalent, webapps/jwa_ui.py)
        add_ui_routes(r)
        if self.flavor is not None:
            self.flavor.add_routes(r)
        httpd.add_health_routes(r)
        httpd.add_metrics_route(r)
        return r

    def serve(self, host: str = "0.0.0.0", port: int = 5000) -> httpd.HttpService:
        return httpd.HttpService(self.router(), host, port)
