"""JWA UI flavors: pluggable spawner variants selected by $UI.

Port of `kubeflow_tpu/webapps/jwa_flavors.py` (no accelerator in it).

The reference ships two spawner backends behind one dispatch —
``UI=default|rok`` (jupyter-web-app/backend/main.py:12-29). The "rok"
flavor overrides the notebook POST to wire workspaces to Rok block
snapshots and adds a per-namespace token endpoint reading a Secret
(kubeflow_jupyter/rok/app.py:27-62, :56+).

The platform keeps the extension-point SHAPE (env-selected
flavor, POST override, token endpoint) but swaps Rok's proprietary block
snapshots for cloud object storage: the "snapshot" flavor seeds a new
notebook's workspace from a gs://|s3:// prefix — the same copier
contract the job sidecar already implements (sidecar/controller.py
default_copier) — via an annotation an init process consumes.
"""

from __future__ import annotations

import base64

from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.utils.httpd import ApiHttpError, HttpReq

# annotation consumed by the notebook image's init hook (the sidecar
# copier contract): seed $HOME from this object-store prefix on start
ANNO_SNAPSHOT_SRC = "notebooks.kubeflow.org/snapshot-source"
# the per-namespace Secret holding object-store credentials (the rok
# token Secret analogue, rok.py rok_secret_name)
SNAPSHOT_SECRET = "snapshot-access"
FLAVORS = ("default", "snapshot")


def select_flavor(env: dict | None = None) -> str:
    import os

    ui = (env or os.environ).get("UI", "default")
    if ui not in FLAVORS:
        # main.py:27-29 logs "There is no <ui> UI to load" and dies; fail
        # just as loudly but with the valid set in the message
        raise ValueError(f"unknown UI flavor {ui!r}; valid: {FLAVORS}")
    return ui


class SnapshotFlavor:
    """Installed onto a JupyterWebApp when UI=snapshot."""

    def __init__(self, app):
        self.app = app

    # -- POST override (rok/app.py:56+ analogue) ---------------------------

    def mutate_notebook(self, nb: dict, form: dict) -> dict:
        src = form.get("snapshotUrl") or ""
        if not src:
            return nb
        if not isinstance(src, str) or not src.startswith(("gs://", "s3://")):
            raise ApiHttpError(
                400, f"snapshotUrl must be gs:// or s3://, got {src!r}")
        ob.set_annotation(nb, ANNO_SNAPSHOT_SRC, src)
        return nb

    # -- token endpoint (rok/app.py:27-52 contract) ------------------------

    def get_token(self, req: HttpReq):
        ns = req.params["ns"]
        token = {"name": SNAPSHOT_SECRET, "value": ""}
        secret = self.app.client.get_or_none(
            "v1", "Secret", SNAPSHOT_SECRET, ns)
        if secret is None:
            return {"success": False, "token": token,
                    "log": f"snapshot Secret doesn't exist in "
                           f"namespace '{ns}'"}
        raw = (secret.get("data") or {}).get("token")
        if not raw:
            return {"success": False, "token": token,
                    "log": f"Secret {SNAPSHOT_SECRET!r} has no 'token' key"}
        try:
            token["value"] = base64.b64decode(raw).decode()
        except Exception:
            return {"success": False, "token": token,
                    "log": "snapshot Secret token is not valid base64"}
        return {"success": True, "token": token}

    def add_routes(self, router) -> None:
        router.route("GET", "/api/snapshot/namespaces/{ns}/token",
                     self.get_token)
