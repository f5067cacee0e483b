"""crud_backend: the shared backend package for CRUD web apps.

Port of `kubeflow_tpu/webapps/crud_backend.py`; authorization reads the
port's Profile types. Mirrors components/crud-web-apps/common/backend/kubeflow/kubeflow/
crud_backend (SURVEY.md §2.3): the next-gen shared Flask package the
reference factors JWA-style apps onto — authn (identity header), authz
(per-verb namespace access checks), api wrappers over Kubernetes
resources (PVCs, secrets, events, storageclasses, namespaces), and the
uniform {success, status, ...} response envelope its frontends expect.

A CRUD app composes: `CrudBackend(client, authz).router(prefix)` gives
the standard resource GETs; app-specific routes are added on top (see
webapps/jwa.py for the notebook-specific equivalent).
"""

from __future__ import annotations

import logging
from typing import Callable

from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.utils import httpd
from kubeflow_tpu_torch.utils.httpd import ApiHttpError, HttpReq, Router

log = logging.getLogger("kubeflow_tpu_torch.crud_backend")

USER_HEADER = "kubeflow-userid"


def success(**kw) -> dict:
    """crud_backend/helpers success envelope."""
    return {"success": True, "status": 200, **kw}


def authn_user(req: HttpReq, required: bool = True) -> str:
    """authn.py equivalent: identity from the trusted proxy header."""
    user = req.user or req.header(USER_HEADER)
    if not user and required:
        raise ApiHttpError(401, "no user identity (missing "
                                f"{USER_HEADER} header)")
    return user or ""


class Authorizer:
    """authz.py equivalent. The reference issues SubjectAccessReviews;
    the platform checks against the same sources KFAM maintains: cluster
    admin, profile ownership, or contributor RoleBindings (user/role
    annotations, kfam/bindings.go:168 List semantics)."""

    READ_VERBS = ("get", "list", "watch")

    def __init__(self, client, cluster_admin: str | None = None):
        self.client = client
        self.cluster_admin = cluster_admin

    def _roles(self, user: str, namespace: str) -> set[str]:
        from kubeflow_tpu_torch.control.profile import types as PT

        roles: set[str] = set()
        prof = self.client.get_or_none("kubeflow.org/v1", "Profile", namespace)
        if prof and PT.owner_name(prof) == user:
            roles.add("admin")
        for rb in self.client.list("rbac.authorization.k8s.io/v1",
                                   "RoleBinding", namespace=namespace):
            anno = (rb.get("metadata") or {}).get("annotations") or {}
            if anno.get(PT.ANNO_USER) == user and anno.get(PT.ANNO_ROLE):
                roles.add(anno[PT.ANNO_ROLE])
        return roles

    def check(self, user: str, verb: str, namespace: str) -> None:
        if self.cluster_admin and user == self.cluster_admin:
            return
        roles = self._roles(user, namespace)
        if "admin" in roles or "edit" in roles:
            return
        if verb in self.READ_VERBS and "view" in roles:
            return
        raise ApiHttpError(403, f"{user} cannot {verb} in {namespace}")


class CrudBackend:
    """Standard resource routes shared by all CRUD apps."""

    def __init__(self, client, authz: Authorizer | None = None):
        self.client = client
        self.authz = authz

    def _auth(self, req: HttpReq, verb: str, namespace: str) -> str:
        user = authn_user(req, required=self.authz is not None)
        if self.authz:
            self.authz.check(user, verb, namespace)
        return user

    # -- api/ wrappers ------------------------------------------------------

    def list_namespaces(self, req: HttpReq):
        # Cluster-scoped, so no per-namespace authz — but still
        # authenticated: anonymous callers must not enumerate tenants.
        authn_user(req, required=self.authz is not None)
        items = self.client.list("v1", "Namespace")
        return success(namespaces=[o["metadata"]["name"] for o in items])

    def list_pvcs(self, req: HttpReq):
        ns = req.params["ns"]
        self._auth(req, "list", ns)
        items = self.client.list("v1", "PersistentVolumeClaim", namespace=ns)
        return success(pvcs=items)

    def create_pvc(self, req: HttpReq):
        ns = req.params["ns"]
        self._auth(req, "create", ns)
        pvc = req.json()
        pvc.setdefault("apiVersion", "v1")
        pvc.setdefault("kind", "PersistentVolumeClaim")
        pvc.setdefault("metadata", {})["namespace"] = ns
        return success(pvc=self.client.create(pvc))

    def delete_pvc(self, req: HttpReq):
        ns, name = req.params["ns"], req.params["name"]
        self._auth(req, "delete", ns)
        try:
            self.client.delete("v1", "PersistentVolumeClaim", name, ns)
        except ob.NotFound:
            raise ApiHttpError(404, f"pvc {ns}/{name} not found")
        return success()

    def list_secrets(self, req: HttpReq):
        ns = req.params["ns"]
        self._auth(req, "list", ns)
        items = self.client.list("v1", "Secret", namespace=ns)
        # names only: secret *values* never transit the CRUD API
        return success(secrets=[o["metadata"]["name"] for o in items])

    def list_events(self, req: HttpReq):
        ns = req.params["ns"]
        self._auth(req, "list", ns)
        items = self.client.list("v1", "Event", namespace=ns)
        return success(events=items)

    def list_storageclasses(self, req: HttpReq):
        authn_user(req, required=self.authz is not None)
        items = self.client.list("storage.k8s.io/v1", "StorageClass")
        return success(storageClasses=[o["metadata"]["name"] for o in items])

    def add_routes(self, r: Router) -> Router:
        r.route("GET", "/api/namespaces", self.list_namespaces)
        r.route("GET", "/api/namespaces/{ns}/pvcs", self.list_pvcs)
        r.route("POST", "/api/namespaces/{ns}/pvcs", self.create_pvc)
        r.route("DELETE", "/api/namespaces/{ns}/pvcs/{name}", self.delete_pvc)
        r.route("GET", "/api/namespaces/{ns}/secrets", self.list_secrets)
        r.route("GET", "/api/namespaces/{ns}/events", self.list_events)
        r.route("GET", "/api/storageclasses", self.list_storageclasses)
        return r

    def router(self, name: str = "crud") -> Router:
        r = Router(name)
        self.add_routes(r)
        httpd.add_health_routes(r)
        httpd.add_metrics_route(r)
        return r
