"""KFAM REST API: profiles + contributor bindings.

Mirrors access-management/kfam/api_default.go + bindings.go:

- POST /kfam/v1/bindings            CreateBinding  (:93)
- GET  /kfam/v1/bindings            ReadBinding    (:199; user/namespace/role filters)
- DELETE /kfam/v1/bindings          DeleteBinding  (:146)
- POST /kfam/v1/profiles            CreateProfile  (:123)
- DELETE /kfam/v1/profiles/{name}   DeleteProfile
- GET  /kfam/v1/clusteradmin        QueryClusterAdmin (:247)

Identity comes from the ``kubeflow-userid`` header (userIdHeader, :278);
authz is isOwnerOrAdmin (:292): cluster admin or profile owner manage
bindings; contributors are RoleBindings to ClusterRole
``kubeflow-<role>`` carrying user/role annotations (bindings.go:76-166),
which ReadBinding filters on (:168). The reference's paired Istio
ServiceRoleBinding becomes an AuthorizationPolicy per contributor.

Port of `kubeflow_tpu/control/kfam/service.py`: the same routes, authz,
objects and bodies over the port's client, Profile types and HTTP
server. Its three counters (``kfam_binding_create_total``,
``kfam_binding_delete_total``, ``kfam_profile_create_total``) go into the
port's registry (`runtime/metrics.py` REGISTRY) under the reference's
names, where the JAX package counts them in prometheus_client; the
service's own ``/metrics`` renders that registry.
"""

from __future__ import annotations

import logging
import os

from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.control.profile import types as PT
from kubeflow_tpu_torch.runtime.metrics import REGISTRY
from kubeflow_tpu_torch.utils import httpd
from kubeflow_tpu_torch.utils.httpd import ApiHttpError, HttpReq, Router
from kubeflow_tpu_torch.utils.names import dns_label_of

log = logging.getLogger("kubeflow_tpu_torch.kfam")

USER_HEADER = "kubeflow-userid"
VALID_ROLES = ("admin", "edit", "view")



def _count(name: str, doc: str) -> None:
    """One event of a KFAM counter (monitoring.go:26-48)."""
    REGISTRY.counter_inc(name, help_=doc)


def binding_name(user: str, role: str) -> str:
    """bindings.go: unique, DNS-safe per (user, role)."""
    return f"user-{dns_label_of(user)}-clusterrole-{role}"


class KfamService:
    def __init__(self, client, cluster_admin: str | None = None):
        self.client = client
        self.cluster_admin = cluster_admin or os.environ.get(
            "CLUSTER_ADMIN", "admin@kubeflow.org")

    # -- authz (api_default.go:278-300) -------------------------------------

    def is_cluster_admin(self, user: str) -> bool:
        return bool(user) and user == self.cluster_admin

    def profile_owner(self, namespace: str) -> str | None:
        prof = self.client.get_or_none(PT.API_VERSION, PT.KIND, namespace)
        if prof is None:
            return None
        return PT.owner_name(prof)

    def is_owner_or_admin(self, user: str, namespace: str) -> bool:
        if self.is_cluster_admin(user):
            return True
        return bool(user) and user == self.profile_owner(namespace)

    def _require(self, req: HttpReq, namespace: str) -> str:
        user = req.header(USER_HEADER)
        if not user:
            raise ApiHttpError(401, f"missing {USER_HEADER} header")
        if not self.is_owner_or_admin(user, namespace):
            raise ApiHttpError(403, f"{user} is not owner/admin of {namespace}")
        return user

    # -- bindings (bindings.go) ---------------------------------------------

    def create_binding(self, req: HttpReq):
        body = req.json() or {}
        user = ((body.get("user") or {}).get("name")
                or (body.get("referredUser") or {}).get("name"))
        namespace = (body.get("referredNamespace")
                     or (body.get("roleRef") or {}).get("namespace"))
        role = (body.get("roleRef") or {}).get("name", "edit")
        role = role.replace("kubeflow-", "")
        if not user or not namespace:
            raise ApiHttpError(400, "binding requires user.name and referredNamespace")
        if role not in VALID_ROLES:
            raise ApiHttpError(400, f"role must be one of {VALID_ROLES}")
        self._require(req, namespace)

        rb = ob.new_object(
            "rbac.authorization.k8s.io/v1", "RoleBinding",
            binding_name(user, role), namespace,
            annotations={PT.ANNO_USER: user, PT.ANNO_ROLE: role},
        )
        rb["roleRef"] = {"apiGroup": "rbac.authorization.k8s.io",
                        "kind": "ClusterRole", "name": f"kubeflow-{role}"}
        rb["subjects"] = [{"apiGroup": "rbac.authorization.k8s.io",
                          "kind": "User", "name": user}]
        # paired Istio-side grant (reference: ServiceRoleBinding with the
        # same annotations, bindings.go:118-151)
        pol = ob.new_object(
            "security.istio.io/v1beta1", "AuthorizationPolicy",
            binding_name(user, role), namespace,
            annotations={PT.ANNO_USER: user, PT.ANNO_ROLE: role},
            spec={"rules": [{"when": [{
                "key": f"request.headers[{USER_HEADER}]", "values": [user]}]}]},
        )
        try:
            self.client.create(rb)
            self.client.create(pol)
        except ob.Conflict:
            raise ApiHttpError(409, f"binding for {user}/{role} already exists")
        _count("kfam_binding_create_total", "bindings created")
        return 200, {"status": "ok"}

    def read_bindings(self, req: HttpReq):
        """ReadBinding (:199) with List filtering (bindings.go:168-199)."""
        want_user = req.q1("user")
        want_ns = req.q1("namespace")
        want_role = req.q1("role")
        out = []
        for rb in self.client.list(
            "rbac.authorization.k8s.io/v1", "RoleBinding",
            namespace=want_ns or None,
        ):
            annos = ob.annotations_of(rb)
            user, role = annos.get(PT.ANNO_USER), annos.get(PT.ANNO_ROLE)
            if not user or not role:
                continue  # not a kfam-managed binding
            if want_user and user != want_user:
                continue
            if want_role and role != want_role:
                continue
            out.append({
                "user": {"kind": "User", "name": user},
                "referredNamespace": ob.meta(rb)["namespace"],
                "roleRef": {"apiGroup": "rbac.authorization.k8s.io",
                            "kind": "ClusterRole", "name": f"kubeflow-{role}"},
            })
        return {"bindings": out}

    def delete_binding(self, req: HttpReq):
        body = req.json() or {}
        user = (body.get("user") or {}).get("name")
        namespace = body.get("referredNamespace")
        role = (body.get("roleRef") or {}).get("name", "edit").replace("kubeflow-", "")
        if not user or not namespace:
            raise ApiHttpError(400, "binding requires user.name and referredNamespace")
        self._require(req, namespace)
        name = binding_name(user, role)
        try:
            self.client.delete("rbac.authorization.k8s.io/v1", "RoleBinding",
                               name, namespace)
        except ob.NotFound:
            raise ApiHttpError(404, f"binding {name} not found")
        try:
            self.client.delete("security.istio.io/v1beta1", "AuthorizationPolicy",
                               name, namespace)
        except ob.NotFound:
            pass
        _count("kfam_binding_delete_total", "bindings deleted")
        return 200, {"status": "ok"}

    # -- profiles (api_default.go:123-197) ----------------------------------

    def create_profile(self, req: HttpReq):
        body = req.json() or {}
        name = (body.get("metadata") or {}).get("name") or body.get("name")
        owner = (((body.get("spec") or {}).get("owner") or {}).get("name")
                 or req.header(USER_HEADER))
        if not name:
            raise ApiHttpError(400, "profile requires metadata.name")
        if not owner:
            raise ApiHttpError(401, f"missing owner and {USER_HEADER} header")
        prof = PT.new_profile(name, owner)
        if (body.get("spec") or {}).get("resourceQuotaSpec"):
            prof["spec"]["resourceQuotaSpec"] = body["spec"]["resourceQuotaSpec"]
        try:
            self.client.create(prof)
        except ob.Conflict:
            raise ApiHttpError(409, f"profile {name} already exists")
        _count("kfam_profile_create_total", "profiles created")
        return 200, {"status": "ok", "name": name}

    def delete_profile(self, req: HttpReq):
        name = req.params["name"]
        user = req.header(USER_HEADER)
        if not self.is_owner_or_admin(user, name):
            raise ApiHttpError(403, f"{user} cannot delete profile {name}")
        try:
            self.client.delete(PT.API_VERSION, PT.KIND, name)
        except ob.NotFound:
            raise ApiHttpError(404, f"profile {name} not found")
        return 200, {"status": "ok"}

    def query_cluster_admin(self, req: HttpReq):
        """QueryClusterAdmin (:247)."""
        user = req.q1("user") or req.header(USER_HEADER)
        return {"user": user, "isClusterAdmin": self.is_cluster_admin(user)}

    # -- wiring -------------------------------------------------------------

    def router(self) -> Router:
        r = Router("kfam")
        r.route("POST", "/kfam/v1/bindings", self.create_binding)
        r.route("GET", "/kfam/v1/bindings", self.read_bindings)
        r.route("DELETE", "/kfam/v1/bindings", self.delete_binding)
        r.route("POST", "/kfam/v1/profiles", self.create_profile)
        r.route("DELETE", "/kfam/v1/profiles/{name}", self.delete_profile)
        r.route("GET", "/kfam/v1/clusteradmin", self.query_cluster_admin)
        httpd.add_health_routes(r)
        httpd.add_metrics_route(r)
        return r

    def serve(self, host: str = "0.0.0.0", port: int = 0) -> httpd.HttpService:
        return httpd.HttpService(self.router(), host, port)
