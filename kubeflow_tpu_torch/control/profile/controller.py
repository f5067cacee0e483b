"""Profile controller: namespace-per-user multi-tenancy.

Port of `kubeflow_tpu/control/profile/controller.py`: the same
reconcile over the port's control plane; the quota it writes names GPUs
(`types.QUOTA_GPU`) where the JAX package's names TPU chips.

Reconcile mirrors profile_controller.go:100-279:
- Namespace create with istio-injection label + ownership conflict
  rejection (:122-186),
- default-editor / default-viewer ServiceAccounts (:199-212),
- namespaceAdmin RoleBinding for the owner (:218-239),
- ResourceQuota `kf-resource-quota` (:241-254) — GPUs first-class,
- plugin dispatch (:257; Plugin interface :74-80) with Revoke on the
  deletion finalizer path (:48).

Istio ServiceRole/Binding from the reference's 2019-era istio-rbac API is
represented by AuthorizationPolicy-shaped unstructured objects (the
modern surface), keeping the same capability: only in-namespace principals
+ the owner reach the namespace workloads.
"""

from __future__ import annotations

import logging
from typing import Protocol

from kubeflow_tpu_torch.control import reconcilehelper as rh
from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.control.profile import types as T
from kubeflow_tpu_torch.control.runtime import Controller, Reconciler, Request, Result

log = logging.getLogger("kubeflow_tpu_torch.profile")


class Plugin(Protocol):
    """profile_controller.go:74-80."""

    def apply(self, client, profile: dict) -> None: ...

    def revoke(self, client, profile: dict) -> None: ...


def plugin_spec_field(profile: dict, kind: str, field: str) -> str | None:
    """Extract one field from the profile's plugin spec of the given kind
    (shared by all cloud-credential plugins)."""
    for p in (profile.get("spec") or {}).get("plugins") or []:
        if p.get("kind") == kind:
            return (p.get("spec") or {}).get(field)
    return None


class WorkloadIdentityPlugin:
    """GCP Workload Identity binding (plugin_workload_identity.go:32-156).

    Cloud IAM calls are delegated to an injectable ``iam`` backend (the
    reference holds a live google IAM client); the in-cluster half —
    annotating default-editor with the GSA — is real.
    """

    KIND = "WorkloadIdentity"
    ANNOTATION = "iam.gke.io/gcp-service-account"  # :32-36

    def __init__(self, iam_backend=None):
        self.iam = iam_backend  # .bind(gsa, ksa), .unbind(gsa, ksa)

    def _gsa(self, profile: dict) -> str | None:
        return plugin_spec_field(profile, self.KIND, "gcpServiceAccount")

    def apply(self, client, profile: dict) -> None:
        gsa = self._gsa(profile)
        if not gsa:
            return
        ns = ob.meta(profile)["name"]
        sa = client.get_or_none("v1", "ServiceAccount", T.SA_EDITOR, ns)
        if sa is None:
            return
        ob.set_annotation(sa, self.ANNOTATION, gsa)
        client.update(sa)
        if self.iam:
            self.iam.bind(gsa, f"{ns}/{T.SA_EDITOR}")

    def revoke(self, client, profile: dict) -> None:
        gsa = self._gsa(profile)
        if gsa and self.iam:
            self.iam.unbind(gsa, f"{ob.meta(profile)['name']}/{T.SA_EDITOR}")


class ProfileReconciler(Reconciler):
    def __init__(self, plugins: dict[str, Plugin] | None = None):
        self.plugins = plugins or {}

    # -- generators ---------------------------------------------------------

    def generate_namespace(self, profile: dict) -> dict:
        name = ob.meta(profile)["name"]
        owner = T.owner_name(profile) or ""
        return ob.new_object(
            "v1", "Namespace", name,
            labels={
                "istio-injection": "enabled",  # :131
                "app.kubernetes.io/part-of": "kubeflow-profile",
            },
            annotations={"owner": owner},
        )

    def generate_service_accounts(self, profile: dict) -> list[dict]:
        ns = ob.meta(profile)["name"]
        return [
            ob.new_object("v1", "ServiceAccount", T.SA_EDITOR, ns),
            ob.new_object("v1", "ServiceAccount", T.SA_VIEWER, ns),
        ]

    def generate_sa_rolebindings(self, profile: dict) -> list[dict]:
        """Bind the namespace SAs to kubeflow-edit/view ClusterRoles
        (:199-212)."""
        ns = ob.meta(profile)["name"]
        out = []
        for sa, role in ((T.SA_EDITOR, T.EDIT_CLUSTER_ROLE),
                         (T.SA_VIEWER, T.VIEW_CLUSTER_ROLE)):
            rb = ob.new_object(
                "rbac.authorization.k8s.io/v1", "RoleBinding", sa, ns,
                annotations={T.ANNO_ROLE: role.split("-")[-1]},
            )
            rb["roleRef"] = {"apiGroup": "rbac.authorization.k8s.io",
                            "kind": "ClusterRole", "name": role}
            rb["subjects"] = [{"kind": "ServiceAccount", "name": sa, "namespace": ns}]
            out.append(rb)
        return out

    def generate_owner_rolebinding(self, profile: dict) -> dict:
        """namespaceAdmin (:218-239): owner -> kubeflow-admin."""
        ns = ob.meta(profile)["name"]
        owner = T.owner_name(profile) or ""
        rb = ob.new_object(
            "rbac.authorization.k8s.io/v1", "RoleBinding", "namespaceAdmin", ns,
            annotations={T.ANNO_USER: owner, T.ANNO_ROLE: "admin"},
        )
        rb["roleRef"] = {"apiGroup": "rbac.authorization.k8s.io",
                        "kind": "ClusterRole", "name": T.ADMIN_CLUSTER_ROLE}
        rb["subjects"] = [{"apiGroup": "rbac.authorization.k8s.io",
                          "kind": "User", "name": owner}]
        return rb

    def generate_quota(self, profile: dict) -> dict | None:
        spec = (profile.get("spec") or {}).get("resourceQuotaSpec")
        if not spec or not spec.get("hard"):
            return None
        ns = ob.meta(profile)["name"]
        return ob.new_object("v1", "ResourceQuota", T.QUOTA_NAME, ns, spec=spec)

    def generate_authz_policy(self, profile: dict) -> dict:
        """The istio-rbac ServiceRole/Binding capability (:190) expressed
        as one AuthorizationPolicy: allow the owner + in-ns principals."""
        ns = ob.meta(profile)["name"]
        owner = T.owner_name(profile) or ""
        pol = ob.new_object(
            "security.istio.io/v1beta1", "AuthorizationPolicy", "ns-owner-access", ns,
            annotations={T.ANNO_USER: owner, T.ANNO_ROLE: "admin"},
            spec={
                "rules": [
                    {"when": [{"key": "request.headers[kubeflow-userid]",
                               "values": [owner]}]},
                    {"from": [{"source": {"namespaces": [ns]}}]},
                ]
            },
        )
        return pol

    # -- reconcile ----------------------------------------------------------

    def reconcile(self, client, req: Request) -> Result | None:
        profile = client.get_or_none(T.API_VERSION, T.KIND, req.name)
        if profile is None:
            return None
        m = ob.meta(profile)

        if m.get("deletionTimestamp"):
            return self._finalize(client, profile)

        if T.FINALIZER not in (m.get("finalizers") or []):
            m.setdefault("finalizers", []).append(T.FINALIZER)
            profile = client.update(profile)

        # namespace, with ownership conflict rejection (:168-186)
        ns_name = m["name"]
        existing = client.get_or_none("v1", "Namespace", ns_name)
        owner = T.owner_name(profile) or ""
        if existing is not None:
            anno_owner = ob.annotations_of(existing).get("owner")
            owned_by_us = any(
                r.get("uid") == m.get("uid")
                for r in ob.meta(existing).get("ownerReferences") or []
            )
            if not owned_by_us and anno_owner not in (None, "", owner):
                ob.cond_set(profile, "Ready", "False", "NamespaceOwnershipConflict",
                            f"namespace {ns_name} owned by {anno_owner}")
                client.update_status(profile)
                return None
        rh.reconcile_child(client, profile, self.generate_namespace(profile))

        for sa in self.generate_service_accounts(profile):
            rh.reconcile_child(client, profile, sa)
        for rb in self.generate_sa_rolebindings(profile):
            rh.reconcile_child(client, profile, rb)
        rh.reconcile_child(client, profile, self.generate_owner_rolebinding(profile))
        rh.reconcile_child(client, profile, self.generate_authz_policy(profile))
        quota = self.generate_quota(profile)
        if quota is not None:
            rh.reconcile_child(client, profile, quota)

        for p in (profile.get("spec") or {}).get("plugins") or []:
            plugin = self.plugins.get(p.get("kind"))
            if plugin:
                plugin.apply(client, profile)
            else:
                log.warning("unknown profile plugin %s", p.get("kind"))

        ob.cond_set(profile, "Ready", "True", "ProfileReady")
        client.update_status(profile)
        return None

    def _finalize(self, client, profile: dict) -> None:
        for p in (profile.get("spec") or {}).get("plugins") or []:
            plugin = self.plugins.get(p.get("kind"))
            if plugin:
                plugin.revoke(client, profile)
        client.remove_finalizer(profile, T.FINALIZER)
        return None


def build_controller(client, plugins: dict[str, Plugin] | None = None) -> Controller:
    rec = ProfileReconciler(plugins=plugins)
    ctl = Controller("profile", client, rec)
    ctl.watches_primary(T.API_VERSION, T.KIND)
    ctl.owns("v1", "Namespace")
    return ctl
