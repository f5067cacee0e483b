"""PodDefault mutation logic and the AdmissionReview webhook server.

Port of `kubeflow_tpu/control/poddefault/webhook.py`, over the port's
control plane. It mirrors admission-webhook/main.go:
- filterPodDefaults (:69-96): namespace PodDefaults whose selector
  matches the pod's labels;
- safeToApplyPodDefaultsOnPod (:98-145): conflict detection. An env var
  or volumeMount required by two defaults with different values rejects
  the whole set rather than corrupting the pod;
- merge functions (:147-316) for env, envFrom, volumes, volumeMounts and
  tolerations;
- applyPodDefaultsOnPod (:321-387): mutation plus the applied annotation
  `poddefault.admission.kubeflow.org/poddefault-<name>`;
- mutatePods (:389-486): AdmissionReview -> JSONPatch response.

On a GPU cluster the same mechanism injects the GPU runtime's defaults
into notebook and job pods (a trace file, NCCL settings, mounts). The
HTTP server speaks admission/v1 AdmissionReview JSON; the same mutator
also wires straight into FakeCluster.add_admission_hook, where the real
admission chain sits.
"""

from __future__ import annotations

import base64
import copy
import json
import logging
import os
import threading

from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.utils.httpd import HttpReq, HttpService, Router, json_resp

log = logging.getLogger("kubeflow_tpu_torch.poddefault")

GROUP = "kubeflow.org"
VERSION = "v1alpha1"
API_VERSION = f"{GROUP}/{VERSION}"
KIND = "PodDefault"

ANNOTATION_PREFIX = "poddefault.admission.kubeflow.org"  # main.go:44


def new_poddefault(
    name: str,
    namespace: str = "default",
    *,
    selector: dict | None = None,
    desc: str = "",
    env: list[dict] | None = None,
    env_from: list[dict] | None = None,
    volumes: list[dict] | None = None,
    volume_mounts: list[dict] | None = None,
    tolerations: list[dict] | None = None,
    labels: dict | None = None,
    annotations: dict | None = None,
) -> dict:
    spec: dict = {"selector": selector or {}, "desc": desc or name}
    if env:
        spec["env"] = env
    if env_from:
        spec["envFrom"] = env_from
    if volumes:
        spec["volumes"] = volumes
    if volume_mounts:
        spec["volumeMounts"] = volume_mounts
    if tolerations:
        spec["tolerations"] = tolerations
    if labels:
        spec["labels"] = labels
    if annotations:
        spec["annotations"] = annotations
    return ob.new_object(API_VERSION, KIND, name, namespace, spec=spec)


def crd_manifest() -> dict:
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"poddefaults.{GROUP}"},
        "spec": {
            "group": GROUP,
            "names": {"kind": KIND, "listKind": "PodDefaultList",
                      "plural": "poddefaults", "singular": "poddefault"},
            "scope": "Namespaced",
            "versions": [{
                "name": VERSION, "served": True, "storage": True,
                "schema": {"openAPIV3Schema": {
                    "type": "object",
                    "x-kubernetes-preserve-unknown-fields": True}},
            }],
        },
    }


# ---------------------------------------------------------------------------
# selection + conflict checks


def filter_poddefaults(pod: dict, poddefaults: list[dict]) -> list[dict]:
    """filterPodDefaults (:69-96): selector match against pod labels;
    pods that opted out via annotation are skipped."""
    annos = ob.annotations_of(pod)
    if annos.get(f"{ANNOTATION_PREFIX}/exclude") == "true":
        return []
    labels = ob.labels_of(pod)
    return [
        pd for pd in poddefaults
        if ob.match_labels(labels, (pd.get("spec") or {}).get("selector"))
    ]


def _merge_keyed(existing: list[dict], addition: list[dict], key: str,
                 what: str) -> list[dict]:
    """Shared merge: same key + equal value = skip, same key + different
    value = conflict (mergeEnv/mergeVolumeMounts/… semantics, :147-316)."""
    out = list(existing)
    by_key = {e[key]: e for e in existing if key in e}
    for item in addition:
        cur = by_key.get(item.get(key))
        if cur is None:
            out.append(copy.deepcopy(item))
            by_key[item[key]] = item
        elif cur != item:
            raise ValueError(
                f"conflict on {what} {item.get(key)!r}: "
                f"existing {cur} != injected {item}"
            )
    return out


def safe_to_apply(pod: dict, poddefaults: list[dict]) -> str | None:
    """safeToApplyPodDefaultsOnPod (:98-145): dry-run the merge; returns an
    error string on conflict, None when safe."""
    try:
        apply_poddefaults(copy.deepcopy(pod), poddefaults)
        return None
    except ValueError as e:
        return str(e)


def apply_poddefaults(pod: dict, poddefaults: list[dict]) -> dict:
    """applyPodDefaultsOnPod (:321-387): mutate pod in place and return it."""
    spec = pod.setdefault("spec", {})
    containers = spec.setdefault("containers", [])
    for pd in poddefaults:
        ps = pd.get("spec") or {}
        for c in containers:
            if ps.get("env"):
                c["env"] = _merge_keyed(c.get("env") or [], ps["env"], "name", "env var")
            if ps.get("envFrom"):
                c["envFrom"] = (c.get("envFrom") or []) + copy.deepcopy(ps["envFrom"])
            if ps.get("volumeMounts"):
                c["volumeMounts"] = _merge_keyed(
                    c.get("volumeMounts") or [], ps["volumeMounts"],
                    "mountPath", "volumeMount",
                )
        if ps.get("volumes"):
            spec["volumes"] = _merge_keyed(
                spec.get("volumes") or [], ps["volumes"], "name", "volume")
        if ps.get("tolerations"):
            existing = spec.get("tolerations") or []
            for tol in ps["tolerations"]:
                if tol not in existing:
                    existing.append(copy.deepcopy(tol))
            spec["tolerations"] = existing
        for k, v in (ps.get("labels") or {}).items():
            ob.set_label(pod, k, v)
        for k, v in (ps.get("annotations") or {}).items():
            ob.set_annotation(pod, k, v)
        ob.set_annotation(
            pod, f"{ANNOTATION_PREFIX}/poddefault-{ob.meta(pd)['name']}",
            ob.meta(pd).get("resourceVersion", ""),
        )
    return pod


class PodDefaultMutator:
    """The webhook core, usable in-process (FakeCluster admission hook) or
    behind the AdmissionReview HTTP server."""

    def __init__(self, client):
        self.client = client
        self.certs = None  # set by serve(certs_dir=...)

    def lookup(self, namespace: str) -> list[dict]:
        return self.client.list(API_VERSION, KIND, namespace=namespace)

    def mutate(self, pod: dict) -> dict:
        ns = ob.meta(pod).get("namespace") or "default"
        matched = filter_poddefaults(pod, self.lookup(ns))
        if not matched:
            return pod
        err = safe_to_apply(pod, matched)
        if err is not None:
            # reference behavior: log and admit unmodified (:433-440) —
            # admission must never brick pod creation
            log.warning("poddefaults not applied to %s: %s",
                        ob.meta(pod).get("name"), err)
            return pod
        return apply_poddefaults(pod, matched)

    def admission_hook(self, verb: str, obj: dict) -> dict:
        if verb == "CREATE" and obj.get("kind") == "Pod":
            return self.mutate(obj)
        return obj

    # -- AdmissionReview over HTTP (mutatePods :389-486) -------------------

    def review(self, body: dict) -> dict:
        req = body.get("request") or {}
        pod = req.get("object") or {}
        pod.setdefault("metadata", {}).setdefault(
            "namespace", req.get("namespace", "default"))
        mutated = self.mutate(copy.deepcopy(pod))
        patch = _json_patch_diff(pod, mutated)
        resp: dict = {"uid": req.get("uid", ""), "allowed": True}
        if patch:
            resp["patchType"] = "JSONPatch"
            resp["patch"] = base64.b64encode(json.dumps(patch).encode()).decode()
        return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
                "response": resp}

    def serve(self, host: str = "0.0.0.0", port: int = 0,
              certs_dir: str | None = None) -> HttpService:
        """Serve the AdmissionReview endpoint. With ``certs_dir`` the
        server speaks HTTPS (bootstrapping a CA + serving cert there if
        absent) — the only form a kube apiserver will call
        (main.go:541-542's --tlsCertFile/--tlsKeyFile equivalent)."""
        router = Router("poddefault-webhook")

        def handle(req: HttpReq):
            return json_resp(self.review(req.json()))

        router.route("POST", "/apply-poddefault", handle)
        router.route("POST", "/mutate", handle)
        from kubeflow_tpu_torch.utils.httpd import add_health_routes, add_metrics_route

        add_health_routes(router)
        add_metrics_route(router)
        tls = None
        if certs_dir:
            from kubeflow_tpu_torch.utils import tlscerts

            self.certs = tlscerts.ensure_certs(
                certs_dir, "poddefault-webhook",
                namespace=os.environ.get("POD_NAMESPACE", "kubeflow"))
            tls = tlscerts.server_context(self.certs.cert, self.certs.key)
        return HttpService(router, host, port, tls=tls)

    def publish_ca_bundle(self, registration: str = "poddefault-webhook",
                          retries: int | None = None,
                          delay: float = 2.0,
                          stop: threading.Event | None = None) -> bool:
        """Patch this pod's bootstrapped CA into the live
        MutatingWebhookConfiguration so the apiserver can verify us —
        the in-cluster replacement for the reference's out-of-band
        cert-gen step (README.md:66 'caBundle: ...'). Retries because the
        registration may be applied after the pod starts; ``retries=None``
        (the server default) retries forever with capped backoff — giving
        up would leave admission silently skipped under
        failurePolicy: Ignore. Setting ``stop`` ends the retries (the
        server's orderly exit)."""
        if self.certs is None:
            return False
        bundle = self.certs.ca_bundle_b64
        attempt = 0
        stop = stop or threading.Event()
        while (retries is None or attempt < retries) and not stop.is_set():
            attempt += 1
            try:
                hook = self.client.get(
                    "admissionregistration.k8s.io/v1",
                    "MutatingWebhookConfiguration", registration)
                changed = False
                for wh in hook.get("webhooks") or []:
                    cc = wh.setdefault("clientConfig", {})
                    if cc.get("caBundle") != bundle:
                        cc["caBundle"] = bundle
                        changed = True
                if changed:
                    self.client.update(hook)
                return True
            except Exception as e:  # registration not applied yet / conflict
                level = log.warning if attempt % 30 == 0 else log.info
                level("caBundle publish attempt %d: %s", attempt, e)
                stop.wait(min(delay * min(attempt, 8), 15.0))
        if stop.is_set():
            return False
        log.error("caBundle never published after %d attempts: admission "
                  "will be silently skipped (failurePolicy: Ignore)", attempt)
        return False


def _json_patch_diff(old: dict, new: dict) -> list[dict]:
    """Whole-document replace ops where top-level sections differ — the
    same JSONPatch shape the reference emits (it patches spec and
    metadata wholesale, :477-486)."""
    ops = []
    for section in ("metadata", "spec"):
        if old.get(section) != new.get(section):
            ops.append({"op": "replace", "path": f"/{section}",
                        "value": new.get(section)})
    return ops
