"""Unstructured Kubernetes objects and apimachinery helpers.

Objects are plain dicts shaped exactly like Kubernetes JSON (apiVersion,
kind, metadata, spec, status). This mirrors the unstructured client the
reference uses for Istio VirtualServices
(components/common/reconcilehelper/util.go:74-105) — generalized here to
every kind, so one Client interface covers built-ins and CRDs alike.

Port of `kubeflow_tpu/control/k8s/objects.py`: the same code over the port's own modules.
"""

from __future__ import annotations

import copy
import datetime
import fnmatch
from typing import Any, Iterable


class ApiError(Exception):
    """Base API error with an HTTP-ish status code."""

    code = 500

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


class NotFound(ApiError):
    code = 404


class Conflict(ApiError):
    """Resource-version conflict or already-exists."""

    code = 409


class Invalid(ApiError):
    code = 422


class Expired(ApiError):
    """410 Gone: a watch/list resourceVersion older than the server's
    retained history — the client must relist (client-go's
    ResourceExpired / informer relist path)."""

    code = 410


def now_iso() -> str:
    return (
        datetime.datetime.now(datetime.timezone.utc)
        .replace(microsecond=0)
        .isoformat()
        .replace("+00:00", "Z")
    )


def new_object(
    api_version: str,
    kind: str,
    name: str,
    namespace: str | None = None,
    labels: dict[str, str] | None = None,
    annotations: dict[str, str] | None = None,
    spec: dict | None = None,
) -> dict:
    obj: dict[str, Any] = {
        "apiVersion": api_version,
        "kind": kind,
        "metadata": {"name": name},
    }
    if namespace is not None:
        obj["metadata"]["namespace"] = namespace
    if labels:
        obj["metadata"]["labels"] = dict(labels)
    if annotations:
        obj["metadata"]["annotations"] = dict(annotations)
    if spec is not None:
        obj["spec"] = spec
    return obj


def meta(obj: dict) -> dict:
    return obj.setdefault("metadata", {})


def gvk(obj: dict) -> tuple[str, str]:
    return obj.get("apiVersion", ""), obj.get("kind", "")


def namespaced_name(obj: dict) -> str:
    m = meta(obj)
    ns = m.get("namespace")
    return f"{ns}/{m['name']}" if ns else m["name"]


def labels_of(obj: dict) -> dict[str, str]:
    return meta(obj).get("labels") or {}


def annotations_of(obj: dict) -> dict[str, str]:
    return meta(obj).get("annotations") or {}


def set_label(obj: dict, key: str, value: str) -> None:
    meta(obj).setdefault("labels", {})[key] = value


def set_annotation(obj: dict, key: str, value: str) -> None:
    meta(obj).setdefault("annotations", {})[key] = value


# ---------------------------------------------------------------------------
# Selectors


def match_labels(labels: dict[str, str], selector: dict | None) -> bool:
    """Evaluate a LabelSelector (matchLabels + matchExpressions).

    Same semantics the PodDefault webhook relies on to pick pods
    (admission-webhook/main.go:69-96 uses metav1.LabelSelectorAsSelector).
    An empty/None selector matches everything (the K8s convention).
    """
    if not selector:
        return True
    for k, v in (selector.get("matchLabels") or {}).items():
        if labels.get(k) != v:
            return False
    for expr in selector.get("matchExpressions") or []:
        key, op = expr.get("key"), expr.get("operator")
        vals = expr.get("values") or []
        has = key in labels
        if op == "In":
            if not has or labels[key] not in vals:
                return False
        elif op == "NotIn":
            if has and labels[key] in vals:
                return False
        elif op == "Exists":
            if not has:
                return False
        elif op == "DoesNotExist":
            if has:
                return False
        else:
            raise Invalid(f"unknown matchExpressions operator {op!r}")
    return True


def parse_label_selector(s: str) -> dict:
    """Parse the string form ``a=b,c!=d,e`` into a LabelSelector dict."""
    sel: dict[str, Any] = {"matchLabels": {}, "matchExpressions": []}
    for part in filter(None, (p.strip() for p in s.split(","))):
        if "!=" in part:
            k, v = part.split("!=", 1)
            sel["matchExpressions"].append(
                {"key": k.strip(), "operator": "NotIn", "values": [v.strip()]}
            )
        elif "=" in part:
            k, v = part.split("=", 1)
            sel["matchLabels"][k.strip()] = v.strip()
        else:
            sel["matchExpressions"].append({"key": part, "operator": "Exists"})
    return sel


def match_fields(obj: dict, field_selector: dict[str, str] | None) -> bool:
    """Minimal fieldSelector: dotted-path equality (status.phase=Running)."""
    if not field_selector:
        return True
    for path, want in field_selector.items():
        cur: Any = obj
        for seg in path.split("."):
            if not isinstance(cur, dict) or seg not in cur:
                cur = None
                break
            cur = cur[seg]
        if cur != want:
            return False
    return True


def match_glob(name: str, pattern: str) -> bool:
    return fnmatch.fnmatchcase(name, pattern)


# ---------------------------------------------------------------------------
# Owner references


def owner_ref(owner: dict, controller: bool = True, block_deletion: bool = True) -> dict:
    api_version, kind = gvk(owner)
    m = meta(owner)
    return {
        "apiVersion": api_version,
        "kind": kind,
        "name": m["name"],
        "uid": m.get("uid", ""),
        "controller": controller,
        "blockOwnerDeletion": block_deletion,
    }


def set_owner(obj: dict, owner: dict) -> None:
    """Append a controller ownerReference (ctrl.SetControllerReference
    analogue; the reference sets it on every generated child — e.g.
    notebook-controller/controllers/notebook_controller.go:120)."""
    refs = meta(obj).setdefault("ownerReferences", [])
    new = owner_ref(owner)
    for r in refs:
        if r.get("uid") == new["uid"] and r.get("name") == new["name"]:
            return
    refs.append(new)


def controller_owner(obj: dict) -> dict | None:
    for r in meta(obj).get("ownerReferences") or []:
        if r.get("controller"):
            return r
    return None


# ---------------------------------------------------------------------------
# Conditions (the status.conditions[] contract Katib-style tests poll —
# testing/katib_studyjob_test.py:128-194 waits for type=Running)


def cond_get(obj: dict, ctype: str) -> dict | None:
    for c in (obj.get("status") or {}).get("conditions") or []:
        if c.get("type") == ctype:
            return c
    return None


def cond_set(
    obj: dict,
    ctype: str,
    status: str = "True",
    reason: str = "",
    message: str = "",
) -> bool:
    """Upsert a condition; returns True when something changed.

    lastTransitionTime only moves when status flips (apimachinery
    SetStatusCondition semantics; the bootstrap plane appends conditions
    similarly at kfctlServer.go:320-327).
    """
    conds = obj.setdefault("status", {}).setdefault("conditions", [])
    for c in conds:
        if c.get("type") == ctype:
            changed = (
                c.get("status") != status
                or c.get("reason") != reason
                or c.get("message") != message
            )
            if c.get("status") != status:
                c["lastTransitionTime"] = now_iso()
            c.update(status=status, reason=reason, message=message)
            c["lastUpdateTime"] = now_iso()
            return changed
    conds.append(
        {
            "type": ctype,
            "status": status,
            "reason": reason,
            "message": message,
            "lastUpdateTime": now_iso(),
            "lastTransitionTime": now_iso(),
        }
    )
    return True


def cond_is_true(obj: dict, ctype: str) -> bool:
    c = cond_get(obj, ctype)
    return bool(c and c.get("status") == "True")


# ---------------------------------------------------------------------------
# Deep merge / patch helpers


def deep_copy(obj: dict) -> dict:
    return copy.deepcopy(obj)


def merge_patch(target: dict, patch: dict) -> dict:
    """RFC 7386 JSON Merge Patch (null deletes)."""
    out = dict(target)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_patch(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def json_patch(target: dict, ops: Iterable[dict]) -> dict:
    """RFC 6902 JSON Patch — the reply format of the mutating webhook
    (admission-webhook/main.go:477-486 returns a JSONPatch). Supports
    add/replace/remove, with ``-`` array append."""
    doc = copy.deepcopy(target)
    for op in ops:
        action = op["op"]
        path = [p.replace("~1", "/").replace("~0", "~") for p in op["path"].split("/")[1:]]
        parent: Any = doc
        for seg in path[:-1]:
            parent = parent[int(seg)] if isinstance(parent, list) else parent[seg]
        last = path[-1] if path else ""
        if action in ("add", "replace"):
            value = copy.deepcopy(op["value"])
            if isinstance(parent, list):
                if last == "-":
                    parent.append(value)
                elif action == "add":
                    parent.insert(int(last), value)
                else:
                    parent[int(last)] = value
            else:
                parent[last] = value
        elif action == "remove":
            if isinstance(parent, list):
                parent.pop(int(last))
            else:
                del parent[last]
        else:
            raise Invalid(f"unsupported json patch op {action!r}")
    return doc
