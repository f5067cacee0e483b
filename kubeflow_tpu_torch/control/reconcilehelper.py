"""Create-or-update reconcile helpers with field-copy policies.

The reference factors its "desired vs found" diff policy into
components/common/reconcilehelper/util.go and reuses it across the
notebook/profile/tensorboard controllers:

- Deployment  (util.go:18-44): create if absent, else copy selected fields
  and update when changed.
- Service     (util.go:46-72): same, but PRESERVE the allocated ClusterIP
  (CopyServiceFields, util.go:166-197).
- StatefulSet (CopyStatefulSetFields, util.go:107-137): only replicas and
  pod template are controller-owned; everything else the cluster owns.
- VirtualService (util.go:74-105, CopyVirtualService :199-230): spec only.

Same policies here, expressed over unstructured dicts and generalized by a
``copy_fields`` registry keyed by kind.

Port of `kubeflow_tpu/control/reconcilehelper.py`: the same code over the port's own modules.
"""

from __future__ import annotations

import logging
from typing import Callable

from kubeflow_tpu_torch.control.k8s import objects as ob

log = logging.getLogger("kubeflow_tpu_torch.reconcilehelper")


def _copy_meta(desired: dict, found: dict) -> bool:
    """Labels and annotations are controller-owned (additive)."""
    changed = False
    fm, dm = ob.meta(found), ob.meta(desired)
    for field in ("labels", "annotations"):
        want = dm.get(field) or {}
        have = fm.get(field) or {}
        merged = {**have, **want}
        if merged != have:
            fm[field] = merged
            changed = True
    return changed


def copy_statefulset_fields(desired: dict, found: dict) -> bool:
    """Only spec.replicas + spec.template (CopyStatefulSetFields,
    util.go:107-137 — replica changes drive culling scale-to-zero)."""
    changed = _copy_meta(desired, found)
    dspec, fspec = desired.get("spec") or {}, found.setdefault("spec", {})
    if fspec.get("replicas") != dspec.get("replicas"):
        fspec["replicas"] = dspec.get("replicas")
        changed = True
    if fspec.get("template") != dspec.get("template"):
        fspec["template"] = dspec.get("template")
        changed = True
    return changed


def copy_deployment_fields(desired: dict, found: dict) -> bool:
    changed = _copy_meta(desired, found)
    dspec = desired.get("spec") or {}
    fspec = found.setdefault("spec", {})
    for f in ("replicas", "template", "selector"):
        if f in dspec and fspec.get(f) != dspec[f]:
            fspec[f] = dspec[f]
            changed = True
    return changed


def copy_service_fields(desired: dict, found: dict) -> bool:
    """Spec is copied except the cluster-allocated ClusterIP
    (CopyServiceFields, util.go:166-197)."""
    changed = _copy_meta(desired, found)
    dspec = dict(desired.get("spec") or {})
    fspec = found.setdefault("spec", {})
    cluster_ip = fspec.get("clusterIP")
    dspec.pop("clusterIP", None)
    compare_found = {k: v for k, v in fspec.items() if k != "clusterIP"}
    if compare_found != dspec:
        new_spec = dict(dspec)
        if cluster_ip is not None:
            new_spec["clusterIP"] = cluster_ip
        found["spec"] = new_spec
        changed = True
    return changed


def copy_spec_only(desired: dict, found: dict) -> bool:
    """Whole-spec ownership (CopyVirtualService, util.go:199-230)."""
    changed = _copy_meta(desired, found)
    if found.get("spec") != desired.get("spec"):
        found["spec"] = desired.get("spec")
        changed = True
    return changed


COPIERS: dict[str, Callable[[dict, dict], bool]] = {
    "StatefulSet": copy_statefulset_fields,
    "Deployment": copy_deployment_fields,
    "Service": copy_service_fields,
}


def reconcile_child(client, owner: dict, desired: dict) -> dict:
    """Create-or-update one generated child with owner reference.

    The per-kind create/get/copy/update dance every reference controller
    repeats (e.g. notebook_controller.go:126-180) — done once.
    """
    ob.set_owner(desired, owner)
    m = ob.meta(desired)
    found = client.get_or_none(
        desired["apiVersion"], desired["kind"], m["name"], m.get("namespace")
    )
    if found is None:
        log.info("creating %s %s/%s", desired["kind"], m.get("namespace"), m["name"])
        return client.create(desired)
    copier = COPIERS.get(desired["kind"], copy_spec_only)
    if copier(desired, found):
        log.info("updating %s %s/%s", desired["kind"], m.get("namespace"), m["name"])
        return client.update(found)
    return found
