"""Node/GPU-pool model for the gang scheduler.

Port of `kubeflow_tpu/control/scheduler/nodes.py`. A ``Node`` in the
FakeCluster (or a real apiserver) carries the GKE GPU pool surface the
JAXJob controller targets with nodeSelectors (jaxjob/types.py
NODESELECTOR_*): the GPU product + node-pool labels,
``status.allocatable["nvidia.com/gpu"]`` GPUs, taints and the Ready
condition. This module reads that surface into a small value type the
admission pass computes against, and provides the constructor tests use
to stand up GPU node pools in the fake cluster.
"""

from __future__ import annotations

import dataclasses

from kubeflow_tpu_torch.control.jaxjob import types as JT
from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.control.scheduler import LABEL_SPOT
from kubeflow_tpu_torch.control.scheduler.topology import normalize_pool

# Pod phases that no longer hold their node's GPUs.
TERMINAL_PHASES = ("Succeeded", "Failed")


def eviction_status(message: str) -> dict:
    """The kubelet-eviction status shape (phase Failed, reason Evicted,
    no containerStatuses): ONE spelling, because every eviction site —
    the scheduler's priority preemption and its node-health pass — must
    be classified as preemption (never crash) by
    ``JAXJobReconciler._pod_preempted``."""
    return {"phase": "Failed", "reason": "Evicted", "message": message,
            "containerStatuses": []}


def spot_taint() -> dict:
    """The spot-pool taint (ONE spelling, mirrored by the toleration the
    JAXJob controller adds to elastic workers): only reclaim-tolerant
    workloads may land on preemptible capacity."""
    return {"key": LABEL_SPOT, "value": "true", "effect": "NoSchedule"}


@dataclasses.dataclass(frozen=True)
class NodeView:
    """The scheduler's read of one Node."""

    name: str
    labels: dict
    allocatable_gpus: int
    ready: bool
    taints: tuple
    # spot/preemptible pool membership (LABEL_SPOT): lowest-priority
    # capacity — preferred for elastic gangs, reclaimed without notice
    spot: bool = False
    # spec.unschedulable (kubectl cordon / the remediation engine's
    # cordon-and-drain): existing pods keep running, nothing new lands
    unschedulable: bool = False


def new_gpu_node(
    name: str,
    product: str = "nvidia-h100-80gb",
    node_pool: str = "gpu-pool",
    gpus: int = 8,
    ready: bool = True,
    taints: tuple = (),
    labels: dict | None = None,
    spot: bool = False,
) -> dict:
    """A Node carrying GPU pool labels (a GKE GPU node pool's node):
    ``product`` is GKE's accelerator label value, ``node_pool`` the
    node pool's name (normalised), ``gpus`` its ``nvidia.com/gpu``
    allocatable (default 8, an a3-highgpu-8g host).

    ``spot=True`` puts the node in a spot/preemptible pool: the
    LABEL_SPOT label plus the matching NoSchedule taint, so only
    reclaim-tolerant (elastic) workers can land on it."""
    node = ob.new_object(
        "v1", "Node", name,
        labels={
            JT.NODESELECTOR_ACCEL: product,
            JT.NODESELECTOR_POOL: normalize_pool(node_pool),
            **({LABEL_SPOT: "true"} if spot else {}),
            **(labels or {}),
        },
    )
    all_taints = tuple(taints) + ((spot_taint(),) if spot else ())
    if all_taints:
        node["spec"] = {"taints": [dict(t) for t in all_taints]}
    node["status"] = {
        "allocatable": {JT.RESOURCE_GPU: gpus},
        "conditions": [
            {"type": "Ready", "status": "True" if ready else "False"}],
    }
    return node


def node_view(node: dict) -> NodeView:
    status = node.get("status") or {}
    alloc = (status.get("allocatable") or {}).get(JT.RESOURCE_GPU) or 0
    conds = status.get("conditions") or []
    ready = any(c.get("type") == "Ready" and c.get("status") == "True"
                for c in conds)
    taints = tuple((node.get("spec") or {}).get("taints") or [])
    labels = dict(ob.labels_of(node))
    return NodeView(
        name=ob.meta(node)["name"],
        labels=labels,
        allocatable_gpus=int(alloc),
        ready=ready,
        taints=taints,
        spot=labels.get(LABEL_SPOT) == "true",
        unschedulable=bool((node.get("spec") or {}).get("unschedulable")),
    )


def pod_gpu_request(pod: dict) -> int:
    """GPUs this pod claims: the sum of its nvidia.com/gpu limits."""
    total = 0
    for c in (pod.get("spec") or {}).get("containers") or []:
        limits = (c.get("resources") or {}).get("limits") or {}
        total += int(limits.get(JT.RESOURCE_GPU) or 0)
    return total


def selector_matches(pod: dict, view: NodeView) -> bool:
    sel = (pod.get("spec") or {}).get("nodeSelector") or {}
    return all(view.labels.get(k) == v for k, v in sel.items())


def tolerates(pod: dict, taint: dict) -> bool:
    """Kubernetes toleration semantics: effect must match (empty
    toleration effect = all effects); operator Exists matches on key
    alone (empty key = everything), operator Equal (the default) also
    requires the taint's value."""
    t_key = taint.get("key")
    t_value = taint.get("value", "")
    t_effect = taint.get("effect", "")
    for tol in (pod.get("spec") or {}).get("tolerations") or []:
        effect = tol.get("effect", "")
        if effect and effect != t_effect:
            continue
        if tol.get("operator", "Equal") == "Exists":
            if not tol.get("key") or tol.get("key") == t_key:
                return True
        elif tol.get("key") == t_key and tol.get("value", "") == t_value:
            return True
    return False


def feasible(pod: dict, view: NodeView) -> bool:
    """Can this pod land on this node at all (ignoring free capacity)?
    NotReady nodes, cordoned (spec.unschedulable) nodes, and
    untolerated NoSchedule/NoExecute taints — which include the
    impending-termination taint — exclude the node."""
    if not view.ready or view.unschedulable:
        return False
    if not selector_matches(pod, view):
        return False
    for t in view.taints:
        if t.get("effect") in ("NoSchedule", "NoExecute") \
                and not tolerates(pod, t):
            return False
    return True
