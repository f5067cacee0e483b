"""Notebook controller: CR -> StatefulSet + Service + VirtualService.

Port of `kubeflow_tpu/control/notebook/controller.py`: the same
reconcile over the port's control plane, its `notebook_*` metrics in the
port's registry (runtime/metrics.py: the card's machine has no
prometheus_client). Reconcile mirrors notebook_controller.go:85-279;
generators mirror generateStatefulSet :282-348, generateService
:349-380, generateVirtualService :382-443. Env knobs kept: USE_ISTIO,
ISTIO_GATEWAY, CLUSTER_DOMAIN, ADD_FSGROUP (a boolean knob is on when it
reads "true" in any case, `utils/envflags.py`). Status is derived from
the pod's container state (:200-231), and namespace Events involving the
notebook's pod are re-emitted onto the Notebook (:565-613) so JWA can
show them. A GPU notebook's pod template carries its `nvidia.com/gpu`
limit and selectors as the Notebook wrote them.
"""

from __future__ import annotations

import logging
import os
import time

from kubeflow_tpu_torch.control import reconcilehelper as rh
from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.control.notebook import culler
from kubeflow_tpu_torch.control.notebook import types as T
from kubeflow_tpu_torch.control.runtime import Controller, Reconciler, Request, Result
from kubeflow_tpu_torch.runtime.metrics import REGISTRY, MetricsRegistry
from kubeflow_tpu_torch.utils.envflags import env_flag

log = logging.getLogger("kubeflow_tpu_torch.notebook")

# metrics.go:27-61 names kept
NB_CREATED = ("notebook_create_total", "notebooks created")
NB_CULLED = ("notebook_culling_total", "notebooks culled")
NB_CREATE_FAILED = ("notebook_create_failed_total",
                    "Total failure times of creating notebooks")
NB_CULLING_TIMESTAMP = ("last_notebook_culling_timestamp_seconds",
                        "Timestamp of the last notebook culling in seconds")
NB_RUNNING = ("notebook_running", "Current running notebooks in the cluster")


class RunningNotebooksCollector:
    """Live-state `notebook_running` gauge: scraped from the CURRENT
    StatefulSet inventory at every /metrics render, not from controller
    event counters — restart-proof and drift-proof, exactly
    metrics.go:95-116's scrape(). An STS counts when its pod template
    carries notebook-name == its own name (the shape generate_statefulset
    produces)."""

    def __init__(self, client):
        self.client = client

    def counts(self) -> dict[str, int] | None:
        """Notebook StatefulSets by namespace; None when the apiserver
        cannot be read (the gauge then has no sample, not 0s)."""
        try:
            # server-side filter: only notebook-owned STS (the controller
            # labels the STS object itself); template labels re-checked
            # below for metrics.go parity
            stss = self.client.list(
                "apps/v1", "StatefulSet",
                label_selector={"matchExpressions": [
                    {"key": T.LABEL_NOTEBOOK_NAME, "operator": "Exists"}]})
        except Exception as e:
            log.warning("notebook_running scrape failed: %s", e)
            return None
        counts: dict[str, int] = {}
        for sts in stss:
            tmpl_labels = (((sts.get("spec") or {}).get("template") or {})
                           .get("metadata") or {}).get("labels") or {}
            if tmpl_labels.get(T.LABEL_NOTEBOOK_NAME) == ob.meta(sts)["name"]:
                ns = ob.meta(sts).get("namespace") or "default"
                counts[ns] = counts.get(ns, 0) + 1
        return counts

    def collect(self, registry: MetricsRegistry) -> None:
        counts = self.counts() or {}
        registry.set_series(NB_RUNNING[0], "gauge", NB_RUNNING[1], [
            ({"namespace": ns}, v) for ns, v in sorted(counts.items())])

    def register(self, registry: MetricsRegistry | None = None
                 ) -> "RunningNotebooksCollector":
        (registry if registry is not None else REGISTRY).add_collector(
            self.collect)
        return self


def use_istio() -> bool:
    return env_flag("USE_ISTIO", "false")


def istio_gateway() -> str:
    return os.environ.get("ISTIO_GATEWAY", "kubeflow/kubeflow-gateway")


def cluster_domain() -> str:
    return os.environ.get("CLUSTER_DOMAIN", "cluster.local")


class NotebookReconciler(Reconciler):
    def __init__(self, probe=culler.default_probe, cache=None,
                 registry: MetricsRegistry | None = None):
        self.probe = probe
        # indexed ClusterCache: pod and Event reads come from the snapshot
        # instead of per-reconcile list calls; None keeps the relist shape.
        self.cache = cache
        self.registry = registry if registry is not None else REGISTRY

    def _nb_pods(self, client, namespace: str, name: str) -> list[dict]:
        if self.cache is not None:
            return self.cache.pods_by_label(
                T.LABEL_NOTEBOOK_NAME, namespace, name)
        return client.list(
            "v1", "Pod", namespace=namespace,
            label_selector={"matchLabels": {T.LABEL_NOTEBOOK_NAME: name}},
        )

    def _ns_events(self, client, namespace: str) -> list[dict]:
        if self.cache is not None:
            # O(namespace bucket): Events are the churniest,
            # highest-cardinality kind — a cluster-wide snapshot scan
            # per reconcile would defeat the indexed-cache wiring
            return self.cache.objects_ns("v1", "Event", namespace)
        return client.list("v1", "Event", namespace=namespace)

    # -- generators ---------------------------------------------------------

    def generate_statefulset(self, nb: dict) -> dict:
        m = ob.meta(nb)
        tmpl = ob.deep_copy((nb.get("spec") or {}).get("template") or {"spec": {}})
        pod_spec = tmpl.setdefault("spec", {})
        containers = pod_spec.setdefault("containers", [{}])
        c0 = containers[0]
        c0.setdefault("name", m["name"])
        c0.setdefault("workingDir", T.HOME_DIR)  # :318
        c0.setdefault("ports", [{"containerPort": T.CONTAINER_PORT, "name": "notebook-port",
                                 "protocol": "TCP"}])
        env = c0.setdefault("env", [])
        if not any(e.get("name") == T.ENV_NB_PREFIX for e in env):
            env.append({"name": T.ENV_NB_PREFIX,
                        "value": f"/notebook/{m['namespace']}/{m['name']}"})  # :329-332
        if env_flag("ADD_FSGROUP", "true"):
            pod_spec.setdefault("securityContext", {}).setdefault("fsGroup", 100)  # :338-345

        labels = tmpl.setdefault("metadata", {}).setdefault("labels", {})
        labels[T.LABEL_NOTEBOOK_NAME] = m["name"]
        labels["statefulset"] = m["name"]

        replicas = 0 if culler.is_stopped(nb) else 1  # :284-286 scale-to-zero
        return ob.new_object(
            "apps/v1", "StatefulSet", m["name"], m["namespace"],
            labels={T.LABEL_NOTEBOOK_NAME: m["name"]},
            spec={
                "serviceName": m["name"],
                "replicas": replicas,
                "selector": {"matchLabels": {"statefulset": m["name"]}},
                "template": tmpl,
            },
        )

    def generate_service(self, nb: dict) -> dict:
        m = ob.meta(nb)
        return ob.new_object(
            "v1", "Service", m["name"], m["namespace"],
            labels={T.LABEL_NOTEBOOK_NAME: m["name"]},
            spec={
                "type": "ClusterIP",
                "selector": {"statefulset": m["name"]},
                "ports": [{
                    # Istio needs the protocol-prefixed port name (:367)
                    "name": f"http-{m['name']}",
                    "port": T.SERVICE_PORT,
                    "targetPort": T.CONTAINER_PORT,
                    "protocol": "TCP",
                }],
            },
        )

    def generate_virtual_service(self, nb: dict) -> dict:
        """Route /notebook/<ns>/<name>/ through the mesh gateway (:382-443)."""
        m = ob.meta(nb)
        prefix = f"/notebook/{m['namespace']}/{m['name']}/"
        host = f"{m['name']}.{m['namespace']}.svc.{cluster_domain()}"
        return ob.new_object(
            "networking.istio.io/v1alpha3", "VirtualService",
            f"notebook-{m['namespace']}-{m['name']}", m["namespace"],
            spec={
                "hosts": ["*"],
                "gateways": [istio_gateway()],
                "http": [{
                    "match": [{"uri": {"prefix": prefix}}],
                    "rewrite": {"uri": prefix},
                    "route": [{"destination": {
                        "host": host, "port": {"number": T.SERVICE_PORT}}}],
                    "timeout": "300s",  # :433
                }],
            },
        )

    # -- reconcile ----------------------------------------------------------

    def reconcile(self, client, req: Request) -> Result | None:
        if self.cache is not None:
            self.cache.refresh()
        nb = client.get_or_none(T.API_VERSION, T.KIND, req.name, req.namespace)
        if nb is None or ob.meta(nb).get("deletionTimestamp"):
            return None

        first_seen = not (nb.get("status") or {})
        if first_seen:
            self.registry.counter_inc(*NB_CREATED)

        try:
            rh.reconcile_child(client, nb, self.generate_statefulset(nb))
        except Exception:
            # metrics.go:41 notebook_create_failed_total; the reconcile
            # error still propagates so the workqueue retries with backoff
            self.registry.counter_inc(*NB_CREATE_FAILED)
            raise
        rh.reconcile_child(client, nb, self.generate_service(nb))
        if use_istio():
            rh.reconcile_child(client, nb, self.generate_virtual_service(nb))

        # -- status from pod container state (:200-231) --------------------
        pods = self._nb_pods(client, req.namespace, req.name)
        status = nb.setdefault("status", {})
        status["readyReplicas"] = sum(
            1 for p in pods
            if all(cs.get("ready") for cs in
                   (p.get("status") or {}).get("containerStatuses") or [{}])
            and (p.get("status") or {}).get("phase") == "Running"
        )
        if pods:
            cs = ((pods[0].get("status") or {}).get("containerStatuses") or [])
            if cs:
                status["containerState"] = cs[0].get("state", {})
        # re-emit pod events onto the Notebook (:565-613)
        self._forward_pod_events(client, nb, pods)

        ready = bool(status.get("readyReplicas"))
        changed = ob.cond_set(
            nb, "Ready",
            "True" if ready else "False",
            "NotebookReady" if ready else "NotebookNotReady",
        )
        client.update_status(nb)
        if changed:
            # readiness transitions are decision points worth an Event
            # (count-dedup in obs/events.py absorbs flapping pods)
            client.record_event(
                nb, "NotebookReady" if ready else "NotebookNotReady",
                f"readyReplicas={status.get('readyReplicas', 0)}",
                "Normal" if ready else "Warning")

        # -- culling (:250 -> culler.GetRequeueTime) ------------------------
        if culler.enabled() and not culler.is_stopped(nb):
            if culler.needs_culling(nb, probe=self.probe):
                fresh = client.get(T.API_VERSION, T.KIND, req.name, req.namespace)
                culler.set_stop_annotation(fresh)
                client.update(fresh)
                self.registry.counter_inc(*NB_CULLED)
                self.registry.gauge(NB_CULLING_TIMESTAMP[0], time.time(),
                                    NB_CULLING_TIMESTAMP[1])
                client.record_event(fresh, "Culling", "notebook idle; scaling to zero")
                return Result(requeue_after=0.0)
            return Result(requeue_after=culler.requeue_seconds())
        return None

    def _forward_pod_events(self, client, nb: dict, pods: list[dict]) -> None:
        nb_uid = ob.meta(nb).get("uid", "")
        pod_names = {ob.meta(p)["name"] for p in pods}
        if not pod_names:
            return
        events = self._ns_events(client, ob.meta(nb)["namespace"])
        # forwarded-marker set computed ONCE per reconcile
        forwarded = {
            e.get("source", {}).get("component")
            for e in events
            if (e.get("involvedObject") or {}).get("uid") == nb_uid
        }
        for ev in events:
            inv = ev.get("involvedObject") or {}
            if inv.get("kind") != "Pod" or inv.get("name") not in pod_names:
                continue
            marker = f"nb-fwd-{ev['metadata']['name']}"
            if marker in forwarded:
                continue
            rec = client.record_event(nb, ev.get("reason", ""),
                                      ev.get("message", ""),
                                      ev.get("type", "Normal"),
                                      component=marker)
            if self.cache is not None and rec:
                # fold our own marker in (the note_write discipline): a
                # pumped snapshot lagging the watch would re-forward the
                # same pod event on the next reconcile
                self.cache.note_write(rec)


def build_controller(client, probe=culler.default_probe,
                     cache: bool = True,
                     registry: MetricsRegistry | None = None) -> Controller:
    """``cache=True`` (default) serves the reconciler's pod and Event
    reads from an indexed ``ClusterCache`` — zero per-reconcile list
    calls; ``cache=False`` keeps the relist shape. ``registry`` takes the
    notebook_* metrics and the controller's own (default: the port's
    REGISTRY)."""
    cluster_cache = None
    if cache:
        from kubeflow_tpu_torch.control.cache import ClusterCache

        cluster_cache = ClusterCache(
            client, kinds=(("v1", "Pod"), ("v1", "Event")),
            pod_labels=(T.LABEL_NOTEBOOK_NAME,)).connect()
    rec = NotebookReconciler(probe=probe, cache=cluster_cache,
                             registry=registry)
    ctl = Controller("notebook", client, rec, registry=registry)
    if cluster_cache is not None:
        ctl.uses(cluster_cache)
    ctl.watches_primary(T.API_VERSION, T.KIND)
    ctl.owns("apps/v1", "StatefulSet").owns("v1", "Service")

    # map pods to notebooks via the notebook-name label (:541-563)
    def pod_to_nb(pod: dict):
        name = ob.labels_of(pod).get(T.LABEL_NOTEBOOK_NAME)
        if name:
            return [Request(ob.meta(pod).get("namespace") or "", name)]
        return []

    ctl.maps("v1", "Pod", pod_to_nb)
    return ctl
