"""JAXService controller: replicated model serving with queue-driven
autoscaling and drain-before-delete scale-down.

The serving analogue of the JAXJob controller (ROADMAP #2). One
reconcile loop owns four responsibilities:

- **Provisioning**: keep exactly ``status.targetReplicas`` replica pods
  (``<svc>-replica-<i>``) running the model server
  (``serving/__main__.py``), each a gang of ONE for the gang scheduler
  when ``spec.schedulerName`` opts in — replicas admit independently
  (a fleet takes every replica it can get; all-or-nothing is a
  training-world law), but inherit slice placement, priority and
  spot-pool preference. A replica that dies (node loss, eviction,
  crash) is reaped and re-provisioned at the same index.
- **Endpoints**: the READY replica set is published on the JAXService's
  ``ANNOTATION_ENDPOINTS`` annotation — the downward-style feed the
  token router consumes (``serving/router.py``, the ONE spelling).
  Cordoned replicas stay listed as ``state=cordoned`` so the router
  keeps draining them without admitting new work.
- **Autoscaling**: ``status.targetReplicas`` moves between
  ``spec.replicas.min`` and ``.max`` on two router-exported signals
  read back from the MetricsRegistry exposition (PR 4):
  ``router_queue_depth`` (queued requests per replica the service
  tolerates) and the ``router_tokens_total`` rate (tokens/sec vs the
  per-replica throughput target). Both directions are HYSTERETIC: a
  scale-up needs the demand to persist for
  ``scaleUpStabilizationSeconds``, a scale-down for the (longer)
  ``scaleDownStabilizationSeconds`` — and scale-down steps ONE replica
  at a time, so a demand lull never mass-cordons the fleet. The target
  is durable in status before any pod is touched (the _gang_restart
  record-FIRST discipline), so interrupted scale operations re-enter
  idempotently.
- **Drain state machine** (scale-down): active → cordoned (the pod is
  annotated, the endpoints entry flips to ``cordoned``, the router
  stops new dispatch) → drained (the router's
  ``router_tokens_inflight{replica}`` gauge reads zero) → deleted.
  In-flight requests always finish; docs/serving.md draws the diagram.

Every reconcile wraps its decision pass in a ``jaxservice.reconcile``
span under the service's minted traceparent; the router's
``router.dispatch`` spans ride each request's own traceparent — one
timeline from client request through dispatch to the replica.

Port of `kubeflow_tpu/control/jaxservice/controller.py` on GPUs: the
reconcile is the JAX package's line for line (endpoints annotation,
drain state machine, hysteretic autoscaling, rollout surge, canary,
promote and rollback, the gang-of-one gate). What names the
accelerator follows the JAXJob's mapping (`jaxservice/types.py`): a
replica pod claims ``nvidia.com/gpu``, pins the GPU product and
node-pool selectors (the pool through ``scheduler/topology.py``'s one
normaliser), runs ``python -m kubeflow_tpu_torch.serving`` with the JAX
package's flags, in the port's serving image by default. The JAX
package's prometheus_client families (jaxservice_replicas,
jaxservice_scale_total, jaxservice_replica_restarts_total,
jaxservice_rollouts_total, jaxservice_rollout_phase) are the port
registry's series of the same names, which the reconcile already
writes (the card's machine has no prometheus_client).
"""

from __future__ import annotations

import logging
import math
import time

from kubeflow_tpu_torch.control import reconcilehelper as rh
from kubeflow_tpu_torch.control.jaxjob import types as JT
from kubeflow_tpu_torch.control.jaxservice import types as T
from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.control.runtime import Controller, Reconciler, Request, Result
from kubeflow_tpu_torch.control.scheduler import (
    ANNOTATION_GANG_SIZE, ANNOTATION_PRIORITY, GATE_GANG, SCHEDULER_NAME,
)
from kubeflow_tpu_torch.control.scheduler.topology import normalize_pool
from kubeflow_tpu_torch.obs import trace as obs_trace
from kubeflow_tpu_torch.runtime.metrics import REGISTRY, MetricsRegistry
from kubeflow_tpu_torch.serving.router import render_endpoints

log = logging.getLogger("kubeflow_tpu_torch.jaxservice")

# Re-provision pacing: deletes need their names freed before recreation
_REQUEUE_FAST = 0.05
# Steady-state autoscale poll (the registry signals are pull-only)
_REQUEUE_POLL = 0.5

REPLICA_STATES = ("desired", "ready", "pending", "cordoned")


# numeric encoding for the jaxservice_rollout_phase gauge
ROLLOUT_PHASE_VALUE = {p: i for i, p in enumerate(T.ROLLOUT_PHASES)}


class JAXServiceReconciler(Reconciler):
    def __init__(self, record_events: bool = True,
                 registry: MetricsRegistry | None = None,
                 signals=None, clock=time.monotonic, cache=None,
                 store=None, rollout_analysis=None):
        self.record_events = record_events
        self.registry = registry if registry is not None else REGISTRY
        # autoscaling signal source (serving.router.RegistrySignals
        # shape); None = no signal plane wired -> the service holds at
        # status.targetReplicas (still min/max-clamped) and a Running
        # cordoned replica is held for spec.drainSeconds before delete
        # (the router routes to the fleet whether or not the controller
        # can read its gauges — "nothing wired = drained" would delete
        # replicas with live decodes in flight)
        self.signals = signals
        self.clock = clock
        self.cache = cache
        # optional obs TimeSeriesStore for PREDICTIVE autoscaling: when
        # wired (and on the same clock), the scale-up demand projects
        # the queue-depth trend over the stabilization window instead
        # of reading only the instantaneous depth — killing the lag
        # where a steadily-growing queue waits a full window before the
        # first move. None (the default, and every pre-existing caller)
        # keeps the instantaneous behavior bit-for-bit: BENCH_SERVE_r01
        # replays identically.
        self.store = store
        # per-service autoscaler memory: tokens-rate sample and the
        # hysteresis pending-direction window. In-memory on purpose — a
        # controller restart just re-observes demand for one window.
        self._scale_state: dict[tuple[str, str], dict] = {}
        # the canary-analysis gate: callable(namespace, service,
        # baseline_rev, canary_rev, now) -> bool (healthy). None =
        # rollouts advance on the time ladder alone (no analysis
        # plane wired). obs/rules.py CanaryAnalysis matches the shape.
        self.rollout_analysis = rollout_analysis
        # cordon observation times for the signal-less drain grace,
        # keyed (namespace, pod) — the LEGACY fallback: the durable
        # path persists the deadline as a pod annotation
        # (ANNOTATION_DRAIN_DEADLINE), so controller restarts resume
        # the countdown instead of restarting it.
        self._drain_started: dict[tuple[str, str], float] = {}
        # services whose jaxservice_rollouts_total outcome labels are
        # pre-registered at 0 (the first-failure tripwire discipline)
        self._rollout_registered: set[tuple[str, str]] = set()

    # -- trace propagation (the jaxjob discipline) --------------------------

    def _ensure_traceparent(self, client, svc: dict) -> dict:
        m = ob.meta(svc)
        if (m.get("annotations") or {}).get(obs_trace.TRACEPARENT_ANNOTATION):
            return svc
        ctx = obs_trace.SpanContext(
            obs_trace.new_trace_id(), obs_trace.new_span_id())
        # rv precondition: two racing first reconciles must not both
        # mint a context (jaxjob controller: the loser 409s, benign)
        return client.patch(
            T.API_VERSION, T.KIND, m["name"],
            {"metadata": {
                "resourceVersion": m["resourceVersion"],
                "annotations": {
                    obs_trace.TRACEPARENT_ANNOTATION: ctx.to_traceparent()}}},
            m["namespace"])

    def _svc_context(self, svc: dict) -> obs_trace.SpanContext | None:
        return obs_trace.parse_traceparent(
            (ob.meta(svc).get("annotations") or {})
            .get(obs_trace.TRACEPARENT_ANNOTATION))

    # -- generate* ----------------------------------------------------------

    def generate_service(self, svc: dict) -> dict:
        """Headless service: stable per-replica DNS
        (<pod>.<svc>.<ns>.svc) — the router's endpoint addresses."""
        m = ob.meta(svc)
        port = (svc.get("spec") or {}).get("port", T.DEFAULT_PORT)
        return ob.new_object(
            "v1", "Service", m["name"], m["namespace"],
            labels={T.LABEL_SERVICE_NAME: m["name"]},
            spec={
                "clusterIP": "None",
                "selector": {T.LABEL_SERVICE_NAME: m["name"]},
                "ports": [{"name": "http-serving", "port": port}],
            },
        )

    def _model_command(self, spec: dict) -> list[str]:
        model = T.model_spec(spec)
        cmd = ["python", "-m", "kubeflow_tpu_torch.serving",
               "--port", str(spec.get("port", T.DEFAULT_PORT)),
               "--lm", f"{model['name']}={model['ref']}",
               "--prompt-len", str(model["promptLen"]),
               "--max-new-tokens", str(model["maxNewTokens"])]
        if model["continuousBatching"]:
            cmd += ["--continuous-batching",
                    "--decode-slots", str(model["decodeSlots"])]
        if model["paramDtype"]:
            cmd += ["--param-dtype", model["paramDtype"]]
        res = T.resilience_spec(spec)
        if res["maxInflight"]:
            # replica-side overload gate: beyond this many concurrent
            # requests the server 429s with Retry-After instead of
            # queueing unboundedly (docs/robustness.md)
            cmd += ["--max-inflight", str(res["maxInflight"])]
        return cmd

    def generate_pod(self, svc: dict, index: int,
                     revision: str | None = None) -> dict:
        m = ob.meta(svc)
        spec = svc.get("spec") or {}
        # revision pinning: a rollout provisions pods for a SPECIFIC
        # revision — when it is not the live spec's (surge pods while
        # the base still runs the old revision, or a rollback after the
        # spec moved on), generate from the status snapshot that minted
        # it. Default (None) shapes from the live spec.
        rev = revision if revision is not None else T.revision_hash(spec)
        if revision is not None and T.revision_hash(spec) != revision:
            snap = T.revisions_status(svc)["snapshots"].get(revision)
            if isinstance(snap, dict):
                spec = snap
        name = T.replica_name(m["name"], index)
        tmpl = ob.deep_copy(spec.get("template") or {"spec": {"containers": [
            {"name": "serving", "image": spec.get(
                "image", JT.SERVING_IMAGE)}]}})
        pod_spec = tmpl.setdefault("spec", {})
        pod_spec.setdefault("restartPolicy", "Never")
        pod_spec["hostname"] = name
        pod_spec["subdomain"] = m["name"]
        env = [
            {"name": T.ENV_SERVICE, "value": m["name"]},
            {"name": T.ENV_REPLICA, "value": str(index)},
            {"name": T.ENV_NAMESPACE, "value": m["namespace"]},
        ]
        traceparent = (m.get("annotations") or {}).get(
            obs_trace.TRACEPARENT_ANNOTATION)
        if traceparent:
            env.append({"name": obs_trace.TRACEPARENT_ENV,
                        "value": traceparent})
        gpu = spec.get("gpu") or {}
        for c in pod_spec.get("containers", []):
            c.setdefault("command", self._model_command(spec))
            have = {e["name"] for e in c.get("env", [])}
            c.setdefault("env", []).extend(
                e for e in env if e["name"] not in have)
            if gpu.get("gpusPerWorker"):
                res = c.setdefault("resources", {}).setdefault("limits", {})
                res.setdefault(JT.RESOURCE_GPU, gpu["gpusPerWorker"])
        if gpu.get("product"):
            sel = pod_spec.setdefault("nodeSelector", {})
            sel.setdefault(JT.NODESELECTOR_ACCEL, gpu["product"])
            if gpu.get("nodePool"):
                try:
                    # the ONE normaliser of the pool key
                    pool = normalize_pool(gpu["nodePool"])
                except (ValueError, AttributeError):
                    pool = gpu["nodePool"]  # validate() reports this
                sel.setdefault(JT.NODESELECTOR_POOL, pool)
        labels = {
            **(tmpl.get("metadata", {}).get("labels") or {}),
            T.LABEL_SERVICE_NAME: m["name"],
            T.LABEL_REPLICA_INDEX: str(index),
            T.LABEL_REVISION: rev,
        }
        annotations = dict(tmpl.get("metadata", {}).get("annotations") or {})
        if spec.get("schedulerName"):
            pod_spec["schedulerName"] = spec["schedulerName"]
        if spec.get("schedulerName") == SCHEDULER_NAME:
            # each replica is its own gang of ONE: the scheduler keys
            # gangs on the jaxjob gang label, so the pod's own name is
            # the gang — independent admission per replica, topology
            # feasibility and priority still enforced. Gate appended,
            # never setdefault (the jaxjob lesson: a template gate must
            # not displace ours).
            labels[JT.LABEL_JOB_NAME] = name
            gates = list(pod_spec.get("schedulingGates") or [])
            if not any(g.get("name") == GATE_GANG for g in gates):
                gates.append({"name": GATE_GANG})
            pod_spec["schedulingGates"] = gates
            annotations[ANNOTATION_GANG_SIZE] = "1"
            annotations[ANNOTATION_PRIORITY] = str(spec.get("priority", 0))
        if traceparent:
            annotations[obs_trace.TRACEPARENT_ANNOTATION] = traceparent
        return {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": name,
                "namespace": m["namespace"],
                "labels": labels,
                "annotations": annotations,
            },
            "spec": pod_spec,
        }

    # -- pod reads ----------------------------------------------------------

    @staticmethod
    def _write_status(client, svc: dict) -> None:
        """update_status + rv rebind: a reconcile writes status more
        than once (scale move, restart count, final publish) and the
        fake apiserver 409s any write carrying a stale rv."""
        resp = client.update_status(svc)
        ob.meta(svc)["resourceVersion"] = ob.meta(resp)["resourceVersion"]

    def _pods(self, client, namespace: str, name: str) -> list[dict]:
        if self.cache is not None:
            return self.cache.pods_by_label(
                T.LABEL_SERVICE_NAME, namespace, name)
        return client.list(
            "v1", "Pod", namespace=namespace,
            label_selector={"matchLabels": {T.LABEL_SERVICE_NAME: name}})

    @staticmethod
    def _cordoned(pod: dict) -> bool:
        return ob.annotations_of(pod).get(T.ANNOTATION_CORDON) == "true"

    @staticmethod
    def _pod_revision(pod: dict) -> str:
        return ((ob.meta(pod).get("labels") or {})
                .get(T.LABEL_REVISION, ""))

    def _cordon_pod(self, client, req, name: str, drain_s: float) -> dict:
        """Cordon a pod AND stamp its drain DEADLINE (now + grace, on
        the controller clock) as an annotation — durable drain grace:
        a restarted controller resumes the countdown from the pod
        instead of restarting its in-memory timer. Raises NotFound
        like a bare patch would."""
        deadline = self.clock() + drain_s
        return client.patch(
            "v1", "Pod", name,
            {"metadata": {"annotations": {
                T.ANNOTATION_CORDON: "true",
                T.ANNOTATION_DRAIN_DEADLINE: f"{deadline:.6f}"}}},
            req.namespace)

    def _replica_drained(self, namespace: str, service: str,
                         pod: dict, drain_s: float) -> bool:
        """Delete gate for a cordoned replica: a pod that is not
        Running holds no connections; a Running one must read zero on
        the router's in-flight gauge, or — when no signal plane is
        wired (the production run_controller default) — outlive the
        spec.drainSeconds grace. The grace is read from the pod's
        persisted deadline annotation when present (controller
        restarts RESUME the countdown); legacy cordons without one
        fall back to the in-memory timer, which a restart restarts —
        only ever draining LONGER. The router keeps routing regardless
        of the controller's gauge access, so signal-less can never
        mean "nothing in flight"."""
        if (pod.get("status") or {}).get("phase") != "Running":
            return True
        name = ob.meta(pod)["name"]
        if self.signals is not None:
            return self.signals.replica_drained(namespace, service, name)
        now = self.clock()
        raw = ob.annotations_of(pod).get(T.ANNOTATION_DRAIN_DEADLINE)
        if raw is not None:
            try:
                deadline = float(raw)
            except (TypeError, ValueError):
                deadline = None
            # a deadline further out than one full grace means the
            # clock rebased under the annotation (the controller moved
            # hosts; monotonic clocks are boot-relative) — fall through
            # to the in-memory grace rather than holding forever
            if deadline is not None and deadline - now <= drain_s:
                return now >= deadline
        key = (namespace, name)
        started = self._drain_started.setdefault(key, now)
        return now - started >= drain_s

    # -- rollout state machine ----------------------------------------------

    def _register_rollout_metrics(self, req) -> None:
        """Pre-register every rollout outcome at 0 on first sight of a
        service, so ``rate()``/``increase()`` have a zero sample BEFORE
        the first abort (the first-failure tripwire discipline)."""
        key = (req.namespace, req.name)
        if key in self._rollout_registered:
            return
        self._rollout_registered.add(key)
        for outcome in T.ROLLOUT_OUTCOMES:
            self.registry.counter_inc(
                "jaxservice_rollouts_total", by=0.0,
                help_="rollouts finished by outcome "
                      "(promoted/rolled_back/aborted)",
                namespace=req.namespace, service=req.name,
                tenant=req.namespace, outcome=outcome)

    def _rollout_outcome(self, req, outcome: str) -> None:
        self.registry.counter_inc(
            "jaxservice_rollouts_total",
            help_="rollouts finished by outcome "
                  "(promoted/rolled_back/aborted)",
            namespace=req.namespace, service=req.name,
            tenant=req.namespace, outcome=outcome)

    def _abort_rollout(self, client, svc, req, rev, now: float) -> None:
        """Failed analysis with autoRollback: flip the machine to
        Rollback toward the previous revision, pin the bad revision as
        ``aborted`` (sticky — not re-attempted until the spec changes
        again), record-FIRST."""
        bad = rev["target"]
        rev.update(aborted=bad, target=rev["previous"] or rev["current"],
                   phase=T.PHASE_ROLLBACK, step=0, stepStartedAt=now,
                   held=False)
        if (svc["status"].get("revisions") or {}) != rev:
            svc["status"]["revisions"] = rev
            self._write_status(client, svc)
        self._rollout_outcome(req, "aborted")
        if self.record_events:
            client.record_event(
                svc, "RolloutAborted",
                f"canary revision {bad} failed analysis; rolling back "
                f"to {rev['target']}", "Warning")

    def _replace_mismatched(self, client, svc, req, by_name, phases,
                            indices, want_rev: str, batch: int,
                            drain_s: float) -> int:
        """Walk the index range; cordon -> drain -> delete pods whose
        revision label differs from ``want_rev``, keeping at most
        ``batch`` slots disrupted at once (capacity never
        oversubscribed). Deleted slots are re-provisioned at
        ``want_rev`` by the provisioning loop later this same
        reconcile. Pod labels ARE the migration state — an interrupted
        walk (controller crash mid-rollout) resumes for free. Returns
        the number of slots currently disrupted."""
        busy = 0
        for i in indices:
            name = T.replica_name(req.name, i)
            pod = by_name.get(name)
            if pod is None or phases.get(name) != "Running" \
                    or self._cordoned(pod):
                busy += 1
        for i in indices:
            name = T.replica_name(req.name, i)
            pod = by_name.get(name)
            if pod is None or self._pod_revision(pod) == want_rev:
                continue
            if not self._cordoned(pod):
                if busy >= batch:
                    continue
                try:
                    patched = self._cordon_pod(client, req, name, drain_s)
                    by_name[name] = patched
                    if self.cache is not None:
                        self.cache.note_write(patched)
                except ob.NotFound:
                    by_name.pop(name, None)
                    continue
                busy += 1
                if self.record_events:
                    client.record_event(
                        svc, "ReplicaCordoned",
                        f"{name} cordoned for rollout replacement "
                        f"(-> {want_rev})")
            elif self._replica_drained(req.namespace, req.name, pod,
                                       drain_s):
                try:
                    client.delete("v1", "Pod", name, req.namespace)
                except (ob.NotFound, ob.ApiError):
                    pass
                if self.cache is not None:
                    self.cache.note_delete(pod)
                self._drain_started.pop((req.namespace, name), None)
                by_name.pop(name, None)
                phases.pop(name, None)
                if self.record_events:
                    client.record_event(
                        svc, "ReplicaRemoved",
                        f"{name} drained and replaced (-> {want_rev})")
        return busy

    def _reconcile_rollout(self, client, svc, req, target: int,
                           by_name, phases) -> dict:
        """Drive the surge -> canary-analyze -> promote | rollback
        machine. Every transition lands in status.revisions BEFORE any
        pod is touched (record-FIRST), so an interrupted rollout
        re-enters idempotently from status. Returns the provisioning
        plan for the rest of the reconcile: how many slots to keep
        ({provision_upto}), which revision each slot runs
        ({revision_for}), and the canary split the endpoints should
        publish ({canary})."""
        spec = svc.get("spec") or {}
        status = svc["status"]
        roll = T.rollout_spec(spec)
        rev = T.revisions_status(svc)
        spec_rev = T.revision_hash(spec)
        surge = max(int(roll["maxSurge"]), 1)
        drain_s = T.drain_seconds(spec)
        now = self.clock()
        self._register_rollout_metrics(req)

        if not rev["current"]:
            # first sight: adopt the live spec as the current revision
            # (no rollout — existing unlabeled pods are grandfathered)
            rev["current"] = rev["target"] = spec_rev
            rev["snapshots"] = {spec_rev: ob.deep_copy(spec)}
            status["revisions"] = rev
            self._write_status(client, svc)

        # keep the idle snapshot fresh: hash-equal spec edits (replica
        # bounds, autoscaling windows) must not leave a stale rollback
        # source. Rides the final status write — any snapshot that
        # hashes to current generates equivalent pods.
        if rev["phase"] == T.PHASE_IDLE and rev["current"] == spec_rev \
                and rev["snapshots"].get(spec_rev) != spec:
            rev["snapshots"] = {spec_rev: ob.deep_copy(spec)}
            status["revisions"] = rev

        # a new shaping revision starts a rollout — unless it is the
        # sticky aborted one (a failed canary is not retried until the
        # spec moves again). A mid-rollout spec revert re-targets the
        # machine the same way: rollback IS a rollout whose target is
        # the previous revision.
        if spec_rev != rev["target"] and spec_rev != rev["aborted"]:
            snaps = dict(rev["snapshots"])
            snaps[spec_rev] = ob.deep_copy(spec)
            keep = {rev["current"], spec_rev}
            old = rev["current"]
            rev.update(
                snapshots={r: s for r, s in snaps.items() if r in keep},
                previous=rev["current"], target=spec_rev,
                phase=T.PHASE_SURGE, step=0, stepStartedAt=now,
                aborted="", held=False)
            status["revisions"] = rev
            self._write_status(client, svc)  # record-FIRST
            if self.record_events:
                client.record_event(
                    svc, "RolloutStarted",
                    f"rolling out revision {spec_rev} (from {old})")

        steps = [float(w) for w in roll["canarySteps"]]
        canary: tuple[str, float] | None = None

        if rev["phase"] == T.PHASE_SURGE:
            # surge replicas run the incoming revision at weight 0 (in
            # membership, taking no preferred traffic) until all are
            # Running — then analysis opens
            canary = (rev["target"], 0.0)
            names = [T.replica_name(req.name, i)
                     for i in range(target, target + surge)]
            stale = [n for n in names if n in by_name
                     and self._pod_revision(by_name[n]) != rev["target"]]
            if stale:
                # leftovers from an interrupted earlier rollout: replace
                self._replace_mismatched(
                    client, svc, req, by_name, phases,
                    range(target, target + surge), rev["target"],
                    surge, drain_s)
            elif all(n in by_name and phases.get(n) == "Running"
                     and not self._cordoned(by_name[n]) for n in names):
                rev.update(phase=T.PHASE_ANALYZE, stepStartedAt=now)
                status["revisions"] = rev
                self._write_status(client, svc)
                canary = (rev["target"], steps[0])
                if self.record_events:
                    client.record_event(
                        svc, "RolloutAnalyzing",
                        f"canary {rev['target']} serving at weight "
                        f"{steps[0]:g}")

        elif rev["phase"] == T.PHASE_ANALYZE:
            step = min(rev["step"], len(steps) - 1)
            weight = steps[step]
            canary = (rev["target"], weight)
            healthy = True
            if self.rollout_analysis is not None:
                healthy = bool(self.rollout_analysis(
                    req.namespace, req.name, rev["current"],
                    rev["target"], now))
            if not healthy:
                if roll["autoRollback"]:
                    self._abort_rollout(client, svc, req, rev, now)
                    canary = ((rev["aborted"], 0.0)
                              if rev["aborted"] else None)
                elif not rev["held"]:
                    # autoRollback off: freeze at this weight until the
                    # spec changes; fire the audit trail exactly once
                    rev["held"] = True
                    status["revisions"] = rev
                    self._write_status(client, svc)
                    self._rollout_outcome(req, "aborted")
                    if self.record_events:
                        client.record_event(
                            svc, "RolloutAborted",
                            f"canary revision {rev['target']} failed "
                            f"analysis at weight {weight:g}; "
                            "autoRollback off — holding", "Warning")
            elif not rev["held"] and \
                    now - rev["stepStartedAt"] >= \
                    roll["analysisWindowSeconds"]:
                rev["step"] = step + 1
                rev["stepStartedAt"] = now
                if rev["step"] >= len(steps):
                    rev["phase"] = T.PHASE_PROMOTE
                    canary = None
                else:
                    canary = (rev["target"], steps[rev["step"]])
                status["revisions"] = rev
                self._write_status(client, svc)
                if self.record_events:
                    if rev["phase"] == T.PHASE_PROMOTE:
                        client.record_event(
                            svc, "RolloutPromoting",
                            f"canary {rev['target']} healthy through "
                            "the ladder; replacing the base fleet")
                    else:
                        client.record_event(
                            svc, "RolloutStepAdvanced",
                            f"canary {rev['target']} weight -> "
                            f"{steps[rev['step']]:g}")

        if rev["phase"] in (T.PHASE_PROMOTE, T.PHASE_ROLLBACK):
            if rev["phase"] == T.PHASE_ROLLBACK and rev["aborted"]:
                # steer traffic off the aborted revision while its
                # replicas are replaced (availability still beats it)
                canary = (rev["aborted"], 0.0)
            span_count = target + (surge if rev["phase"]
                                   == T.PHASE_PROMOTE else 0)
            batch = max(1, surge + max(int(roll["maxUnavailable"]), 0))
            self._replace_mismatched(
                client, svc, req, by_name, phases, range(span_count),
                rev["target"], batch, drain_s)
            base = [T.replica_name(req.name, i) for i in range(target)]
            base_ok = all(
                n in by_name and phases.get(n) == "Running"
                and self._pod_revision(by_name[n]) == rev["target"]
                and not self._cordoned(by_name[n]) for n in base)
            extras = [n for n, p in by_name.items()
                      if self._pod_revision(p) != rev["target"]]
            if base_ok and not extras:
                outcome = ("promoted" if rev["phase"] == T.PHASE_PROMOTE
                           else "rolled_back")
                if outcome == "promoted":
                    rev["previous"] = rev["current"]
                    rev["current"] = rev["target"]
                snap = rev["snapshots"].get(rev["current"])
                rev.update(
                    snapshots={rev["current"]:
                               (snap if snap is not None
                                else ob.deep_copy(spec))},
                    phase=T.PHASE_IDLE, step=0, stepStartedAt=now,
                    held=False)
                status["revisions"] = rev
                self._write_status(client, svc)
                self._rollout_outcome(req, outcome)
                canary = None
                if self.record_events:
                    if outcome == "promoted":
                        client.record_event(
                            svc, "RolloutPromoted",
                            f"revision {rev['current']} promoted to "
                            "the full fleet")
                    else:
                        client.record_event(
                            svc, "RolloutRolledBack",
                            f"fleet back on revision {rev['current']} "
                            f"(rolled back from {rev['aborted']})",
                            "Warning")

        phase = rev["phase"]
        self.registry.gauge(
            "jaxservice_rollout_phase", ROLLOUT_PHASE_VALUE[phase],
            help_="rollout state-machine position "
                  "(0=idle 1=surge 2=analyze 3=promote 4=rollback)",
            namespace=req.namespace, service=req.name)

        upto = (target + surge
                if phase in (T.PHASE_SURGE, T.PHASE_ANALYZE,
                             T.PHASE_PROMOTE) else target)
        cur_rev, target_rev = rev["current"], rev["target"]

        def revision_for(i: int) -> str:
            if phase in (T.PHASE_PROMOTE, T.PHASE_ROLLBACK):
                return target_rev
            if i >= target:  # surge slots run the incoming revision
                return target_rev
            return cur_rev

        return {"active": phase != T.PHASE_IDLE, "phase": phase,
                "target_rev": target_rev, "provision_upto": upto,
                "revision_for": revision_for, "canary": canary}

    # -- reconcile ----------------------------------------------------------

    def reconcile(self, client, req: Request) -> Result | None:
        if self.cache is not None:
            self.cache.refresh()
        svc = client.get_or_none(T.API_VERSION, T.KIND, req.name,
                                 req.namespace)
        if svc is None:
            # deleted; ownerRef GC reaps replicas. Drop autoscaler and
            # drain-grace memory
            self._scale_state.pop((req.namespace, req.name), None)
            self._rollout_registered.discard((req.namespace, req.name))
            prefix = req.name + "-replica-"
            for k in [k for k in self._drain_started
                      if k[0] == req.namespace and k[1].startswith(prefix)]:
                del self._drain_started[k]
            return None
        if ob.meta(svc).get("deletionTimestamp"):
            return None

        errs = T.validate(svc)
        if errs:
            changed = ob.cond_set(svc, T.COND_DEGRADED, "True",
                                  "ValidationFailed", "; ".join(errs))
            if changed:
                client.update_status(svc)
            return None

        if not ob.cond_get(svc, T.COND_CREATED):
            svc = self._ensure_traceparent(client, svc)
            ob.cond_set(svc, T.COND_CREATED, "True", "JAXServiceCreated",
                        "replica set is being provisioned")
            svc = client.update_status(svc)
            if self.record_events:
                client.record_event(svc, "JAXServiceCreated",
                                    "provisioning serving replicas")

        rh.reconcile_child(client, svc, self.generate_service(svc))

        with obs_trace.TRACER.span(
                "jaxservice.reconcile", parent=self._svc_context(svc),
                namespace=req.namespace, service=req.name) as span:
            return self._reconcile_replicas(client, svc, req, span)

    def _reconcile_replicas(self, client, svc: dict, req: Request,
                            span) -> Result | None:
        spec = svc.get("spec") or {}
        reps = T.replicas_spec(spec)
        status = svc["status"] = svc.get("status") or {}
        prev_status = ob.deep_copy(status)
        target = min(max(status.get("targetReplicas") or reps["min"],
                         reps["min"]), reps["max"])

        pods = self._pods(client, req.namespace, req.name)
        by_name = {ob.meta(p)["name"]: p for p in pods}
        phases = {n: (p.get("status") or {}).get("phase", "Pending")
                  for n, p in by_name.items()}

        # -- autoscale decision (durable target move, record-FIRST) --------
        new_target = self._autoscale(svc, target)
        # remediation nudge: a one-shot floor from obs/remediate.py,
        # consumed (cleared) here so it can only act once — and flows
        # through the same record-first write as any scale decision
        nudge = self._consume_nudge(client, svc)
        if nudge is not None and nudge > new_target:
            new_target = min(nudge, reps["max"])
        if new_target != target:
            direction = "up" if new_target > target else "down"
            status["targetReplicas"] = new_target
            status["scales"] = status.get("scales", 0) + 1
            # target lands in status BEFORE any pod is touched: an
            # interrupted scale re-enters here idempotently
            self._write_status(client, svc)
            self.registry.counter_inc(
                "jaxservice_scale_total",
                help_="autoscaler target moves by direction",
                namespace=req.namespace, service=req.name,
                tenant=req.namespace, direction=direction)
            if self.record_events:
                client.record_event(
                    svc, "ScaledUp" if direction == "up" else "ScaledDown",
                    f"target replicas {target} -> {new_target}",
                    "Normal")
            target = new_target
        span.attrs["target"] = target

        # -- rollout state machine (surge/canary/promote/rollback):
        # transitions are status-durable record-FIRST; the returned
        # plan tells the loops below how many slots to keep and which
        # revision each runs ------------------------------------------
        rollout = self._reconcile_rollout(client, svc, req, target,
                                          by_name, phases)
        upto = rollout["provision_upto"]
        span.attrs["rollout_phase"] = rollout["phase"]

        # -- grow-back: a replica cordoned for a scale-down that was
        # reversed before its drain completed returns to service (the
        # uncordon arrow in docs/serving.md) — otherwise nothing ever
        # clears the annotation and the service wedges below target
        # (not reaped, not re-provisioned, endpoints stuck cordoned)
        for i in range(target):
            name = T.replica_name(req.name, i)
            pod = by_name.get(name)
            if pod is None or not self._cordoned(pod):
                continue
            if rollout["active"] and \
                    self._pod_revision(pod) != rollout["revision_for"](i):
                # cordoned for rollout REPLACEMENT, not scale-down:
                # let it drain out
                continue
            try:
                patched = client.patch(
                    "v1", "Pod", name,
                    {"metadata": {"annotations": {
                        T.ANNOTATION_CORDON: "false",
                        T.ANNOTATION_DRAIN_DEADLINE: None}}},
                    req.namespace)
                by_name[name] = patched
                if self.cache is not None:
                    self.cache.note_write(patched)
            except ob.NotFound:
                by_name.pop(name, None)
                continue
            self._drain_started.pop((req.namespace, name), None)
            if self.record_events:
                client.record_event(
                    svc, "ReplicaUncordoned",
                    f"{name} returned to service (scale-down reversed)")

        # -- reap dead replicas below the provisioning line (surge
        # slots included) — re-provision at same index ----------------
        restarted = 0
        for i in range(upto):
            name = T.replica_name(req.name, i)
            pod = by_name.get(name)
            if pod is not None and phases[name] in ("Failed", "Succeeded") \
                    and not self._cordoned(pod):
                try:
                    client.delete("v1", "Pod", name, req.namespace)
                except (ob.NotFound, ob.ApiError):
                    pass
                if self.cache is not None:
                    # fold the delete in (the note_write discipline): a
                    # stale snapshot would keep showing the dead pod and
                    # stall its re-provision until the watch catches up
                    self.cache.note_delete(pod)
                by_name.pop(name, None)
                restarted += 1
        if restarted:
            status["restarts"] = status.get("restarts", 0) + restarted
            self._write_status(client, svc)
            self.registry.counter_inc(
                "jaxservice_replica_restarts_total", by=float(restarted),
                help_="replicas reaped and re-provisioned after dying",
                namespace=req.namespace, service=req.name,
                tenant=req.namespace)
            if self.record_events:
                client.record_event(
                    svc, "ReplicaRestarted",
                    f"{restarted} dead replica(s) re-provisioned",
                    "Warning")
            # names must free before recreation — poll again shortly
            self._publish_status(client, svc, req, by_name, phases,
                                 target, prev_status, rollout)
            return Result(requeue_after=_REQUEUE_FAST)

        # -- provision missing replicas below the line (surge slots
        # run the incoming revision; a rollback re-pins the slot to
        # the snapshot of the revision it is converging to) ----------
        for i in range(upto):
            name = T.replica_name(req.name, i)
            if name in by_name:
                continue
            pod = self.generate_pod(svc, i,
                                    revision=rollout["revision_for"](i))
            ob.set_owner(pod, svc)
            try:
                created = client.create(pod)
            except ob.Conflict:
                continue  # old name still releasing; next pass recreates
            by_name[name] = created
            phases[name] = (created.get("status") or {}).get(
                "phase", "Pending")
            if self.cache is not None:
                self.cache.note_write(created)

        # -- scale-down drain: indices >= the provisioning line (the
        # replica_index sort sentinel puts malformed leftovers here too
        # — drained away, not aliased to a real slot). Surge replicas
        # retire through this same path once a rollout completes (or
        # rolls back) and the line drops back to target ----------------
        draining = 0
        for name in sorted(by_name, key=T.replica_index):
            if T.replica_index(name) < upto:
                continue
            pod = by_name[name]
            if not self._cordoned(pod):
                try:
                    patched = self._cordon_pod(
                        client, req, name,
                        T.drain_seconds(svc.get("spec") or {}))
                    by_name[name] = patched
                    if self.cache is not None:
                        self.cache.note_write(patched)
                except ob.NotFound:
                    by_name.pop(name, None)
                    continue
                if self.record_events:
                    client.record_event(
                        svc, "ReplicaCordoned",
                        f"{name} cordoned for scale-down (draining)")
                draining += 1
            elif self._replica_drained(req.namespace, req.name, pod,
                                       T.drain_seconds(svc.get("spec")
                                                       or {})):
                try:
                    client.delete("v1", "Pod", name, req.namespace)
                except (ob.NotFound, ob.ApiError):
                    pass
                if self.cache is not None:
                    self.cache.note_delete(pod)
                self._drain_started.pop((req.namespace, name), None)
                by_name.pop(name, None)
                phases.pop(name, None)
                if self.record_events:
                    client.record_event(
                        svc, "ReplicaRemoved",
                        f"{name} drained and removed")
            else:
                draining += 1
        span.attrs["draining"] = draining

        res = self._publish_status(client, svc, req, by_name, phases,
                                   target, prev_status, rollout)
        span.attrs["ready"] = (status.get("replicas") or {}).get("ready", 0)
        return res

    # -- status + endpoints --------------------------------------------------

    def _publish_status(self, client, svc, req, by_name, phases, target,
                        prev_status, rollout=None) -> Result | None:
        status = svc["status"]
        ready, pending, cordoned = [], [], []
        for name in sorted(by_name, key=T.replica_index):
            pod = by_name[name]
            if self._cordoned(pod):
                cordoned.append(name)
            elif phases.get(name) == "Running":
                ready.append(name)
            else:
                pending.append(name)
        status["targetReplicas"] = target
        status["replicas"] = {
            "desired": target,
            "ready": len(ready),
            "pending": len(pending),
            "cordoned": len(cordoned),
        }
        status["replicaStatuses"] = {
            n: ("Cordoned" if n in cordoned
                else phases.get(n, "Pending")) for n in sorted(
                by_name, key=T.replica_index)}
        # surge replicas count toward ready during a rollout: >= not ==
        all_ready = len(ready) >= target and not pending
        ob.cond_set(svc, T.COND_READY,
                    "True" if all_ready else "False",
                    "AllReplicasReady" if all_ready else "ReplicasPending",
                    f"{len(ready)}/{target} replicas ready")
        if ob.cond_is_true(svc, T.COND_DEGRADED):
            ob.cond_set(svc, T.COND_DEGRADED, "False", "Recovered", "")

        self._publish_endpoints(
            client, svc, req, ready, cordoned, by_name,
            canary=(rollout or {}).get("canary"))
        self._publish_gauges(req, target, ready, pending, cordoned)

        if svc.get("status") != prev_status:
            self._write_status(client, svc)
        if pending or cordoned:
            return Result(requeue_after=_REQUEUE_FAST)
        if rollout is not None and rollout["active"]:
            # an analysis window only elapses if someone re-looks: an
            # active rollout keeps the reconcile scheduled even when
            # the replica set is momentarily steady
            return Result(requeue_after=_REQUEUE_POLL)
        if self.signals is not None:
            # the signal plane is pull-only: keep sampling for the
            # autoscaler even when the replica set is steady
            return Result(requeue_after=_REQUEUE_POLL)
        return None

    def _publish_endpoints(self, client, svc, req, ready, cordoned,
                           by_name, canary=None) -> None:
        """Stamp the router-consumed endpoint list; no-op when the
        rendered JSON is byte-identical (every write is a watch event —
        the PR 5 status-storm lesson). Entries carry the pod's revision
        label; while a rollout analyzes, the canaried revision's ACTIVE
        entries also carry the ladder weight — the router derives its
        deterministic split from them."""
        port = (svc.get("spec") or {}).get("port", T.DEFAULT_PORT)
        eps = []
        for name in ready:
            ep = {"name": name,
                  "addr": f"http://{name}.{req.name}."
                          f"{req.namespace}.svc:{port}",
                  "state": T.STATE_ACTIVE}
            rev = self._pod_revision(by_name[name])
            if rev:
                ep["revision"] = rev
                if canary is not None and rev == canary[0]:
                    ep["canary"] = canary[1]
            eps.append(ep)
        for name in cordoned:
            # only a live cordoned replica still drains; terminal ones
            # are awaiting deletion and must leave membership entirely
            if (by_name[name].get("status") or {}).get("phase") \
                    == "Running":
                ep = {"name": name,
                      "addr": f"http://{name}.{req.name}."
                              f"{req.namespace}.svc:{port}",
                      "state": T.STATE_CORDONED}
                rev = self._pod_revision(by_name[name])
                if rev:
                    ep["revision"] = rev
                eps.append(ep)
        rendered = render_endpoints(eps)
        m = ob.meta(svc)
        if (m.get("annotations") or {}).get(T.ANNOTATION_ENDPOINTS) \
                == rendered:
            return
        try:
            patched = client.patch(
                T.API_VERSION, T.KIND, req.name,
                {"metadata": {"annotations": {
                    T.ANNOTATION_ENDPOINTS: rendered}}},
                req.namespace)
            m.setdefault("annotations", {})[T.ANNOTATION_ENDPOINTS] = \
                rendered
            m["resourceVersion"] = ob.meta(patched)["resourceVersion"]
        except ob.ApiError:
            log.exception("endpoints annotation patch failed for %s/%s",
                          req.namespace, req.name)

    def _publish_gauges(self, req, target, ready, pending,
                        cordoned) -> None:
        counts = {"desired": target, "ready": len(ready),
                  "pending": len(pending), "cordoned": len(cordoned)}
        for state in REPLICA_STATES:
            self.registry.gauge(
                "jaxservice_replicas", counts[state],
                help_="replica counts by state per service",
                namespace=req.namespace, service=req.name, state=state)

    # -- autoscaler ----------------------------------------------------------

    def _consume_nudge(self, client, svc: dict) -> int | None:
        """Read-and-clear the remediation scale nudge annotation.
        Returns the requested floor (un-clamped), or None. The clear is
        a merge patch deleting the key; clear failures leave the nudge
        for the next reconcile (idempotent: it is a floor, not an
        increment)."""
        m = ob.meta(svc)
        raw = (m.get("annotations") or {}).get(T.ANNOTATION_SCALE_NUDGE)
        if raw is None:
            return None
        try:
            resp = client.patch(
                T.API_VERSION, T.KIND, m["name"],
                {"metadata": {"annotations": {
                    T.ANNOTATION_SCALE_NUDGE: None}}},
                m["namespace"])
            # rebind rv (and annotations) so the record-first status
            # write later this reconcile doesn't 409 on the stale rv
            m["resourceVersion"] = ob.meta(resp)["resourceVersion"]
            m["annotations"] = dict(ob.meta(resp).get("annotations") or {})
        except Exception:
            log.warning("scale-nudge clear failed for %s/%s; will retry",
                        m["namespace"], m["name"])
        try:
            return int(raw)
        except (TypeError, ValueError):
            log.warning("ignoring malformed scale nudge %r on %s/%s",
                        raw, m["namespace"], m["name"])
            return None

    def _queue_slope(self, namespace: str, name: str,
                     start: float, end: float) -> float:
        """Summed least-squares slope (queue items/s) of every
        ``router_queue_depth`` series for the service over the window —
        the TSDB trend read behind predictive scale-up."""
        total = 0.0
        for _labels, pts in self.store.window(
                "router_queue_depth",
                {"namespace": namespace, "service": name}, start, end):
            if len(pts) < 2:
                continue
            n = len(pts)
            mt = sum(t for t, _ in pts) / n
            mv = sum(v for _, v in pts) / n
            denom = sum((t - mt) ** 2 for t, _ in pts)
            if denom <= 0:
                continue
            total += sum((t - mt) * (v - mv) for t, v in pts) / denom
        return total

    def _autoscale(self, svc: dict, target: int) -> int:
        """Demand-driven target with hysteresis. Deterministic given
        the clock and signal sequence — the serve_bench replay law."""
        spec = svc.get("spec") or {}
        reps = T.replicas_spec(spec)
        mn, mx = reps["min"], reps["max"]
        target = min(max(target, mn), mx)
        if self.signals is None or mn == mx:
            return target
        m = ob.meta(svc)
        key = (m["namespace"], m["name"])
        st = self._scale_state.setdefault(key, {})
        auto = T.autoscaling_spec(spec)
        now = self.clock()

        queue = self.signals.queue_depth(m["namespace"], m["name"])
        total = self.signals.tokens_total(m["namespace"], m["name"])
        prev = st.get("sample")
        if prev is not None and now > prev[0]:
            st["rate"] = max(0.0, (total - prev[1]) / (now - prev[0]))
            st["sample"] = (now, total)
        elif prev is None:
            st["sample"] = (now, total)
        rate = st.get("rate", 0.0)

        if self.store is not None:
            # predictive scale-up: project the queue along its TSDB
            # trend over the stabilization window. A positive slope
            # raises effective demand NOW (the hysteresis window then
            # confirms it); a negative slope never shrinks the signal —
            # prediction accelerates scale-up only, scale-down keeps
            # its observe-then-step gentleness.
            window = auto["scaleUpStabilizationSeconds"]
            slope = self._queue_slope(m["namespace"], m["name"],
                                      now - window, now)
            if slope > 0:
                queue = max(queue, queue + slope * window)

        by_queue = math.ceil(queue / auto["targetQueueDepth"])
        by_rate = math.ceil(rate / auto["targetTokensPerSec"])
        demand = min(max(by_queue, by_rate, mn), mx)

        if demand == target:
            st.pop("pending", None)
            return target
        direction = "up" if demand > target else "down"
        pending = st.get("pending")
        if not pending or pending[0] != direction:
            st["pending"] = (direction, now)
            return target
        window = (auto["scaleUpStabilizationSeconds"] if direction == "up"
                  else auto["scaleDownStabilizationSeconds"])
        if now - pending[1] < window:
            return target
        st.pop("pending", None)
        if direction == "up":
            return demand  # jump to demand: a queue spike wants capacity NOW
        return target - 1  # step down one: lulls release capacity gently


def build_controller(client, record_events: bool = True, registry=None,
                     signals=None, clock=time.monotonic,
                     cache: bool = True, store=None,
                     rollout_analysis=None) -> Controller:
    """``cache=True`` (default) reads replica pods from an indexed
    ``ClusterCache`` keyed on the service label — zero per-reconcile
    list calls (the ISSUE 7 discipline, pinned in tests)."""
    cluster_cache = None
    if cache:
        from kubeflow_tpu_torch.control.cache import ClusterCache

        cluster_cache = ClusterCache(
            client, kinds=(("v1", "Pod"),),
            pod_labels=(T.LABEL_SERVICE_NAME,)).connect()
    rec = JAXServiceReconciler(record_events=record_events,
                               registry=registry, signals=signals,
                               clock=clock, cache=cluster_cache,
                               store=store,
                               rollout_analysis=rollout_analysis)
    ctl = Controller("jaxservice", client, rec, registry=registry)
    if cluster_cache is not None:
        ctl.uses(cluster_cache)
    ctl.watches_primary(T.API_VERSION, T.KIND)
    ctl.owns("v1", "Pod").owns("v1", "Service")
    return ctl
