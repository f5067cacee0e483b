"""Alert-driven remediation: the detect->decide->act layer.

The rule engine (``obs/rules.py``) detects every incident it stages; this module
closes the loop. A ``RemediationEngine`` consumes the transition list
each ``RuleEngine.evaluate_once`` pass returns and, when an
``AlertRule`` enters ``firing``, runs the registered ``Remediation``
for that alert. Acting only on the *firing* transition inherits the
rule engine's pending->firing damping wholesale: an alert that
oscillates pending->inactive across evaluation ticks produces no
firing transition, so it can never trigger an action or burn a
cooldown — flap protection is structural, not a timer.

Guardrails, in evaluation order per firing transition:

- label matchers scope a remediation to a subset of a rule's label
  sets (e.g. only ``namespace="prod"``);
- silences (the ``silenced`` hook, FleetPlane's silence store) mute
  the action the way they mute notification;
- per-action cooldown: after an action runs (live or dry-run), the
  same action stays quiet for ``cooldown_s`` — remediations act on
  control loops whose effect takes time to land;
- a global rate limit (``max_actions`` per ``rate_window_s``) bounds
  the blast radius of a correlated alert storm: a fleet-wide outage
  must page a human, not trigger a hundred automated mutations.

Every decision — executed, dry-run, suppressed, failed — is recorded
in a bounded audit ring, counted in
``obs_remediations_total{action,result,tenant}`` in the engine's
``MetricsRegistry``, and executed/failed actions additionally emit
dedup'd k8s Events through the ``EventRecorder``. The audit ring is the
deterministic decision log a drill fingerprints.

Three actions ship, each wired through an existing control path (the
engine never invents a side channel into a controller):

- ``scale_up_nudge_action`` — KVPagesExhausted: annotate the
  JAXService with a one-shot floor (``ANNOTATION_SCALE_NUDGE``); the
  autoscaler honors it through its normal record-first target move.
- ``cache_relist_action`` — SchedulerPassSlow: mark the scheduler's
  ``ClusterCache`` kinds dirty so the next refresh re-lists them
  (repairing a cache poisoned by a missed watch event).
- ``cordon_drain_action`` — node-scoped SLO burn: set
  ``spec.unschedulable`` on the node and evict this scheduler's bound
  pods with the one-spelling ``eviction_status`` — elastic gangs then
  shrink to survivors through the elastic path instead of restarting.

Port of `kubeflow_tpu/obs/remediate.py`: the same engine, guards, audit
and actions over the port's JAXService types, ``ClusterCache`` and gang
scheduler (whose nodes are GPU nodes). The JAX package also counts
decisions in prometheus_client; the port counts them in its registry
only.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

from kubeflow_tpu_torch.runtime.metrics import REGISTRY, MetricsRegistry

log = logging.getLogger("kubeflow_tpu_torch.obs.remediate")

# Decision results (the `result` label of obs_remediations_total).
EXECUTED = "executed"
DRY_RUN = "dry_run"
COOLDOWN = "cooldown"
RATE_LIMITED = "rate_limited"
SILENCED = "silenced"
SKIPPED = "skipped"  # action declined (e.g. transition lacks a label)
ERROR = "error"


class SkipAction(Exception):
    """An action declining to act on this transition (not a failure):
    e.g. a node-scoped action on a transition with no node label."""


@dataclass
class Remediation:
    """One alert->action binding.

    ``action(transition)`` receives the firing transition dict
    (``{"alert", "to", "labels", "value", "at"}``) and returns a short
    human-readable detail string; it raises ``SkipAction`` to decline
    and any other exception to report failure. ``matchers`` restricts
    the binding to transitions whose labels carry every listed
    key=value."""

    name: str
    alert: str
    action: Callable[[dict], str]
    cooldown_s: float = 300.0
    matchers: dict = field(default_factory=dict)


class RemediationEngine:
    """Consumes alert transitions, executes matching remediations.

    ``observe(transitions, at=)`` is the only entry point — FleetPlane
    calls it from ``tick()`` with the pass's transition list. Returns
    the decision records made this call, in deterministic order (the
    transition order the rule engine produced, which is itself
    sorted)."""

    def __init__(self, remediations: list[Remediation] | None = None,
                 recorder=None,
                 registry: MetricsRegistry | None = None,
                 clock: Callable[[], float] = time.time,
                 dry_run: bool = False,
                 max_actions: int = 5,
                 rate_window_s: float = 600.0,
                 silenced: Callable[[str, dict, float], bool] | None = None,
                 audit_limit: int = 256):
        self.remediations: list[Remediation] = list(remediations or [])
        self.recorder = recorder
        self.registry = registry if registry is not None else REGISTRY
        self.clock = clock
        self.dry_run = dry_run
        self.max_actions = max_actions
        self.rate_window_s = rate_window_s
        self.silenced = silenced
        self._lock = threading.Lock()
        # action name -> last run time (live or dry-run both burn it)
        self._last_run: dict[str, float] = {}
        # run timestamps inside the rate window (live + dry-run)
        self._window: deque[float] = deque()
        self._audit: deque[dict] = deque(maxlen=audit_limit)

    def register(self, remediation: Remediation) -> None:
        with self._lock:
            self.remediations.append(remediation)

    # -- the decision pass ---------------------------------------------------

    def observe(self, transitions: list[dict],
                at: float | None = None) -> list[dict]:
        now = self.clock() if at is None else at
        decisions: list[dict] = []
        with self._lock:
            for tr in transitions:
                # ONLY firing triggers: pending and resolved never act,
                # and a pending->inactive flap produces neither — the
                # rule engine's for-duration damping is the gate.
                if tr.get("to") != "firing":
                    continue
                for rem in self.remediations:
                    if rem.alert != tr.get("alert"):
                        continue
                    labels = tr.get("labels") or {}
                    if any(labels.get(k) != v
                           for k, v in rem.matchers.items()):
                        continue
                    decisions.append(self._decide(rem, tr, labels, now))
        return decisions

    def _decide(self, rem: Remediation, tr: dict, labels: dict,
                now: float) -> dict:
        result, detail = self._guard(rem, labels, now)
        if result is None:
            # guards passed: burn the cooldown and the rate window for
            # BOTH live and dry-run, so a dry-run fleet produces the
            # byte-identical decision log a live fleet would
            self._last_run[rem.name] = now
            self._window.append(now)
            if self.dry_run:
                result, detail = DRY_RUN, "dry-run: action not executed"
            else:
                try:
                    detail = rem.action(tr) or ""
                    result = EXECUTED
                except SkipAction as e:
                    result, detail = SKIPPED, str(e)
                except Exception as e:  # an action must not kill the pass
                    log.exception("remediation %s failed", rem.name)
                    result, detail = ERROR, f"{type(e).__name__}: {e}"
        return self._record(rem, labels, result, detail, now)

    def _guard(self, rem: Remediation, labels: dict,
               now: float) -> tuple[str | None, str]:
        if self.silenced is not None:
            try:
                if self.silenced(rem.alert, labels, now):
                    return SILENCED, "alert is silenced"
            except Exception:
                log.exception("silence check failed")
        last = self._last_run.get(rem.name)
        if last is not None and now - last < rem.cooldown_s:
            return COOLDOWN, (f"action ran {now - last:.0f}s ago "
                              f"(cooldown {rem.cooldown_s:.0f}s)")
        while self._window and now - self._window[0] >= self.rate_window_s:
            self._window.popleft()
        if len(self._window) >= self.max_actions:
            return RATE_LIMITED, (
                f"{len(self._window)} actions in the last "
                f"{self.rate_window_s:.0f}s (limit {self.max_actions})")
        return None, ""

    def _record(self, rem: Remediation, labels: dict, result: str,
                detail: str, now: float) -> dict:
        # the namespace whose alert triggered this action IS the tenant
        # the decision bills to (chargeback attribution); an explicit
        # tenant label on the transition wins
        tenant = (labels.get("tenant") or labels.get("namespace")
                  or "default")
        decision = {
            "action": rem.name, "alert": rem.alert,
            "labels": dict(sorted(labels.items())),
            "tenant": tenant,
            "result": result, "detail": detail, "at": now,
        }
        self._audit.append(decision)
        try:
            self.registry.counter_inc(
                "obs_remediations_total",
                help_="remediation decisions by action and result",
                action=rem.name, result=result, tenant=tenant)
        except Exception:  # telemetry must never break the pass
            log.exception("remediation metric emit failed")
        if self.recorder is not None and result in (EXECUTED, DRY_RUN,
                                                    ERROR):
            involved = {
                "apiVersion": "obs.kubeflow.org/v1",
                "kind": "Remediation",
                "metadata": {
                    "name": rem.name.lower(),
                    "namespace": labels.get("namespace", "default"),
                },
            }
            label_str = ",".join(f"{k}={v}"
                                 for k, v in sorted(labels.items()))
            try:
                if result == ERROR:
                    self.recorder.event(
                        involved, "RemediationFailed",
                        f"{rem.name} for {rem.alert} ({label_str}) "
                        f"failed: {detail}", etype="Warning")
                else:
                    self.recorder.event(
                        involved, "RemediationExecuted",
                        f"{rem.name} for {rem.alert} ({label_str}): "
                        f"{detail or result}")
            except Exception:
                log.exception("remediation event emit failed")
        return decision

    # -- introspection -------------------------------------------------------

    def audit(self) -> list[dict]:
        """The bounded decision history, oldest first."""
        with self._lock:
            return [dict(d) for d in self._audit]


# -- the shipped actions ------------------------------------------------------


def scale_up_nudge_action(client, namespace: str = "default"):
    """KVPagesExhausted -> nudge the JAXService autoscaler up one.

    Writes ``ANNOTATION_SCALE_NUDGE`` on the JAXService named by the
    transition's ``service`` label: a one-shot replica floor of
    (current target + 1) the autoscaler consumes — and clears — inside
    its normal reconcile, so the move flows through the record-first
    durable status write, hysteresis bookkeeping, and max-replica
    clamp like any other scale decision."""
    from kubeflow_tpu_torch.control.jaxservice import types as T

    def act(tr: dict) -> str:
        labels = tr.get("labels") or {}
        svc = labels.get("service")
        if not svc:
            raise SkipAction("transition has no service label")
        ns = labels.get("namespace", namespace)
        cur = client.get(T.API_VERSION, T.KIND, svc, ns)
        target = int((cur.get("status") or {}).get(
            "targetReplicas",
            (cur.get("spec") or {}).get("minReplicas", 1)))
        nudge = target + 1
        client.patch(
            T.API_VERSION, T.KIND, svc,
            {"metadata": {"annotations": {
                T.ANNOTATION_SCALE_NUDGE: str(nudge)}}}, ns)
        return f"nudged {ns}/{svc} floor to {nudge} replicas"

    return act


def cache_relist_action(cache, kinds: tuple[tuple[str, str], ...] = ()):
    """SchedulerPassSlow -> mark the scheduler's ClusterCache dirty.

    A slow pass with a healthy node fleet usually means the cache has
    drifted (a dropped watch event leaving a stale index bucket); a
    relist of the dirty kinds rebuilds the indexes wholesale through
    the cache's own repair path."""

    def act(tr: dict) -> str:
        n = cache.mark_dirty(kinds or None)
        # complete the repair now rather than at the next scheduling
        # pass: refresh() relists exactly the dirty kinds (the cache's
        # own recovery path), so a quiet cluster still heals
        cache.refresh()
        return f"relisted {n} cached kind(s)"

    return act


def cordon_drain_action(client, scheduler_name: str | None = None):
    """Node-scoped SLO burn -> cordon the node and drain its pods.

    Cordons by setting ``spec.unschedulable`` (the scheduler's
    feasibility check excludes cordoned nodes, so nothing new lands),
    then evicts the gang scheduler's bound pods with the one-spelling
    ``eviction_status`` — phase Failed / reason Evicted, which the
    JAXJob controller classifies as preemption, so elastic gangs
    shrink to survivors through the elastic path (zero restart-budget
    burn) instead of whole-gang restarting."""
    from kubeflow_tpu_torch.control.scheduler import SCHEDULER_NAME
    from kubeflow_tpu_torch.control.scheduler import nodes as N

    sched = scheduler_name or SCHEDULER_NAME

    def act(tr: dict) -> str:
        labels = tr.get("labels") or {}
        node = labels.get("node")
        if not node:
            raise SkipAction("transition has no node label")
        client.patch("v1", "Node", node,
                     {"spec": {"unschedulable": True}})
        evicted = 0
        for pod in client.list("v1", "Pod"):
            spec = pod.get("spec") or {}
            if spec.get("nodeName") != node:
                continue
            if spec.get("schedulerName") != sched:
                continue
            phase = (pod.get("status") or {}).get("phase", "Pending")
            if phase in ("Succeeded", "Failed"):
                continue
            pod.setdefault("status", {})
            pod["status"].update(N.eviction_status(
                f"node {node} cordoned by remediation "
                f"({tr.get('alert')})"))
            client.update_status(pod)
            evicted += 1
        return f"cordoned {node}, evicted {evicted} pod(s)"

    return act


def default_remediations(client=None, cache=None,
                         namespace: str = "default") -> list[Remediation]:
    """The shipped alert->action bindings, wired to a kube client and
    (optionally) the scheduler's ClusterCache. Callers drop entries
    whose dependency is absent."""
    rems: list[Remediation] = []
    if client is not None:
        rems.append(Remediation(
            name="jaxservice-scale-up", alert="KVPagesExhausted",
            action=scale_up_nudge_action(client, namespace=namespace),
            cooldown_s=120.0))
        rems.append(Remediation(
            name="node-cordon-drain", alert="NodeSLOBurn",
            action=cordon_drain_action(client),
            cooldown_s=600.0))
    if cache is not None:
        rems.append(Remediation(
            name="cache-relist", alert="SchedulerPassSlow",
            action=cache_relist_action(cache),
            cooldown_s=300.0))
    return rems
