"""ChaosClient — seeded, policy-driven fault injection for any Client.

The reference platform's failure story is per-replica ``restartPolicy``
plus real-GKE E2E (SURVEY.md §4-5); nothing in its test tiers can
*inject* an apiserver error, a dropped watch, or a node dying under a
running gang. This module is the missing chaos engine: it wraps any
Client (FakeCluster or RestClient — the two share one verb surface) and
injects deterministic faults per verb/kind at a configured rate:

- ``Conflict`` storms on mutating verbs (the optimistic-concurrency
  loser path every controller must treat as benign);
- transient 429/500/503 ``ApiError`` (with a ``retry_after`` attribute,
  the Retry-After header analogue RestClient's backoff honors);
- injected latency (slow-apiserver simulation);
- mid-stream watch termination with resubscribe — exercising the
  resume-from-resourceVersion path and, when the resume point has
  fallen out of the watch cache, the 410-Expired relist path;
- cluster-level primitives to mark nodes NotReady, heal them, and kill
  bound pods mid-run (the preemptible-node steady state).

Everything is driven by one ``random.Random(seed)``, so a failure
sequence replays exactly: same seed + same call order = same faults.
``TPU_CHAOS_SEED`` / ``TPU_CHAOS_RATE`` configure the default policy
(the knob convention TPU_RACE_* established for the race tier). With
rate 0 the wrapper is a strict pass-through and every existing suite
runs unchanged through it.

Events are NEVER fault-injected here: Kubernetes event recording is
fire-and-forget (client-go's recorder drops on overflow rather than
failing the reconcile), so event loss is modeled by watch drops and the
EventRecorder's own best-effort contract, not by raising into a
controller that must not care.

Arming: by default every eligible call can fault (``always_on=True``).
Test harnesses that share one client between the controller under test
and the assertions pass ``always_on=False`` and arm chaos only around
reconciles (``arm_controller``) — faults then hit exactly the code that
must survive them, never the test's own setup/assert calls.

Port of `kubeflow_tpu/control/k8s/chaos.py`: the same code over the
port's own modules. ``TPU_CHAOS_SEED`` / ``TPU_CHAOS_RATE`` keep their
names on GPUs: they are the deployment's contract.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import logging
import os
import random
import threading
import time
from collections import deque

from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.control.k8s.fake import WatchEvent

log = logging.getLogger("kubeflow_tpu_torch.chaos")

ENV_SEED = "TPU_CHAOS_SEED"
ENV_RATE = "TPU_CHAOS_RATE"

# Verbs a conflict can be injected on (409 only makes sense for writes).
MUTATING_VERBS = frozenset(
    {"create", "update", "update_status", "patch", "apply", "delete"})
READ_VERBS = frozenset({"get", "list"})
DATA_VERBS = MUTATING_VERBS | READ_VERBS

# Ambient "faults may fire now" flag. A contextvar, not a client field:
# each thread (controller worker, watch thread, test main) gets its own
# context, so arming a reconcile in one worker never opens the window
# for the test thread's assertion calls.
_ARMED: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "kftpu_chaos_armed", default=False)


@dataclasses.dataclass(frozen=True)
class ChaosPolicy:
    """What to inject, where, how often. Frozen: a policy is config."""

    seed: int = 0
    rate: float = 0.0            # per-eligible-call fault probability
    conflict_weight: float = 1.0  # vs error_weight, mutating verbs only
    error_weight: float = 1.0
    error_codes: tuple = (429, 500, 503)
    retry_after: float = 0.05    # attached to 429/503 (Retry-After)
    latency: float = 0.0         # >0: some faults are delays, not errors
    latency_weight: float = 1.0
    verbs: frozenset | None = None   # None = all DATA_VERBS
    kinds: frozenset | None = None   # None = every kind
    watch_drop_every: int = 0    # ~every N delivered events; 0 = never

    @classmethod
    def from_env(cls, environ=None, **overrides) -> "ChaosPolicy":
        """Policy from TPU_CHAOS_SEED / TPU_CHAOS_RATE (overridable)."""
        env = os.environ if environ is None else environ
        fields = {
            "seed": int(env.get(ENV_SEED, "0")),
            "rate": float(env.get(ENV_RATE, "0")),
        }
        fields.update(overrides)
        return cls(**fields)


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected fault — the replayable record of a chaos decision."""

    call: int       # 1-based index among eligible calls
    verb: str
    kind: str
    fault: str      # "conflict" | "error:<code>" | "latency"


class ChaosClient:
    """Wrap ``inner`` (any Client) with seeded fault injection.

    Unknown attributes delegate to the inner client, so backend-specific
    surface (``dump``, ``add_admission_hook``, ``list_page``, ...) keeps
    working through the wrapper.
    """

    def __init__(self, inner, policy: ChaosPolicy | None = None,
                 always_on: bool = True, sleeper=None):
        self.inner = inner
        self.policy = policy if policy is not None else ChaosPolicy.from_env()
        self.always_on = always_on
        self._sleeper = sleeper if sleeper is not None else time.sleep
        self._lock = threading.Lock()
        self._rng = random.Random(self.policy.seed)
        self._calls = 0
        self._faults: list[Fault] = []

    # -- arming --------------------------------------------------------------

    @contextlib.contextmanager
    def armed(self):
        """Faults may fire inside this context (for always_on=False)."""
        token = _ARMED.set(True)
        try:
            yield self
        finally:
            _ARMED.reset(token)

    def _active(self) -> bool:
        return self.always_on or _ARMED.get()

    # -- the dice ------------------------------------------------------------

    def fault_log(self) -> list[Fault]:
        """Injected faults so far — equal across same-seed replays."""
        with self._lock:
            return list(self._faults)

    def _randint(self, a: int, b: int) -> int:
        with self._lock:
            return self._rng.randint(a, b)

    def _maybe_fault(self, verb: str, kind: str) -> None:
        p = self.policy
        if p.rate <= 0 or not self._active():
            return
        if p.verbs is not None and verb not in p.verbs:
            return
        if p.kinds is not None and kind not in p.kinds:
            return
        with self._lock:
            # every *eligible* call consumes exactly one uniform draw, so
            # the fault sequence is a pure function of (seed, call order)
            self._calls += 1
            n = self._calls
            if self._rng.random() >= p.rate:
                return
            menu: list[tuple[str, float]] = [("error", p.error_weight)]
            if verb in MUTATING_VERBS:
                menu.append(("conflict", p.conflict_weight))
            if p.latency > 0:
                menu.append(("latency", p.latency_weight))
            menu = [(name, w) for name, w in menu if w > 0]
            if not menu:  # e.g. conflict-only policy on a read verb
                return
            total = sum(w for _, w in menu)
            pick = self._rng.random() * total
            fault = menu[-1][0]
            for name, w in menu:
                if pick < w:
                    fault = name
                    break
                pick -= w
            if fault == "error":
                code = p.error_codes[self._rng.randrange(len(p.error_codes))]
                fault = f"error:{code}"
            self._faults.append(Fault(n, verb, kind, fault))
        self._raise_or_delay(fault, verb, kind)

    def _raise_or_delay(self, fault: str, verb: str, kind: str) -> None:
        if fault == "latency":
            self._sleeper(self.policy.latency)
            return
        if fault == "conflict":
            raise ob.Conflict(f"chaos: injected conflict on {verb} {kind}")
        code = int(fault.split(":", 1)[1])
        err = ob.ApiError(
            f"chaos: injected HTTP {code} on {verb} {kind}")
        err.code = code
        if code in (429, 503):
            err.retry_after = self.policy.retry_after
        raise err

    # -- Client verbs (faulted) ---------------------------------------------

    def create(self, obj: dict) -> dict:
        self._maybe_fault("create", obj.get("kind", ""))
        return self.inner.create(obj)

    def get(self, api_version, kind, name, namespace=None) -> dict:
        self._maybe_fault("get", kind)
        return self.inner.get(api_version, kind, name, namespace)

    def get_or_none(self, api_version, kind, name, namespace=None):
        self._maybe_fault("get", kind)
        return self.inner.get_or_none(api_version, kind, name, namespace)

    def list(self, api_version, kind, namespace=None,
             label_selector=None, field_selector=None) -> list[dict]:
        self._maybe_fault("list", kind)
        return self.inner.list(api_version, kind, namespace,
                               label_selector, field_selector)

    def update(self, obj: dict) -> dict:
        self._maybe_fault("update", obj.get("kind", ""))
        return self.inner.update(obj)

    def update_status(self, obj: dict) -> dict:
        self._maybe_fault("update_status", obj.get("kind", ""))
        return self.inner.update_status(obj)

    def patch(self, api_version, kind, name, patch, namespace=None) -> dict:
        self._maybe_fault("patch", kind)
        return self.inner.patch(api_version, kind, name, patch, namespace)

    def apply(self, obj: dict, *, field_manager: str, force: bool = False):
        self._maybe_fault("apply", obj.get("kind", ""))
        return self.inner.apply(obj, field_manager=field_manager, force=force)

    def delete(self, api_version, kind, name, namespace=None) -> None:
        self._maybe_fault("delete", kind)
        return self.inner.delete(api_version, kind, name, namespace)

    def record_event(self, involved, reason, message, etype="Normal",
                     component="kubeflow-tpu") -> dict:
        # fire-and-forget channel: never faulted (see module docstring)
        return self.inner.record_event(involved, reason, message, etype,
                                       component=component)

    def watch(self, api_version, kind, namespace=None, **kw):
        stream = self.inner.watch(api_version, kind, namespace, **kw)
        if self.policy.watch_drop_every <= 0:
            return stream
        return ChaosWatchStream(self, (api_version, kind, namespace), stream)

    def __getattr__(self, name):
        # backend-specific surface passes through unfaulted
        return getattr(self.inner, name)

    # -- cluster-level chaos primitives (always direct, never faulted) ------

    def fail_node(self, name: str) -> None:
        """Mark a Node NotReady — the TPU-maintenance / host-death drill.
        The scheduler's health pass and the JAXJob slice-health check
        both key off this condition."""
        self._set_node_ready(name, False)

    def heal_node(self, name: str) -> None:
        self._set_node_ready(name, True)

    def _set_node_ready(self, name: str, ready: bool) -> None:
        node = self.inner.get("v1", "Node", name)
        status = node.setdefault("status", {})
        conds = [c for c in status.get("conditions") or []
                 if c.get("type") != "Ready"]
        conds.append({"type": "Ready",
                      "status": "True" if ready else "False"})
        status["conditions"] = conds
        self.inner.update_status(node)  # tpulint: disable=CTL502  chaos drill, not a reconcile: fail/heal_node mutate on purpose every invocation
        log.info("chaos: node %s -> Ready=%s", name, ready)

    def delete_node(self, name: str) -> None:
        self.inner.delete("v1", "Node", name)
        log.info("chaos: node %s deleted", name)

    def evict_pod(self, name: str, namespace: str = "default",
                  message: str = "chaos: node-pressure eviction") -> None:
        """Kubelet-eviction shape (phase Failed, reason Evicted, no
        containerStatuses) — classified as preemption, not crash, by
        JAXJobReconciler._pod_preempted."""
        from kubeflow_tpu_torch.control.scheduler.nodes import eviction_status

        pod = self.inner.get_or_none("v1", "Pod", name, namespace)
        if pod is None:
            return
        pod.setdefault("status", {})
        pod["status"].update(eviction_status(message))
        self.inner.update_status(pod)
        log.info("chaos: evicted pod %s/%s", namespace, name)

    def kill_pod(self, name: str, namespace: str = "default") -> None:
        """Hard kill: the pod object vanishes (a node dying takes its
        pods' apiserver records with it once the GC runs)."""
        try:
            self.inner.delete("v1", "Pod", name, namespace)
        except ob.NotFound:
            pass
        log.info("chaos: killed pod %s/%s", namespace, name)


class ChaosWatchStream:
    """Wrap a watch stream; every ~``watch_drop_every`` delivered events
    the underlying stream is torn down mid-flight and resubscribed —
    resume-from-resourceVersion when the backend retained the history,
    else (410 Expired, or a backend without resume) a full relist that
    re-yields every live object as MODIFIED and synthesizes DELETED for
    objects this stream had seen that vanished during the gap (the
    informer relist contract ``_RestWatchStream`` implements for real
    apiservers, exercised here hermetically)."""

    def __init__(self, client: ChaosClient, args: tuple, stream):
        self._client = client
        self._args = args
        self._stream = stream
        self._closed = False
        self._served = 0
        self._budget = self._draw_budget()
        self._drops = 0
        self._last_rv = ""
        self._known: dict[tuple[str, str], dict] = {}
        self._replay: deque[WatchEvent] = deque()
        if hasattr(stream, "poll"):
            # only expose poll when the wrapped stream has it (the
            # hermetic FakeWatchStream); runtime._drain_streams keys off
            # hasattr to tell test-mode streams from production ones
            self.poll = self._poll

    @property
    def drops(self) -> int:
        return self._drops

    def _draw_budget(self) -> int:
        n = self._client.policy.watch_drop_every
        return self._client._randint(max(1, n // 2), max(1, 2 * n))

    @staticmethod
    def _key(obj: dict) -> tuple[str, str]:
        m = ob.meta(obj)
        return (m.get("namespace") or "", m.get("name") or "")

    def _note(self, ev: WatchEvent) -> None:
        self._last_rv = ob.meta(ev.object).get(
            "resourceVersion", self._last_rv)
        if ev.type == "DELETED":
            self._known.pop(self._key(ev.object), None)
        else:
            self._known[self._key(ev.object)] = ev.object

    def _drop_and_resubscribe(self) -> None:
        self._drops += 1
        self._served = 0
        self._budget = self._draw_budget()
        try:
            self._stream.stop()
        except Exception:
            pass
        api_version, kind, namespace = self._args
        inner = self._client.inner
        stream = None
        if self._last_rv:
            try:
                stream = inner.watch(api_version, kind, namespace,
                                     since_rv=self._last_rv)
                log.info("chaos: watch %s dropped, resumed from rv=%s",
                         kind, self._last_rv)
            except ob.Expired:
                log.info("chaos: watch %s dropped, resume rv=%s expired "
                         "(410) -> relist", kind, self._last_rv)
            except TypeError:
                pass  # backend without watch-cache resume: relist below
        if stream is None:
            # subscribe FIRST, then relist: changes landing between the
            # two are replayed by the fresh stream, never lost in a gap
            stream = inner.watch(api_version, kind, namespace)
            live: dict[tuple[str, str], dict] = {}
            for obj in inner.list(api_version, kind, namespace):
                live[self._key(obj)] = obj
                self._last_rv = ob.meta(obj).get(
                    "resourceVersion", self._last_rv)
                self._replay.append(WatchEvent("MODIFIED", obj))
            for key, last_state in self._known.items():
                if key not in live:
                    self._replay.append(WatchEvent("DELETED", last_state))
            self._known = live
        self._stream = stream

    def _poll(self, timeout: float = 0.0):
        if self._replay:
            return self._replay.popleft()
        if self._served >= self._budget:
            self._drop_and_resubscribe()
            if self._replay:
                return self._replay.popleft()
        ev = self._stream.poll(timeout)
        if ev is None:
            return None
        self._served += 1
        self._note(ev)
        return ev

    def __iter__(self):
        while not self._closed:
            while self._replay:
                yield self._replay.popleft()
            if self._served >= self._budget:
                self._drop_and_resubscribe()
                continue
            delivered = False
            for ev in self._stream:
                if self._closed:
                    return
                self._served += 1
                self._note(ev)
                delivered = True
                yield ev
                if self._served >= self._budget or self._replay:
                    break
            if not delivered and not self._replay \
                    and self._served < self._budget:
                return  # inner stream ended for good (closed)

    def stop(self) -> None:
        self._closed = True
        self._stream.stop()


class ArmedReconciler:
    """Duck-typed Reconciler wrapper: faults fire only while the wrapped
    reconcile runs (pair with ``ChaosClient(always_on=False)``)."""

    def __init__(self, inner, chaos: ChaosClient):
        self.inner = inner
        self.chaos = chaos

    def reconcile(self, client, req):
        with self.chaos.armed():
            return self.inner.reconcile(client, req)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def arm_controller(ctl, chaos: ChaosClient):
    """Route a Controller's reconciles through ``chaos.armed()`` so only
    the code under test sees faults, never the harness around it."""
    ctl.reconciler = ArmedReconciler(ctl.reconciler, chaos)
    return ctl
