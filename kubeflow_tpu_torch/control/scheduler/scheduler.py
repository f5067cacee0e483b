"""Gang scheduler runtime: all-or-nothing admission, priority preemption.

Port of `kubeflow_tpu/control/scheduler/scheduler.py`: the same
admission, preemption, health and elastic passes, counting
``nvidia.com/gpu`` and pooling nodes by (GPU product, node pool). Its
metrics go to the port's ``MetricsRegistry`` under the JAX package's
names (the JAX scheduler also mirrors three of them into
prometheus_client, which the card's machine does not have).

A ``Reconciler`` on the same ``control/runtime.py`` machinery as every
other controller. Reconcile keys are gangs (namespace + job name, from
the pod label the JAXJob controller already stamps); pod events map to
their gang, node events retry everything queued.

Admission is kube-scheduler-shaped but slice-native:

1. walk each namespace's queued gangs in priority/FIFO order
   (``GangQueue.ordered_by_namespace`` — a backed-off head still blocks
   its namespace, see _schedule_pass);
2. for the head gang, compute per-node free GPUs (allocatable minus
   the requests of bound, non-terminal pods) and try to place EVERY
   worker on a feasible node (selector + taints + readiness) — best-fit
   on free GPUs so gangs pack;
3. complete assignment -> bind all pods (spec.nodeName patch + lift the
   scheduling gate); any bind failure releases the partial reservation
   (unbind + re-gate) — no partial placement ever escapes;
4. no assignment -> try preempting lower-priority gangs (evict their
   pods as Failed/Evicted, which fires the JAXJob controller's existing
   gang-restart path), else requeue with exponential backoff.

The pass is strict-priority FIFO per namespace (Kueue StrictFIFO): a
blocked head gang blocks its namespace's queue behind it, so a large
high-priority job cannot be starved by a stream of small ones — while
one tenant's stuck gang never halts another tenant's admission.
"""

from __future__ import annotations

import logging
import threading
import time

from kubeflow_tpu_torch.control.cache import ClusterCache
from kubeflow_tpu_torch.control.jaxjob import types as JT
from kubeflow_tpu_torch.control.jaxjob.controller import (
    SCHEDULE_LATENCY_BUCKETS, worker_index,
)
from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.control.runtime import (
    Controller, Reconciler, Request, Result,
)
from kubeflow_tpu_torch.control.scheduler import (
    ANNOTATION_ELASTIC_MIN, ANNOTATION_GANG_SIZE, ANNOTATION_PRIORITY,
    GATE_GANG, SCHEDULER_NAME,
)
from kubeflow_tpu_torch.control.scheduler import capacity as CP
from kubeflow_tpu_torch.control.scheduler import nodes as N
from kubeflow_tpu_torch.control.scheduler.queue import GangQueue
from kubeflow_tpu_torch.obs import trace as obs_trace
from kubeflow_tpu_torch.runtime.metrics import REGISTRY, MetricsRegistry

# Queue-to-bound latency buckets: scheduling is sub-second when capacity
# exists, minutes when a gang waits behind backoff/preemption.
BIND_LATENCY_BUCKETS = (0.1, 0.5, 1, 2, 5, 10, 30, 60, 120, 300, 600)

# Pass-duration buckets: an indexed pass is sub-millisecond at hundreds
# of nodes; the tier-1 scale smoke budgets the tail (docs/scale.md).
PASS_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                0.1, 0.25, 0.5, 1.0, 2.5, 5.0)

log = logging.getLogger("kubeflow_tpu_torch.scheduler")

# after a preemption the freed GPUs appear as soon as the eviction
# status lands — retry quickly rather than paying a backoff round
_RETRY_AFTER_PREEMPT = 0.05

# _WAIT: blocked for a non-capacity reason (gang mid-creation, transient
# bind failure) — never a preemption trigger. _UNPLACEABLE: a genuine
# failed capacity assignment — the only outcome that may evict others.
# _PARTIAL: an ELASTIC gang bound a subset >= its floor; the remainder
# re-queues at the back of the FIFO (grow-back). _GROW_WAIT: an elastic
# gang already running at/above its floor found no room to grow — backs
# off WITHOUT head-blocking its namespace and never preempts (growth is
# a preference; only sub-floor admission is a need).
_ADMITTED, _GONE, _WAIT, _UNPLACEABLE, _PARTIAL, _GROW_WAIT = \
    "admitted", "gone", "wait", "unplaceable", "partial", "grow-wait"

# Sentinel reconcile key: "retry everything queued". Node events and
# bound-pod phase changes enqueue this ONE key instead of one key per
# queued gang — each reconcile already runs a full global scheduling
# pass, so fanning out N keys per event was N-1 redundant passes.
RETRY_ALL = Request("", "-retry-all-")


def _gang_annotation(pods: list[dict], key: str) -> int | None:
    for p in pods:
        v = ob.annotations_of(p).get(key)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                return None
    return None


def _gang_context(pods: list[dict]) -> obs_trace.SpanContext | None:
    """The job's trace context, read from the traceparent annotation the
    JAXJob controller stamps on gang pods — admission/bind/preemption
    spans parent on it so the scheduler's work appears inside the job's
    own timeline, not in a disconnected trace."""
    for p in pods:
        ctx = obs_trace.parse_traceparent(
            ob.annotations_of(p).get(obs_trace.TRACEPARENT_ANNOTATION))
        if ctx is not None:
            return ctx
    return None


class GangScheduler(Reconciler):
    # Optional hook: called with each pass duration in seconds (the
    # scale benchmark collects raw samples for p50/p99 — histogram
    # buckets are too coarse for a tail assertion).
    pass_observer = None

    def __init__(
        self,
        queue: GangQueue | None = None,
        registry: MetricsRegistry = REGISTRY,
        record_events: bool = True,
        clock=None,
        jitter: float = 0.0,
        cache: ClusterCache | None = None,
    ):
        if queue is None:
            kw = {"jitter": jitter}
            if clock:
                kw["clock"] = clock
            queue = GangQueue(**kw)
        self.queue = queue
        self.registry = registry
        self.record_events = record_events
        # The indexed cluster cache. With it, every hot-path read —
        # gang pods, capacity, victim scan, node health — is an
        # O(bucket) snapshot lookup; without it (cache=None, the relist
        # shape) each read is a full apiserver relist.
        self.cache = cache
        # legacy-path node-set memory for the health-pass short-circuit
        self._known_nodes: set[str] | None = None
        # last published cache stats, for counter deltas; read-compute-
        # update must be atomic or two workers publishing concurrently
        # double-count the same delta
        self._cache_stats: dict[str, int] = {}
        self._stats_lock = threading.Lock()
        # admission is a read-compute-bind transaction over cluster
        # state; two run(workers=N) threads interleaving passes would
        # each see the same free GPUs and double-book a node, so the
        # whole pass is serialized (kube-scheduler's single scheduling
        # cycle). Queue state has its own finer lock.
        self._pass_lock = threading.Lock()
        # injectable pass timer (DET601): pass-duration metrics come
        # off this hook so virtual-time benches can pin it
        self._perf = time.perf_counter

    # -- reconcile ----------------------------------------------------------

    def reconcile(self, client, req: Request) -> Result | None:
        with self._pass_lock:
            t0 = self._perf()
            if self.cache is not None:
                # catch the snapshot up BEFORE reading: the event that
                # triggered this reconcile is already in the watch
                # queues, and the serialized pass keeps event
                # application single-writer
                self.cache.refresh()
            if req != RETRY_ALL:  # the sentinel names no gang to sync
                self._sync(client, req)
            else:
                # node events land here: before admitting anything,
                # evict gangs whose nodes died under them (freed GPUs
                # then feed the same pass). Under the pass lock: two
                # concurrent node-event reconciles must not double-
                # evict (and double-count) the same pods.
                self._health_pass(client)
            delay = self._schedule_pass(client)
            self._observe_pass(self._perf() - t0)
        self._publish_metrics()
        if delay is not None:
            return Result(requeue_after=max(delay, 0.01))
        return None

    def _observe_pass(self, dt: float) -> None:
        self.registry.histogram(
            "scheduler_pass_seconds", dt,
            help_="scheduling pass duration (sync + health + admit)",
            buckets=PASS_BUCKETS)
        if self.pass_observer is not None:
            self.pass_observer(dt)

    def _note(self, obj: dict | None) -> None:
        """Fold our own write response into the cache (assume-cache):
        the next admission in this same pass must see this bind."""
        if self.cache is not None and obj:
            self.cache.note_write(obj)

    def _count_read(self, source: str) -> None:
        self.registry.counter_inc(
            "scheduler_cache_reads_total",
            help_="hot-path cluster reads by source (cache hit rate)",
            source=source)

    def _count_scanned(self, cap: CP.Capacity) -> None:
        if cap.scanned:
            self.registry.counter_inc(
                "scheduler_nodes_scanned_total",
                help_="nodes examined by best-fit placement walks",
                by=cap.scanned)
            cap.scanned = 0

    def _sync(self, client, req: Request) -> None:
        """Fold this gang's current cluster state into the queue."""
        pods = self._gang_pods(client, req.namespace, req.name)
        pending = [p for p in pods if self._unbound_pending(p)]
        if not pending and self._cache_may_lag(pods, req.namespace,
                                               req.name):
            pods = self._confirm_gang(client, req.namespace, req.name)
            pending = [p for p in pods if self._unbound_pending(p)]
        if not pending:
            self.queue.remove(req.namespace, req.name)
            return
        prio = _gang_annotation(pods, ANNOTATION_PRIORITY) or 0
        newly = self.queue.get(req.namespace, req.name) is None
        self.queue.offer(req.namespace, req.name, priority=prio)
        if newly and self.record_events and hasattr(client, "record_event"):
            client.record_event(
                pending[0], "GangQueued",
                f"gang {req.namespace}/{req.name} queued for admission "
                f"(priority {prio})", component=SCHEDULER_NAME)

    def _schedule_pass(self, client) -> float | None:
        """Admit queued gangs, per namespace, in strict priority/FIFO
        order until that namespace's head blocks. Returns the shortest
        delay to requeue after, or None when idle.

        Head blocking is PER NAMESPACE (the queue is per-tenant): an
        unplaceable gang in one namespace cannot starve another
        tenant whose pool has room. Within a namespace the walk covers
        ALL entries, not just backoff-expired ones — a backed-off head
        still holds its namespace's queue (nothing may jump it), its
        backoff only pacing how often admission is retried."""
        now = self.queue.clock()
        delays: list[float] = []
        # namespaces are processed in their HEAD entry's global
        # admission order (priority desc, then FIFO): after an eviction
        # the retrying preemptor is always first to the freed GPUs — a
        # lower-priority head in a later namespace can never steal them
        by_ns = self.queue.ordered_by_namespace()
        for _ns, entries in sorted(
                by_ns.items(),
                key=lambda kv: (-kv[1][0].priority, kv[1][0].seq)):
            for entry in entries:
                if entry.not_before > now:
                    delays.append(entry.not_before - now)  # head backing off
                    break
                outcome = self._try_admit(client, entry)
                if outcome in (_ADMITTED, _GONE):
                    self.queue.remove(entry.namespace, entry.name)
                    continue
                if outcome == _PARTIAL:
                    # the elastic gang got capacity down to its floor;
                    # its remainder moves to the BACK of the FIFO (fresh
                    # seq) with backoff, so a gang waiting to grow back
                    # can never starve the siblings queued behind it
                    prio = entry.priority
                    self.queue.remove(entry.namespace, entry.name)
                    self.queue.offer(entry.namespace, entry.name,
                                     priority=prio)
                    delays.append(
                        self.queue.requeue(entry.namespace, entry.name))
                    continue
                if outcome == _GROW_WAIT:
                    # running at/above its floor, nothing to grow into:
                    # back off but DO NOT head-block the namespace — a
                    # viable running gang is not starved, and holding
                    # the queue for its preference would starve others
                    delays.append(
                        self.queue.requeue(entry.namespace, entry.name))
                    self.registry.counter_inc(
                        "scheduler_requeues_total",
                        help_="gang admission attempts that failed and "
                              "backed off",
                        namespace=entry.namespace, tenant=entry.namespace)
                    continue
                # blocked: the namespace head holds its queue; on a
                # genuine capacity failure (never on a gang still being
                # created or a transient bind error) try to make room,
                # else back off
                if outcome == _WAIT:
                    # mid-creation / transient: poll at the base rate
                    # WITHOUT burning the exponential schedule or the
                    # failed-admission counter — this gang never had a
                    # real admission attempt rejected
                    delays.append(self.queue.base_backoff)
                    break
                if self._try_preempt(client, entry):
                    # end the WHOLE pass: gangs in not-yet-walked
                    # namespaces must not bind the GPUs this eviction
                    # just freed for the preemptor
                    return _RETRY_AFTER_PREEMPT
                delays.append(
                    self.queue.requeue(entry.namespace, entry.name))
                self.registry.counter_inc(
                    "scheduler_requeues_total",
                    help_="gang admission attempts that failed and "
                          "backed off",
                    namespace=entry.namespace, tenant=entry.namespace)
                break
        if delays:
            return min(delays)
        return self.queue.next_wakeup(now)

    # -- node health --------------------------------------------------------

    def _health_pass(self, client) -> None:
        """Evict bound gang pods whose node went NotReady or vanished
        (today's admission-time filter, nodes.py feasible(), protects
        only FUTURE placements). Eviction uses the kubelet-eviction
        shape — phase Failed, reason Evicted — so the JAXJob
        controller's existing ``_pod_preempted`` path gang-restarts the
        job on its preemption budget, and the recreated (gated) pods
        requeue for admission on the surviving nodes.

        Steady-state cost: with every node Ready
        this pass touches ZERO pods — the cache answers "any bound pod
        on a dead node?" from its by-node index, and the legacy path
        skips the pod list unless a node is unready or vanished since
        the last pass (it previously listed every Pod in the cluster on
        every RETRY_ALL reconcile)."""
        victims: list[tuple[dict, str]] = []
        new_known: set[str] | None = None
        if self.cache is not None:
            self._count_read("cache")
            for node, why in sorted(
                    self.cache.unhealthy_bound_nodes().items()):
                for p in self.cache.pods_on_node(node):
                    if (p.get("spec") or {}).get("schedulerName") \
                            != SCHEDULER_NAME:
                        continue
                    victims.append((p, f"node {node} {why} under gang"))
        else:
            self._count_read("list")
            views = {v.name: v for v in (N.node_view(n)
                                         for n in client.list("v1", "Node"))}
            unready = {n for n, v in views.items() if not v.ready}
            vanished = (self._known_nodes or set()) - set(views)
            first = self._known_nodes is None
            if not unready and not vanished and not first:
                # all Ready, nothing vanished: skip the pod list (safe
                # to commit the node set here — there is no work below
                # whose failure could lose a signal)
                self._known_nodes = set(views)
                return
            new_known = set(views)
            for p in client.list("v1", "Pod"):
                spec = p.get("spec") or {}
                if spec.get("schedulerName") != SCHEDULER_NAME:
                    continue
                node = spec.get("nodeName")
                if not node:
                    continue
                if (p.get("status") or {}).get("phase") in N.TERMINAL_PHASES:
                    continue
                view = views.get(node)
                if view is not None and view.ready:
                    continue
                why = "deleted" if view is None else "NotReady"
                victims.append((p, f"node {node} {why} under gang"))
        for p, message in victims:
            m = ob.meta(p)
            cur = client.get_or_none("v1", "Pod", m["name"],
                                     m.get("namespace"))
            if cur is None:
                continue
            if (cur.get("status") or {}).get("phase") in N.TERMINAL_PHASES:
                continue
            cur.setdefault("status", {})
            cur["status"].update(N.eviction_status(message))
            self._note(client.update_status(cur))
            log.info("evicted %s/%s: %s", m.get("namespace"), m["name"],
                     message)
            self.registry.counter_inc(
                "scheduler_node_evictions_total",
                help_="gang pods evicted because their node died",
                namespace=m.get("namespace") or "default")
            if self.record_events and hasattr(client, "record_event"):
                client.record_event(cur, "GangNodeLost", message, "Warning",
                                    component=SCHEDULER_NAME)
        # commit the node-set memory only once every eviction landed: a
        # raising list/update above leaves _known_nodes unchanged, so
        # the retrying reconcile still sees the vanished node (eviction
        # is idempotent — already-terminal victims are skipped)
        if new_known is not None:
            self._known_nodes = new_known

    # -- admission ----------------------------------------------------------

    def _gang_pods(self, client, namespace: str, name: str) -> list[dict]:
        if self.cache is not None:
            self._count_read("cache")
            pods = self.cache.gang_pods(namespace, name)
            return [p for p in pods
                    if (p.get("spec") or {}).get("schedulerName")
                    == SCHEDULER_NAME]
        return self._gang_pods_listed(client, namespace, name)

    def _gang_pods_listed(self, client, namespace: str,
                          name: str) -> list[dict]:
        self._count_read("list")
        pods = client.list(
            "v1", "Pod", namespace=namespace,
            label_selector={"matchLabels": {JT.LABEL_JOB_NAME: name}})
        return [p for p in pods
                if (p.get("spec") or {}).get("schedulerName")
                == SCHEDULER_NAME]

    def _cache_may_lag(self, pods: list[dict], namespace: str,
                       name: str) -> bool:
        """Whether 'no pending pods' is trustworthy enough to drop the
        gang. In pumped mode refresh() cannot drain the pump-owned
        streams, so a reconcile can read a snapshot that predates its
        own triggering event — and a gang dropped from the queue on
        that basis has nothing left to requeue it (gated Pending pods
        emit no further events). Only the states a stalled restart
        actually leaves behind need confirming (no pods / all terminal
        / still queued): live bound pods mean the gang is running, and
        its eventual terminal transitions re-enter here."""
        if self.cache is None or not self.cache.pumped:
            return False
        if not pods or all((p.get("status") or {}).get("phase")
                           in N.TERMINAL_PHASES for p in pods):
            return True
        return self.queue.get(namespace, name) is not None

    def _confirm_gang(self, client, namespace: str,
                      name: str) -> list[dict]:
        """Authoritative re-read before a destructive queue decision,
        folded back into the lagging cache (rv-guarded, so it can only
        advance the snapshot)."""
        pods = self._gang_pods_listed(client, namespace, name)
        for p in pods:
            self._note(p)
        return pods

    @staticmethod
    def _unbound_pending(pod: dict) -> bool:
        spec = pod.get("spec") or {}
        phase = (pod.get("status") or {}).get("phase", "Pending")
        if phase != "Pending" or spec.get("nodeName"):
            return False
        # kube semantics: a pod carrying ANY foreign gate is
        # unschedulable — admitting its gang would reserve GPUs (and
        # possibly preempt running work) for workers that cannot start
        # until that gate's controller lifts it
        return all(g.get("name") == GATE_GANG
                   for g in spec.get("schedulingGates") or [])

    def _try_admit(self, client, entry) -> str:
        pods = self._gang_pods(client, entry.namespace, entry.name)
        with obs_trace.TRACER.span(
                "scheduler.admit", parent=_gang_context(pods),
                namespace=entry.namespace, gang=entry.name,
                attempt=entry.attempts,
                queue_wait_s=round(
                    max(self.queue.clock() - entry.enqueued_at, 0.0),
                    6)) as sp:
            outcome = self._admit(client, entry, pods)
            sp.attrs["outcome"] = outcome
            return outcome

    def _admit(self, client, entry, pods: list[dict]) -> str:
        if self._repair_stragglers(client, entry.namespace, pods):
            pods = self._gang_pods(client, entry.namespace, entry.name)
        pending = sorted((p for p in pods if self._unbound_pending(p)),
                         key=lambda p: ob.meta(p)["name"])
        if not pending and self.cache is not None and self.cache.pumped:
            # a queued gang with nothing pending is about to be dropped
            # — confirm the lagging snapshot against the apiserver first
            pods = self._confirm_gang(client, entry.namespace, entry.name)
            pending = sorted((p for p in pods if self._unbound_pending(p)),
                             key=lambda p: ob.meta(p)["name"])
        if not pending:
            return _GONE  # bound elsewhere or deleted
        bound = [p for p in pods
                 if (p.get("spec") or {}).get("nodeName")
                 and (p.get("status") or {}).get("phase")
                 not in N.TERMINAL_PHASES]
        size = _gang_annotation(pods, ANNOTATION_GANG_SIZE) \
            or (len(pending) + len(bound))
        if len(pending) + len(bound) < size:
            return _WAIT  # gang mid-creation: wait for the full set
        emin = _gang_annotation(pods, ANNOTATION_ELASTIC_MIN)
        elastic = emin is not None and emin >= 1
        if len(pending) < size and not elastic:
            # rigid gangs: bound residue (half-started bind) is the
            # JAXJob controller's to resolve — unchanged semantics
            return _WAIT
        cap = self._capacity(client)
        try:
            assignment = self._assign(pending, cap, prefer_spot=elastic)
            if assignment is None and elastic:
                # partial admission: any subset keeping the world at or
                # above the elastic floor beats idling — the scheduler's
                # half of shrink-to-survivors. Rigid gangs never get
                # here: all-or-nothing stays the law.
                floor = max(emin - len(bound), 1)
                assignment = self._assign_partial(pending, cap, floor=floor)
                if assignment is None and len(bound) >= emin:
                    return _GROW_WAIT
            if assignment is None:
                if self.record_events and hasattr(client, "record_event"):
                    # dedup (obs/events.py) collapses the retry storm:
                    # one Event whose count tracks the failed attempts
                    client.record_event(
                        pending[0], "GangUnschedulable",
                        f"gang {entry.namespace}/{entry.name}: no node set "
                        f"fits all {len(pending)} workers"
                        + (f" (nor >= the elastic floor of {emin})"
                           if elastic else ""), "Warning",
                        component=SCHEDULER_NAME)
                return _UNPLACEABLE
        finally:
            self._count_scanned(cap)
        if not self._bind(client, entry, assignment):
            return _WAIT
        if any(cap.views[n].spot for n in assignment.values()):
            self.registry.counter_inc(
                "scheduler_spot_admissions_total",
                help_="gang admissions that placed workers on "
                      "spot-pool nodes",
                namespace=entry.namespace)
        if self._slice_groups(pending) is not None:
            self.registry.counter_inc(
                "scheduler_slice_admissions_total",
                help_="multislice gang admissions placed slice-by-slice "
                      "(one pool per slice, all-or-nothing across "
                      "slices)",
                namespace=entry.namespace)
        if len(assignment) < len(pending):
            if self.record_events and hasattr(client, "record_event"):
                client.record_event(
                    pending[0], "GangPartiallyAdmitted",
                    f"gang {entry.namespace}/{entry.name}: bound "
                    f"{len(assignment) + len(bound)}/{size} workers "
                    f"(elastic floor {emin}); remainder queued for "
                    f"grow-back", component=SCHEDULER_NAME)
            return _PARTIAL
        return _ADMITTED

    def _capacity(self, client) -> CP.Capacity:
        """The placement snapshot: per-node free GPUs = allocatable -
        requests of bound, non-terminal pods (an evicted gang's GPUs
        free immediately), plus the sorted per-pool buckets. Served
        from the cache's incremental indexes, or (legacy path, kept for
        the seed-vs-optimized benchmark) rebuilt from a full relist."""
        if self.cache is not None:
            self._count_read("cache")
            return self.cache.capacity()
        self._count_read("list")
        views = {v.name: v
                 for v in (N.node_view(n)
                           for n in client.list("v1", "Node"))}
        free = {name: v.allocatable_gpus for name, v in views.items()}
        for p in client.list("v1", "Pod"):
            node = (p.get("spec") or {}).get("nodeName")
            if not node or node not in free:
                continue
            if (p.get("status") or {}).get("phase") in N.TERMINAL_PHASES:
                continue
            free[node] -= N.pod_gpu_request(p)
        return CP.Capacity.from_views(views, free)

    @staticmethod
    def _slice_groups(pods: list[dict]) -> dict[int, list[dict]] | None:
        """Pods grouped by their slice label (JAXJob controller stamps
        LABEL_SLICE_INDEX on sliceCount > 1 gangs), slice ids ascending;
        None when the gang is not sliced (any pod without the label) —
        single-slice admission stays byte-identical to the flat path."""
        groups: dict[int, list[dict]] = {}
        for p in pods:
            idx = ob.labels_of(p).get(JT.LABEL_SLICE_INDEX)
            if idx is None:
                return None
            try:
                groups.setdefault(int(idx), []).append(p)
            except ValueError:
                return None
        return dict(sorted(groups.items()))

    @classmethod
    def _assign(cls, pods: list[dict], cap: CP.Capacity,
                prefer_spot: bool = False, txn: CP.CapacityTxn | None = None):
        """All-or-nothing placement: best-fit every worker or None.
        Each worker is a bisect into its pool's sorted free-capacity
        bucket plus a walk to the first feasible node (capacity.py) —
        the semantics of the old full scan (min free GPUs, then
        lexicographically-first name), minus the O(nodes) per worker.
        Trials never disturb the snapshot: placement happens on a
        copy-on-write ``CapacityTxn`` (``txn`` lets the preemption loop
        seed one with victim credits).

        Sliced gangs (LABEL_SLICE_INDEX on every pod) place slice by
        slice with same-pool-per-slice affinity — see _assign_sliced;
        all-or-nothing still holds ACROSS slices.

        ``prefer_spot`` (elastic gangs): when any feasible spot node has
        room, best-fit among spot nodes only — spot capacity is
        reclaim-tolerant work's to burn, keeping on-demand pools free
        for rigid gangs. Preferred, not required: with the spot pool
        full, placement falls back to any feasible node."""
        if txn is None:
            txn = cap.txn()
        groups = cls._slice_groups(pods)
        if groups is not None:
            out: dict[str, str] = {}
            for spods in groups.values():
                placed = cls._assign_slice(spods, txn, prefer_spot)
                if placed is None:
                    return None  # all-or-nothing across slices
                out.update(placed)
            return out
        out = {}
        for pod in pods:
            need = N.pod_gpu_request(pod)
            best = txn.best_fit(pod, need, prefer_spot)
            if best is None:
                return None
            txn.take(best, need)
            out[ob.meta(pod)["name"]] = best
        return out

    @classmethod
    def _assign_slice(cls, spods: list[dict], txn: CP.CapacityTxn,
                      prefer_spot: bool) -> dict[str, str] | None:
        """Place ONE slice entirely inside ONE (product, node pool) pool
        — a node pool shares one fabric, so a slice split across pools
        would run its inner axes over the slower link. Candidate pools
        are walked in pool-level best-fit order (ascending total free
        GPUs as this txn sees them, then key, deterministic); each
        trial runs on a FORK of the txn so a failed pool leaves no
        residue, and the first pool that fits the whole slice is
        replayed onto the parent txn. Different slices of one gang may land in different
        pools (the dcn axis crosses pools; the rest stays inside one).

        Nodes without BOTH pool labels live only in the catch-all
        bucket and are never slice candidates — a slice needs a pool
        identity to pin."""
        sel = (spods[0].get("spec") or {}).get("nodeSelector") or {}
        product = sel.get(JT.NODESELECTOR_ACCEL)
        pool = sel.get(JT.NODESELECTOR_POOL)
        candidates = sorted(
            (key for key in txn.bucket_keys()
             if (product is None or key[0] == product)
             and (pool is None or key[1] == pool)),
            key=lambda k: (txn.bucket_free(k), k))
        ordered = sorted(spods, key=cls._replica_order)
        needs = [N.pod_gpu_request(p) for p in ordered]
        for key in candidates:
            trial = txn.fork()
            placed: dict[str, str] = {}
            try:
                for pod, need in zip(ordered, needs):
                    best = trial.best_fit(pod, need, prefer_spot,
                                          bucket_key=key)
                    if best is None:
                        placed = {}
                        break
                    trial.take(best, need)
                    placed[ob.meta(pod)["name"]] = best
            except Exception:
                trial.rollback()  # a torn trial must leave no residue
                raise
            if placed:
                trial.commit()  # replay the winning takes on the parent
                return placed
            trial.rollback()
        return None

    @staticmethod
    def _replica_order(pod: dict):
        """Numeric replica-index key (worker-10 must sort AFTER
        worker-2, which plain name order gets wrong for gangs >= 10):
        the partial-admission prefix keeps the lowest indices, so
        worker 0 — the coordinator pick — survives when anything does.
        ``worker_index`` is the ONE index parse, shared with the JAXJob
        controller's world-membership ordering — the admitted prefix
        and the world stamp must agree on what "lowest" means."""
        name = ob.meta(pod)["name"]
        return (worker_index(name), name)

    def _assign_partial(self, pods: list[dict], cap, free=None,
                        floor: int = 1):
        """Largest placeable prefix of at least ``floor`` workers, or
        None. Gang workers are homogeneous (same selector/GPUs), so a
        deterministic index-ordered prefix loses no generality. Prefix
        placeability is monotone in k (dropping a worker from a valid
        assignment stays valid), so binary search: O(log n) full
        best-fit passes instead of O(n) on the scheduler's hot path.

        ``cap`` is a ``Capacity`` snapshot; the older
        ``(views, free)`` pair is still accepted (``free`` not None)
        and wrapped on the spot."""
        if free is not None:
            cap = CP.Capacity.from_views(cap, free)
        if floor > len(pods):
            return None
        groups = self._slice_groups(pods)
        if groups is not None:
            # slice-elastic: the world only ever holds COMPLETE slices,
            # so the admitted subset is a prefix of whole slices (lowest
            # slice ids first — slice 0 carries worker 0, the
            # coordinator pick). Same monotone binary search, over
            # slice count instead of worker count.
            sids = sorted(groups)
            per = max(len(g) for g in groups.values())
            floor_slices = max(1, -(-floor // per))
            if floor_slices > len(sids):
                return None
            best = None
            lo, hi = floor_slices, len(sids) - 1
            while lo <= hi:
                mid = (lo + hi) // 2
                subset = [p for s in sids[:mid] for p in groups[s]]
                a = self._assign(subset, cap, prefer_spot=True)
                if a is not None:
                    best = a
                    lo = mid + 1
                else:
                    hi = mid - 1
            return best
        pods = sorted(pods, key=self._replica_order)
        best = None
        lo, hi = floor, len(pods) - 1
        while lo <= hi:
            mid = (lo + hi) // 2
            a = self._assign(pods[:mid], cap, prefer_spot=True)
            if a is not None:
                best = a
                lo = mid + 1
            else:
                hi = mid - 1
        return best

    def _bind(self, client, entry, assignment: dict[str, str]) -> bool:
        """Bind the whole gang in two phases: set every spec.nodeName
        WHILE the scheduling gates still hold the kubelets off, and only
        once all binds landed lift the gates. A failure in the BIND
        phase leaves only gated (unrunnable) pods to release, so a
        kubelet polling mid-bind can never start a partial gang. A
        failure in the LIFT phase (pod deleted under us — the JAXJob
        controller tearing the gang down) can leave an already-ungated
        pod briefly runnable; the release below re-gates whatever is
        still Pending and leaves Running pods to the JAXJob controller's
        gang-restart reconciliation (a lone worker is a missing-worker
        gang restart there) — full multi-pod atomicity does not exist
        over an apiserver."""
        bound: list[str] = []
        bound_objs: dict[str, dict] = {}
        with obs_trace.TRACER.span("scheduler.bind",
                                   workers=len(assignment)) as bind_span:
            try:
                for pod_name, node_name in sorted(assignment.items()):
                    bound_objs[pod_name] = client.patch(
                        "v1", "Pod", pod_name,
                        {"spec": {"nodeName": node_name}},
                        entry.namespace)
                    self._note(bound_objs[pod_name])
                    bound.append(pod_name)
                for pod_name in sorted(assignment):
                    # the bind-phase patch response already carries the
                    # pod's gate list — one coalesced write per object,
                    # no per-pod re-GET on the hot path
                    self._lift_gate(client, entry.namespace, pod_name,
                                    cur=bound_objs[pod_name])
            except ob.ApiError as e:
                log.warning("gang %s/%s: bind failed (%s); releasing %d pods",
                            entry.namespace, entry.name, e, len(bound))
                bind_span.status = "ERROR"
                bind_span.error = f"{type(e).__name__}: {e}"
                for pod_name in bound:
                    try:
                        self._release_pod(client, entry.namespace, pod_name)
                    except ob.ApiError:
                        log.exception("gang %s/%s: release of %s failed",
                                      entry.namespace, entry.name, pod_name)
                return False
        latency = max(self.queue.clock() - entry.enqueued_at, 0.0)
        self.registry.histogram(
            "jaxjob_gang_schedule_seconds", latency,
            help_="creation -> all workers scheduled",
            buckets=SCHEDULE_LATENCY_BUCKETS)
        self.registry.histogram(
            "scheduler_bind_latency_seconds", latency,
            help_="queue-to-bound gang latency",
            buckets=BIND_LATENCY_BUCKETS,
            namespace=entry.namespace, tenant=entry.namespace)
        self.registry.counter_inc(
            "scheduler_gangs_admitted_total",
            help_="gangs fully bound", namespace=entry.namespace,
            tenant=entry.namespace)
        if self.record_events and hasattr(client, "record_event"):
            # the bind-phase patch responses already carry everything an
            # involvedObject needs — no per-pod re-GET on the hot pass
            for pod_name, node_name in sorted(assignment.items()):
                client.record_event(
                    bound_objs[pod_name], "Scheduled",
                    f"gang-bound {pod_name} to {node_name}",
                    component=SCHEDULER_NAME)
        return True

    def _repair_stragglers(self, client, namespace: str,
                           pods: list[dict]) -> bool:
        """Release half-bound leftovers: a pod that is Pending, BOUND,
        and still carrying OUR gate is the residue of a failed bind
        whose rollback also failed. Left alone it wedges its gang in
        _WAIT forever (bound pods are excluded from the pending set);
        releasing it here makes the rollback self-healing. Safe against
        our own in-flight binds: passes are serialized by _pass_lock, so
        no bind is mid-phase while this runs."""
        repaired = False
        for p in pods:
            spec = p.get("spec") or {}
            phase = (p.get("status") or {}).get("phase", "Pending")
            if phase != "Pending" or not spec.get("nodeName"):
                continue
            if not any(g.get("name") == GATE_GANG
                       for g in spec.get("schedulingGates") or []):
                continue
            try:
                self._release_pod(client, namespace, ob.meta(p)["name"])
                repaired = True
            except ob.ApiError:
                log.exception("straggler release of %s/%s failed",
                              namespace, ob.meta(p)["name"])
        return repaired

    def _lift_gate(self, client, namespace: str, pod_name: str,
                   cur: dict | None = None) -> None:
        """Remove OUR gate only — another controller's gate (a quota
        hold, say) is its to lift, never ours to clobber. ``cur`` (the
        bind-phase patch response) saves the re-GET on the hot path."""
        if cur is None:
            cur = client.get("v1", "Pod", pod_name, namespace)
        gates = [g for g in (cur.get("spec") or {}).get("schedulingGates")
                 or [] if g.get("name") != GATE_GANG]
        self._note(client.patch(
            "v1", "Pod", pod_name,
            {"spec": {"schedulingGates": gates or None}}, namespace))

    def _release_pod(self, client, namespace: str, pod_name: str) -> None:
        """Failed-bind rollback for one pod: unbind and restore OUR gate
        (preserving any foreign gates). Non-Pending pods are left alone
        — stripping a Running pod's binding would corrupt node
        accounting; the JAXJob controller owns its fate (gang restart)."""
        cur = client.get_or_none("v1", "Pod", pod_name, namespace)
        if cur is None:
            return
        if (cur.get("status") or {}).get("phase", "Pending") != "Pending":
            return
        gates = list((cur.get("spec") or {}).get("schedulingGates") or [])
        if not any(g.get("name") == GATE_GANG for g in gates):
            gates.append({"name": GATE_GANG})
        self._note(client.patch(
            "v1", "Pod", pod_name,
            {"spec": {"nodeName": None, "schedulingGates": gates}},
            namespace))

    # -- preemption ---------------------------------------------------------

    def _try_preempt(self, client, entry) -> bool:
        """Make room for a blocked gang by evicting lower-priority
        gangs, lowest first, until the blocked gang would fit. Eviction
        marks victims Failed/Evicted — the JAXJob controller's
        ``_pod_preempted`` path gang-restarts them (preemption budget,
        not the crash budget) and their recreated pods requeue behind
        the preemptor."""
        pods = self._gang_pods(client, entry.namespace, entry.name)
        pending = sorted((p for p in pods if self._unbound_pending(p)),
                         key=lambda p: ob.meta(p)["name"])
        if not pending:
            return False
        with obs_trace.TRACER.span(
                "scheduler.preempt", parent=_gang_context(pods),
                namespace=entry.namespace, gang=entry.name,
                priority=entry.priority) as sp:
            evicted = self._preempt(client, entry, pending)
            sp.attrs["evicted"] = evicted
            return evicted

    def _preempt(self, client, entry, pending: list[dict]) -> bool:
        cap = self._capacity(client)
        try:
            if self._assign(pending, cap) is not None:
                # fits without evicting anyone (state moved since the
                # failed admission attempt) — let the next pass admit it
                return False
            # only nodes the preemptor could actually use: evicting a
            # gang from a different pool (node pool/product mismatch)
            # frees nothing this gang can take, so such victims are
            # never touched
            usable = {name for name, v in cap.views.items()
                      if any(N.feasible(p, v) for p in pending)}
            # victim GPUs accumulate on ONE credits txn; each what-if
            # assignment runs on a fork so its takes never leak into
            # the next round's starting state
            credits = cap.txn()
            chosen: list[tuple[tuple[str, str], list[dict]]] = []
            for gang_key, gang_pods in self._victim_gangs(
                    client, entry.priority):
                if not any((p.get("spec") or {}).get("nodeName") in usable
                           for p in gang_pods):
                    continue
                for p in gang_pods:
                    node = (p.get("spec") or {}).get("nodeName")
                    if node in cap.free:
                        credits.credit(node, N.pod_gpu_request(p))
                chosen.append((gang_key, gang_pods))
                if self._assign(pending, cap, txn=credits.fork()) is not None:
                    self._evict(client, entry, chosen)
                    return True
            return False
        finally:
            self._count_scanned(cap)

    def _victim_gangs(self, client, priority: int):
        """Bound, non-terminal gangs of strictly lower priority, grouped
        and ordered lowest-priority first (then newest name-order last
        resort for determinism)."""
        gangs: dict[tuple[str, str], list[dict]] = {}
        prios: dict[tuple[str, str], int] = {}
        if self.cache is not None:
            self._count_read("cache")
            pods = self.cache.bound_pods()  # O(bound), no copies
        else:
            self._count_read("list")
            pods = client.list("v1", "Pod")
        for p in pods:
            spec = p.get("spec") or {}
            if spec.get("schedulerName") != SCHEDULER_NAME:
                continue
            if not spec.get("nodeName"):
                continue
            if (p.get("status") or {}).get("phase") in N.TERMINAL_PHASES:
                continue
            job = ob.labels_of(p).get(JT.LABEL_JOB_NAME)
            if not job:
                continue
            try:
                prio = int(ob.annotations_of(p).get(ANNOTATION_PRIORITY, 0))
            except ValueError:
                prio = 0
            if prio >= priority:
                continue
            key = (ob.meta(p).get("namespace") or "default", job)
            gangs.setdefault(key, []).append(p)
            prios[key] = prio
        order = sorted(gangs, key=lambda k: (prios[k], k))
        return [(k, gangs[k]) for k in order]

    def _evict(self, client, entry, chosen) -> None:
        for (ns, name), gang_pods in chosen:
            message = (f"preempted by higher-priority gang "
                       f"{entry.namespace}/{entry.name}")
            for p in gang_pods:
                cur = client.get_or_none("v1", "Pod", ob.meta(p)["name"], ns)
                if cur is None:
                    continue
                cur.setdefault("status", {})
                cur["status"].update(N.eviction_status(message))
                self._note(client.update_status(cur))
            log.info("evicted gang %s/%s: %s", ns, name, message)
            self.registry.counter_inc(
                "scheduler_preemptions_total",
                help_="gangs evicted for a higher-priority gang",
                namespace=ns, tenant=ns)
            if self.record_events and hasattr(client, "record_event") \
                    and gang_pods:
                client.record_event(gang_pods[0], "GangPreempted", message,
                                    "Warning", component=SCHEDULER_NAME)

    # -- observability ------------------------------------------------------

    def _publish_metrics(self) -> None:
        for ns, depth in self.queue.depths().items():
            self.registry.gauge(
                "scheduler_queue_depth", depth,
                help_="gangs queued awaiting admission", namespace=ns,
                tenant=ns)
        if self.cache is None:
            return
        helps = {
            "events": "watch events applied to the cluster cache",
            "stale_events": "out-of-order/replayed events dropped by "
                            "the resourceVersion guard",
            "relists": "full relists the cache performed (initial sync "
                       "+ 410/expired recoveries)",
            "resubscribes": "watch streams the cache resubscribed",
        }
        with self._stats_lock:
            stats = self.cache.stats()
            deltas = {key: stats.get(key, 0) - self._cache_stats.get(key, 0)
                      for key in helps}
            self._cache_stats = stats
        for key, help_ in helps.items():
            if deltas[key]:
                self.registry.counter_inc(
                    f"cluster_cache_{key}_total", help_=help_,
                    by=deltas[key])


def _pod_mapper(rec: GangScheduler, client):
    """A pod event maps to its own gang (kicking that gang's backoff —
    its pod set changed, retry on the new state now); a BOUND pod's
    event also enqueues the single RETRY_ALL sentinel, kicking every
    backoff when the pod's GPUs just freed — terminal phase, or the
    pod is gone from the cluster (a Running pod deleted out from under
    its gang) — so new capacity never waits out an exponential delay."""

    def fn(pod: dict) -> list[Request]:
        spec = pod.get("spec") or {}
        m = ob.meta(pod)
        reqs: dict[Request, None] = {}
        if spec.get("schedulerName") == SCHEDULER_NAME:
            job = ob.labels_of(pod).get(JT.LABEL_JOB_NAME)
            if job:
                ns = m.get("namespace") or "default"
                rec.queue.kick_one(ns, job)
                reqs[Request(ns, job)] = None
        if spec.get("nodeName") and rec.queue.depth():
            freed = (pod.get("status") or {}).get("phase") \
                in N.TERMINAL_PHASES
            if not freed:
                # mappers see objects, not event types: a DELETED
                # Running pod is recognized by its absence from the
                # store (its last state still says Running)
                freed = client.get_or_none(
                    "v1", "Pod", m["name"], m.get("namespace")) is None
            if freed:
                rec.queue.kick()
            reqs[RETRY_ALL] = None
        return list(reqs)

    return fn


def _node_mapper(rec: GangScheduler):
    """Node capacity/health changed: expire every backoff (new capacity
    must not wait out an exponential delay) and run one global pass.

    With an EMPTY queue, only an unhealthy-looking node event triggers
    the sentinel (its reconcile runs the node-health pass over bound
    gangs): a healthy node's periodic heartbeat/capacity refresh must
    not cost a full-cluster list on an idle scheduler. A node DELETED
    while Ready is the one shape this gate can miss (the event carries
    the last state); the JAXJob controller's slice-health watch treats
    a missing node as unhealthy and covers it."""

    def fn(node: dict) -> list[Request]:
        if rec.queue.depth():
            rec.queue.kick()
            return [RETRY_ALL]
        if not N.node_view(node).ready:
            return [RETRY_ALL]
        return []

    return fn


def build_scheduler(
    client,
    registry: MetricsRegistry = REGISTRY,
    record_events: bool = True,
    clock=None,
    queue: GangQueue | None = None,
    jitter: float = 0.0,
    cache: bool = True,
) -> Controller:
    """``cache=True`` (the default) runs the scheduler on an indexed
    ``ClusterCache`` — one initial list per kind, then incremental
    watch maintenance. ``cache=False`` keeps the relist-per-pass shape
    for A/B comparison (tools/sched_bench.py's "seed" arm)."""
    cluster_cache = ClusterCache(client).connect() if cache else None
    rec = GangScheduler(queue=queue, registry=registry,
                        record_events=record_events, clock=clock,
                        jitter=jitter, cache=cluster_cache)
    ctl = Controller("gang-scheduler", client, rec, registry=registry)
    if cluster_cache is not None:
        ctl.uses(cluster_cache)
    ctl.maps("v1", "Pod", _pod_mapper(rec, client))
    ctl.maps("v1", "Node", _node_mapper(rec))
    return ctl
