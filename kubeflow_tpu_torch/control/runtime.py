"""Controller engine — the controller-runtime Manager/Controller analogue.

Every reference operator follows the same kubebuilder shape: a Reconcile
function driven by watches on the primary CRD plus Owns() on generated
children, with mapped watches for side objects (e.g. the notebook
controller watches Pods via the `notebook-name` label and Events via
involvedObject — notebook_controller.go:519-613). This module provides
that machinery once:

- ``Controller``: a named workqueue of reconcile keys, fed by watches;
  dedup, rate-limited retry on error, RequeueAfter support.
- ``watches(kind)``, ``owns(kind)``, ``maps(kind, fn)`` registration.
- Two drive modes: ``run()`` (threads + watch streams, production) and
  ``run_until_idle()`` (synchronous drain for hermetic tests — processes
  events deterministically without sleeping, the fast path envtest never
  gave the reference).

Port of `kubeflow_tpu/control/runtime.py`: the same code over the port's own modules.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
from typing import Callable

from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.obs import trace as obs_trace
from kubeflow_tpu_torch.runtime.metrics import REGISTRY, MetricsRegistry

log = logging.getLogger("kubeflow_tpu_torch.control")


@dataclasses.dataclass(frozen=True)
class Request:
    namespace: str
    name: str


@dataclasses.dataclass
class Result:
    requeue_after: float | None = None  # seconds


class Reconciler:
    """Interface: reconcile(client, req) -> Result | None."""

    def reconcile(self, client, req: Request) -> Result | None:  # pragma: no cover
        raise NotImplementedError


@dataclasses.dataclass
class _Source:
    api_version: str
    kind: str
    mapper: Callable[[dict], list[Request]] | None  # None → identity (primary)


def _owner_mapper(owner_kind: str) -> Callable[[dict], list[Request]]:
    def fn(obj: dict) -> list[Request]:
        ref = ob.controller_owner(obj)
        if ref and ref.get("kind") == owner_kind:
            return [Request(ob.meta(obj).get("namespace") or "", ref["name"])]
        return []

    return fn


class Controller:
    MAX_RETRIES = 8
    # Error-retry backoff: min(RETRY_BASE * 2^attempt, RETRY_CAP).
    # Class attrs so harnesses can pin the schedule (a chaos replay sets
    # RETRY_BASE=0 to make retry timing wall-clock-free).
    RETRY_BASE = 0.01
    RETRY_CAP = 5.0
    # Conflict (409) retry window: two writers ping-ponging conflicts
    # with IMMEDIATE re-enqueue spin at CPU speed against the apiserver;
    # a small jittered delay desynchronizes them while staying far below
    # human-visible latency. (0, 0) re-enables immediate retry for
    # deterministic harnesses.
    CONFLICT_RETRY = (0.01, 0.05)

    def __init__(self, name: str, client, reconciler: Reconciler,
                 registry: MetricsRegistry | None = None, tracer=None):
        self.name = name
        self.client = client
        self.reconciler = reconciler
        self.registry = registry if registry is not None else REGISTRY
        self.tracer = tracer if tracer is not None else obs_trace.TRACER
        self._sources: list[_Source] = []
        self._primary: tuple[str, str] | None = None
        self._queue: dict[Request, None] = {}  # ordered set
        self._delayed: list[tuple[float, Request]] = []
        self._failures: dict[Request, int] = {}
        # first-enqueue time per key, for the workqueue-wait histogram
        # and the reconcile span's queue_wait_s attribute (the answer to
        # "why did my job take 40s to start" when the queue was deep)
        self._enqueued_at: dict[Request, float] = {}
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._streams: list = []
        self._resources: list = []  # lifecycle-coupled (see uses())
        self._elector = None  # set by with_leader_election
        # Pre-register the outcome counter at 0 for every result label:
        # rate()/increase() need two samples to see a delta, so a series
        # born AT its first error (value 1, then flat) never shows an
        # increase — the fleet plane's ReconcileErrorRate alert would be
        # blind to a controller's first failure window.
        for result in ("success", "requeue", "error", "conflict"):
            self.registry.counter_inc(
                "controller_reconcile_total", help_="reconciles by outcome",
                by=0.0, controller=self.name, result=result)

    # -- registration (kubebuilder For/Owns/Watches analogues) -------------

    def watches_primary(self, api_version: str, kind: str) -> "Controller":
        self._primary = (api_version, kind)
        self._sources.append(_Source(api_version, kind, None))
        return self

    def owns(self, api_version: str, kind: str) -> "Controller":
        assert self._primary, "call watches_primary first"
        self._sources.append(_Source(api_version, kind, _owner_mapper(self._primary[1])))
        return self

    def maps(
        self, api_version: str, kind: str, fn: Callable[[dict], list[Request]]
    ) -> "Controller":
        self._sources.append(_Source(api_version, kind, fn))
        return self

    def uses(self, resource) -> "Controller":
        """Attach a lifecycle-coupled resource — e.g. a ``ClusterCache``
        whose watch pumps must run exactly as long as this controller's
        threads do. ``run()`` calls each resource's ``start()``,
        ``stop()`` its ``stop()``. Hermetic ``run_until_idle`` drives
        such resources synchronously instead (the reconciler calls
        ``refresh()``), so no threads are started for them there."""
        self._resources.append(resource)
        return self

    # -- queue --------------------------------------------------------------

    def enqueue(self, req: Request) -> None:
        with self._cv:
            self._queue[req] = None
            self._enqueued_at.setdefault(req, time.monotonic())
            self._report_depth_locked()
            self._cv.notify_all()

    def enqueue_after(self, req: Request, delay: float) -> None:
        with self._cv:
            self._delayed.append((time.monotonic() + delay, req))
            self._cv.notify_all()

    def _report_depth_locked(self) -> None:
        """Publish the depth gauge WHILE holding _cv: read+report must be
        atomic against other reporters, or a stale depth published late
        overwrites a newer one and the gauge sticks wrong on an idle
        queue. (_cv -> registry lock only, never the reverse.)"""
        self.registry.gauge(
            "workqueue_depth", len(self._queue),
            help_="reconcile keys queued, per controller",
            controller=self.name)

    def _dispatch(self, src: _Source, obj: dict) -> None:
        if src.mapper is None:
            m = ob.meta(obj)
            self.enqueue(Request(m.get("namespace") or "", m["name"]))
        else:
            for req in src.mapper(obj):
                self.enqueue(req)

    def _pump_delayed(self) -> float | None:
        """Move due delayed items into the queue; return next due in secs."""
        now = time.monotonic()
        due = [r for t, r in self._delayed if t <= now]
        self._delayed = [(t, r) for t, r in self._delayed if t > now]
        for r in due:
            self._queue[r] = None
            # queue wait counts from (re)entry into the hot queue, not
            # from when the requeue-after timer was armed
            self._enqueued_at.setdefault(r, now)
        if self._delayed:
            return max(0.0, min(t for t, _ in self._delayed) - now)
        return None

    def _process_one(self, req: Request) -> None:
        now = time.monotonic()
        with self._cv:
            t_enq = self._enqueued_at.pop(req, None)
            attempt = self._failures.get(req, 0) + 1
            self._report_depth_locked()
        wait = max(now - t_enq, 0.0) if t_enq is not None else 0.0
        self.registry.histogram(
            "workqueue_wait_seconds", wait,
            help_="time a reconcile key spent queued before processing",
            controller=self.name)
        result = "success"
        t0 = time.perf_counter()
        # nothing may sit between begin() and the try whose finally
        # finishes the span — a raise in that window orphans it (RES704)
        span = self.tracer.begin(
            "reconcile", controller=self.name, namespace=req.namespace,
            object=req.name, attempt=attempt, queue_wait_s=round(wait, 6))
        try:
            res = self.reconciler.reconcile(self.client, req)
            with self._cv:
                self._failures.pop(req, None)
            if res and res.requeue_after:
                result = "requeue"
                self.enqueue_after(req, res.requeue_after)
        except ob.Conflict:
            # optimistic-concurrency loser: benign retry after a small
            # jittered delay (immediate re-enqueue lets two writers
            # ping-pong 409s at CPU speed — a conflict hot-spin)
            result = "conflict"
            lo, hi = self.CONFLICT_RETRY
            delay = random.uniform(lo, hi) if hi > 0 else 0.0
            if delay > 0:
                self.enqueue_after(req, delay)
            else:
                self.enqueue(req)
        except Exception as e:
            result = "error"
            span.status = "ERROR"
            span.error = f"{type(e).__name__}: {e}"
            with self._cv:
                n = self._failures.get(req, 0) + 1
                self._failures[req] = n
            self.registry.counter_inc(
                "controller_reconcile_retries_total",
                help_="reconciles retried after an error",
                controller=self.name)
            if n <= self.MAX_RETRIES:
                log.exception("%s: reconcile %s failed (attempt %d)", self.name, req, n)
                self.enqueue_after(
                    req, min(self.RETRY_BASE * (2 ** n), self.RETRY_CAP))
            else:
                log.error("%s: reconcile %s dropped after %d attempts", self.name, req, n)
                # dropping ends this failure streak: a later event-driven
                # reconcile of the same key starts from attempt 1 with a
                # full retry budget (and a truthful span attribute)
                with self._cv:
                    self._failures.pop(req, None)
        finally:
            span.attrs["result"] = result
            self.tracer.finish(span)
            self.registry.counter_inc(
                "controller_reconcile_total",
                help_="reconciles by outcome",
                controller=self.name, result=result)
            self.registry.histogram(
                "controller_reconcile_seconds", time.perf_counter() - t0,
                help_="reconcile latency", controller=self.name)

    # -- production mode ----------------------------------------------------

    def run(self, workers: int = 1) -> "Controller":
        """Start watch threads + worker threads; returns immediately."""
        for resource in self._resources:
            resource.start()
        for src in self._sources:
            stream = self.client.watch(src.api_version, src.kind)
            with self._cv:
                self._streams.append(stream)
            t = threading.Thread(
                target=self._watch_loop, args=(src, stream), daemon=True,
                name=f"{self.name}-watch-{src.kind}",
            )
            t.start()
        # seed with existing objects (informer initial list)
        for src in self._sources:
            for obj in self.client.list(src.api_version, src.kind):
                self._dispatch(src, obj)
        for i in range(workers):
            threading.Thread(
                target=self._worker, daemon=True, name=f"{self.name}-worker-{i}"
            ).start()
        return self

    def _watch_loop(self, src: _Source, stream) -> None:
        """Pump one watch stream into the queue — and OUTLIVE it. A
        stream that raises (or ends while we are still running) would
        otherwise silently kill this thread and the controller would
        never see another {kind} event; instead resubscribe and relist
        (the level-triggered resync) after a short pause."""
        while not self._stop.is_set():
            try:
                for ev in stream:
                    if self._stop.is_set():
                        return
                    self._dispatch(src, ev.object)
            except Exception:
                log.exception("%s: watch stream for %s failed; resubscribing",
                              self.name, src.kind)
            if self._stop.is_set():
                return
            self._stop.wait(0.2)
            try:
                new_stream = self.client.watch(src.api_version, src.kind)
            except Exception:
                log.exception("%s: watch resubscribe for %s failed; will "
                              "retry", self.name, src.kind)
                continue
            # REPLACE the dead stream's slot (never append): a
            # long-lived controller resubscribing across apiserver
            # restarts must not grow _streams — or leak the dead
            # stream's socket — forever
            with self._cv:
                try:
                    self._streams.remove(stream)
                except ValueError:
                    pass
                self._streams.append(new_stream)
            try:
                stream.stop()
            except Exception:
                pass
            stream = new_stream
            try:
                for obj in self.client.list(src.api_version, src.kind):
                    self._dispatch(src, obj)
            except Exception:
                log.exception("%s: post-resubscribe relist for %s failed; "
                              "stream is live, next events resync",
                              self.name, src.kind)

    def _worker(self) -> None:
        while not self._stop.is_set():
            if not self._may_lead():
                # standby: watches stay subscribed, work queues up, but
                # nothing reconciles until the lease is ours
                self._stop.wait(0.5)
                continue
            req = None
            with self._cv:
                timeout = self._pump_delayed()
                if not self._queue:
                    # bounded wait, then fall through to the outer loop:
                    # an IDLE leader must keep renewing its lease (the
                    # elector caches, so this is a local check most
                    # rounds, one apiserver renew per lease_seconds/3)
                    self._cv.wait(timeout=min(timeout, 0.2) if timeout else 0.2)
                    self._pump_delayed()
                if self._queue:
                    req = next(iter(self._queue))
                    del self._queue[req]
            if req is None:
                continue
            if not self._may_lead():
                # lost the lease between pop and process: hand the item
                # back rather than reconcile as a deposed leader
                self.enqueue(req)
                continue
            self._process_one(req)

    def stop(self) -> None:
        self._stop.set()
        for s in self._streams:
            s.stop()
        for resource in self._resources:
            resource.stop()
        with self._cv:
            self._cv.notify_all()

    # -- hermetic test mode -------------------------------------------------

    def _drain_streams(self) -> None:
        """Pull pending watch events synchronously (test mode)."""
        for stream in self._streams:
            if not hasattr(stream, "poll"):
                continue
            while True:
                ev = stream.poll()
                if ev is None:
                    break
                for src in self._sources:
                    if (src.api_version, src.kind) == (
                        ev.object.get("apiVersion"),
                        ev.object.get("kind"),
                    ):
                        self._dispatch(src, ev.object)

    def with_leader_election(self, elector) -> "Controller":
        """Only reconcile while holding the lease (the reference's
        --enable-leader-election manager capability): watches keep
        accumulating work so a standby is current the moment it takes
        over, but _process_one runs only on the leader."""
        self._elector = elector
        return self

    def _may_lead(self) -> bool:
        return self._elector is None or self._elector.try_acquire()

    def run_until_idle(self, max_rounds: int = 200, advance_delayed: bool = False) -> int:
        """Synchronously drain the queue (and watch events) until no work
        remains. Returns the number of reconciles performed. With
        advance_delayed, due-in-the-future requeues fire immediately once
        per drain (so culling/requeue paths are testable without sleeping).
        """
        done = 0
        if not self._may_lead():
            self._drain_streams()  # stay current on standby
            return 0
        for _ in range(max_rounds):
            self._drain_streams()
            # queue surgery under the condition lock: the drain is
            # single-threaded by contract, but nothing stops a caller
            # from draining while run() workers are live, and unlocked
            # dict/list mutation here would tear their state
            with self._cv:
                self._pump_delayed()
                if not self._queue and advance_delayed and self._delayed:
                    now = time.monotonic()
                    for _, r in self._delayed:
                        self._queue[r] = None
                        self._enqueued_at.setdefault(r, now)
                    self._delayed = []
                    advance_delayed = False  # one synthetic advance per call
                if not self._queue:
                    break
                req = next(iter(self._queue))
                del self._queue[req]
            # reconcile outside the lock: holding _cv through a reconcile
            # would serialize this drain against every run() worker
            self._process_one(req)
            done += 1
        return done


class Manager:
    """Holds controllers sharing one client; mirrors ctrl.Manager."""

    def __init__(self, client):
        self.client = client
        self.controllers: list[Controller] = []

    def add(self, controller: Controller) -> Controller:
        self.controllers.append(controller)
        return controller

    def start(self, workers: int = 1) -> None:
        for c in self.controllers:
            c.run(workers=workers)

    def stop(self) -> None:
        for c in self.controllers:
            c.stop()

    def run_until_idle(self, rounds: int = 10) -> int:
        """Drain all controllers to a fixpoint (cross-controller cascades:
        e.g. Profile creates a Namespace that another controller watches)."""
        total = 0
        for _ in range(rounds):
            did = 0
            for c in self.controllers:
                did += c.run_until_idle()
            total += did
            if did == 0:
                break
        return total


def seed_controller(c: Controller) -> Controller:
    """Test-mode wiring: subscribe watches (poll-driven) + initial list,
    without starting threads. Use with run_until_idle()."""
    for src in c._sources:
        stream = c.client.watch(src.api_version, src.kind)
        with c._cv:
            c._streams.append(stream)
    for src in c._sources:
        for obj in c.client.list(src.api_version, src.kind):
            c._dispatch(src, obj)
    return c
