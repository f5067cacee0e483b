"""Token-aware serving router (port of kubeflow_tpu/serving/router.py):
the front door over N replica servers (`serving/server.py`).

Replica choice is least-outstanding-TOKENS, not least-connections:
decode cost scales with tokens (prompt prefill + requested
continuation), so one 2k-token request weighs as much as thirty short
ones, and balancing on request counts would pile long prompts onto one
replica while its neighbors idle.

A DETERMINISTIC synchronous core (`TokenRouter`: every transition
happens in an explicit call under one lock, clock injectable) under a
thin threaded/HTTP shell (`RouterFrontend`):

- bounded admission queue: `submit` beyond `max_queue` raises
  `RouterBusy` (the HTTP shell's 429), backpressure instead of an
  unbounded latency cliff;
- membership comes from the endpoints list (`ANNOTATION_ENDPOINTS`'s
  wire format, or `--endpoints`): only active replicas receive work, a
  cordoned replica finishes its in-flight tokens but admits nothing
  new, and a replica REMOVED from membership has its in-flight requests
  shed back to the queue FRONT and re-dispatched to survivors;
- resilience (`ResilienceConfig`): deadlines, criticality bands shed
  under overload, per-replica circuit breakers, hedged dispatch and a
  per-tenant retry budget;
- every dispatch opens a `router.dispatch` span parented on the
  request's W3C traceparent (`obs/trace.py`).

Metrics (`router_queue_depth`, `router_tokens_inflight{replica}`,
`router_request_seconds`, `router_tokens_total`, ...) go to the port's
MetricsRegistry, rendered at `/metrics`; `RegistrySignals` reads them
back. The reference also mirrors them into prometheus_client, which
the port does not use. `main(--apiserver)` takes its membership from
the JAXService endpoints annotation (`control/jaxservice`).
"""

from __future__ import annotations

import collections
import json
import logging
import math
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from kubeflow_tpu_torch.obs import trace as obs_trace
from kubeflow_tpu_torch.runtime.metrics import REGISTRY, MetricsRegistry

log = logging.getLogger("kubeflow_tpu_torch.serving.router")

# The controller -> router membership wire contract: a JSON list of
# {"name", "addr", "state"} stamped on the JAXService object. "active"
# members take new work; "cordoned" members only drain.
ANNOTATION_ENDPOINTS = "jaxservice.kubeflow.org/endpoints"
STATE_ACTIVE = "active"
STATE_CORDONED = "cordoned"

# Request-latency buckets: sub-second cache hits up to multi-minute
# long-context decodes under queueing.
REQUEST_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                   60.0, 120.0, 300.0)

# Criticality bands: under overload the router sheds the HIGHEST rank
# first, so interactive traffic survives a batch-traffic wave.
# Namespace-defaulted through the JAXService spec (`resilience_spec`).
BAND_CRITICAL = "critical"
BAND_DEFAULT = "default"
BAND_SHEDDABLE = "sheddable"
BAND_RANK = {BAND_CRITICAL: 0, BAND_DEFAULT: 1, BAND_SHEDDABLE: 2}
BANDS = tuple(BAND_RANK)

# Circuit-breaker states (gauge values for router_breaker_state)
BREAKER_CLOSED = "closed"
BREAKER_HALF_OPEN = "half-open"
BREAKER_OPEN = "open"
_BREAKER_GAUGE = {BREAKER_CLOSED: 0, BREAKER_HALF_OPEN: 1, BREAKER_OPEN: 2}

# Request headers the shell understands (and forwards replica-ward):
# the remaining deadline budget in seconds — it SHRINKS across retry
# hops — the criticality band, and the tenant the request bills to
# (defaulted from the JAXService namespace; the chargeback dimension).
HEADER_DEADLINE = "x-request-deadline-s"
HEADER_BAND = "x-request-band"
HEADER_TENANT = "x-request-tenant"

# A tenant is a kubernetes namespace (or an explicit header override
# spelled the same way): DNS-1123 label. Anything else is a 400 at the
# shell — unbounded attacker-chosen label values would otherwise flow
# straight into the metric exposition.
TENANT_RE = re.compile(r"^[a-z0-9]([a-z0-9-]{0,61}[a-z0-9])?$")

# The outcomes every tenant's router_requests_total series is
# pre-registered at 0 for on first sight (rate() needs a 0-sample
# BEFORE the first error, or a fresh tenant's first failure never
# fires its burn rule).
TENANT_OUTCOMES = ("completed", "failed", "rejected", "deadline",
                   "shed", "shed_band")

# "argument not provided" sentinel for set_members(canary=...): None
# means "clear the split", absence means "leave it alone"
_KEEP = object()

class RouterBusy(Exception):
    """Admission queue full — the HTTP shell's 429 Too Many Requests.
    ``retry_after`` (seconds, derived from the queue drain rate) rides
    along so the 429 response can carry a Retry-After header."""

    retry_after: float | None = None


class DeadlineExceeded(Exception):
    """The request's deadline elapsed before it could be served — the
    HTTP shell's 504. Raised by ``submit`` for dead-on-arrival requests
    and by the continuous batcher when it cancels an expired slot."""


@dataclass
class ResilienceConfig:
    """Tuning for the request-resilience layer. ``TokenRouter`` built
    WITHOUT one (the default) behaves exactly like the pre-resilience
    router — same pick key, same FIFO drain, no breakers/hedges — so
    decision replays of the plain router stay byte-identical."""

    # EWMA smoothing for per-replica completion latency
    ewma_alpha: float = 0.3
    # consecutive transport failures that trip a breaker open
    breaker_failures: int = 3
    # open -> half-open probe delay (seconds on the router clock)
    breaker_cooloff_s: float = 5.0
    # hedge after this quantile of recent completion latencies...
    hedge_quantile: float = 0.95
    # ...but never sooner than this (protects against hedging every
    # request when the fleet is uniformly fast)
    hedge_min_s: float = 0.25
    # minimum completed samples before hedging activates
    hedge_min_samples: int = 16
    # token-bucket retry budget: refilled per ADMITTED request, spent
    # 1.0 per retry or hedge — a failing fleet cannot amplify its own
    # load beyond ~ratio of offered traffic
    retry_budget_ratio: float = 0.1
    retry_budget_cap: float = 32.0
    # completion-latency window feeding the hedge quantile
    latency_window: int = 128


class _Health:
    """Per-replica health the breaker and scorer read. Lives outside
    membership so a replica that flaps out and back keeps its history."""

    __slots__ = ("lat", "fails", "state", "opened_at", "probing")

    def __init__(self) -> None:
        self.lat: float | None = None   # EWMA completion latency (s)
        self.fails = 0                  # consecutive transport failures
        self.state = BREAKER_CLOSED
        self.opened_at = 0.0
        self.probing = False            # half-open probe outstanding


@dataclass
class Member:
    """One routable replica. ``transport`` is whatever the shell uses
    to reach it (an HTTP base URL, an in-process callable, a bench
    stub) — the core never calls it, it only hands it back on
    dispatch. ``revision`` is the JAXService revision label the
    controller stamped on the replica's pod ("" for pre-rollout
    endpoints) — the canary split routes on it."""

    name: str
    transport: Any = None
    state: str = STATE_ACTIVE
    revision: str = ""


@dataclass
class Ticket:
    """One request's journey through the router. ``member`` is set at
    dispatch (None while queued); ``done`` fires on dispatch AND on
    completion so a blocking shell can wait on either transition.
    ``tried`` holds replicas whose transport already FAILED this
    ticket — re-dispatch prefers anyone else (the name-tie-break would
    otherwise send every retry straight back to the dead replica)."""

    tokens: int
    item: Any = None
    context: "obs_trace.SpanContext | None" = None
    member: Member | None = None
    done: threading.Event = field(default_factory=threading.Event,
                                  repr=False)
    tried: set = field(default_factory=set, repr=False)
    _t0: float = 0.0
    _span: "obs_trace.Span | None" = field(default=None, repr=False)
    _queued_at: float = 0.0
    # -- resilience layer -----------------------------------------------
    band: str = BAND_DEFAULT
    deadline: float | None = None       # absolute, on the router clock
    # the namespace this request bills to (chargeback attribution);
    # "" means "the router's own namespace" — submit() resolves it
    tenant: str = ""
    hedge_member: Member | None = field(default=None, repr=False)
    # why the router dropped this ticket without the shell asking
    # ("deadline" / "shed_band" / "retry_budget"); the shell maps it to
    # 504 / 429 / 503 after its done-event fires
    dropped_reason: str | None = None
    retry_after: float | None = None    # rides with "shed_band" drops
    # terminally resolved (completed, or failed without requeue) — the
    # shell's last-resort abandon path keys off this so an exception
    # AFTER resolution never double-resolves the ticket
    resolved: bool = False
    _dispatched_at: float = 0.0
    _hedge_at: float = 0.0
    # -- rollout layer ---------------------------------------------------
    # the revision of the replica that served (or is serving) this
    # request — stamped at dispatch, re-stamped if a hedge leg wins, and
    # carried into the revision label on router_requests_total /
    # router_request_seconds (the canary-vs-baseline burn dimension)
    revision: str = ""
    # the canary draw: (canary_revision, wants_canary) decided ONCE at
    # admission from the deterministic seeded sequence; None = no canary
    # active. A soft preference — availability beats the ladder.
    _canary_pref: Any = field(default=None, repr=False)


def estimate_tokens(instances: list, max_new_tokens: int) -> int:
    """The in-flight cost estimate for a predict body: prompt tokens
    (prefill) plus the full requested continuation per row. An estimate
    on purpose — the router needs relative weight, not billing."""
    total = 0
    for inst in instances or [None]:
        row = inst.get("tokens") if isinstance(inst, dict) else inst
        total += (len(row) if hasattr(row, "__len__") else 1)
        total += max_new_tokens
    return max(total, 1)


class TokenRouter:
    """Deterministic least-outstanding-tokens dispatcher.

    All state lives under one lock and is mutated only in locked
    methods; transports
    are never invoked here, so no I/O happens under the lock.
    """

    def __init__(self, service: str = "default", namespace: str = "default",
                 max_queue: int = 256,
                 replica_token_budget: int | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 registry: MetricsRegistry | None = None,
                 tracer=None,
                 resilience: ResilienceConfig | None = None,
                 on_decision: Callable[[dict], None] | None = None,
                 canary_seed: int = 0):
        self.service = service
        self.namespace = namespace
        self.max_queue = max_queue
        # max outstanding tokens a replica accepts before the router
        # queues instead (None = always eligible; the least-loaded
        # replica still wins). Roughly slots * (prompt + continuation).
        self.replica_token_budget = replica_token_budget
        self.clock = clock
        self.registry = registry if registry is not None else REGISTRY
        self.tracer = tracer if tracer is not None else obs_trace.TRACER
        # None = legacy behavior, decision-for-decision
        self.resilience = resilience
        # deterministic decision tap for the resilience bench: called
        # UNDER the lock with {"kind", "t", ...} on breaker transitions,
        # hedges, band sheds, and deadline drops
        self.on_decision = on_decision
        self._lock = threading.Lock()
        self._members: dict[str, Member] = {}
        self._inflight: dict[str, dict[int, Ticket]] = {}  # name -> tickets
        self._tokens: dict[str, int] = {}                  # name -> estimate
        self._queue: list[Ticket] = []
        self._closed = False
        self._health: dict[str, _Health] = {}              # name -> health
        self._lat_samples: collections.deque = collections.deque(
            maxlen=(resilience.latency_window if resilience else 64))
        # recent completion stamps -> queue drain rate -> Retry-After
        self._completions: collections.deque = collections.deque(maxlen=64)
        # per-TENANT retry/hedge token buckets: one
        # tenant's retry storm drains only its own bucket. The sum is
        # bounded by retry_budget_cap; a new tenant seeds with whatever
        # headroom remains (the first tenant gets the full cap, so the
        # single-tenant banked replays are unchanged).
        self._retry_tokens: dict[str, float] = {}
        # tenants whose counter families are already pre-registered
        self._tenants: set[str] = set()
        # canary split state: (revision, weight) the controller is
        # currently canarying, plus the deterministic draw sequence —
        # seeded so benches replay decision-for-decision
        self._canary: tuple[str, float] | None = None
        self._canary_seed = int(canary_seed)
        self._canary_seq = 0

    # -- membership (controller-fed) ----------------------------------------

    def sync_endpoints(self, endpoints: list[dict],
                       transport_factory: Callable[[dict], Any] | None = None,
                       ) -> list[Ticket]:
        """Apply a controller-published endpoint list (the parsed
        ``ANNOTATION_ENDPOINTS`` value). Returns the tickets re-DISPATCHED
        after shedding removed members (see ``set_members``). Endpoint
        entries may carry ``revision`` (the pod's revision label) and a
        ``canary`` weight — present on the canaried revision's entries
        while a rollout analyzes; absent entries mean no split."""
        members = []
        canary: tuple[str, float] | None = None
        for ep in endpoints:
            name = ep.get("name")
            if not name:
                continue
            rev = ep.get("revision") or ""
            members.append(Member(
                name=name,
                transport=(transport_factory(ep) if transport_factory
                           else ep.get("addr")),
                state=(STATE_CORDONED if ep.get("state") == STATE_CORDONED
                       else STATE_ACTIVE),
                revision=rev))
            w = ep.get("canary")
            if rev and isinstance(w, (int, float)) \
                    and not isinstance(w, bool):
                canary = (rev, float(w))
        return self.set_members(members, canary=canary)

    def sync_from_object(self, service_obj: dict,
                         transport_factory=None) -> list[Ticket]:
        """Membership straight from a JAXService object (a watch-driven
        shell calls this per event)."""
        return self.sync_endpoints(
            parse_endpoints(service_obj), transport_factory)

    def set_members(self, members: list[Member],
                    canary: "tuple[str, float] | None | object" = _KEEP,
                    ) -> list[Ticket]:
        """Replace membership. A member that disappears sheds its
        in-flight tickets back to the queue FRONT (oldest first) and a
        drain pass re-dispatches to survivors — the zero-drop half of
        the replica-kill drill. Returns the newly dispatched tickets so
        a synchronous caller can start their work on the survivors.
        ``canary`` sets the (revision, weight) split alongside the
        membership swap (None clears it); omitted = left unchanged, so
        pre-rollout callers keep their exact behavior."""
        with self._lock:
            now = self.clock()
            new = {m.name: m for m in members}
            shed: list[Ticket] = []
            if canary is not _KEEP:
                self._canary = canary  # type: ignore[assignment]
            for name in list(self._members):
                if name not in new:
                    shed.extend(self._shed_member_locked(name, now))
            for name, m in new.items():
                cur = self._members.get(name)
                if cur is None:
                    self._members[name] = m
                    self._inflight.setdefault(name, {})
                    self._tokens.setdefault(name, 0)
                    self._publish_inflight_locked(name)
                else:
                    cur.state = m.state
                    cur.transport = m.transport
                    cur.revision = m.revision
            # requeue shed tickets at the FRONT, original order. done is
            # CLEARED: a blocking shell waiting on this ticket must park
            # until the re-dispatch below (or a later drain) fires it
            # again — a stale set() would busy-spin its retry loop
            for t in reversed(shed):
                t.member = None
                t.done.clear()
                self._queue.insert(0, t)
            dispatched = self._drain_locked(now)
            self._publish_queue_locked()
        for t in dispatched:
            t.done.set()
        return dispatched

    def cordon(self, name: str) -> None:
        """Stop NEW dispatch to a replica; in-flight work finishes
        (connection draining). The controller cordons before delete."""
        with self._lock:
            m = self._members.get(name)
            if m is not None:
                m.state = STATE_CORDONED

    def uncordon(self, name: str) -> None:
        with self._lock:
            m = self._members.get(name)
            if m is not None:
                m.state = STATE_ACTIVE
        self.kick()

    def set_canary(self, revision: str | None,
                   weight: float = 0.0) -> None:
        """Set (or clear, with ``revision=None``) the canary split: new
        admissions draw from the seeded sequence and prefer the canary
        revision with probability ``weight``. A preference, not a
        partition — when the preferred side has no eligible replica the
        other side serves (availability beats the ladder)."""
        with self._lock:
            self._canary = (None if revision is None
                            else (revision, float(weight)))

    def canary(self) -> "tuple[str, float] | None":
        with self._lock:
            return self._canary

    def _shed_member_locked(self, name: str, now: float) -> list[Ticket]:
        """Remove a member; return its in-flight tickets oldest-first."""
        self._members.pop(name, None)
        tickets = sorted(self._inflight.pop(name, {}).values(),
                         key=lambda t: t._t0)
        self._tokens.pop(name, None)
        for t in tickets:
            if t._span is not None:
                # the dispatch to the dead replica exports as ERROR; the
                # re-dispatch below opens a fresh span in the same trace
                t._span.status = "ERROR"
                t._span.error = f"replica {name} lost; shed to survivors"
                self.tracer.finish(t._span)
                t._span = None
            self._count_locked("shed", t.tenant, t.revision)
        self.registry.gauge(
            "router_tokens_inflight", 0,
            help_="outstanding token estimate per replica",
            namespace=self.namespace, service=self.service, replica=name)
        return tickets

    # -- admission -----------------------------------------------------------

    def submit(self, tokens: int, item: Any = None,
               context: "obs_trace.SpanContext | None" = None,
               band: str = BAND_DEFAULT,
               deadline: float | None = None,
               tenant: str | None = None) -> Ticket:
        """Admit one request of ``tokens`` estimated cost. Dispatches
        immediately to the least-loaded eligible replica, else queues;
        raises ``RouterBusy`` (429) when the bounded queue is full —
        unless a strictly-less-critical ticket is queued, in which case
        THAT one is shed instead (band shedding; resilience mode only).
        ``deadline`` is absolute on the router clock; a dead-on-arrival
        request raises ``DeadlineExceeded`` (504) without queueing.
        ``tenant`` is the namespace this request bills to (chargeback
        attribution); None/empty defaults to the router's namespace."""
        t = Ticket(tokens=int(tokens), item=item, context=context,
                   band=band if band in BAND_RANK else BAND_DEFAULT,
                   deadline=deadline, tenant=tenant or self.namespace)
        victim: Ticket | None = None
        expired: list[Ticket] = []
        try:
            with self._lock:
                if self._closed:
                    raise RouterBusy("router is shut down")
                now = self.clock()
                t._t0 = t._queued_at = now
                self._register_tenant_locked(t.tenant)
                if self.resilience is not None:
                    self._refill_budget_locked(t.tenant)
                if self._canary is not None:
                    t._canary_pref = self._canary_draw_locked()
                if t.deadline is not None and now >= t.deadline:
                    self._drop_deadline_locked(t, now)
                    raise DeadlineExceeded(
                        "deadline elapsed before admission")
                expired = self._sweep_deadlines_locked(now)
                member = self._pick_locked(t.tokens, pref=t._canary_pref)
                if member is not None:
                    self._dispatch_locked(t, member, now)
                elif len(self._queue) >= self.max_queue:
                    victim = self._shed_band_locked(t, now)
                    if victim is None:
                        self._count_locked("rejected", t.tenant)
                        e = RouterBusy(
                            f"admission queue full ({self.max_queue})")
                        e.retry_after = self._retry_after_locked(now)
                        self._publish_queue_locked()
                        raise e
                    self._queue.append(t)
                else:
                    self._queue.append(t)
                self._publish_queue_locked()
        finally:
            # fire drop notifications even on the raise paths — a shell
            # thread parked on a swept/shed ticket must wake regardless
            # of how THIS submit exits
            for dead in expired:
                dead.done.set()
            if victim is not None:
                victim.done.set()
        if t.member is not None:
            t.done.set()
        return t

    def _shed_band_locked(self, t: Ticket, now: float) -> Ticket | None:
        """Full queue + new arrival: evict the NEWEST queued ticket of
        the most-sheddable band strictly less critical than the
        arrival. Returns the victim (caller fires its done event), or
        None when nothing queued is less critical — then the ARRIVAL is
        the right thing to reject."""
        if self.resilience is None or not self._queue:
            return None
        my_rank = BAND_RANK.get(t.band, BAND_RANK[BAND_DEFAULT])
        ranks = [BAND_RANK.get(q.band, BAND_RANK[BAND_DEFAULT])
                 for q in self._queue]
        worst = max(ranks)
        if worst <= my_rank:
            return None
        idx = len(ranks) - 1 - ranks[::-1].index(worst)
        victim = self._queue.pop(idx)
        victim.dropped_reason = "shed_band"
        victim.retry_after = self._retry_after_locked(now)
        self._count_locked("shed_band", victim.tenant)
        self.registry.counter_inc(
            "router_shed_total",
            help_="queued requests evicted by criticality band under "
                  "overload",
            namespace=self.namespace, service=self.service,
            tenant=victim.tenant or self.namespace, band=victim.band)
        self._decide_locked("shed", now, band=victim.band)
        return victim

    def complete(self, ticket: Ticket, tokens_done: int | None = None,
                 winner: str | None = None) -> list[Ticket]:
        """Mark a dispatched ticket finished; drain the queue into the
        freed capacity. Returns newly dispatched tickets (their
        ``member`` set) for synchronous callers. ``winner`` names the
        replica whose response was used (a hedged ticket has two legs;
        the loser's accounting is released here and its leg canceled).

        Shed-race safe, symmetric to ``fail``: if a concurrent
        membership sync shed this ticket back into the queue while its
        transport call was succeeding, the queued copy is removed here
        — the handler thread has already returned the response, so a
        re-dispatch would permanently inflate the survivor's in-flight
        accounting (nobody is left to complete it) and wedge its drain
        gate."""
        with self._lock:
            now = self.clock()
            if ticket.member is None:
                self._queue = [t for t in self._queue if t is not ticket]
            hedge_won = self._resolve_hedge_locked(ticket, winner, now)
            if self.resilience is not None and ticket.member is not None:
                wname = winner or ticket.member.name
                start = ticket._hedge_at if hedge_won \
                    else ticket._dispatched_at
                sample = max(now - start, 0.0)
                self._record_success_locked(wname, sample, now)
                self._lat_samples.append(sample)
            self._completions.append(now)
            self._finish_locked(ticket, now, tokens_done)
            expired = self._sweep_deadlines_locked(now)
            dispatched = self._drain_locked(now)
            self._publish_queue_locked()
        for t in expired:
            t.done.set()
        for t in dispatched:
            t.done.set()
        return dispatched

    def _resolve_hedge_locked(self, ticket: Ticket, winner: str | None,
                              now: float) -> bool:
        """Release the hedge leg's accounting; True when the hedge leg
        is the winner (latency/health credit then belongs to it)."""
        h = ticket.hedge_member
        if h is None:
            return False
        ticket.hedge_member = None
        if h.name in self._tokens:
            self._tokens[h.name] = max(
                0, self._tokens.get(h.name, 0) - ticket.tokens)
            self._publish_inflight_locked(h.name)
        won = winner is not None and winner == h.name
        self._hedge_count_locked("won" if won else "canceled")
        if won:
            # the hedge replica served the response: its revision is
            # the one the latency/outcome labels should bill
            ticket.revision = h.revision
            self._decide_locked("hedge_win", now, replica=h.name)
        return won

    def fail(self, ticket: Ticket, requeue: bool = True) -> list[Ticket]:
        """A transport-level failure for one dispatched ticket: take it
        off its replica and (by default) requeue it at the FRONT for a
        retry on whoever is least loaded now. ``requeue=False`` drops
        it (the caller is surfacing the error to its client).

        Safe against the shed race: if a concurrent membership sync
        already shed this ticket back into the queue (``member`` is
        None), a requeue is a no-op — inserting it AGAIN would have it
        dispatched twice and permanently inflate a replica's in-flight
        accounting — and a drop removes it from the queue so nothing
        ghost-dispatches a request whose handler thread has given up."""
        with self._lock:
            now = self.clock()
            member = ticket.member
            if member is not None:
                # remember the failed transport: the retry must prefer
                # any OTHER replica (least-loaded + name-tie would
                # otherwise re-pick the dead one forever)
                ticket.tried.add(member.name)
                bucket = self._inflight.get(member.name)
                if bucket is not None and bucket.pop(id(ticket), None) \
                        is not None:
                    self._tokens[member.name] = max(
                        0, self._tokens.get(member.name, 0) - ticket.tokens)
                    self._publish_inflight_locked(member.name)
                if self.resilience is not None:
                    self._record_failure_locked(member.name, now)
            # a hedged ticket fails as a WHOLE (the shell only calls
            # fail after both legs failed or it is giving up): release
            # the hedge leg's accounting and penalize it too
            h = ticket.hedge_member
            if h is not None:
                ticket.hedge_member = None
                ticket.tried.add(h.name)
                if h.name in self._tokens:
                    self._tokens[h.name] = max(
                        0, self._tokens.get(h.name, 0) - ticket.tokens)
                    self._publish_inflight_locked(h.name)
                if self.resilience is not None:
                    self._record_failure_locked(h.name, now)
                self._hedge_count_locked("canceled")
            if ticket._span is not None:
                ticket._span.status = "ERROR"
                ticket._span.error = "transport failure"
                self.tracer.finish(ticket._span)
                ticket._span = None
            ticket.member = None
            if requeue and self.resilience is not None:
                # retries draw on the deadline AND the retry budget: an
                # expired or budget-less ticket drops instead, with the
                # reason stamped for the shell (504 / 503)
                if ticket.deadline is not None and now >= ticket.deadline:
                    requeue = False
                    ticket.dropped_reason = "deadline"
                elif not self._spend_budget_locked(1.0, ticket.tenant):
                    requeue = False
                    ticket.dropped_reason = "retry_budget"
                    ticket.retry_after = self._retry_after_locked(now)
                    self._decide_locked("retry_budget_drop", now)
                else:
                    # the retry really spent a budget token: charge it
                    # to the tenant whose request is retrying
                    self._tenant_spend_locked(ticket.tenant, "retry", 1.0)
            queued = any(t is ticket for t in self._queue)
            if requeue:
                ticket.done.clear()
                if not queued:
                    self._queue.insert(0, ticket)
                    self._count_locked("shed", ticket.tenant,
                                       ticket.revision)
            else:
                ticket.resolved = True
                if queued:
                    self._queue = [t for t in self._queue
                                   if t is not ticket]
                if ticket.dropped_reason == "deadline":
                    self._drop_deadline_locked(ticket, now)
                else:
                    self._count_locked("failed", ticket.tenant,
                                       ticket.revision)
            expired = self._sweep_deadlines_locked(now)
            dispatched = self._drain_locked(now)
            self._publish_queue_locked()
        for t in expired:
            t.done.set()
        for t in dispatched:
            t.done.set()
        return dispatched

    def kick(self) -> list[Ticket]:
        """Re-try queued dispatch (capacity may have appeared through a
        membership edit rather than a completion)."""
        with self._lock:
            now = self.clock()
            expired = self._sweep_deadlines_locked(now)
            dispatched = self._drain_locked(now)
            self._publish_queue_locked()
        for t in expired:
            t.done.set()
        for t in dispatched:
            t.done.set()
        return dispatched

    # -- resilience: hedging and introspection --------------------------------

    def hedge_delay(self) -> float | None:
        """Seconds a shell should wait on the primary leg before
        hedging: the configured quantile of recent completion
        latencies, floored at ``hedge_min_s``. None = hedging off
        (no config, or not enough samples yet)."""
        with self._lock:
            r = self.resilience
            if r is None or len(self._lat_samples) < r.hedge_min_samples:
                return None
            lat = sorted(self._lat_samples)
            q = lat[min(int(len(lat) * r.hedge_quantile), len(lat) - 1)]
            return max(q, r.hedge_min_s)

    def try_hedge(self, ticket: Ticket) -> Member | None:
        """Open a second leg for a slow dispatched ticket: charges the
        retry budget, accounts the ticket's tokens against the hedge
        replica too (it really is doing the work twice), and returns
        the hedge member for the shell to call — or None when hedging
        is off, no distinct eligible replica exists, the deadline
        already passed, or the budget is dry."""
        with self._lock:
            r = self.resilience
            if r is None or self._closed:
                return None
            primary = ticket.member
            if primary is None or ticket.hedge_member is not None:
                return None
            now = self.clock()
            if ticket.deadline is not None and now >= ticket.deadline:
                return None
            exclude = set(ticket.tried) | {primary.name}
            m = self._pick_locked(ticket.tokens, exclude=exclude,
                                  pref=ticket._canary_pref)
            # _pick treats exclude as a soft preference (retry beats
            # starvation); a hedge to the SAME replica is pointless, so
            # enforce it hard here
            if m is None or m.name in exclude:
                return None
            if not self._spend_budget_locked(1.0, ticket.tenant):
                return None
            self._tenant_spend_locked(ticket.tenant, "hedge", 1.0)
            ticket.hedge_member = m
            ticket._hedge_at = now
            self._tokens[m.name] = \
                self._tokens.get(m.name, 0) + ticket.tokens
            self._publish_inflight_locked(m.name)
            self._hedge_count_locked("started")
            self._decide_locked("hedge", now, replica=m.name)
            return m

    def retry_after(self) -> float:
        """Seconds a rejected client should back off, from the current
        queue depth over the recent completion rate."""
        with self._lock:
            return self._retry_after_locked(self.clock())

    def breaker_states(self) -> dict[str, str]:
        with self._lock:
            return {n: h.state for n, h in self._health.items()}

    def retry_budget(self, tenant: str | None = None) -> float:
        """The fleet-wide retry/hedge budget (sum over tenant buckets),
        or one tenant's bucket level when ``tenant`` is given."""
        with self._lock:
            if tenant is not None:
                return self._retry_tokens.get(tenant, 0.0)
            return sum(self._retry_tokens.values())

    def close(self) -> list[Ticket]:
        """Reject everything still queued (shell shutdown)."""
        with self._lock:
            self._closed = True
            orphans, self._queue = self._queue, []
            self._publish_queue_locked()
        for t in orphans:
            t.done.set()
        return orphans

    # -- introspection (the controller's drain checks ride on these) ---------

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def inflight_tokens(self, name: str | None = None) -> int:
        with self._lock:
            if name is not None:
                return self._tokens.get(name, 0)
            return sum(self._tokens.values())

    def drained(self, name: str) -> bool:
        """True when a cordoned replica holds no in-flight work — the
        controller's delete gate."""
        with self._lock:
            return not self._inflight.get(name)

    def members(self) -> dict[str, str]:
        with self._lock:
            return {n: m.state for n, m in self._members.items()}

    # -- locked internals ----------------------------------------------------

    def _canary_draw_locked(self) -> "tuple[str, bool] | None":
        """One deterministic draw from the seeded sequence: returns
        (canary_revision, wants_canary). A 32-bit avalanche finalizer
        over (sequence, seed) — no RNG state beyond the counter, so an
        identical admission order replays identically, and distinct
        seeds give decorrelated accept sequences (an additive offset
        would leave every seed drawing the same splits)."""
        c = self._canary
        if c is None:
            return None
        rev, weight = c
        seq = self._canary_seq
        self._canary_seq += 1
        x = (seq + 1 + self._canary_seed * 0x9E3779B9) & 0xFFFFFFFF
        x = ((x ^ (x >> 16)) * 0x7FEB352D) & 0xFFFFFFFF
        x = ((x ^ (x >> 15)) * 0x846CA68B) & 0xFFFFFFFF
        u = (x ^ (x >> 16)) / 4294967296.0
        return (rev, u < weight)

    @staticmethod
    def _canary_mismatch(m: Member, pref) -> bool:
        """True when member ``m`` sits on the wrong side of the
        ticket's canary draw — a SOFT penalty in the pick key."""
        if pref is None:
            return False
        rev, want = pref
        return (m.revision == rev) != want

    def _pick_locked(self, tokens: int,
                     exclude: set | frozenset = frozenset(),
                     pref=None) -> Member | None:
        """Least-outstanding-tokens over ACTIVE members; name breaks
        ties so replays are order-independent. Budget-full replicas are
        skipped (the request queues for the next completion). Members
        in ``exclude`` (a retrying ticket's failed transports) are
        avoided — unless they are ALL that's left, in which case a
        retry beats starvation. ``pref`` is the ticket's canary draw:
        the wrong side of the split is penalized AFTER the tried
        penalty (a retry avoids the dead replica first) but before
        load — with no canary active the element is constant and the
        legacy ordering is untouched.

        With resilience on, the key becomes (breaker-rank, tried,
        canary-mismatch, score-adjusted load, name): open breakers are
        ineligible, a half-open breaker admits exactly one probe, and
        load is scaled by EWMA latency relative to the fleet's fastest
        replica — a browned-out (slow but alive) member looks
        proportionally more expensive and drains naturally instead of
        wedging."""
        best = None
        best_key = None
        resilient = self.resilience is not None
        min_lat = None
        if resilient:
            lats = [h.lat for n, h in self._health.items()
                    if h.lat is not None and n in self._members]
            min_lat = min(lats) if lats else None
        now = self.clock() if resilient else 0.0
        for name, m in self._members.items():
            if m.state != STATE_ACTIVE:
                continue
            load = self._tokens.get(name, 0)
            if self.replica_token_budget is not None and load > 0 \
                    and load + tokens > self.replica_token_budget:
                continue
            mismatch = self._canary_mismatch(m, pref)
            if not resilient:
                key = (0, name in exclude, mismatch, load, name)
            else:
                rank = self._breaker_rank_locked(name, now)
                if rank >= 3:  # open (or probe already out): ineligible
                    continue
                score = 1.0
                h = self._health.get(name)
                if h is not None and h.lat is not None and min_lat:
                    score = max(h.lat / min_lat, 1.0)
                key = (rank, name in exclude, mismatch, load * score, name)
            if best_key is None or key < best_key:
                best, best_key = m, key
        return best

    def _dispatch_locked(self, t: Ticket, member: Member,
                         now: float) -> None:
        t.member = member
        t.revision = member.revision
        t._dispatched_at = now
        self._inflight.setdefault(member.name, {})[id(t)] = t
        self._tokens[member.name] = \
            self._tokens.get(member.name, 0) + t.tokens
        if self.resilience is not None:
            h = self._health.get(member.name)
            if h is not None and h.state == BREAKER_HALF_OPEN:
                h.probing = True  # exactly one probe per half-open
        # detached: finish() runs in a LATER call (complete/fail/shed),
        # so this span must never install itself as the ambient parent —
        # an out-of-order reset would pollute the caller's contextvar
        t._span = self.tracer.begin(
            "router.dispatch", parent=t.context, detached=True,
            service=self.service, namespace=self.namespace,
            tenant=t.tenant or self.namespace,
            replica=member.name, tokens=t.tokens,
            queue_wait_s=round(max(now - t._queued_at, 0.0), 6))
        self._publish_inflight_locked(member.name)

    def _finish_locked(self, t: Ticket, now: float,
                       tokens_done: int | None) -> None:
        t.resolved = True
        member = t.member
        if member is not None:
            bucket = self._inflight.get(member.name)
            if bucket is not None:
                bucket.pop(id(t), None)
            self._tokens[member.name] = max(
                0, self._tokens.get(member.name, 0) - t.tokens)
            self._publish_inflight_locked(member.name)
        if t._span is not None:
            self.tracer.finish(t._span)
            t._span = None
        latency = max(now - t._t0, 0.0)
        done = t.tokens if tokens_done is None else int(tokens_done)
        tenant = t.tenant or self.namespace
        hist_labels = dict(namespace=self.namespace, service=self.service,
                           tenant=tenant)
        if t.revision:  # unrevisioned traffic keeps its old series
            hist_labels["revision"] = t.revision
        self.registry.histogram(
            "router_request_seconds", latency,
            help_="submit -> completion latency through the router",
            buckets=REQUEST_BUCKETS, **hist_labels)
        self.registry.counter_inc(
            "router_tokens_total",
            help_="tokens completed through the router (rate = the "
                  "autoscaler's tokens/sec signal)",
            by=float(done), namespace=self.namespace, service=self.service,
            tenant=tenant)
        self._count_locked("completed", t.tenant, t.revision)

    def _drain_locked(self, now: float) -> list[Ticket]:
        """Drain the queue into whatever capacity exists. Legacy mode
        is strict FIFO; resilience mode drains by (band, FIFO) so a
        critical request never waits behind a sheddable backlog —
        band-priority dispatch is the other half of band shedding."""
        dispatched: list[Ticket] = []
        if self.resilience is None:
            remaining: list[Ticket] = []
            for t in self._queue:
                member = self._pick_locked(t.tokens, exclude=t.tried,
                                       pref=t._canary_pref)
                if member is None:
                    remaining.append(t)
                    continue
                self._dispatch_locked(t, member, now)
                dispatched.append(t)
            self._queue = remaining
            return dispatched
        order = sorted(
            range(len(self._queue)),
            key=lambda i: (BAND_RANK.get(self._queue[i].band,
                                         BAND_RANK[BAND_DEFAULT]), i))
        taken: set[int] = set()
        for i in order:
            t = self._queue[i]
            member = self._pick_locked(t.tokens, exclude=t.tried,
                                       pref=t._canary_pref)
            if member is None:
                continue
            self._dispatch_locked(t, member, now)
            dispatched.append(t)
            taken.add(i)
        if taken:
            self._queue = [t for i, t in enumerate(self._queue)
                           if i not in taken]
        return dispatched

    # -- locked resilience internals ------------------------------------------

    def _sweep_deadlines_locked(self, now: float) -> list[Ticket]:
        """Shed queued tickets whose deadline passed BEFORE spending
        replica capacity on them. Caller fires each one's done event
        outside the lock; the shell reads ``dropped_reason``."""
        if not self._queue or all(t.deadline is None for t in self._queue):
            return []
        expired = [t for t in self._queue
                   if t.deadline is not None and now >= t.deadline]
        if not expired:
            return []
        dead = set(map(id, expired))
        self._queue = [t for t in self._queue if id(t) not in dead]
        for t in expired:
            t.dropped_reason = "deadline"
            self._drop_deadline_locked(t, now)
        return expired

    def _drop_deadline_locked(self, t: Ticket, now: float) -> None:
        t.dropped_reason = "deadline"
        self._count_locked("deadline", t.tenant)
        self.registry.counter_inc(
            "router_deadline_exceeded_total",
            help_="requests dropped because their deadline elapsed",
            namespace=self.namespace, service=self.service,
            tenant=t.tenant or self.namespace)
        self._decide_locked("deadline", now, band=t.band)

    def _refill_budget_locked(self, tenant: str) -> None:
        """Refill the admitting TENANT'S bucket — so refill is
        proportional to each tenant's admitted traffic. The SUM across
        buckets never exceeds retry_budget_cap: when the fleet-wide
        pool is full, the refill reclaims from the fullest OTHER bucket
        (deterministic tie-break) so an idle tenant's hoard cannot
        starve an active one — but a storming tenant still only ever
        SPENDS its own bucket."""
        r = self.resilience
        tenant = tenant or self.namespace
        buckets = self._retry_tokens
        buckets.setdefault(tenant, 0.0)
        need = r.retry_budget_ratio
        headroom = r.retry_budget_cap - sum(buckets.values())
        add = min(need, max(headroom, 0.0))
        short = need - add
        if short > 1e-12:
            others = sorted(((v, k) for k, v in buckets.items()
                             if k != tenant and v > 0.0), reverse=True)
            for v, k in others:
                take = min(v, short)
                buckets[k] = v - take
                add += take
                short -= take
                if short <= 1e-12:
                    break
        if add > 0.0:
            buckets[tenant] += add
        self._publish_budget_locked()

    def _spend_budget_locked(self, cost: float, tenant: str = "") -> bool:
        """Spend from the tenant's OWN bucket only (the isolation
        half: a retry storm cannot drain a neighbor's budget)."""
        if self.resilience is None:
            return True
        tenant = tenant or self.namespace
        level = self._retry_tokens.get(tenant, 0.0)
        if level < cost:
            return False
        self._retry_tokens[tenant] = level - cost
        self._publish_budget_locked()
        return True

    def _publish_budget_locked(self) -> None:
        for tenant, level in self._retry_tokens.items():
            self.registry.gauge(
                "router_retry_budget", round(level, 6),
                help_="retry/hedge token bucket level — 0 means the "
                      "fleet is failing faster than it refills",
                namespace=self.namespace, service=self.service,
                tenant=tenant)

    def _health_locked(self, name: str) -> _Health:
        h = self._health.get(name)
        if h is None:
            h = self._health[name] = _Health()
        return h

    def _record_success_locked(self, name: str, sample: float,
                               now: float) -> None:
        h = self._health_locked(name)
        a = self.resilience.ewma_alpha
        h.lat = sample if h.lat is None else a * sample + (1 - a) * h.lat
        h.fails = 0
        h.probing = False
        if h.state != BREAKER_CLOSED:
            self._set_breaker_locked(name, h, BREAKER_CLOSED, now)

    def _record_failure_locked(self, name: str, now: float) -> None:
        h = self._health_locked(name)
        h.fails += 1
        h.probing = False
        if h.state == BREAKER_HALF_OPEN or (
                h.state == BREAKER_CLOSED
                and h.fails >= self.resilience.breaker_failures):
            h.opened_at = now
            self._set_breaker_locked(name, h, BREAKER_OPEN, now)

    def _breaker_rank_locked(self, name: str, now: float) -> int:
        """0 = closed, 1 = half-open probe slot free, 3 = ineligible
        (open and cooling off, or probe already dispatched). The
        open -> half-open transition is time-driven and happens on the
        first pick after cooloff."""
        h = self._health.get(name)
        if h is None or h.state == BREAKER_CLOSED:
            return 0
        if h.state == BREAKER_OPEN:
            if now - h.opened_at < self.resilience.breaker_cooloff_s:
                return 3
            self._set_breaker_locked(name, h, BREAKER_HALF_OPEN, now)
            h.probing = False
        return 3 if h.probing else 1

    def _set_breaker_locked(self, name: str, h: _Health, state: str,
                            now: float) -> None:
        h.state = state
        self.registry.gauge(
            "router_breaker_state", _BREAKER_GAUGE[state],
            help_="per-replica circuit breaker "
                  "(0=closed 1=half-open 2=open)",
            namespace=self.namespace, service=self.service, replica=name)
        self._decide_locked("breaker", now, replica=name, state=state)

    def _hedge_count_locked(self, outcome: str) -> None:
        self.registry.counter_inc(
            "router_hedges_total",
            help_="hedged dispatches by outcome (started/won/canceled)",
            namespace=self.namespace, service=self.service,
            outcome=outcome)

    def _retry_after_locked(self, now: float) -> float:
        """Queue depth over the recent completion rate, clamped to
        [1, 120] whole seconds — what a 429/503 Retry-After should
        say. With no completion history yet, 1s (the optimistic
        floor beats telling clients to go away for minutes)."""
        depth = len(self._queue) + 1
        dq = self._completions
        if len(dq) >= 2 and dq[-1] > dq[0]:
            rate = (len(dq) - 1) / (dq[-1] - dq[0])
            est = depth / rate if rate > 0 else 1.0
        else:
            est = 1.0
        return float(min(max(math.ceil(est), 1), 120))

    def _decide_locked(self, kind: str, now: float, **kv: Any) -> None:
        if self.on_decision is not None:
            self.on_decision(dict(kind=kind, t=round(now, 6), **kv))

    def _publish_queue_locked(self) -> None:
        self.registry.gauge(
            "router_queue_depth", len(self._queue),
            help_="requests waiting in the router admission queue",
            namespace=self.namespace, service=self.service)
        # the per-tenant cut is a SEPARATE family: RegistrySignals sums
        # router_queue_depth by label SUBSET, so tenant series on the
        # fleet gauge would double-count the autoscaler's signal
        if self._tenants:
            depth: dict[str, int] = {t: 0 for t in self._tenants}
            for q in self._queue:
                tenant = q.tenant or self.namespace
                depth[tenant] = depth.get(tenant, 0) + 1
            for tenant, n in depth.items():
                self.registry.gauge(
                    "router_tenant_queue_depth", n,
                    help_="requests waiting in the router admission "
                          "queue, by billing tenant",
                    namespace=self.namespace, service=self.service,
                    tenant=tenant)

    def _publish_inflight_locked(self, name: str) -> None:
        self.registry.gauge(
            "router_tokens_inflight", self._tokens.get(name, 0),
            help_="outstanding token estimate per replica",
            namespace=self.namespace, service=self.service, replica=name)

    def _count_locked(self, outcome: str, tenant: str = "",
                      revision: str = "") -> None:
        # the revision label exists only while revisions are in play —
        # unrevisioned traffic keeps its pre-rollout series identity
        labels = dict(namespace=self.namespace, service=self.service,
                      tenant=tenant or self.namespace, outcome=outcome)
        if revision:
            labels["revision"] = revision
        self.registry.counter_inc(
            "router_requests_total",
            help_="requests by outcome (completed/rejected/shed/failed)",
            **labels)

    def _register_tenant_locked(self, tenant: str) -> None:
        """First sight of a tenant: pre-register its counter families
        at 0 so ``rate()``/``increase()`` have a sample BEFORE the
        first error — a fresh tenant's very first failure must trip
        its burn/storm rules (a rate needs a zero sample first)."""
        tenant = tenant or self.namespace
        if tenant in self._tenants:
            return
        self._tenants.add(tenant)
        if self.resilience is not None:
            # seed the tenant's retry bucket with the pool's remaining
            # headroom, topped up to a fair share (cap / tenants seen)
            # reclaimed from the fullest buckets when headroom is
            # short. The FIRST tenant still starts at the full cap
            # (single-tenant behavior unchanged — banked replays hold);
            # a late arrival gets a working share immediately instead
            # of having its very first retry denied, yet the sum across
            # buckets never exceeds the cap and nobody's bucket is
            # touched while the pool has headroom.
            cap = self.resilience.retry_budget_cap
            buckets = self._retry_tokens
            seed = max(cap - sum(buckets.values()), 0.0)
            share = cap / (len(buckets) + 1)
            short = share - seed
            if short > 1e-12:
                others = sorted(((v, k) for k, v in buckets.items()
                                 if v > 0.0), reverse=True)
                for v, k in others:
                    take = min(v, short)
                    buckets[k] = v - take
                    seed += take
                    short -= take
                    if short <= 1e-12:
                        break
            buckets[tenant] = seed
            self._publish_budget_locked()
        for outcome in TENANT_OUTCOMES:
            self.registry.counter_inc(
                "router_requests_total", by=0.0,
                help_="requests by outcome "
                      "(completed/rejected/shed/failed)",
                namespace=self.namespace, service=self.service,
                tenant=tenant, outcome=outcome)
        self.registry.counter_inc(
            "router_tokens_total", by=0.0,
            help_="tokens completed through the router (rate = the "
                  "autoscaler's tokens/sec signal)",
            namespace=self.namespace, service=self.service, tenant=tenant)
        for kind in ("retry", "hedge"):
            self.registry.counter_inc(
                "router_tenant_retry_tokens_total", by=0.0,
                help_="retry-budget tokens spent on retries and hedges, "
                      "by billing tenant",
                namespace=self.namespace, service=self.service,
                tenant=tenant, kind=kind)
        self.registry.gauge(
            "router_tenant_queue_depth", 0,
            help_="requests waiting in the router admission queue, by "
                  "billing tenant",
            namespace=self.namespace, service=self.service, tenant=tenant)

    def _tenant_spend_locked(self, tenant: str, kind: str,
                             cost: float) -> None:
        """Attribute a retry-budget spend (a retry or a hedge leg) to
        the tenant whose request drew it — the retry-storm signal."""
        self.registry.counter_inc(
            "router_tenant_retry_tokens_total", by=cost,
            help_="retry-budget tokens spent on retries and hedges, "
                  "by billing tenant",
            namespace=self.namespace, service=self.service,
            tenant=tenant or self.namespace, kind=kind)


# -- endpoints annotation helpers -------------------------------------------


def render_endpoints(endpoints: list[dict]) -> str:
    """Canonical JSON for the annotation (sorted, compact) so an
    unchanged endpoint set patches to an identical string — the
    controller's no-op write guard compares it byte-for-byte."""
    return json.dumps(sorted(endpoints, key=lambda e: e.get("name", "")),
                      separators=(",", ":"), sort_keys=True)


def parse_endpoints(service_obj: dict) -> list[dict]:
    """The endpoint list a JAXService object currently publishes."""
    raw = ((service_obj.get("metadata") or {}).get("annotations") or {}) \
        .get(ANNOTATION_ENDPOINTS)
    if not raw:
        return []
    try:
        eps = json.loads(raw)
    except ValueError:
        log.warning("malformed %s annotation ignored", ANNOTATION_ENDPOINTS)
        return []
    return [e for e in eps if isinstance(e, dict) and e.get("name")]


# -- autoscaler signal source -----------------------------------------------


class RegistrySignals:
    """The JAXService autoscaler's signal reader: parses the router- and
    replica-exported series back out of a MetricsRegistry's text
    exposition (the histograms ARE the wire — in production the
    same text arrives by scraping the router's /metrics; hermetically
    the registry is shared in-process). Series names are the catalog in
    docs/observability.md."""

    def __init__(self, registry):
        # a MetricsRegistry (shared-process fast path), or a zero-arg
        # callable returning an exposition body — the scraped-/metrics
        # source for a controller running out-of-process from the router
        self.registry = registry

    def _series(self, name: str) -> list[tuple[dict, float]]:
        # in-process fast path: structured samples straight off the
        # registry (O(metric) instead of rendering + parsing the whole
        # exposition per signal read). Scraped bodies go through the
        # ONE exposition parser (obs/expofmt.py) shared with the fleet
        # scrape plane — no second spelling.
        reader = getattr(self.registry, "series", None)
        if reader is not None:
            return reader(name)
        from kubeflow_tpu_torch.obs import expofmt

        text = self.registry() if callable(self.registry) \
            else self.registry.render()
        return expofmt.samples(text, name)

    def _sum(self, name: str, **match) -> float:
        total = 0.0
        for labels, value in self._series(name):
            if all(labels.get(k) == v for k, v in match.items()):
                total += value
        return total

    def queue_depth(self, namespace: str, service: str) -> float:
        return self._sum("router_queue_depth",
                         namespace=namespace, service=service)

    def tokens_total(self, namespace: str, service: str) -> float:
        return self._sum("router_tokens_total",
                         namespace=namespace, service=service)

    def inflight_tokens(self, namespace: str, service: str,
                        replica: str | None = None) -> float:
        match = {"namespace": namespace, "service": service}
        if replica is not None:
            match["replica"] = replica
        return self._sum("router_tokens_inflight", **match)

    def replica_drained(self, namespace: str, service: str,
                        replica: str) -> bool:
        return self.inflight_tokens(namespace, service, replica) <= 0


# -- threaded/HTTP shell ----------------------------------------------------


class TransportError(Exception):
    """A replica answered with an HTTP error. Carries the status and
    the parsed Retry-After (seconds) so the frontend's retry loop can
    honor the replica's backpressure as a backoff FLOOR instead of
    hammering it on a fixed schedule."""

    def __init__(self, status: int, message: str,
                 retry_after: float | None = None):
        super().__init__(message)
        self.status = status
        self.retry_after = retry_after


class HttpTransport:
    """POST a predict body to a replica server (urllib; stdlib-only,
    the RestClient discipline)."""

    def __init__(self, base_url: str, timeout: float = 300.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def predict(self, model: str, body: bytes,
                headers: dict | None = None) -> bytes:
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            f"{self.base_url}/v1/models/{model}:predict", data=body,
            headers={"Content-Type": "application/json", **(headers or {})},
            method="POST")
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            ra = None
            try:
                raw_ra = e.headers.get("Retry-After") if e.headers else None
                if raw_ra is not None:
                    ra = max(float(raw_ra), 0.0)
            except (TypeError, ValueError):
                ra = None
            raise TransportError(
                e.code, f"replica returned {e.code}: {e.reason}",
                retry_after=ra) from e


def resilience_spec(spec: dict) -> dict:
    """spec.resilience with defaults (the reference's
    control/jaxservice/types.py `resilience_spec`): the namespace-level
    request knobs `RouterFrontend.apply_spec` adopts. `defaultBand` for
    requests without an x-request-band header, `deadlineSeconds` for
    those without an x-request-deadline-s header (0: none), `hedge`
    whether a second replica leg may race, `maxInflight` the per-replica
    admission cap (0: unbounded)."""
    r = spec.get("resilience")
    r = r if isinstance(r, dict) else {}
    return {
        "defaultBand": r.get("defaultBand", BAND_DEFAULT),
        "deadlineSeconds": r.get("deadlineSeconds", 0.0),
        "hedge": bool(r.get("hedge", True)),
        "maxInflight": r.get("maxInflight", 0),
    }


def _retry_after_headers(retry_after: float | None) -> dict | None:
    if retry_after is None:
        return None
    return {"Retry-After": str(int(math.ceil(retry_after)))}


class RouterFrontend:
    """The blocking HTTP face over the deterministic core: one handler
    thread carries its request end-to-end (submit -> wait for dispatch
    -> call the replica transport -> complete), so the router itself
    never blocks under its lock.

    Resilience responsibilities live here too: parse the deadline/band
    headers, forward the SHRINKING deadline budget replica-ward on
    every attempt, honor Retry-After as a backoff floor between
    retries, race a hedge leg when the core says the primary is slow,
    and map router drop reasons to 504/429/503."""

    def __init__(self, router: TokenRouter, max_new_tokens: int = 32,
                 dispatch_timeout: float = 120.0,
                 default_deadline_s: float | None = None,
                 default_band: str = BAND_DEFAULT,
                 sleep: Callable[[float], None] = time.sleep):
        self.router = router
        self.max_new_tokens = max_new_tokens
        self.dispatch_timeout = dispatch_timeout
        self.default_deadline_s = default_deadline_s
        self.default_band = default_band
        self.hedging = True
        self.retry_backoff_s = 0.05   # doubles per failure
        self.retry_backoff_cap_s = 5.0
        self._sleep = sleep

    def apply_spec(self, service_obj: dict) -> None:
        """Adopt the JAXService spec's resilience defaults (namespace-
        defaulted band/deadline — the multi-tenancy bridge). The
        endpoints watch calls this per event, so a spec edit takes
        effect without a router restart."""
        r = resilience_spec((service_obj or {}).get("spec") or {})
        self.default_band = r["defaultBand"]
        self.default_deadline_s = r["deadlineSeconds"] or None
        self.hedging = bool(r["hedge"])

    @staticmethod
    def _drop_error(ticket: Ticket):
        """Map a router-side drop to the client-facing status."""
        from kubeflow_tpu_torch.utils.httpd import ApiHttpError

        if ticket.dropped_reason == "deadline":
            return ApiHttpError(504, "deadline exceeded")
        if ticket.dropped_reason == "shed_band":
            return ApiHttpError(
                429, f"shed under overload (band={ticket.band})",
                headers=_retry_after_headers(ticket.retry_after))
        if ticket.dropped_reason == "retry_budget":
            return ApiHttpError(
                503, "retry budget exhausted",
                headers=_retry_after_headers(ticket.retry_after))
        return None

    def _abandon(self, ticket: Ticket) -> None:
        """Last-resort resolution when the dispatch loop exits on an
        unexpected exception: a ticket the router already resolved
        (completed, or dropped with a reason) is left alone; anything
        else is failed WITHOUT requeue so the replica's in-flight
        token accounting is released before the error propagates."""
        if ticket.resolved or ticket.dropped_reason is not None:
            return
        self.router.fail(ticket, requeue=False)

    def predict(self, req):
        from kubeflow_tpu_torch.utils.httpd import ApiHttpError

        model = req.params["model"]
        body = req.json() or {}
        instances = body.get("instances")
        if instances is None:
            raise ApiHttpError(400, 'request body must contain "instances"')
        ctx = obs_trace.parse_traceparent(req.header("traceparent"))
        tokens = estimate_tokens(instances, self.max_new_tokens)
        band = req.header(HEADER_BAND) or self.default_band
        if band not in BAND_RANK:
            band = BAND_DEFAULT
        # the billing tenant: an explicit header override, else the
        # JAXService namespace (submit() applies the default). Garbage
        # is a 400, not a label value — header text must never flow
        # unchecked into the metric exposition.
        tenant = (req.header(HEADER_TENANT) or "").strip() or None
        if tenant is not None and not TENANT_RE.match(tenant):
            raise ApiHttpError(
                400, f"bad {HEADER_TENANT} header: must be a DNS-1123 "
                     f"label")
        # the real HTTP shell returns "" for a missing header (httpd
        # HttpReq.header default) while stubs return None — both mean
        # "no deadline requested"
        raw_deadline = req.header(HEADER_DEADLINE)
        if raw_deadline:
            try:
                deadline_s = float(raw_deadline)
            except ValueError:
                raise ApiHttpError(
                    400, f"bad {HEADER_DEADLINE} header: {raw_deadline!r}")
        else:
            deadline_s = self.default_deadline_s
        deadline = (self.router.clock() + deadline_s
                    if deadline_s is not None and deadline_s > 0 else None)
        try:
            ticket = self.router.submit(tokens, item=model, context=ctx,
                                        band=band, deadline=deadline,
                                        tenant=tenant)
        except DeadlineExceeded:
            raise ApiHttpError(504, "deadline exceeded")
        except RouterBusy as e:
            raise ApiHttpError(
                429, str(e),
                headers=_retry_after_headers(e.retry_after))
        # every path below must resolve the ticket (complete, or fail
        # with/without requeue). The blanket handler is the last-resort
        # resolution for anything unexpected thrown mid-dispatch --
        # without it the replica's in-flight accounting would hold this
        # ticket's tokens forever.
        try:
            last_err: Exception | None = None
            failures = 0
            while failures < 3:
                if ticket.member is None:
                    wait_s = self.dispatch_timeout
                    if deadline is not None:
                        wait_s = min(
                            wait_s,
                            max(deadline - self.router.clock(), 0.0) + 0.05)
                    fired = ticket.done.wait(wait_s)
                    err = self._drop_error(ticket)
                    if err is not None:
                        raise err
                    if not fired:
                        self.router.fail(ticket, requeue=False)
                        err = self._drop_error(ticket)
                        if err is not None:  # fail() resolved it as a drop
                            raise err
                        if deadline is not None \
                                and self.router.clock() >= deadline:
                            raise ApiHttpError(504, "deadline exceeded")
                        raise ApiHttpError(503, "no replica capacity")
                member = ticket.member
                if member is None:  # shed mid-wait; loop waits again
                    continue
                hdrs: dict[str, str] = {}
                if req.header("traceparent"):
                    hdrs["traceparent"] = req.header("traceparent")
                if band != BAND_DEFAULT:
                    hdrs[HEADER_BAND] = band
                if deadline is not None:
                    remaining = deadline - self.router.clock()
                    if remaining <= 0:
                        self.router.fail(ticket, requeue=False)
                        raise ApiHttpError(504, "deadline exceeded")
                    # the budget SHRINKS across retries: each hop sees only
                    # what's left, so a retried request cannot overstay
                    hdrs[HEADER_DEADLINE] = f"{remaining:.3f}"
                try:
                    delay = (self.router.hedge_delay()
                             if self.hedging else None)
                    if delay is None:
                        raw = member.transport.predict(
                            model, req.body, headers=hdrs or None)
                        winner = None
                    else:
                        raw, winner = self._hedged_predict(
                            ticket, member, model, req.body, hdrs, delay,
                            deadline)
                except Exception as e:  # replica died mid-request: retry
                    last_err = e
                    failures += 1
                    self.router.fail(ticket, requeue=True)
                    err = self._drop_error(ticket)
                    if err is not None:  # deadline/budget ended the retries
                        raise err
                    floor = getattr(e, "retry_after", None) or 0.0
                    backoff = max(
                        self.retry_backoff_s * (2 ** (failures - 1)), floor)
                    if backoff > 0:
                        self._sleep(min(backoff, self.retry_backoff_cap_s))
                    continue
                self.router.complete(ticket, winner=winner)
                return json.loads(raw)
            self.router.fail(ticket, requeue=False)
            raise ApiHttpError(502, f"replica transport failed: {last_err}")
        except BaseException:
            self._abandon(ticket)
            raise

    def _hedged_predict(self, ticket: Ticket, member: Member, model: str,
                        body: bytes, hdrs: dict, delay: float,
                        deadline: float | None):
        """Race the primary transport against a hedge leg opened after
        ``delay`` seconds of silence. First SUCCESS wins; the loser is
        abandoned (its replica-side deadline cancels it and frees its
        pages — the core already released its token accounting via
        ``complete(winner=...)``). Raises the primary's error when
        every started leg failed."""
        box: dict[str, Any] = {"raw": None, "winner": None, "errors": []}
        box_lock = threading.Lock()
        wake = threading.Event()
        legs: list[Member] = [member]

        def leg(m: Member, leg_hdrs: dict | None) -> None:
            try:
                out = m.transport.predict(model, body, headers=leg_hdrs)
            except Exception as e:
                with box_lock:
                    box["errors"].append(e)
                wake.set()
                return
            with box_lock:
                if box["winner"] is None:
                    box["winner"] = m.name
                    box["raw"] = out
            wake.set()

        threading.Thread(target=leg, args=(member, dict(hdrs) or None),
                         daemon=True, name="router-hedge-primary").start()
        if not wake.wait(delay):
            hedge = self.router.try_hedge(ticket)
            if hedge is not None:
                leg_hdrs = dict(hdrs)
                if deadline is not None:
                    leg_hdrs[HEADER_DEADLINE] = \
                        f"{max(deadline - self.router.clock(), 0.0):.3f}"
                legs.append(hedge)
                threading.Thread(
                    target=leg, args=(hedge, leg_hdrs or None),
                    daemon=True, name="router-hedge-secondary").start()
        # wait for a winner or for every started leg to fail, bounded
        # by the deadline (plus grace for the replica-side cancel)
        t_end = None
        if deadline is not None:
            t_end = deadline + 1.0
        while True:
            with box_lock:
                if box["winner"] is not None:
                    return box["raw"], box["winner"]
                if len(box["errors"]) >= len(legs):
                    raise box["errors"][0]
                wake.clear()
            budget = self.dispatch_timeout
            if t_end is not None:
                budget = min(budget,
                             max(t_end - self.router.clock(), 0.0))
            if not wake.wait(budget):
                with box_lock:
                    if box["winner"] is not None:
                        return box["raw"], box["winner"]
                raise TransportError(
                    504, "all legs exceeded the request deadline")

    def build(self):
        from kubeflow_tpu_torch.utils import httpd

        r = httpd.Router("jaxservice-router")
        r.route("POST", "/v1/models/{model}:predict", self.predict)
        httpd.add_health_routes(r)
        httpd.add_metrics_route(r)
        return r

    def serve(self, host: str = "0.0.0.0", port: int = 8600):
        from kubeflow_tpu_torch.utils import httpd

        return httpd.HttpService(self.build(), host, port)


def main(argv: list[str] | None = None,
         stop: threading.Event | None = None) -> int:
    """The router process: `--endpoints name=url[,name=url...]` over
    replica servers, or `--apiserver URL`, which watches the JAXService
    `--service` in `--namespace` and takes its membership from the
    endpoints annotation the controller publishes (a daemon thread
    running `control.jaxservice.watch_endpoints`). Serves until
    ``stop`` is set (a seam for callers in-process), else forever; the
    watch ends with the server."""
    import argparse
    import os

    p = argparse.ArgumentParser("kubeflow-tpu-torch-router")
    p.add_argument("--port", type=int, default=8600)
    p.add_argument("--service", default=os.environ.get("JAXSERVICE_NAME",
                                                       "default"))
    p.add_argument("--namespace", default=os.environ.get("POD_NAMESPACE",
                                                         "default"))
    p.add_argument("--max-queue", type=int, default=256)
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--endpoints", default="",
                   help="static bootstrap: name=url[,name=url...] "
                        "(the controller watch takes over in-cluster)")
    p.add_argument("--apiserver", default="",
                   help="watch the JAXService endpoints annotation")
    p.add_argument("--no-resilience", action="store_true",
                   help="disable deadlines/hedging/breakers/band "
                        "shedding (legacy dispatch)")
    p.add_argument("--default-deadline-s", type=float, default=0.0,
                   help="deadline for requests without an "
                        "x-request-deadline-s header (0 = none)")
    p.add_argument("--default-band", default=BAND_DEFAULT,
                   choices=BANDS,
                   help="criticality band for unlabeled requests")
    args = p.parse_args(argv)
    router = TokenRouter(service=args.service, namespace=args.namespace,
                         max_queue=args.max_queue,
                         resilience=(None if args.no_resilience
                                     else ResilienceConfig()))
    if args.endpoints:
        eps = [{"name": n, "addr": u, "state": STATE_ACTIVE}
               for n, _, u in (e.partition("=")
                               for e in args.endpoints.split(","))]
        router.sync_endpoints(
            eps, transport_factory=lambda ep: HttpTransport(ep["addr"]))
    frontend = RouterFrontend(
        router, max_new_tokens=args.max_new_tokens,
        default_deadline_s=args.default_deadline_s or None,
        default_band=args.default_band)
    stop = stop if stop is not None else threading.Event()
    if args.apiserver:
        from kubeflow_tpu_torch.control.jaxservice import watch_endpoints

        threading.Thread(
            target=watch_endpoints,
            args=(args.apiserver, args.namespace, args.service, router),
            kwargs={"frontend": frontend, "stop": stop},
            daemon=True, name="router-endpoints-watch").start()
    svc = frontend.serve(port=args.port)
    log.info("jaxservice router %s/%s on :%d", args.namespace,
             args.service, svc.port)

    def stopper() -> None:
        stop.wait()
        svc.shutdown()

    threading.Thread(target=stopper, daemon=True,
                     name="router-stop").start()
    try:
        svc.serve_forever()
    finally:
        stop.set()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
