"""FleetPlane — the assembled observability plane, one handle.

Bundles the ``tsdb`` scrape plane, the ``rules`` engine and ``goodput``
accounting, plus the closing-the-loop layers —
the alert-driven ``RemediationEngine``, per-alert routing, and
silences — behind the object the dashboard routes (``GET /api/alerts``
/ ``/api/query`` / ``/api/goodput`` / ``/api/silences``) and
``run_controller``-style mains wire up. Hermetic harnesses build their
own with fake clocks; a process that just wants "the plane" uses the
module-level ``default_plane()`` singleton (the REGISTRY/COLLECTOR/
TRACER convention from runtime/metrics.py and obs/trace.py).

Routing and silences follow Alertmanager's split: a *route* maps an
alert (by severity and label matchers) to a receiver name — operators
read it off ``route_for``; a *silence* (matchers + expiry) mutes
notification and remediation for matching alerts WITHOUT touching the
alert state machine, so un-silencing reveals true current state.

Port of `kubeflow_tpu/obs/plane.py` over the port's store, rules,
remediation, goodput and span collector; ``default_plane()`` scrapes
the port's own ``REGISTRY``.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

from kubeflow_tpu_torch.obs import goodput as gp
from kubeflow_tpu_torch.obs import trace as obs_trace
from kubeflow_tpu_torch.obs.rules import RuleEngine, default_rule_pack
from kubeflow_tpu_torch.obs.tsdb import ScrapeLoop, Target, TimeSeriesStore


@dataclass
class Route:
    """severity + label matchers -> receiver. First match wins; a
    ``severity`` of "" matches every severity."""

    receiver: str
    severity: str = ""
    matchers: dict = field(default_factory=dict)


DEFAULT_ROUTES = (
    Route(receiver="page", severity="critical"),
    Route(receiver="ticket", severity="warning"),
    Route(receiver="log"),
)


class SilenceStore:
    """Bounded set of active silences (id, matchers, until, comment).

    ``silenced(alertname, labels, at)`` is the predicate both the rule
    engine (Events) and the remediation engine (actions) consult; a
    matcher key of ``alertname`` matches the rule name, every other
    key matches the alert's labels. Expired silences are pruned on
    every read."""

    def __init__(self, clock: Callable[[], float] = time.time,
                 limit: int = 256):
        self.clock = clock
        self.limit = limit
        self._lock = threading.Lock()
        self._silences: dict[str, dict] = {}
        self._ids = itertools.count(1)

    def add(self, matchers: dict, until: float,
            comment: str = "", created_by: str = "") -> dict:
        if not matchers:
            raise ValueError("a silence needs at least one matcher")
        with self._lock:
            self._prune(self.clock())
            if len(self._silences) >= self.limit:
                raise ValueError("silence store full")
            sid = f"s{next(self._ids)}"
            entry = {"id": sid,
                     "matchers": {str(k): str(v)
                                  for k, v in matchers.items()},
                     "until": float(until), "comment": comment,
                     "createdBy": created_by,
                     "createdAt": self.clock()}
            self._silences[sid] = entry
            return dict(entry)

    def delete(self, sid: str) -> bool:
        with self._lock:
            return self._silences.pop(sid, None) is not None

    def list(self, at: float | None = None) -> list[dict]:
        now = self.clock() if at is None else at
        with self._lock:
            self._prune(now)
            return [dict(s) for _, s in sorted(self._silences.items())]

    def silenced(self, alertname: str, labels: dict,
                 at: float | None = None) -> bool:
        now = self.clock() if at is None else at
        with self._lock:
            self._prune(now)
            for s in self._silences.values():
                if all(alertname == v if k == "alertname"
                       else (labels or {}).get(k) == v
                       for k, v in s["matchers"].items()):
                    return True
        return False

    def _prune(self, now: float) -> None:
        dead = [sid for sid, s in self._silences.items()
                if s["until"] <= now]
        for sid in dead:
            del self._silences[sid]


class FleetPlane:
    """store + scraper + rule engine + goodput reads + remediation,
    one lifecycle.

    ``tick()`` is the deterministic unit (one scrape cycle + one rule
    pass + one remediation pass at the shared clock) — drills, tests
    and the bench drive it on virtual time; ``start()``/``stop()`` run
    it on wall time."""

    def __init__(self, registry=None, recorder=None,
                 targets: list[Target] = (),
                 discover: Callable[[], list[Target]] | None = None,
                 rules: list | None = None,
                 interval_s: float = 15.0,
                 clock: Callable[[], float] = time.time,
                 collector: "obs_trace.TraceCollector | None" = None,
                 max_points: int = 512, max_series: int = 50000,
                 lookback_s: float | None = None,
                 remediator=None,
                 routes: tuple = DEFAULT_ROUTES):
        from kubeflow_tpu_torch.runtime.metrics import REGISTRY

        self.registry = registry if registry is not None else REGISTRY
        self.clock = clock
        self.collector = collector if collector is not None \
            else obs_trace.COLLECTOR
        self.store = TimeSeriesStore(max_points=max_points,
                                     max_series=max_series)
        self.scraper = ScrapeLoop(
            self.store, targets=targets, discover=discover,
            interval_s=interval_s, clock=clock, registry=self.registry)
        self.silences = SilenceStore(clock=clock)
        # instant-selector lookback tracks the scrape interval: a
        # series is "current" while it misses fewer than ~4 scrapes
        self.engine = RuleEngine(
            self.store,
            rules=default_rule_pack() if rules is None else rules,
            recorder=recorder, registry=self.registry, clock=clock,
            lookback_s=(lookback_s if lookback_s is not None
                        else max(interval_s * 4, 60.0)),
            silenced=self.silences.silenced)
        # alert-driven remediation (obs/remediate.py). The plane owns
        # the silence hookup so an operator's POST /api/silences mutes
        # both notification AND action in one move.
        self.remediator = remediator
        if remediator is not None and remediator.silenced is None:
            remediator.silenced = self.silences.silenced
        self.routes: tuple = tuple(routes)
        self.slos = [gp.ServingSLO()]
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- deterministic core --------------------------------------------------

    def tick(self, at: float | None = None) -> dict:
        """One scrape + rule pass + remediation pass; returns
        {'scrape': ..., 'transitions': [...], 'remediations': [...]} —
        the unit the benches fingerprint."""
        scrape = self.scraper.scrape_once()
        transitions = self.engine.evaluate_once(at=at)
        remediations: list = []
        if self.remediator is not None:
            remediations = self.remediator.observe(transitions, at=at)
        return {"scrape": scrape, "transitions": transitions,
                "remediations": remediations}

    # -- routing -------------------------------------------------------------

    def route_for(self, alertname: str, severity: str,
                  labels: dict | None = None) -> str:
        """First-match routing: the receiver this alert notifies."""
        for r in self.routes:
            if r.severity and r.severity != severity:
                continue
            if any((labels or {}).get(k) != v
                   for k, v in r.matchers.items()):
                continue
            return r.receiver
        return "log"

    # -- dashboard reads -----------------------------------------------------

    def alerts(self) -> dict:
        out = self.engine.active_alerts()
        by_name = {r.name: r for r in self.engine.rules
                   if hasattr(r, "severity")}
        now = self.clock()
        for a in out:
            rule = by_name.get(a["alert"])
            a["severity"] = rule.severity if rule else "warning"
            a["receiver"] = self.route_for(
                a["alert"], a["severity"], a["labels"])
            a["silenced"] = self.silences.silenced(
                a["alert"], a["labels"], now)
        return {"alerts": out}

    def query(self, text: str, at: float | None = None) -> dict:
        result = self.engine.query(text, at=at)
        return {"query": text,
                "result": [{"labels": labels, "value": value}
                           for labels, value in result]}

    def goodput(self, chips: int = 1, window_s: float | None = None,
                at: float | None = None) -> dict:
        """Training goodput from the span stream + serving SLO status
        from the TSDB — the /api/goodput body."""
        spans = self.collector.spans()
        report = gp.job_report(spans, chips=chips)
        now = self.clock() if at is None else at
        slos = [slo.from_store(self.store, now,
                               window_s=window_s or 300.0)
                for slo in self.slos]
        return {"training": report.check().to_dict(), "serving": slos}

    def remediation_audit(self) -> dict:
        if self.remediator is None:
            return {"audit": []}
        return {"audit": self.remediator.audit()}

    def chargeback(self, window_s: float = 300.0,
                   at: float | None = None,
                   chips_by_tenant: dict | None = None,
                   default_chips: int = 1) -> dict:
        """The per-tenant bill over the trailing window — the
        /api/chargeback body. For every tenant seen in the span stream,
        the TSDB's tenant-labeled router series, or the remediation
        audit: goodput %, chip-seconds lost by cause (the conservation-
        checked ledger cut — ``TenantLedger.check`` raises rather than
        publish an invoice that doesn't add up to the fleet ledger),
        SLO attainment, and the remediation actions its alerts
        triggered."""
        now = self.clock() if at is None else at
        start = max(now - max(window_s, 0.0), 0.0)
        ledger = gp.tenant_report(
            self.collector.spans(), start, now,
            chips_by_tenant=chips_by_tenant,
            default_chips=default_chips).check()
        tenants = set(ledger.reports)
        for labels, _v in self.engine.query(
                "sum by (tenant) (router_requests_total)", at=now):
            if labels.get("tenant"):
                tenants.add(labels["tenant"])
        audit = (self.remediator.audit()
                 if self.remediator is not None else [])
        remediations: dict[str, int] = {}
        for decision in audit:
            if decision.get("at") is not None \
                    and not (start <= decision["at"] <= now):
                continue
            tenant = decision.get("tenant") or "default"
            remediations[tenant] = remediations.get(tenant, 0) + 1
        tenants.update(remediations)
        out: dict = {
            "window_s": round(max(window_s, 0.0), 6),
            "at": round(now, 6),
            "chips": ledger.chips,
            "tenants": {},
        }
        for tenant in sorted(tenants):
            report = ledger.reports.get(tenant)
            slos = [slo.from_store(self.store, now,
                                   window_s=max(window_s, 1.0),
                                   tenant=tenant)
                    for slo in self.slos]
            out["tenants"][tenant] = {
                "goodput": (report.check().to_dict()
                            if report is not None else None),
                "slo": slos,
                "remediations": remediations.get(tenant, 0),
            }
        return out

    # -- thread shell --------------------------------------------------------

    def start(self) -> "FleetPlane":  # pragma: no cover - thread shell
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="obs-plane", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:  # pragma: no cover - thread shell
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.scraper.interval_s + 5)
            self._thread = None

    def _run(self) -> None:  # pragma: no cover - thread shell
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:  # the plane must outlive a bad pass
                import logging

                logging.getLogger("kubeflow_tpu_torch.obs.plane").exception(
                    "plane tick failed")
            self._stop.wait(self.scraper.interval_s)


_default: FleetPlane | None = None
_default_lock = threading.Lock()


def default_plane() -> FleetPlane:
    """The process-wide plane (lazily built, self-scraping the global
    MetricsRegistry). The dashboard serves this one unless handed
    another. STARTED on first build — a plane that is never ticked
    would serve a permanently empty store and a silent alert surface,
    which is worse than no plane at all."""
    global _default
    with _default_lock:
        if _default is None:
            from kubeflow_tpu_torch.obs.tsdb import RegistryTarget
            from kubeflow_tpu_torch.runtime.metrics import REGISTRY

            _default = FleetPlane(
                targets=[RegistryTarget("self", REGISTRY)]).start()
        return _default
