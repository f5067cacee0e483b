"""Goodput accounting: what fraction of chip-seconds were productive?

"Scale MLPerf-0.6 models on Google TPU-v3 Pods" (PAPERS.md) frames
pod-scale efficiency as THE metric; at fleet scale the question is not
"is the job running" but "of the wall-clock the gang held chips, how
much advanced the model?". This module answers it from telemetry the
platform already emits — the PR 4 span stream — with no new
instrumentation contract:

- ``train.step``                 -> ``productive_step`` (or ``compile``
                                    when the span carries the trainer's
                                    ``compile=True`` attr — step 0 pays
                                    XLA compilation)
- ``train.checkpoint``           -> ``checkpoint`` (Checkpointer.save's
                                    device->host + queue window)
- ``elastic.rebuild``            -> ``resize_rebuild`` (teardown,
                                    re-formation, trainer rebuild and
                                    restore across an elastic resize)
- ``jaxjob.provision`` after the
  first                          -> ``restart_rebuild`` (gang restarts
                                    re-provisioning the world)
- window start -> first activity -> ``blocked_on_admission`` (queue
                                    wait + scheduling + image pull +
                                    process start: everything before
                                    the first classified span)
- everything else                -> ``other`` (data stalls, eval,
                                    Python overhead — visible on
                                    purpose: a growing ``other`` is a
                                    profiling signal, not a rounding
                                    error)

Accounting is a single SPMD timeline: overlapping spans are resolved
by bucket priority on an interval sweep, so a checkpoint inside a step
window never double-counts — **conservation** (buckets sum exactly to
the wall-clock window) is checked, not assumed (``GoodputReport.check``
raises on violation; the chaos soak and the elastic resize drill
assert it). Chip-seconds-lost = bucket seconds x gang chips.

``ServingSLO`` is the serving-side counterpart: a latency target +
error budget evaluated from the router's native histograms, the numbers
``GET /api/goodput`` serves and the SLO-burn alert watches.

Port of `kubeflow_tpu/obs/goodput.py` on GPUs: the same accounting over
the port's own span stream and registry. A gang's ``chips`` are its
GPUs, so ``chip_seconds_lost`` counts GPU-seconds; the env variable that
sizes it (``TPU_GOODPUT_CHIPS``) and the exported series
(``goodput_ratio``, ``goodput_wall_seconds``,
``goodput_bucket_seconds``, ``goodput_chip_seconds_lost``) keep the JAX
package's names, which dashboards and alerts read. Left out:
``ServingSLO.from_store``, which reads the fleet TSDB through
``obs/rules.py``, a module the port does not have
(``ServingSLO.from_registry`` is kept).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from kubeflow_tpu_torch.obs.trace import Span

# Bucket names, priority order (earlier wins where spans overlap).
PRODUCTIVE = "productive_step"
COMPILE = "compile"
CHECKPOINT = "checkpoint"
RESIZE = "resize_rebuild"
RESTART = "restart_rebuild"
ADMISSION = "blocked_on_admission"
OTHER = "other"
BUCKETS = (PRODUCTIVE, COMPILE, CHECKPOINT, RESIZE, RESTART, ADMISSION,
           OTHER)

# span name -> bucket. jaxjob.provision is special-cased (first one is
# startup, later ones are restarts) in classify().
SPAN_BUCKETS = {
    "train.step": PRODUCTIVE,
    "train.checkpoint": CHECKPOINT,
    "elastic.rebuild": RESIZE,
    "jaxjob.provision": RESTART,
}


@dataclass
class GoodputReport:
    """One window's accounting. ``buckets`` are seconds; they sum to
    ``wall_s`` (conservation — ``check()`` proves it)."""

    wall_s: float
    chips: int
    buckets: dict = field(default_factory=dict)

    @property
    def goodput(self) -> float:
        """Fraction of wall time in productive steps (0..1)."""
        if self.wall_s <= 0:
            return 0.0
        return self.buckets.get(PRODUCTIVE, 0.0) / self.wall_s

    def chip_seconds_lost(self) -> dict:
        """Chip-seconds by non-productive cause — the fleet-level cost
        of each failure mode, the number capacity planning wants."""
        return {name: round(self.buckets.get(name, 0.0) * self.chips, 6)
                for name in BUCKETS if name != PRODUCTIVE}

    def check(self, tolerance: float = 1e-6) -> "GoodputReport":
        """Conservation: bucket seconds sum to the wall window. A
        violation means double-counted or dropped time — raise, never
        publish a goodput number that doesn't add up."""
        total = sum(self.buckets.values())
        if not math.isclose(total, self.wall_s, abs_tol=tolerance,
                            rel_tol=1e-9):
            raise AssertionError(
                f"goodput buckets sum to {total:.9f}s != wall "
                f"{self.wall_s:.9f}s (delta {total - self.wall_s:+.9f})")
        return self

    def to_dict(self) -> dict:
        return {
            "wall_s": round(self.wall_s, 6),
            "chips": self.chips,
            "goodput_pct": round(self.goodput * 100.0, 3),
            "buckets_s": {k: round(v, 6)
                          for k, v in sorted(self.buckets.items())},
            "chip_seconds_lost": self.chip_seconds_lost(),
        }


def classify(spans: list[Span]) -> list[tuple[int, float, float]]:
    """Spans -> (priority, start, end) intervals. Priority is the
    bucket's index in BUCKETS (lower wins). Open spans are skipped —
    an unfinished step cannot be credited yet."""
    provisions = sorted(
        (s for s in spans if s.name == "jaxjob.provision"
         and s.end is not None),
        key=lambda s: s.start)
    first_provision = provisions[0] if provisions else None
    out: list[tuple[int, float, float]] = []
    for s in spans:
        if s.end is None or s.end <= s.start:
            continue
        bucket = SPAN_BUCKETS.get(s.name)
        if bucket is None:
            continue
        if s.name == "train.step" and s.attrs.get("compile"):
            bucket = COMPILE
        if s.name == "jaxjob.provision" and s is first_provision:
            # the FIRST provision is cold start: it precedes the first
            # worker activity and lands in blocked_on_admission with
            # the rest of the startup gap
            bucket = ADMISSION
        out.append((BUCKETS.index(bucket), s.start, s.end))
    return out


def account(spans: list[Span], window_start: float, window_end: float,
            chips: int = 1) -> GoodputReport:
    """Sweep-line accounting of ``spans`` over ``[window_start,
    window_end]``: each elementary segment goes to the highest-priority
    covering interval; the prefix before the first classified activity
    is ``blocked_on_admission``; the uncovered remainder is ``other``.
    Conservation holds by construction — and is re-checked in
    ``GoodputReport.check`` because "by construction" has been wrong
    before."""
    wall = max(window_end - window_start, 0.0)
    report = GoodputReport(wall_s=wall, chips=max(int(chips), 1),
                           buckets={name: 0.0 for name in BUCKETS})
    if wall <= 0:
        return report
    intervals = []
    for prio, s, e in classify(spans):
        s = max(s, window_start)
        e = min(e, window_end)
        if e > s:
            intervals.append((prio, s, e))
    # the admission prefix: window start up to the first NON-admission
    # activity (worker spans or a restart/resize rebuild) — the first
    # provision and any gap around it are all "waiting to start"
    admission_prio = BUCKETS.index(ADMISSION)
    first_activity = min((s for prio, s, _ in intervals
                          if prio < admission_prio),
                         default=window_end)
    if first_activity > window_start:
        intervals.append((BUCKETS.index(ADMISSION), window_start,
                          first_activity))
    # sweep the elementary segments between all boundaries; a per-
    # priority active count makes the whole pass O(n log n) — the soak
    # hands this thousands of spans
    deltas: dict[float, list[int]] = {}
    for prio, s, e in intervals:
        deltas.setdefault(s, [0] * len(BUCKETS))[prio] += 1
        deltas.setdefault(e, [0] * len(BUCKETS))[prio] -= 1
    cuts = sorted({window_start, window_end, *deltas})
    active = [0] * len(BUCKETS)
    for lo, hi in zip(cuts, cuts[1:]):
        if lo in deltas:
            for prio, d in enumerate(deltas[lo]):
                active[prio] += d
        if hi <= window_start or lo >= window_end:
            continue
        best = next((p for p, n in enumerate(active) if n > 0), None)
        name = BUCKETS[best] if best is not None else OTHER
        report.buckets[name] += hi - lo
    return report


def job_report(spans: list[Span], chips: int = 1,
               window_start: float | None = None,
               window_end: float | None = None) -> GoodputReport:
    """Convenience: account a job's trace over its own observed extent
    (root span start -> latest span end) unless the caller pins the
    window (the drills pin it to the drill clock)."""
    closed = [s for s in spans if s.end is not None]
    if not closed and window_start is None:
        return GoodputReport(wall_s=0.0, chips=max(int(chips), 1),
                             buckets={name: 0.0 for name in BUCKETS})
    start = window_start if window_start is not None \
        else min(s.start for s in closed)
    # a pinned start with nothing closed yet: an all-admission window,
    # not a max()-over-empty crash
    end = window_end if window_end is not None \
        else max((s.end for s in closed), default=start)
    return account(spans, start, end, chips=chips)


# -- tenant attribution (the chargeback ledger cut) ---------------------------

# span attrs consulted for the billing tenant, in precedence order: an
# explicit tenant attr (the router stamps one per dispatch) wins over
# the emitting controller's namespace.
TENANT_ATTRS = ("tenant", "namespace")
DEFAULT_TENANT = "default"


def span_tenant(span: Span) -> str:
    """The tenant a span bills to — its ``tenant`` attr, else its
    ``namespace``, else the default tenant (fleet-global spans like
    scheduler passes land there on purpose: unattributable time must
    stay visible, not vanish)."""
    for key in TENANT_ATTRS:
        value = span.attrs.get(key)
        if value:
            return str(value)
    return DEFAULT_TENANT


@dataclass
class TenantLedger:
    """The per-tenant cut of the goodput ledger over one window.

    Each tenant gets its own sweep-line ``GoodputReport`` over ITS
    spans (tenants are independent SPMD timelines — one tenant's
    checkpoint must never mask another's productive step), weighted by
    that tenant's chips. ``check()`` proves conservation twice: every
    per-tenant report conserves to the wall window, AND the chip-second
    buckets summed across tenants equal the fleet total
    (``wall x total chips``) exactly — a chargeback invoice that does
    not add up to the fleet bill is raised, never published."""

    wall_s: float
    reports: dict = field(default_factory=dict)   # tenant -> GoodputReport

    @property
    def chips(self) -> int:
        return sum(r.chips for r in self.reports.values())

    def chip_seconds_by_tenant(self) -> dict:
        """tenant -> {cause: chip_seconds} over EVERY bucket (including
        productive time — the invoice bills held chips, not just lost
        ones)."""
        return {
            tenant: {name: r.buckets.get(name, 0.0) * r.chips
                     for name in BUCKETS}
            for tenant, r in sorted(self.reports.items())
        }

    def check(self, tolerance: float = 1e-6) -> "TenantLedger":
        """Conservation, raised not warned (the fleet ledger's
        discipline): per-tenant bucket seconds sum to the wall window,
        and summed chip-seconds across tenants equal the fleet
        ledger."""
        total = 0.0
        for tenant, r in self.reports.items():
            try:
                r.check(tolerance)
            except AssertionError as e:
                raise AssertionError(f"tenant {tenant!r}: {e}") from None
            total += sum(r.buckets.values()) * r.chips
        fleet = self.wall_s * self.chips
        if not math.isclose(total, fleet, abs_tol=tolerance,
                            rel_tol=1e-9):
            raise AssertionError(
                f"tenant chip-seconds sum to {total:.9f} != fleet "
                f"ledger {fleet:.9f} (delta {total - fleet:+.9f})")
        return self

    def to_dict(self) -> dict:
        return {
            "wall_s": round(self.wall_s, 6),
            "chips": self.chips,
            "tenants": {tenant: r.to_dict()
                        for tenant, r in sorted(self.reports.items())},
        }


def tenant_report(spans: list[Span], window_start: float,
                  window_end: float,
                  chips_by_tenant: dict | None = None,
                  default_chips: int = 1) -> TenantLedger:
    """Cut the span stream by billing tenant and account each tenant's
    timeline over the SAME window. ``chips_by_tenant`` sets each
    tenant's chip weight (missing tenants get ``default_chips``);
    tenants listed there with no spans still get a report — an
    all-admission window, the honest bill for chips held idle."""
    by_tenant: dict[str, list[Span]] = {}
    for s in spans:
        by_tenant.setdefault(span_tenant(s), []).append(s)
    for tenant in (chips_by_tenant or {}):
        by_tenant.setdefault(tenant, [])
    ledger = TenantLedger(wall_s=max(window_end - window_start, 0.0))
    for tenant, tenant_spans in sorted(by_tenant.items()):
        chips = (chips_by_tenant or {}).get(tenant, default_chips)
        ledger.reports[tenant] = account(
            tenant_spans, window_start, window_end, chips=chips)
    return ledger


# -- serving SLOs ------------------------------------------------------------


@dataclass
class ServingSLO:
    """A latency objective over the router histogram: ``objective`` of
    requests complete within ``latency_target_s``. The target must sit
    on a REQUEST_BUCKETS bound (serving/router.py) — attainment is read
    straight off the cumulative ``le`` counts, no interpolation, so the
    SLO is exact rather than estimated."""

    name: str = "router-latency"
    latency_target_s: float = 0.5
    objective: float = 0.99

    @property
    def le(self) -> str:
        """The bucket label the target matches, normalized through
        float(): the registry renders ``le`` bounds as ``str(float)``
        ("1.0", never "1"), so an int-valued target must not silently
        match zero fast samples."""
        return str(float(self.latency_target_s))

    def _status(self, fast: float, total: float) -> dict:
        budget = max(1.0 - self.objective, 1e-9)
        attainment = (fast / total) if total > 0 else 1.0
        burn = (1.0 - attainment) / budget
        return {
            "slo": self.name,
            "latency_target_s": self.latency_target_s,
            "objective": self.objective,
            "requests": total,
            "attainment": round(attainment, 6),
            # 1.0 = burning the whole budget over the period measured
            "budget_burn": round(burn, 6),
            "budget_remaining": round(1.0 - burn, 6),
            "met": attainment >= self.objective,
        }

    def from_registry(self, registry, namespace: str,
                      service: str, tenant: str | None = None) -> dict:
        """Cumulative-since-start attainment from a MetricsRegistry's
        router histogram (the in-process shape). ``tenant`` narrows to
        one billing tenant's series (the chargeback cut)."""
        fast = total = 0.0
        # the native histogram renders per-le series; read via the text
        # exposition through the ONE parser
        from kubeflow_tpu_torch.obs import expofmt

        for s in expofmt.parse(registry.render()):
            labels = s.labels_dict()
            if labels.get("namespace") != namespace or \
                    labels.get("service") != service:
                continue
            if tenant is not None and labels.get("tenant") != tenant:
                continue
            if s.name == "router_request_seconds_bucket" and \
                    labels.get("le") == self.le:
                fast += s.value
            elif s.name == "router_request_seconds_count":
                total += s.value
        return self._status(fast, total)


# -- the goodput exporter -----------------------------------------------------

# GPU count multiplying chip-seconds-lost (GPU-seconds here) in exported
# series; 0 disables the export loop entirely (controller managers read
# this; unset means 1)
ENV_GOODPUT_CHIPS = "TPU_GOODPUT_CHIPS"


class GoodputExporter:
    """Publish the goodput ledger as ``goodput_*`` series.

    The PR 10 ledger could be *queried* (``GET /api/goodput``) but no
    production process ever exported it — fleet dashboards had nothing
    to scrape. This exporter closes that open: each ``export_once``
    recomputes the report from the process's span stream and publishes

    - ``goodput_ratio``                      (0..1)
    - ``goodput_wall_seconds``               (accounted window)
    - ``goodput_bucket_seconds{bucket=}``    (per-cause time)
    - ``goodput_chip_seconds_lost{cause=}``  (per-cause chip cost)

    into the MetricsRegistry, so the scrape plane picks them up like
    any other series. ``run_controller`` mains start one; harnesses
    call ``export_once(at=...)`` on virtual time."""

    def __init__(self, registry=None, collector=None, chips: int = 1,
                 interval_s: float = 30.0):
        from kubeflow_tpu_torch.obs import trace as obs_trace
        from kubeflow_tpu_torch.runtime.metrics import REGISTRY

        self.registry = registry if registry is not None else REGISTRY
        self.collector = collector if collector is not None \
            else obs_trace.COLLECTOR
        self.chips = max(int(chips), 1)
        self.interval_s = interval_s
        self._thread = None
        self._stop = None

    def export_once(self, at: float | None = None) -> GoodputReport:
        spans = self.collector.spans()
        report = job_report(spans, chips=self.chips, window_end=at)
        self.registry.gauge("goodput_ratio", report.goodput,
                            help_="fraction of wall time in productive "
                                  "steps (0..1)")
        self.registry.gauge("goodput_wall_seconds", report.wall_s,
                            help_="wall-clock window the ledger "
                                  "accounted")
        for name, secs in sorted(report.buckets.items()):
            self.registry.gauge("goodput_bucket_seconds", secs,
                                help_="accounted seconds by cause",
                                bucket=name)
        for cause, cost in sorted(report.chip_seconds_lost().items()):
            self.registry.gauge("goodput_chip_seconds_lost", cost,
                                help_="chip-seconds lost by "
                                      "non-productive cause", cause=cause)
        return report

    def start(self) -> "GoodputExporter":  # pragma: no cover - thread
        import threading

        if self._thread is None:
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._run, name="goodput-export", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:  # pragma: no cover - thread shell
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:  # pragma: no cover - thread shell
        import logging

        while not self._stop.wait(self.interval_s):
            try:
                self.export_once()
            except Exception:  # telemetry must never kill the process
                logging.getLogger("kubeflow_tpu_torch.obs.goodput").exception(
                    "goodput export failed")
