"""Bounded in-memory TSDB + the fleet scrape loop.

Every process has a ``MetricsRegistry`` filled with the series an
operator must watch — but each registry only knows its own process.
This module is the aggregation plane: a bounded ring timeseries store
(``TimeSeriesStore``) and a ``ScrapeLoop`` that pulls targets
discovered three ways:

- **in-process**: a ``MetricsRegistry`` object (``RegistryTarget``) —
  the hermetic-harness and single-binary shape;
- **HTTP**: any ``/metrics`` endpoint (``HttpTarget``) — workers at
  ``:9100``, the router, the prober;
- **cluster**: JAXService replica endpoints read from the controller's
  endpoints annotation through a ``ClusterCache`` or k8s client
  (``jaxservice_targets``) — membership-driven discovery, zero
  steady-state list calls on a cache.

Every exposition body goes through the ONE parser (``obs/expofmt.py``,
shared with the router's ``RegistrySignals``). Design constraints
follow ``obs/trace.py``: stdlib-only, bounded memory (a ring per
series + a series-count cap), injectable clock so the rule engine,
benchmarks and drills replay deterministically on virtual time.

Staleness follows Prometheus: when a target stops answering, every
series it last exposed gets a NaN marker — instant selectors skip the
series from that point, so alerts over a dead replica RESOLVE instead
of firing forever on its last-known-bad value. ``up{instance=}`` is
synthesized per target (1/0) exactly like Prometheus, so target loss
itself is alertable.

Port of `kubeflow_tpu/obs/tsdb.py`: the same store, targets, discovery
and staleness over the port's exposition parser, its router's
``parse_endpoints`` and its JAXService types. A replica scraped here is
one of the port's GPU serving replicas, whose ``serving_kv_pages_free``
counts the KV cache's pages in the card's memory.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Iterable

from kubeflow_tpu_torch.obs import expofmt

log = logging.getLogger("kubeflow_tpu_torch.obs.tsdb")

# Series key: (name, sorted (k,v) label tuple). The instance/job labels
# the scraper attaches are part of the key, like any other label.
SeriesKey = tuple[str, tuple[tuple[str, str], ...]]

# the one staleness marker value (Prometheus's dedicated NaN bit
# pattern — see expofmt.is_stale: real NaN data is not staleness)
STALE = expofmt.STALE_NAN


def series_key(name: str, labels: dict | None = None,
               extra: dict | None = None) -> SeriesKey:
    merged = dict(labels or {})
    if extra:
        merged.update(extra)
    return (name, tuple(sorted(merged.items())))


class TimeSeriesStore:
    """Label-indexed store of ``(t, value)`` rings.

    - ``max_points`` bounds every series (ring: old points age out);
    - ``max_series`` bounds cardinality — appends creating a series
      beyond the cap are DROPPED and counted (``stats['dropped']``),
      never an unbounded dict: a label-explosion bug in one target
      cannot OOM the plane that watches it.

    Counters, gauges and native-histogram component series
    (``_bucket``/``_sum``/``_count``) all land here as plain series,
    exactly like Prometheus — ``rate()``/``histogram_quantile`` in
    obs/rules.py reconstruct meaning from the samples.
    """

    def __init__(self, max_points: int = 512, max_series: int = 50000):
        self.max_points = max_points
        self.max_series = max_series
        self._lock = threading.Lock()
        self._series: dict[SeriesKey, deque[tuple[float, float]]] = {}
        self._by_name: dict[str, set[SeriesKey]] = {}
        self._appends = 0
        self._dropped = 0

    # -- writes --------------------------------------------------------------

    def append(self, name: str, labels: dict | None, value: float,
               t: float) -> bool:
        key = series_key(name, labels)
        with self._lock:
            ring = self._series.get(key)
            if ring is None:
                if len(self._series) >= self.max_series:
                    self._dropped += 1
                    return False
                ring = self._series[key] = deque(maxlen=self.max_points)
                self._by_name.setdefault(name, set()).add(key)
            ring.append((float(t), float(value)))
            self._appends += 1
        return True

    def mark_stale(self, key: SeriesKey, t: float) -> None:
        """Append a staleness marker to an EXISTING series (noop for an
        unknown key — a target that died before its first scrape has
        nothing to mark)."""
        with self._lock:
            ring = self._series.get(key)
            if ring is not None:
                ring.append((float(t), STALE))
                self._appends += 1

    # -- reads ---------------------------------------------------------------

    @staticmethod
    def _match(key: SeriesKey, matchers: dict[str, str] | None) -> bool:
        if not matchers:
            return True
        labels = dict(key[1])
        return all(labels.get(k) == v for k, v in matchers.items())

    def instant(self, name: str, matchers: dict[str, str] | None,
                at: float, lookback: float = 300.0,
                ) -> list[tuple[dict, float]]:
        """Latest point per matching series within ``(at-lookback, at]``
        — the PromQL instant-vector read. A series whose newest
        in-window point is a staleness marker is EXCLUDED (its target
        vanished); one with no point in the window is excluded too
        (aged out / never scraped)."""
        out: list[tuple[dict, float]] = []
        with self._lock:
            for key in self._by_name.get(name, ()):
                if not self._match(key, matchers):
                    continue
                newest = None
                for t, v in reversed(self._series[key]):
                    if t <= at:
                        newest = (t, v)
                        break
                if newest is None or newest[0] <= at - lookback:
                    continue
                if expofmt.is_stale(newest[1]):
                    continue
                out.append((dict(key[1]), newest[1]))
        return out

    def window(self, name: str, matchers: dict[str, str] | None,
               start: float, end: float,
               ) -> list[tuple[dict, list[tuple[float, float]]]]:
        """All points per matching series in ``(start, end]`` — the
        range-vector read (``rate()``/``increase()`` input). Staleness
        markers are filtered out here: a counter's rate must be
        computed over its real samples only."""
        out: list[tuple[dict, list[tuple[float, float]]]] = []
        with self._lock:
            for key in self._by_name.get(name, ()):
                if not self._match(key, matchers):
                    continue
                pts = [(t, v) for t, v in self._series[key]
                       if start < t <= end and not expofmt.is_stale(v)]
                if pts:
                    out.append((dict(key[1]), pts))
        return out

    def dump_since(self, since: float | None = None,
                   ) -> list[tuple[str, dict, list[tuple[float, float]]]]:
        """Every series' points with ``t > since`` (None = everything),
        in deterministic (name, labels) order — the persistence read
        (``obs/persist.py``). Staleness markers are INCLUDED: a restore
        must reproduce them or a dead target's series would look live
        again."""
        out: list[tuple[str, dict, list[tuple[float, float]]]] = []
        with self._lock:
            for name in sorted(self._by_name):
                for key in sorted(self._by_name[name]):
                    pts = [(t, v) for t, v in self._series[key]
                           if since is None or t > since]
                    if pts:
                        out.append((name, dict(key[1]), pts))
        return out

    def latest(self, key: SeriesKey) -> tuple[float, float] | None:
        with self._lock:
            ring = self._series.get(key)
            return ring[-1] if ring else None

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._by_name)

    def series_count(self, name: str | None = None) -> int:
        with self._lock:
            if name is None:
                return len(self._series)
            return len(self._by_name.get(name, ()))

    def stats(self) -> dict[str, int]:
        """Deterministic op counts — what the bench and the tier-1
        smoke pin (appends do not depend on the machine)."""
        with self._lock:
            points = sum(len(r) for r in self._series.values())
            return {"series": len(self._series), "points": points,
                    "appends": self._appends, "dropped": self._dropped}


# -- scrape targets ----------------------------------------------------------


class Target:
    """One scrapeable exposition source. ``instance`` becomes the
    ``instance`` label on every ingested series (and on ``up``);
    ``labels`` ride along (e.g. ``job``, ``service``, ``replica``)."""

    def __init__(self, instance: str, labels: dict | None = None):
        self.instance = instance
        self.labels = dict(labels or {})

    def fetch(self) -> str:  # pragma: no cover - interface
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.instance}>"


class RegistryTarget(Target):
    """An in-process ``MetricsRegistry`` — scraped through its text
    exposition so the wire parser sees EXACTLY what an HTTP scrape
    would (the fast ``MetricsRegistry.series()`` path stays the
    router-signal read; parity between the two is pinned in tests)."""

    def __init__(self, instance: str, registry,
                 labels: dict | None = None):
        super().__init__(instance, labels)
        self.registry = registry

    def fetch(self) -> str:
        return self.registry.render()


class HttpTarget(Target):
    """A ``GET /metrics`` endpoint (urllib, stdlib-only — the
    RestClient discipline)."""

    def __init__(self, instance: str, url: str, labels: dict | None = None,
                 timeout: float = 10.0):
        super().__init__(instance, labels)
        self.url = url
        self.timeout = timeout

    def fetch(self) -> str:
        import urllib.request

        with urllib.request.urlopen(self.url, timeout=self.timeout) as resp:
            return resp.read().decode("utf-8", "replace")


def jaxservice_targets(source, namespace: str | None = None,
                       path: str = "/metrics") -> list[HttpTarget]:
    """Discover replica scrape targets from JAXService endpoints
    annotations — the SAME wire contract the router consumes
    (``serving.router.parse_endpoints``; one spelling).

    ``source`` is anything with ``objects(api_version, kind)`` (a
    ``ClusterCache`` — zero list calls at steady state) or ``list``
    (a raw k8s client). Cordoned replicas stay scraped: an operator
    wants to SEE a draining replica's metrics."""
    from kubeflow_tpu_torch.control.jaxservice import types as ST
    from kubeflow_tpu_torch.serving.router import parse_endpoints

    if hasattr(source, "objects"):
        objs = list(source.objects(ST.API_VERSION, ST.KIND).values())
    else:
        objs = source.list(ST.API_VERSION, ST.KIND, namespace=namespace)
    out: list[HttpTarget] = []
    for svc in objs:
        meta = svc.get("metadata") or {}
        ns = meta.get("namespace") or "default"
        if namespace is not None and ns != namespace:
            continue
        for ep in parse_endpoints(svc):
            addr = ep.get("addr") or ""
            if not addr:
                continue
            url = addr if "://" in addr else f"http://{addr}"
            # instance is namespace-qualified: replica POD names repeat
            # across namespaces (team-a/chat-replica-0 and
            # team-b/chat-replica-0), and scrape_once dedups targets by
            # instance — a bare name would silently drop one of them
            out.append(HttpTarget(
                f"{ns}/{ep['name']}", url.rstrip("/") + path,
                labels={"job": "jaxservice", "namespace": ns,
                        "service": meta.get("name", ""),
                        "replica": ep["name"]}))
    return sorted(out, key=lambda t: t.instance)


# -- the scrape loop ---------------------------------------------------------


class ScrapeLoop:
    """Pull every target's exposition into the store. Deterministic
    core (``scrape_once`` with an injectable clock — what the bench,
    drills, and the rule engine drive); the production loop lifecycle
    belongs to ``obs/plane.py:FleetPlane`` — a scraper ticking without
    its rule engine would be a half-alive plane.

    Target loss: a fetch that raises writes ``up{instance=} 0`` and a
    staleness marker on every series that instance exposed on its last
    good scrape — downstream instant selectors drop them, alerts over
    the dead target resolve. Recovery simply overwrites: the next good
    scrape appends fresh points after the markers.
    """

    def __init__(self, store: TimeSeriesStore,
                 targets: Iterable[Target] = (),
                 discover: Callable[[], Iterable[Target]] | None = None,
                 interval_s: float = 15.0,
                 clock: Callable[[], float] = time.time,
                 registry=None):
        self.store = store
        self.targets: list[Target] = list(targets)
        # re-evaluated every cycle (cluster membership moves between
        # scrapes); static targets always scrape too
        self.discover = discover
        self.interval_s = interval_s
        self.clock = clock
        self.registry = registry  # MetricsRegistry for plane self-metrics
        self._lock = threading.Lock()
        self._exposed: dict[str, set[SeriesKey]] = {}  # instance -> keys
        self._up: dict[str, bool] = {}
        self._up_labels: dict[str, dict] = {}  # instance -> up's label set
        self._scrapes = 0
        self._failures = 0
        self._samples = 0

    # -- one deterministic cycle --------------------------------------------

    def scrape_once(self) -> dict:
        """Scrape every target once at ``clock()``; returns the cycle
        stats (deterministic given target contents)."""
        now = self.clock()
        targets = list(self.targets)
        discovery_ok = True
        if self.discover is not None:
            try:
                targets += list(self.discover())
            except Exception as e:  # discovery source down ≠ plane down
                discovery_ok = False
                log.warning("target discovery failed: %s", e)
        seen: dict[str, Target] = {}
        for t in targets:
            seen.setdefault(t.instance, t)
        ok = failed = samples = 0
        for instance, target in sorted(seen.items()):
            try:
                body = target.fetch()
            except Exception as e:
                failed += 1
                self._mark_down(instance, target, now)
                log.warning("scrape %s failed: %s", instance, e)
                continue
            samples += self._ingest(instance, target, body, now)
            ok += 1
        # targets that VANISHED from discovery (a drained replica
        # leaving the endpoints annotation) are forgotten: every series
        # they exposed — up included — gets a staleness marker so
        # alerts over them resolve, and their bookkeeping is dropped so
        # obs_scrape_targets stops counting a removed replica as "up"
        # forever. (A target that merely FAILED stays tracked above.)
        # Only when discovery itself SUCCEEDED: a one-cycle apiserver
        # blip must not mass-forget the fleet and falsely resolve a
        # live incident's alerts back through a fresh for-duration.
        if discovery_ok:
            with self._lock:
                gone = (set(self._up) | set(self._exposed)) - set(seen)
            for instance in sorted(gone):
                self._forget(instance, now)
        with self._lock:
            self._scrapes += 1
            self._failures += failed
            self._samples += samples
        self._publish()
        return {"targets": len(seen), "ok": ok, "failed": failed,
                "samples": samples, "at": now}

    def _ingest(self, instance: str, target: Target, body: str,
                now: float) -> int:
        extra = {"instance": instance, **target.labels}
        keys: set[SeriesKey] = set()
        n = 0
        for sample in expofmt.parse(body):
            labels = {**sample.labels_dict(), **extra}
            if self.store.append(sample.name, labels, sample.value, now):
                keys.add(series_key(sample.name, labels))
                n += 1
        self.store.append("up", extra, 1.0, now)
        keys.add(series_key("up", extra))
        with self._lock:
            # stale-mark series the target STOPPED exposing (a replica
            # label set that vanished must not linger as last-known)
            gone = self._exposed.get(instance, set()) - keys
            self._exposed[instance] = keys
            self._up[instance] = True
            self._up_labels[instance] = extra
        for key in sorted(gone):
            self.store.mark_stale(key, now)
        return n

    def _mark_down(self, instance: str, target: Target,
                   now: float) -> None:
        # up carries the SAME label set whether the target was ever
        # scraped or died before its first success — `up{job=...} == 0`
        # alerting must match a replica that was unreachable from
        # provisioning onward, not just ones that flapped
        with self._lock:
            was_up = self._up.get(instance, False)
            self._up[instance] = False
            keys = set(self._exposed.get(instance, set()))
            up_labels = dict(self._up_labels.get(instance)
                             or {"instance": instance, **target.labels})
            # remembered even for a never-up target: _forget needs the
            # label set to stale-mark this synthesized up series when
            # the target later leaves discovery entirely
            self._up_labels[instance] = up_labels
        # up=0 lands EVERY failed cycle (the Prometheus shape — target
        # loss stays visible as a live series); the staleness markers
        # land once, on the up->down transition
        self.store.append("up", up_labels, 0.0, now)
        if not was_up:
            return
        for key in sorted(keys):
            if key[0] != "up":
                self.store.mark_stale(key, now)

    def _forget(self, instance: str, now: float) -> None:
        """A target removed from discovery: stale-mark everything it
        exposed (up included) and drop its bookkeeping. A target that
        NEVER scraped successfully has no exposed keys, but its
        synthesized up=0 series still exists — stale-mark it from the
        remembered label set so an `up == 0` alert resolves on the
        removal cycle, not at lookback expiry."""
        with self._lock:
            keys = self._exposed.pop(instance, set())
            self._up.pop(instance, None)
            up_labels = self._up_labels.pop(instance, None)
        if up_labels:
            keys = set(keys)
            keys.add(series_key("up", up_labels))
        for key in sorted(keys):
            self.store.mark_stale(key, now)

    def _publish(self) -> None:
        if self.registry is None:
            return
        with self._lock:
            up = sum(1 for v in self._up.values() if v)
            down = sum(1 for v in self._up.values() if not v)
            scrapes, failures, samples = (self._scrapes, self._failures,
                                          self._samples)
        st = self.store.stats()
        reg = self.registry
        reg.gauge("obs_scrape_targets", up,
                  help_="scrape targets by state", state="up")
        reg.gauge("obs_scrape_targets", down,
                  help_="scrape targets by state", state="down")
        reg.gauge("obs_tsdb_series", st["series"],
                  help_="live series in the fleet TSDB")
        reg.gauge("obs_tsdb_points", st["points"],
                  help_="points currently held across all rings")
        reg.gauge("obs_scrapes_total", scrapes,
                  help_="scrape cycles completed")
        reg.gauge("obs_scrape_failures_total", failures,
                  help_="target fetches that raised")
        reg.gauge("obs_scrape_samples_total", samples,
                  help_="samples ingested across all scrapes")
        reg.gauge("obs_tsdb_series_dropped_total", st["dropped"],
                  help_="appends dropped by the series-cardinality cap")

    def up(self, instance: str) -> bool:
        with self._lock:
            return self._up.get(instance, False)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"scrapes": self._scrapes, "failures": self._failures,
                    "samples": self._samples}
