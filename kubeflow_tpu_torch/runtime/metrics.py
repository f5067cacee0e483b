"""Step metering and the metrics registry (port of
kubeflow_tpu/runtime/metrics.py).

StepMeter: step time, throughput and MFU over a sliding window, with the
port's own peak table; each metered step can be a `train.step` span. A device not in the table gets no MFU (None):
there is no default peak, so an unknown card is never measured against
another's.

MetricsRegistry / REGISTRY: a minimal Prometheus registry (gauges,
counters, histograms; text format 0.0.4) that the serving and decode
meters publish into and `GET /metrics` renders. The reference mirrors
the same signals into prometheus_client as well; the port does not
(the card's machine has no prometheus_client). `serve_metrics` serves
the registry at /metrics with /healthz, as the launcher does at
$JAXRT_METRICS_PORT.
"""

from __future__ import annotations

import threading
import time
from collections import deque

# Dense bf16 tensor-core peak FLOP/s by torch.cuda.get_device_name()
# prefix (NVIDIA H100 data sheet, without sparsity): the SXM part
# reports as "NVIDIA H100 80GB HBM3".
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
    "NVIDIA H100 SXM": 989e12,
    "NVIDIA H100 PCIe": 756e12,
}


def peak_flops(device_kind: str) -> float | None:
    for prefix, val in sorted(PEAK_FLOPS.items(), key=lambda kv: -len(kv[0])):
        if device_kind.startswith(prefix):
            return val
    return None


class StepMeter:
    """Step wall time, examples/sec and MFU over the last `window` steps.
    `flops_per_step` is the whole world's step, so MFU is over the peak
    of the world's `n_chips` devices, as the reference divides by the
    mesh's device count. The caller synchronizes the device before
    stop().

    With ``tracer`` set (an ``obs.trace.Tracer``), each start/stop pair
    also emits a ``train.step`` span under the ambient trace context,
    its ``step`` attribute ``step_base`` + the metered count."""

    def __init__(self, flops_per_step: float, device_kind: str = "",
                 window: int = 20, tracer=None, step_base: int = 0,
                 n_chips: int = 1):
        self.flops_per_step = float(flops_per_step)
        self.n_chips = max(1, n_chips)
        peak = peak_flops(device_kind)
        self.peak = peak * self.n_chips if peak else None
        self._times: deque[float] = deque(maxlen=window)
        self._t0: float | None = None
        self.steps = 0
        self._tracer = tracer
        self.step_base = step_base
        self._span = None

    def start(self) -> None:
        if self._tracer is not None:
            # a previous step that never reached stop() raised: its span
            # still exports, as ERROR
            self.close()
            self._span = self._tracer.begin(
                "train.step", step=self.step_base + self.steps)
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("stop() without start()")
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        self.steps += 1
        self._t0 = None
        if self._span is not None:
            self._span.attrs["step_time_s"] = round(dt, 6)
            self._tracer.finish(self._span)
            self._span = None
        return dt

    def close(self) -> None:
        """Finish a still-open step span as ERROR: the loop unwound
        between start() and stop() (a step raised)."""
        if self._span is not None:
            self._span.status = "ERROR"
            self._tracer.finish(self._span)
            self._span = None

    @property
    def step_time(self) -> float:
        return sum(self._times) / len(self._times) if self._times else float("nan")

    def throughput(self, examples_per_step: int) -> float:
        return examples_per_step / self.step_time

    @property
    def achieved_flops(self) -> float:
        return self.flops_per_step / self.step_time

    @property
    def mfu(self) -> float | None:
        return self.achieved_flops / self.peak if self.peak else None


# Default latency buckets (seconds) — controller-runtime's reconcile
# histogram range: sub-ms reconciles up to minute-scale stalls.
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class _Histogram:
    """Cumulative-bucket histogram state for one label set."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        for i, le in enumerate(self.buckets):
            if value <= le:
                self.counts[i] += 1
                break
        self.sum += value
        self.count += 1


def _escape_label(value) -> str:
    """Prometheus text-format label-value escaping: backslash, quote and
    newline must be escaped or the exposition is unscrapeable."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _label_str(key: tuple, extra: tuple = ()) -> str:
    return ",".join(f'{k}="{_escape_label(v)}"' for k, v in (*key, *extra))


class MetricsRegistry:
    """Minimal Prometheus registry: gauges, counters and native
    histograms, text format 0.0.4."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, tuple[str, str, dict[tuple, object]]] = {}
        self._collectors: list = []

    def _set(self, kind: str, name: str, help_: str, value: float, labels: dict | None):
        key = tuple(sorted((labels or {}).items()))
        with self._lock:
            _, _, series = self._metrics.setdefault(name, (kind, help_, {}))
            series[key] = value

    def add_collector(self, fn) -> None:
        """Run ``fn(registry)`` at every render(), before the exposition
        is built (prometheus_client's custom collectors): a gauge read
        from live state at scrape time, written with set_series."""
        with self._lock:
            self._collectors.append(fn)

    def set_series(self, name: str, kind: str, help_: str,
                   samples: list[tuple[dict, float]]) -> None:
        """Replace every sample of one metric: a label set absent from
        ``samples`` is gone from the exposition, as a collector's family
        holds only what it yielded."""
        with self._lock:
            self._metrics[name] = (kind, help_, {
                tuple(sorted(labels.items())): float(value)
                for labels, value in samples})

    def gauge(self, name: str, value: float, help_: str = "", **labels) -> None:
        self._set("gauge", name, help_, value, labels)

    def gauge_add(self, name: str, by: float, help_: str = "", **labels) -> None:
        """Move a gauge by ``by`` (prometheus_client's Gauge.inc/dec):
        an up-down count such as the JAXJobs currently Running."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            _, _, series = self._metrics.setdefault(name, ("gauge", help_, {}))
            series[key] = series.get(key, 0.0) + by

    def counter_inc(self, name: str, help_: str = "", by: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            _, _, series = self._metrics.setdefault(name, ("counter", help_, {}))
            series[key] = series.get(key, 0.0) + by

    def histogram(self, name: str, value: float, help_: str = "",
                  buckets=DEFAULT_BUCKETS, **labels) -> None:
        """Observe ``value`` into a cumulative-bucket histogram. Renders
        as ``name_bucket{le=...}`` / ``name_sum`` / ``name_count`` —
        the native type the scheduler's hand-rolled ``_sum``/``_count``
        counter pair predated."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            _, _, series = self._metrics.setdefault(
                name, ("histogram", help_, {}))
            hist = series.get(key)
            if not isinstance(hist, _Histogram):
                hist = series[key] = _Histogram(buckets)
            hist.observe(float(value))

    @staticmethod
    def _render_histogram(out: list, name: str, key: tuple,
                          hist: _Histogram) -> None:
        cum = 0
        for le, n in zip(hist.buckets, hist.counts):
            cum += n
            out.append(f"{name}_bucket{{"
                       f"{_label_str(key, (('le', le),))}}} {cum}")
        out.append(f"{name}_bucket{{{_label_str(key, (('le', '+Inf'),))}}} "
                   f"{hist.count}")
        suffix = f"{{{_label_str(key)}}}" if key else ""
        out.append(f"{name}_sum{suffix} {hist.sum}")
        out.append(f"{name}_count{suffix} {hist.count}")

    def series(self, name: str) -> list[tuple[dict, float]]:
        """One scalar metric's samples as (labels, value) pairs, the
        in-process read of the router's RegistrySignals (no render and
        parse of the whole exposition). Histograms are skipped: read
        those through render()."""
        with self._lock:
            entry = self._metrics.get(name)
            if entry is None:
                return []
            return [(dict(key), float(value))
                    for key, value in entry[2].items()
                    if not isinstance(value, _Histogram)]

    def render(self) -> str:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            fn(self)
        out = []
        with self._lock:
            for name, (kind, help_, series) in sorted(self._metrics.items()):
                if help_:
                    out.append(f"# HELP {name} {_escape_help(help_)}")
                out.append(f"# TYPE {name} {kind}")
                for key in sorted(series):
                    value = series[key]
                    if isinstance(value, _Histogram):
                        self._render_histogram(out, name, key, value)
                    elif key:
                        out.append(f"{name}{{{_label_str(key)}}} {value}")
                    else:
                        out.append(f"{name} {value}")
        return "\n".join(out) + "\n"


REGISTRY = MetricsRegistry()


def serve_metrics(port: int = 9100, host: str = "0.0.0.0"):
    """Start /metrics (REGISTRY, text format 0.0.4) and /healthz on a
    daemon thread; returns the HttpService (caller may .shutdown()).
    Port 0 picks a free port."""
    from kubeflow_tpu_torch.utils import httpd

    router = httpd.Router("metrics")
    httpd.add_metrics_route(router)
    httpd.add_health_routes(router)
    return httpd.HttpService(router, host, port).serve_background()
