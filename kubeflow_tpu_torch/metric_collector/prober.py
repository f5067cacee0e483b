"""Availability prober: the `kubeflow_availability` gauge.

Mirrors metric-collector/service-readiness/kubeflow-readiness.py: an
authenticated GET against the platform endpoint sets a binary Prometheus
gauge (:20-22, metric_update :25-37). Auth is pluggable (the reference
used OIDC-through-IAP; header-identity and none are provided here), and
a multi-target mode probes every component the TpuDef deployed.

Port of `kubeflow_tpu/metric_collector/prober.py`. Results land in a
``MetricsRegistry`` (the process's REGISTRY unless given another), which
the fleet observability plane (``obs/tsdb.ScrapeLoop``) pulls through a
``RegistryTarget`` or the registry's ``/metrics`` endpoint; the JAX
package also mirrors the gauge into prometheus_client, which the port
does not use. ``http_check`` speaks HTTP through urllib, where the JAX
package uses requests; the probe loop (the JAX package's
``AvailabilityProber.run``) is the module's ``main``, which stops on
SIGTERM.
"""

from __future__ import annotations

import logging
import urllib.error
import urllib.request
from typing import Callable

from kubeflow_tpu_torch.runtime.metrics import REGISTRY, MetricsRegistry

log = logging.getLogger("kubeflow_tpu_torch.metric_collector")


def http_check(url: str, headers: dict[str, str] | None = None,
               timeout: float = 10.0) -> bool:
    """True when a GET of ``url`` answers 2xx or 3xx (redirects are
    followed, as requests.get does)."""
    req = urllib.request.Request(url, headers=headers or {}, method="GET")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return 200 <= resp.status < 400
    except urllib.error.HTTPError as e:
        return 200 <= e.code < 400
    except Exception as e:
        log.debug("probe %s failed: %s", url, e)
        return False


class AvailabilityProber:
    def __init__(
        self,
        targets: dict[str, str],
        checker: Callable[[str], bool] | None = None,
        user_header: str | None = None,
        registry: MetricsRegistry | None = None,
    ):
        headers = {"kubeflow-userid": user_header} if user_header else {}
        self.targets = targets
        self.checker = checker or (lambda url: http_check(url, headers))
        self.registry = registry if registry is not None else REGISTRY

    def probe_once(self) -> dict[str, bool]:
        out = {}
        for name, url in self.targets.items():
            up = self.checker(url)
            self.registry.gauge(
                "kubeflow_availability", 1 if up else 0,
                help_="whether the kubeflow-tpu endpoint answers "
                      "(1 up / 0 down)", target=name)
            self.registry.counter_inc(
                "kubeflow_probe_total",
                help_="availability probes by result",
                target=name, result="up" if up else "down")
            out[name] = up
        return out



def main(argv: list[str] | None = None) -> int:
    """Probe every ``--target name=url`` each ``--period-secs`` and serve
    the registry's ``/metrics`` (and ``/healthz``) on ``--port`` until
    SIGTERM or SIGINT, then exit 0."""
    import argparse

    from kubeflow_tpu_torch.runtime.metrics import serve_metrics
    from kubeflow_tpu_torch.utils.httpd import serve_until_signalled

    p = argparse.ArgumentParser("kubeflow-tpu-metric-collector")
    p.add_argument("--target", action="append", default=[],
                   help="name=url, repeatable")
    p.add_argument("--port", type=int, default=8088)
    p.add_argument("--period-secs", type=float, default=30.0)
    args = p.parse_args(argv)
    targets = dict(t.split("=", 1) for t in args.target) or {
        "dashboard": "http://centraldashboard.kubeflow.svc/healthz"}
    prober = AvailabilityProber(targets)

    def probe() -> None:
        down = [k for k, up in prober.probe_once().items() if not up]
        if down:
            log.warning("targets down: %s", down)

    svc = serve_metrics(args.port)
    return serve_until_signalled(
        svc, f"metric collector on :{svc.port}", period_s=args.period_secs,
        each_period=probe)
