"""The port's availability prober (kubeflow_tpu_torch/metric_collector/)
against the JAX package's.

`probe_once` runs against a live port `HttpService`: the targets up,
one answering an error status, one refusing the connection. Both
packages' probers write into a `MetricsRegistry` of their own, and the
two registries must render the same exposition, probe after probe; the
port's `http_check` (urllib) must answer as the JAX package's (requests)
on every status. The module's main serves its registry's /metrics while
it probes, and exits 0 on SIGTERM.
"""

import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from kubeflow_tpu.metric_collector import prober as RP
from kubeflow_tpu.runtime.metrics import MetricsRegistry as RRegistry
from kubeflow_tpu_torch.metric_collector import prober as PP
from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry as PRegistry
from kubeflow_tpu_torch.utils import httpd
from test_torch_control_jaxjob import ROOT

STATUSES = (200, 204, 301, 302, 400, 401, 403, 404, 500, 503)


@pytest.fixture(scope="module")
def live():
    """A port HttpService answering /healthz, /status/<code> with that
    code (a 3xx points at /healthz) and echoing the identity header."""
    r = httpd.Router("probe-target")
    httpd.add_health_routes(r)
    seen = []

    def status(req):
        code = int(req.params["code"])
        seen.append(req.header("kubeflow-userid"))
        headers = {"Location": "/healthz"} if 300 <= code < 400 else {}
        return httpd.HttpResp(status=code, body=b"{}", headers=headers)

    r.route("GET", "/status/{code}", status)
    svc = httpd.HttpService(r, "127.0.0.1", 0).serve_background()
    yield f"http://127.0.0.1:{svc.port}", seen
    svc.shutdown()


def _closed_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("code", STATUSES)
def test_http_check_equal(live, code):
    base, _ = live
    url = f"{base}/status/{code}"
    assert PP.http_check(url, timeout=5) == RP.http_check(url, timeout=5)


def test_http_check_refused_and_header(live):
    base, seen = live
    url = f"http://127.0.0.1:{_closed_port()}/healthz"
    assert PP.http_check(url, timeout=5) is RP.http_check(url, timeout=5) \
        is False
    seen.clear()
    assert PP.http_check(f"{base}/status/200", {"kubeflow-userid": "u@x"})
    assert seen == ["u@x"]


def test_probe_once_renders_equal(live):
    base, seen = live
    targets = {"healthz": f"{base}/healthz",
               "broken": f"{base}/status/503",
               "moved": f"{base}/status/302",
               "gone": f"http://127.0.0.1:{_closed_port()}/healthz"}
    preg, rreg = PRegistry(), RRegistry()
    port = PP.AvailabilityProber(targets, user_header="probe@x",
                                 registry=preg)
    ref = RP.AvailabilityProber(targets, user_header="probe@x",
                                registry=rreg)
    for _ in range(3):
        seen.clear()
        got, want = port.probe_once(), ref.probe_once()
        assert got == want == {"healthz": True, "broken": False,
                               "moved": True, "gone": False}
        assert seen == ["probe@x", "probe@x"] * 2
        assert preg.render() == rreg.render()
    assert dict((tuple(sorted(k.items())), v) for k, v in preg.series(
        "kubeflow_probe_total"))[(("result", "up"), ("target", "healthz"))] \
        == 3.0


def test_injected_checker_flips():
    calls = []

    def checker(url):
        calls.append(url)
        return len(calls) % 3 != 0

    preg, rreg = PRegistry(), RRegistry()
    targets = {"a": "http://a/healthz", "b": "http://b/healthz"}
    port = PP.AvailabilityProber(targets, checker=checker, registry=preg)
    ref_calls = []

    def ref_checker(url):
        ref_calls.append(url)
        return len(ref_calls) % 3 != 0

    ref = RP.AvailabilityProber(targets, checker=ref_checker, registry=rreg)
    for _ in range(4):
        assert port.probe_once() == ref.probe_once()
        assert preg.render() == rreg.render()


def _metric(base: str, target: str) -> float | None:
    with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
        body = r.read().decode()
    for line in body.splitlines():
        if line.startswith(f'kubeflow_availability{{target="{target}"}}'):
            return float(line.split()[-1])
    return None


def test_main_serves_and_probes():
    """`python -m kubeflow_tpu_torch.metric_collector --target t=URL
    --period-secs 0.2 --port 0`: /healthz answers, /metrics reads the
    target 1 while it serves and 0 once it stopped, SIGTERM exits 0."""
    r = httpd.Router("t")
    httpd.add_health_routes(r)
    target = httpd.HttpService(r, "127.0.0.1", 0).serve_background()
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.metric_collector",
         "--target", f"t=http://127.0.0.1:{target.port}/healthz",
         "--period-secs", "0.2", "--port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=os.environ)
    stopped = False
    try:
        line = proc.stdout.readline()
        assert line.startswith("metric collector on :"), (
            line, proc.stderr.read())
        base = f"http://127.0.0.1:{int(line.split(':')[-1])}"
        with urllib.request.urlopen(base + "/healthz", timeout=5) as resp:
            assert resp.status == 200
        seen = []
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            v = _metric(base, "t")
            if v is not None and (not seen or seen[-1] != v):
                seen.append(v)
            if v == 1.0 and not stopped:
                target.shutdown()
                stopped = True
            if seen[-2:] == [1.0, 0.0]:
                break
            time.sleep(0.05)
        assert seen[-2:] == [1.0, 0.0], seen
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(10) == 0
    finally:
        if not stopped:
            target.shutdown()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()
