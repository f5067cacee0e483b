"""The port's process entry points on the control plane, against the
port's own ApiServer on 127.0.0.1 (port 0 everywhere):

- ``python -m kubeflow_tpu_torch.control.jaxservice`` as a subprocess
  (the one controller main these tests start; its own session, killed
  in ``finally``): it creates a submitted JAXService's replica pods,
  which claim nvidia.com/gpu and run the port's server, holds the
  Lease, and on SIGTERM exits 0 within 10 s with renewTime null;
- the router's ``main --apiserver``, in-process: it adopts the
  endpoints annotation the controller publishes and routes to them;
- the sidecar's ``main --master-pod``, in-process: it returns 0 when
  the master pod turns Succeeded;
- goodput: a report over one span stream, and the exporter's series,
  equal the JAX package's.
"""

import functools
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from kubeflow_tpu.obs import goodput as RG
from kubeflow_tpu.obs import trace as RTr
from kubeflow_tpu.runtime.metrics import MetricsRegistry as RRegistry
from kubeflow_tpu_torch.control import leases as PL
from kubeflow_tpu_torch.control.jaxjob import types as PJT
from kubeflow_tpu_torch.control.jaxservice import types as PT
from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.control.k8s.apiserver import ApiServer
from kubeflow_tpu_torch.obs import goodput as PG
from kubeflow_tpu_torch.obs import trace as PTr
from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry as PRegistry
from kubeflow_tpu_torch.serving import router as PR
from kubeflow_tpu_torch.sidecar import controller as PS

from test_torch_control_jaxjob import ROOT


def _wait(fn, timeout=20.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = fn()
        if v:
            return v
        time.sleep(0.05)
    raise TimeoutError(what)


@pytest.fixture()
def server():
    s = ApiServer().serve_background()
    try:
        yield s
    finally:
        s.shutdown()


def test_the_jaxservice_main_serves_holds_the_lease_and_exits_on_sigterm(
        server):
    cluster = server.cluster
    cluster.create(PT.new_jaxservice(
        "chat", model="gpt-125m", min_replicas=2,
        product="nvidia-h100-80gb", node_pool="card"))
    env = dict(os.environ, POD_NAMESPACE="kubeflow", TPU_GOODPUT_CHIPS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.control.jaxservice",
         "--apiserver", server.url, "--metrics-port", "0",
         "--enable-leader-election"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        start_new_session=True)
    try:
        pods = _wait(lambda: (lambda ps: ps if len(ps) == 2 else None)(
            cluster.list("v1", "Pod", namespace="default")),
            what="two replica pods")
        lease = _wait(lambda: cluster.get_or_none(
            PL.API_VERSION, PL.KIND, "jaxservice-controller", "kubeflow"),
            what="the Lease")
        assert lease["spec"]["holderIdentity"]
        assert lease["spec"]["renewTime"]
        for p in pods:
            c = p["spec"]["containers"][0]
            assert c["command"][:3] == ["python", "-m",
                                        "kubeflow_tpu_torch.serving"]
            assert c["resources"]["limits"] == {PJT.RESOURCE_GPU: 1}
            assert c["image"] == PJT.SERVING_IMAGE
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(10)
        assert time.monotonic() - t0 < 10.0
        out = proc.stdout.read().decode(errors="replace")
        assert rc == 0, out[-3000:]
        assert "metrics on :" in out
        lease = cluster.get(PL.API_VERSION, PL.KIND, "jaxservice-controller",
                            "kubeflow")
        assert lease["spec"]["renewTime"] is None
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(10)
        proc.stdout.close()


class _Replica(BaseHTTPRequestHandler):
    """A stand-in replica: answers every predict with its own name."""

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length") or 0))
        body = json.dumps({"predictions": [[7, 7]],
                           "replica": self.server.name}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_the_router_main_adopts_the_annotation_endpoints(server):
    replica = ThreadingHTTPServer(("127.0.0.1", 0), _Replica)
    replica.name = "r0"
    threading.Thread(target=replica.serve_forever, daemon=True).start()
    svc = PT.new_jaxservice("chat", model="gpt-125m")
    ob.meta(svc)["annotations"] = {PT.ANNOTATION_ENDPOINTS: PR.render_endpoints(
        [{"name": "chat-replica-0", "state": PT.STATE_ACTIVE,
          "addr": f"http://127.0.0.1:{replica.server_address[1]}"}])}
    server.cluster.create(svc)
    port = _free_port()
    stop = threading.Event()
    rc = []
    main = threading.Thread(target=lambda: rc.append(PR.main(
        ["--port", str(port), "--apiserver", server.url, "--service",
         "chat", "--namespace", "default"], stop=stop)), daemon=True)
    main.start()

    def predict():
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/models/chat:predict",
            data=json.dumps({"instances": [{"tokens": [1, 2]}]}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=5) as resp:
                return json.loads(resp.read())
        except OSError:
            return None          # not listening yet, or no member yet

    try:
        out = _wait(predict, what="a routed predict")
        assert out["predictions"] == [[7, 7]]
    finally:
        stop.set()
        main.join(10)
        replica.shutdown()
        replica.server_close()
    assert not main.is_alive() and rc == [0]


def test_the_sidecar_main_returns_when_the_master_pod_succeeds(
        server, tmp_path, monkeypatch):
    cluster = server.cluster
    cluster.create(ob.new_object("v1", "Pod", "job-worker-0", "default"))
    # the card's gate answers yes here; the master watch is what is held
    monkeypatch.setattr(PS, "SidecarController", functools.partial(
        PS.SidecarController, device_check=lambda: True, poll_s=0.05))
    rc = []
    main = threading.Thread(target=lambda: rc.append(PS.main(
        ["--shared-dir", str(tmp_path), "--master-pod", "job-worker-0",
         "--namespace", "default", "--apiserver", server.url,
         "--timeout-secs", "30"])), daemon=True)
    main.start()
    signals = tmp_path / PS.SIGNAL_DIR
    _wait(lambda: (signals / PS.SIGCONT_FILE).exists(), what="SIGCONT")
    time.sleep(0.2)
    assert main.is_alive() and not (signals / PS.SIGTERM_FILE).exists()
    pod = cluster.get("v1", "Pod", "job-worker-0", "default")
    pod["status"] = {"phase": PS.PHASE_SUCCEEDED}
    cluster.update_status(pod)
    main.join(10)
    assert not main.is_alive() and rc == [0]
    assert (signals / PS.SIGTERM_FILE).exists()


def _spans(trace) -> list:
    """One job's span stream: a cold provision, a compile step, steps
    with a checkpoint inside one, a restart and an elastic rebuild, a
    span no bucket claims, and one still open."""
    S = trace.Span
    rows = [("jaxjob.provision", 0.0, 2.0, {}),
            ("train.step", 3.0, 9.0, {"compile": True}),
            ("train.step", 9.0, 10.0, {}),
            ("train.checkpoint", 9.5, 10.5, {}),
            ("train.step", 10.5, 11.5, {"namespace": "team-a"}),
            ("jaxjob.provision", 12.0, 14.0, {}),
            ("elastic.rebuild", 14.0, 15.0, {"tenant": "team-b"}),
            ("train.step", 15.0, 16.0, {}),
            ("data.wait", 16.0, 17.0, {}),
            ("train.step", 17.0, None, {})]
    return [S(name, "t" * 32, f"{i:016x}", start=s, end=e, attrs=a)
            for i, (name, s, e, a) in enumerate(rows)]


def test_goodput_reports_and_series_equal_the_jax_package():
    want = RG.job_report(_spans(RTr), chips=8, window_end=20.0).check()
    got = PG.job_report(_spans(PTr), chips=8, window_end=20.0).check()
    assert got.to_dict() == want.to_dict()
    assert got.goodput > 0 and got.buckets[PG.OTHER] > 0
    tenants = [m.tenant_report(_spans(t), 0.0, 20.0,
                               chips_by_tenant={"team-a": 4, "idle": 2})
               .check().to_dict() for m, t in ((RG, RTr), (PG, PTr))]
    assert tenants[1] == tenants[0]

    def exported(m, trace, registry):
        collector = trace.TraceCollector()
        for s in _spans(trace):
            collector.add(s)
        m.GoodputExporter(registry=registry, collector=collector,
                          chips=8).export_once(at=20.0)
        return registry.render()

    assert exported(PG, PTr, PRegistry()) == exported(RG, RTr, RRegistry())
    assert PG.ENV_GOODPUT_CHIPS == RG.ENV_GOODPUT_CHIPS == "TPU_GOODPUT_CHIPS"
