"""The port's TLS bootstrap (kubeflow_tpu_torch/utils/tlscerts.py) and
its HTTPS webhook, against the JAX package's.

Each test plays the apiserver's part as tests/test_tlscerts.py does: a
verifying `ssl` client trusting only the bootstrapped CA. The port's
chain verifies for `<svc>.<ns>.svc` under both packages' client
contexts, `ensure_certs` is idempotent and lays files out as the JAX one
does, and the port's webhook answers AdmissionReviews over HTTPS through
`HttpService(tls=)` with the same response as the reference's.
"""

import base64
import json
import os
import signal
import socket
import ssl
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from kubeflow_tpu.control.k8s.fake import FakeCluster as RCluster
from kubeflow_tpu.control.poddefault import PodDefaultMutator as RMutator
from kubeflow_tpu.utils import tlscerts as RT
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster as PCluster
from kubeflow_tpu_torch.control.poddefault import PodDefaultMutator as PMutator
from kubeflow_tpu_torch.utils import tlscerts as PT

ROOT = Path(__file__).resolve().parents[1]


def _handshake(port: int, ctx: ssl.SSLContext, host: str) -> dict:
    """A verifying TLS handshake to 127.0.0.1:port naming `host`."""
    with socket.create_connection(("127.0.0.1", port), timeout=10) as raw:
        with ctx.wrap_socket(raw, server_hostname=host) as tls:
            return tls.getpeercert()


@pytest.mark.parametrize("client", ["port", "jax"])
def test_chain_verifies_for_the_service_name(tmp_path, client):
    """A port-issued chain, served by the stdlib, verifies for
    <svc>.<ns>.svc (and localhost) under a CERT_REQUIRED client of either
    package; another name fails the hostname check."""
    paths = PT.ensure_certs(tmp_path, "poddefault-webhook", "kubeflow")
    server = PT.server_context(paths.cert, paths.key)
    ctx = (PT if client == "port" else RT).client_context(paths.ca_cert)
    lsock = socket.create_server(("127.0.0.1", 0))
    port = lsock.getsockname()[1]
    import threading

    def serve(n):
        for _ in range(n):
            conn, _ = lsock.accept()
            try:
                with server.wrap_socket(conn, server_side=True):
                    pass
            except (ssl.SSLError, OSError):
                pass

    t = threading.Thread(target=serve, args=(3,), daemon=True)
    t.start()
    try:
        cert = _handshake(port, ctx, "poddefault-webhook.kubeflow.svc")
        sans = {v for k, v in cert["subjectAltName"] if k == "DNS"}
        assert {"poddefault-webhook.kubeflow.svc",
                "poddefault-webhook.kubeflow.svc.cluster.local",
                "poddefault-webhook", "localhost"} <= sans
        _handshake(port, ctx, "localhost")
        with pytest.raises(ssl.SSLCertVerificationError):
            _handshake(port, ctx, "other.kubeflow.svc")
    finally:
        t.join(10)
        lsock.close()


def test_ensure_certs_idempotent_and_laid_out_as_the_reference(tmp_path):
    p1 = PT.ensure_certs(tmp_path / "port", "svc", "ns")
    r1 = RT.ensure_certs(tmp_path / "jax", "svc", "ns")
    names = lambda d: sorted(f.name for f in d.iterdir())  # noqa: E731
    assert names(tmp_path / "port") == names(tmp_path / "jax") == [
        "ca.crt", "ca.key", "tls.crt", "tls.key"]
    for d in ("port", "jax"):
        assert oct((tmp_path / d / "tls.key").stat().st_mode & 0o777) == \
            "0o600"
    before = (p1.ca_cert.read_bytes(), p1.cert.read_bytes())
    p2 = PT.ensure_certs(tmp_path / "port", "svc", "ns")
    assert (p2.ca_cert.read_bytes(), p2.cert.read_bytes()) == before
    # a lost serving cert is reissued under the same CA
    p2.cert.unlink()
    p2.key.unlink()
    p3 = PT.ensure_certs(tmp_path / "port", "svc", "ns")
    assert p3.ca_cert.read_bytes() == before[0]
    assert p3.cert.read_bytes() != before[1]
    assert p3.ca_bundle_b64 == base64.b64encode(before[0]).decode()
    assert r1.ca_bundle_b64 != p3.ca_bundle_b64   # two CAs, two keys


def test_preprovisioned_readonly_dir_reused(tmp_path):
    """A mounted Secret (tls.crt, tls.key, ca.crt, no ca.key, read-only)
    is reused verbatim: the registered caBundle pins its CA."""
    src = PT.ensure_certs(tmp_path / "gen", "svc")
    mnt = tmp_path / "mnt"
    mnt.mkdir()
    for name in ("ca.crt", "tls.crt", "tls.key"):
        (mnt / name).write_bytes((tmp_path / "gen" / name).read_bytes())
    mnt.chmod(0o555)
    try:
        assert PT.ensure_certs(mnt, "svc").cert.read_bytes() == \
            src.cert.read_bytes()
    finally:
        mnt.chmod(0o755)


def _post_review(url: str, ctx: ssl.SSLContext) -> dict:
    review = {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
              "request": {"uid": "u1", "namespace": "default",
                          "object": {"kind": "Pod", "metadata": {"name": "p"},
                                     "spec": {"containers": [
                                         {"name": "c", "image": "i"}]}}}}
    req = urllib.request.Request(
        url, data=json.dumps(review).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, context=ctx, timeout=10) as r:
        return json.loads(r.read())


def test_webhook_over_verified_https_equals_the_reference(tmp_path):
    """Both webhooks serve HTTPS from their own bootstrapped CA; a
    client trusting that CA gets equal AdmissionReview answers, and a
    client pinning another CA fails the handshake."""
    answers = {}
    for side, mutator in (("port", PMutator(PCluster())),
                          ("jax", RMutator(RCluster()))):
        svc = mutator.serve(host="127.0.0.1",
                            certs_dir=str(tmp_path / side)).serve_background()
        try:
            assert svc.tls
            ctx = PT.client_context(tmp_path / side / "ca.crt")
            answers[side] = _post_review(
                f"https://localhost:{svc.port}/apply-poddefault", ctx)
            if side == "port":
                other = PT.ensure_certs(tmp_path / "other", "svc")
                with pytest.raises((ssl.SSLError,
                                    urllib.error.URLError)) as ei:
                    _post_review(
                        f"https://localhost:{svc.port}/apply-poddefault",
                        PT.client_context(other.ca_cert))
                assert isinstance(getattr(ei.value, "reason", ei.value),
                                  ssl.SSLError)
        finally:
            svc.shutdown()
    assert answers["port"] == answers["jax"]
    assert answers["port"]["response"]["allowed"] is True


def test_https_main_publishes_its_ca_and_exits_on_sigterm(tmp_path):
    """The in-cluster topology: `python -m
    kubeflow_tpu_torch.control.poddefault --certs-dir` against the port's
    apiserver bootstraps its certs, patches its CA into the rendered
    MutatingWebhookConfiguration (tpctl's, still empty), answers verified
    HTTPS with exactly that bundle trusted, and exits 0 on SIGTERM."""
    from kubeflow_tpu_torch.control.k8s.apiserver import ApiServer
    from kubeflow_tpu_torch.tpctl import manifests
    from kubeflow_tpu_torch.tpctl.tpudef import TpuDef

    cluster = PCluster()
    for o in manifests.render(TpuDef(applications=("poddefault-webhook",))):
        cluster.create(o)
    api = ApiServer(cluster).serve_background()
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.control.poddefault",
         "--port", "0", "--apiserver", api.url, "--certs-dir",
         str(tmp_path / "certs")],
        cwd=ROOT, stdout=subprocess.PIPE, text=True,
        env={**os.environ, "POD_NAMESPACE": "kubeflow"})
    try:
        line = proc.stdout.readline().strip()
        assert "(https)" in line, line
        port = int(line.split(":")[-1].split(" ")[0])
        bundle = ""
        deadline = time.monotonic() + 30
        while not bundle and time.monotonic() < deadline:
            hook = cluster.get("admissionregistration.k8s.io/v1",
                               "MutatingWebhookConfiguration",
                               "poddefault-webhook")
            bundle = hook["webhooks"][0]["clientConfig"]["caBundle"]
            time.sleep(0.05)
        assert bundle, "the webhook never published its caBundle"
        trust = tmp_path / "trust.crt"
        trust.write_bytes(base64.b64decode(bundle))
        out = _post_review(f"https://localhost:{port}/apply-poddefault",
                           PT.client_context(trust))
        assert out["response"] == {"uid": "u1", "allowed": True}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(20) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        api.shutdown()


def test_publish_ca_bundle_stops_when_asked(tmp_path):
    """With no registration to patch, the publisher retries until its
    stop event is set, then returns False at once."""
    import threading

    mutator = PMutator(PCluster())
    svc = mutator.serve(host="127.0.0.1", certs_dir=str(tmp_path)) \
        .serve_background()
    try:
        stop = threading.Event()
        t = threading.Thread(target=mutator.publish_ca_bundle,
                             kwargs={"delay": 0.01, "stop": stop})
        t.start()
        time.sleep(0.1)
        assert t.is_alive()
        stop.set()
        t.join(5)
        assert not t.is_alive()
        assert mutator.publish_ca_bundle(retries=2, delay=0.0) is False
    finally:
        svc.shutdown()
