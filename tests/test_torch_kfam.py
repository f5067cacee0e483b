"""The port's KFAM service (kubeflow_tpu_torch/control/kfam/) against the
JAX package's, each on its own FakeCluster.

Seeded scripts of the six routes (bindings created, read with filters
and deleted; profiles created and deleted; the cluster-admin query), as
owners, the cluster admin, strangers and callers with no identity,
go through both routers. Every answer must be equal byte for byte, every
object each cluster then holds equal (`cluster_view`), and the port's
counters in its registry must move as the JAX package's prometheus_client
counters do. The module's main runs as `python -m` against the port's
ApiServer.
"""

import json
import os
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import prometheus_client
import pytest

from kubeflow_tpu.control.k8s.fake import FakeCluster as RCluster
from kubeflow_tpu.control.kfam import service as RK
from kubeflow_tpu.control.profile import types as RT
from kubeflow_tpu.utils.httpd import HttpReq as RReq
from kubeflow_tpu_torch.control.k8s.apiserver import ApiServer
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster as PCluster
from kubeflow_tpu_torch.control.kfam import service as PK
from kubeflow_tpu_torch.control.profile import types as PT
from kubeflow_tpu_torch.runtime.metrics import REGISTRY
from kubeflow_tpu_torch.utils.httpd import HttpReq as PReq
from test_torch_control_jaxjob import ROOT
from test_torch_control_profile import assert_views_equal

ADMIN = "root@example.com"
OWNERS = {"team-a": "alice@example.com", "team-b": "carol@example.com"}
USERS = ("bob@example.com", "eve@example.com", "Dave.O'Neil@Example.COM",
         "alice@example.com")
CALLERS = (None, ADMIN, "alice@example.com", "carol@example.com",
           "mallory@example.com")
ROLES = ("admin", "edit", "view", "kubeflow-edit", "owner")
NAMESPACES = ("team-a", "team-b", "team-z")
COUNTERS = ("kfam_binding_create_total", "kfam_binding_delete_total",
            "kfam_profile_create_total")


def _req(cls, method, path, user=None, body=None, query=None, params=None):
    headers = {RK.USER_HEADER: user} if user else {}
    raw = json.dumps(body).encode() if body is not None else b""
    return cls(method=method, path=path, params=params or {},
               query=query or {}, headers=headers, body=raw)


class Pair:
    """One KFAM service per package, each over its own FakeCluster with
    the same two profiles."""

    def __init__(self):
        self.rc, self.pc = RCluster(), PCluster()
        for ns, owner in OWNERS.items():
            self.rc.create(RT.new_profile(ns, owner))
            self.pc.create(PT.new_profile(ns, owner))
        self.rr = RK.KfamService(self.rc, cluster_admin=ADMIN).router()
        self.pr = PK.KfamService(self.pc, cluster_admin=ADMIN).router()

    def send(self, method, path, **kw) -> tuple:
        got = self.pr.dispatch(_req(PReq, method, path, **kw))
        want = self.rr.dispatch(_req(RReq, method, path, **kw))
        return (got.status, got.body, got.content_type,
                got.headers), (want.status, want.body, want.content_type,
                               want.headers)


def _binding(user, ns, role):
    return {"user": {"kind": "User", "name": user}, "referredNamespace": ns,
            "roleRef": {"kind": "ClusterRole", "name": role}}


def script(seed: int, n: int = 48) -> list[tuple]:
    """``n`` seeded calls of the six routes."""
    rng = np.random.default_rng(seed)
    pick = lambda xs: xs[int(rng.integers(len(xs)))]  # noqa: E731
    calls = []
    for _ in range(n):
        kind = int(rng.integers(7))
        caller = pick(CALLERS)
        if kind in (0, 1):
            calls.append(("POST", "/kfam/v1/bindings", dict(
                user=caller, body=_binding(pick(USERS), pick(NAMESPACES),
                                           pick(ROLES)))))
        elif kind == 2:
            q = {}
            for key, pool in (("user", USERS), ("namespace", NAMESPACES),
                              ("role", ROLES[:3])):
                if rng.random() < 0.4:
                    q[key] = [pick(pool)]
            calls.append(("GET", "/kfam/v1/bindings", dict(query=q)))
        elif kind == 3:
            calls.append(("DELETE", "/kfam/v1/bindings", dict(
                user=caller, body=_binding(pick(USERS), pick(NAMESPACES),
                                           pick(ROLES)))))
        elif kind == 4:
            name = pick(("team-c", "team-d", "team-a"))
            body = {"metadata": {"name": name}}
            if rng.random() < 0.5:
                body["spec"] = {"owner": {"kind": "User",
                                          "name": pick(USERS)}}
            if rng.random() < 0.3:
                body.setdefault("spec", {})["resourceQuotaSpec"] = {
                    "hard": {"requests.cpu": "8"}}
            calls.append(("POST", "/kfam/v1/profiles",
                          dict(user=caller, body=body)))
        elif kind == 5:
            name = pick(("team-a", "team-b", "team-c", "team-z"))
            calls.append(("DELETE", f"/kfam/v1/profiles/{name}",
                          dict(user=caller)))
        else:
            q = {"user": [pick(CALLERS[1:])]} if rng.random() < 0.5 else {}
            calls.append(("GET", "/kfam/v1/clusteradmin",
                          dict(user=caller, query=q)))
    # a tail that reaches the refusals every script must show: a role
    # KFAM does not grant (400) and a binding with no identity (401)
    calls.append(("POST", "/kfam/v1/bindings", dict(
        user=ADMIN, body=_binding(USERS[0], "team-a", "owner"))))
    calls.append(("POST", "/kfam/v1/bindings", dict(
        body=_binding(USERS[0], "team-a", "view"))))
    return calls


def _port_counts() -> dict:
    return {n: sum(v for _, v in REGISTRY.series(n)) for n in COUNTERS}


def _jax_counts() -> dict:
    return {n: prometheus_client.REGISTRY.get_sample_value(n) or 0.0
            for n in COUNTERS}


@pytest.mark.parametrize("seed", range(6))
def test_seeded_script_equal(seed):
    pair = Pair()
    p0, r0 = _port_counts(), _jax_counts()
    statuses = []
    for method, path, kw in script(seed):
        got, want = pair.send(method, path, **kw)
        assert got == want, (method, path, kw)
        statuses.append(got[0])
    # the scripts reach every answer the routes give
    assert {200, 400, 401, 403, 404, 409} <= set(statuses), statuses
    assert_views_equal(pair.rc, pair.pc, f"seed {seed}")
    p1, r1 = _port_counts(), _jax_counts()
    moved = {n: p1[n] - p0[n] for n in COUNTERS}
    assert moved == {n: r1[n] - r0[n] for n in COUNTERS}
    assert moved["kfam_binding_create_total"] > 0


def test_binding_objects_and_read_back():
    """A binding made by the owner: the RoleBinding and
    AuthorizationPolicy pair, named by `binding_name`, equal in both
    clusters; the read filters; the delete takes both."""
    pair = Pair()
    user = "Dave.O'Neil@Example.COM"
    assert PK.binding_name(user, "view") == RK.binding_name(user, "view") \
        == "user-dave-o-neil-example-com-clusterrole-view"
    for role in ("edit", "view"):
        got, want = pair.send("POST", "/kfam/v1/bindings",
                              user="alice@example.com",
                              body=_binding(user, "team-a", role))
        assert got == want and got[0] == 200
    for q in ({}, {"role": ["view"]}, {"user": [user]},
              {"namespace": ["team-b"]}):
        got, want = pair.send("GET", "/kfam/v1/bindings", query=q)
        assert got == want
    assert len(json.loads(got[1])["bindings"]) == 0
    assert_views_equal(pair.rc, pair.pc)
    got, want = pair.send("DELETE", "/kfam/v1/bindings",
                          user="alice@example.com",
                          body=_binding(user, "team-a", "edit"))
    assert got == want and got[0] == 200
    view = assert_views_equal(pair.rc, pair.pc)
    kinds = sorted(json.loads(k)[1] for k in view["objects"])
    assert kinds.count("RoleBinding") == 1
    assert kinds.count("AuthorizationPolicy") == 1


def _get(url: str) -> tuple[int, bytes]:
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read()


def test_main_serves_against_the_apiserver():
    """`python -m kubeflow_tpu_torch.control.kfam --apiserver URL
    --port 0` answers /healthz, reads a Profile through the port's
    RestClient, counts in /metrics, and exits 0 on SIGTERM."""
    cluster = PCluster()
    cluster.create(PT.new_profile("team-a", "alice@example.com"))
    api = ApiServer(cluster).serve_background()
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.control.kfam",
         "--apiserver", api.url, "--port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "CLUSTER_ADMIN": ADMIN})
    try:
        line = proc.stdout.readline()
        assert line.startswith("kfam on :"), (line, proc.stderr.read())
        base = f"http://127.0.0.1:{int(line.split(':')[-1])}"
        assert _get(base + "/healthz")[0] == 200
        req = urllib.request.Request(
            base + "/kfam/v1/bindings", method="POST",
            data=json.dumps(_binding("bob@example.com", "team-a",
                                     "edit")).encode(),
            headers={RK.USER_HEADER: "alice@example.com"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert resp.status == 200
        assert cluster.get("rbac.authorization.k8s.io/v1", "RoleBinding",
                           PK.binding_name("bob@example.com", "edit"),
                           "team-a")
        metrics = _get(base + "/metrics")[1].decode()
        assert "kfam_binding_create_total 1.0" in metrics
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(10) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()
        api.shutdown()
