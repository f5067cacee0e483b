"""The port's tpctl REST plane, its HTTP client and its cloud plumbing
(kubeflow_tpu_torch/tpctl/{server,client,apispec,cloudauth,iam_patch,
staterepo}.py) against the JAX package's.

The cases mirror tests/test_tpctl.py's server, client and isolation
classes: create then poll to Available over HTTP, the isMatch conflict,
GC of idle workers only, 429 on a full queue, the client's
apply_and_wait and its clean timeout, and one subprocess worker whose
apply runs in a child `python -m kubeflow_tpu_torch.tpctl.cli apply`
against the port's apiserver. The pure functions (the OpenAPI document,
IAM policy merges, the access check's verdicts, the IAM patch loop) are
run in both packages on the same inputs and held equal; the state repo
round-trips a deployment through a local bare git remote.
"""

import copy
import json
import subprocess
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from kubeflow_tpu.tpctl import apispec as RSpec
from kubeflow_tpu.tpctl import cloudauth as RAuth
from kubeflow_tpu.tpctl import iam_patch as RIam
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster
from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry
from kubeflow_tpu_torch.tpctl import apispec as PSpec
from kubeflow_tpu_torch.tpctl import cloudauth as PAuth
from kubeflow_tpu_torch.tpctl import iam_patch as PIam
from kubeflow_tpu_torch.tpctl.apply import Coordinator
from kubeflow_tpu_torch.tpctl.client import DeploymentFailed, TpctlClient
from kubeflow_tpu_torch.tpctl.server import TpctlServer, _Worker
from kubeflow_tpu_torch.tpctl.staterepo import StateRepo
from kubeflow_tpu_torch.tpctl.tpudef import TpuDef, example_yaml
from kubeflow_tpu_torch.utils import yaml_lite
from kubeflow_tpu_torch.utils.httpd import ApiHttpError, HttpReq


def _server(cluster=None, **kw) -> TpctlServer:
    cluster = cluster if cluster is not None else FakeCluster()
    return TpctlServer(cluster, coordinator_factory=lambda: Coordinator(
        cluster, registry=MetricsRegistry()), **kw)


def _post(url: str, body: dict) -> tuple[int, dict]:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _req(body: dict) -> HttpReq:
    return HttpReq("POST", "/tpctl/apps/v1/create", {}, {}, {},
                   json.dumps(body).encode())


def test_create_then_poll_over_http():
    cluster = FakeCluster()
    svc = _server(cluster).serve(host="127.0.0.1").serve_background()
    try:
        base = f"http://127.0.0.1:{svc.port}/tpctl/apps/v1"
        status, body = _post(f"{base}/create", yaml_lite.loads(example_yaml()))
        assert (status, body) == (200, {"name": "kubeflow-tpu",
                                        "status": "enqueued"})
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            status, got = _post(f"{base}/get", {"name": "kubeflow-tpu"})
            conds = {c["type"]: c["status"]
                     for c in got.get("conditions", [])}
            if status == 200 and conds.get("TpuDefAvailable") == "True":
                break
            time.sleep(0.05)
        else:
            pytest.fail(f"never Available: {got}")
        assert cluster.get("apps/v1", "Deployment", "tensorboard-controller",
                           "kubeflow")
        assert _post(f"{base}/get", {"name": "nope"})[0] == 404
    finally:
        svc.shutdown()


def test_conflicting_spec_is_409_and_bad_body_400():
    srv = _server()
    body = yaml_lite.loads(example_yaml())
    assert srv.router().dispatch(_req(body)).status == 200
    changed = copy.deepcopy(body)
    changed["spec"]["platform"]["gpus"] = 16
    assert srv.router().dispatch(_req(changed)).status == 409
    bad = HttpReq("POST", "/tpctl/apps/v1/create", {}, {}, {}, b"[1]")
    assert srv.router().dispatch(bad).status == 400


def test_gc_reaps_idle_workers_only():
    gate, started = threading.Event(), threading.Event()

    class Slow:
        def apply(self, cfg):
            started.set()
            gate.wait(30)

    srv = TpctlServer(FakeCluster(), ttl_s=0.01,
                      coordinator_factory=lambda: Slow())
    srv.create(_req({"metadata": {"name": "busy"},
                     "spec": {"applications": ["crds"]}}))
    assert started.wait(10)
    time.sleep(0.05)
    assert srv.gc_once() == []          # busy: never reaped
    w = srv.workers["busy"]
    gate.set()
    deadline = time.monotonic() + 10
    while w.busy and time.monotonic() < deadline:
        time.sleep(0.02)
    assert srv.gc_once() == ["busy"]
    assert not srv.workers


def test_full_worker_queue_is_429_not_a_deadlock():
    gate = threading.Event()

    class Blocked:
        def apply(self, cfg):
            gate.wait(30)

    w = _Worker("jam", Blocked())
    with pytest.raises(ApiHttpError) as e:
        for _ in range(12):               # queue cap 10 + the one in flight
            w.submit(TpuDef(name="jam", applications=("crds",)))
    assert e.value.status == 429
    gate.set()


def test_client_apply_and_wait_and_its_timeout():
    cluster = FakeCluster()
    svc = _server(cluster).serve(host="127.0.0.1").serve_background()
    try:
        client = TpctlClient(f"http://127.0.0.1:{svc.port}")
        assert client.check_access()
        status = client.apply_and_wait(
            TpuDef(name="gpu-kf", applications=("crds", "namespace")),
            timeout_s=30, poll_s=0.05)
        assert {c["type"]: c["status"] for c in status["conditions"]} == {
            "TpuDefAvailable": "True", "TpuDefDegraded": "False"}
        assert cluster.get("v1", "Namespace", "kubeflow")
        t = [0.0]
        with pytest.raises(TimeoutError):
            client.wait_available("never-created", timeout_s=10, poll_s=1,
                                  clock=lambda: t[0],
                                  sleep=lambda s: t.__setitem__(0, t[0] + s))
        with pytest.raises(DeploymentFailed, match="HTTP 400"):
            client._post("/tpctl/apps/v1/get", {})
    finally:
        svc.shutdown()
    assert not TpctlClient("http://127.0.0.1:1").check_access()


def test_subprocess_worker_applies_through_a_child_process():
    from kubeflow_tpu_torch.control.k8s.apiserver import ApiServer, client_for
    from kubeflow_tpu_torch.tpctl.tpudef import API_VERSION

    api = ApiServer().serve_background()
    try:
        with pytest.raises(ValueError):
            TpctlServer(FakeCluster(), isolation="subprocess")
        srv = TpctlServer(client_for(api), isolation="subprocess",
                          apiserver_url=api.url)
        svc = srv.serve(host="127.0.0.1", port=0).serve_background()
        try:
            status, _ = _post(
                f"http://127.0.0.1:{svc.port}/tpctl/apps/v1/create",
                {"metadata": {"name": "iso-dep"},
                 "spec": {"applications": ["crds"]}})
            assert status == 200
            w = srv.workers["iso-dep"]
            deadline = time.monotonic() + 120
            while w.busy and time.monotonic() < deadline:
                time.sleep(0.1)
            assert w.error is None, w.error
            assert w.last_pid is not None
            obj = api.cluster.get(API_VERSION, "TpuDef", "iso-dep")
            assert {c["type"]: c["status"]
                    for c in obj["status"]["conditions"]} == {
                "TpuDefAvailable": "True", "TpuDefDegraded": "False"}
            assert api.cluster.get("apiextensions.k8s.io/v1",
                                   "CustomResourceDefinition",
                                   "tensorboards.tensorboard.kubeflow.org")
        finally:
            svc.shutdown()
    finally:
        api.shutdown()


def test_openapi_documents_every_route_as_the_reference():
    doc = PSpec.openapi()
    ref = RSpec.openapi()
    assert sorted(doc["paths"]) == sorted(ref["paths"])
    for path, ops in doc["paths"].items():
        assert sorted(ops) == sorted(ref["paths"][path])
    routes = {(m, rx.pattern.strip("^$"))
              for m, rx, _ in _server().router()._routes}
    for method, path in routes:
        assert method.lower() in doc["paths"][path], (method, path)
    plat = doc["components"]["schemas"]["TpuDef"]["properties"]["spec"][
        "properties"]["platform"]["properties"]
    assert plat["kind"]["enum"] == ["existing", "gke-gpu"]
    assert plat["gpus"]["default"] == 8 and "topology" not in plat


def _seeded_policy(seed: int) -> tuple[dict, list[dict]]:
    rng = np.random.default_rng(seed)
    roles = ["roles/owner", "roles/viewer", "roles/iap.httpsResourceAccessor",
             "roles/container.admin"]
    members = ["user:a@x.com", "serviceAccount:s@p.iam.gserviceaccount.com",
               "set-kubeflow-admin-service-account",
               "set-kubeflow-iap-account", "group:g@x.com"]
    policy = {"etag": f"e{seed}", "bindings": [
        {"role": r, "members": [str(m) for m in rng.choice(
            members[:2] + members[4:], 2, replace=False)]}
        for r in rng.choice(roles, 2, replace=False)]}
    bindings = [{"members": [str(m) for m in rng.choice(members, 2,
                                                        replace=False)],
                 "roles": [str(r) for r in rng.choice(roles, 2,
                                                      replace=False)]}
                for _ in range(2)]
    return policy, bindings


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("action", ["add", "remove"])
def test_update_policy_equals_the_reference(seed, action):
    policy, bindings = _seeded_policy(seed)
    kw = dict(cluster="kf", project="proj-1", email="ops@x.com",
              action=action)
    assert PAuth.update_policy(copy.deepcopy(policy), bindings, **kw) == \
        RAuth.update_policy(copy.deepcopy(policy), bindings, **kw)
    for acct in ("a@x.com", "s@p.iam.gserviceaccount.com",
                 "google-kubeflow-support@x.com"):
        assert PAuth.prepare_account(acct) == RAuth.prepare_account(acct)


class _Backend:
    """A scripted cloudresourcemanager: `answers` are returned or raised
    in turn by testIamPermissions; the IAM policy is kept in memory and
    set_iam_policy may fail `conflicts` times first."""

    def __init__(self, answers=(), conflicts=0):
        self.answers, self.conflicts = list(answers), conflicts
        self.policy = {"bindings": [{"role": "roles/viewer",
                                     "members": ["user:a@x.com"]}]}
        self.sets = 0

    def test_iam_permissions(self, project, token, permissions):
        a = self.answers.pop(0)
        if isinstance(a, Exception):
            raise a
        return a

    def get_iam_policy(self, project, token):
        return copy.deepcopy(self.policy)

    def set_iam_policy(self, project, token, policy):
        self.sets += 1
        if self.conflicts:
            self.conflicts -= 1
            raise RuntimeError("409 concurrent policy change")
        self.policy = copy.deepcopy(policy)


class _HttpErr(Exception):
    def __init__(self, code):
        super().__init__(f"HTTP {code}")
        self.code = code


@pytest.mark.parametrize("answers", [
    [[PAuth.SET_IAM_POLICY_PERMISSION]],
    [[]],
    [_HttpErr(403)],
    [OSError("reset"), OSError("reset"), [PAuth.SET_IAM_POLICY_PERMISSION]],
])
def test_check_project_access_verdicts_equal(answers):
    def run(mod):
        backend = _Backend(copy.deepcopy(answers))
        return mod.check_project_access("p", "t", backend, sleep=lambda s: None)

    assert run(PAuth) == run(RAuth)


def test_access_outage_reraises_and_token_refresh_validates():
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    for mod in (PAuth, RAuth):
        with pytest.raises(OSError):
            mod.check_project_access("p", "t", _Backend([OSError("down")] * 50),
                                     max_elapsed=5.0, sleep=lambda s: None,
                                     clock=clock)
    src = PAuth.RefreshableTokenSource("p", _Backend([[]]))
    with pytest.raises(PermissionError):
        src.refresh("tok")
    assert src.token() is None
    src = PAuth.RefreshableTokenSource(
        "p", _Backend([[PAuth.SET_IAM_POLICY_PERMISSION]]))
    src.refresh("tok")
    assert src.token() == "tok"


def test_iam_patch_equals_the_reference(tmp_path):
    f = tmp_path / "bindings.yaml"
    f.write_text("bindings:\n  - members: [set-kubeflow-iap-account, "
                 "user:x@y.com]\n    roles: [roles/iap.httpsResourceAccessor]\n")
    assert PIam.load_bindings(str(f)) == RIam.load_bindings(str(f))
    bindings = PIam.load_bindings(str(f))
    out = []
    for mod in (PIam, RIam):
        backend = _Backend(conflicts=2)
        final = mod.patch_iam_policy("p", "t", bindings, backend,
                                     cluster="kf", email="ops@x.com",
                                     sleep=lambda s: None)
        out.append((final, backend.policy, backend.sets))
    assert out[0] == out[1]
    assert out[0][2] == 3


def test_state_repo_round_trip(tmp_path):
    remote = tmp_path / "remote.git"
    subprocess.run(["git", "init", "--bare", "-b", "main", str(remote)],
                   check=True, capture_output=True)
    cfg = TpuDef(name="gpu-kf", platform="gke-gpu", gpus=16)
    with StateRepo(str(remote)) as repo:
        sha = repo.save_deployment(cfg.name, cfg.dump(),
                                   manifests_yaml="kind: List\n")
        assert len(sha) == 40
        # an unchanged save commits nothing
        assert repo.save_deployment(cfg.name, cfg.dump(),
                                    manifests_yaml="kind: List\n") == sha
    with StateRepo(str(remote)) as repo:
        assert repo.list_deployments() == ["gpu-kf"]
        assert TpuDef.from_dict(yaml_lite.loads(
            repo.load_deployment("gpu-kf"))).gpus == 16
        assert repo.delete_deployment("gpu-kf") is True
        assert repo.delete_deployment("gpu-kf") is False
    with pytest.raises(ValueError, match="Name <email>"):
        StateRepo(str(remote), author="nobody")
