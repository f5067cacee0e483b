"""The port's Notebook controller and culler
(kubeflow_tpu_torch/control/notebook/) against the JAX package's, each
on its own FakeCluster.

The same notebooks (their GPU counts, sizes and names drawn from a seed
with numpy) go to both controllers; every object each cluster then holds
must be equal after the GPU mapping (tests/test_torch_control_profile.py
`gpu_view`): the notebook's ``google.com/tpu`` limit becomes
``nvidia.com/gpu`` and the JAX notebook image the port's
(``NOTEBOOK_IMAGE``), nothing else. The cases mirror
tests/test_notebook_controller.py: the StatefulSet, Service and
VirtualService, status from the pod, pod events re-emitted onto the
Notebook, culling, the live ``notebook_running`` gauge, and the
notebook_* counters (the JAX package's in prometheus_client, the port's
in its own registry). The culler's status probe, on the standard
library in the port, reads a local stand-in Jupyter and answers None
where nothing listens.
"""

import datetime
import http.server
import json
import socket
import threading

import numpy as np
import pytest

from kubeflow_tpu.control.k8s import objects as rob
from kubeflow_tpu.control.k8s.fake import FakeCluster as RCluster
from kubeflow_tpu.control.notebook import controller as RC
from kubeflow_tpu.control.notebook import culler as RCull
from kubeflow_tpu.control.notebook import types as RT
from kubeflow_tpu.control.runtime import seed_controller as r_seed
from kubeflow_tpu_torch.control.jaxjob.types import NOTEBOOK_IMAGE, RESOURCE_GPU
from kubeflow_tpu_torch.control.k8s import objects as pob
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster as PCluster
from kubeflow_tpu_torch.control.notebook import controller as PC
from kubeflow_tpu_torch.control.notebook import culler as PCull
from kubeflow_tpu_torch.control.notebook import types as PT
from kubeflow_tpu_torch.control.runtime import seed_controller as p_seed
from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry
from test_torch_control_profile import assert_views_equal, drain

ANCIENT = "2020-01-01T00:00:00Z"


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("ENABLE_CULLING", "USE_ISTIO", "CULL_IDLE_TIME",
              "ADD_FSGROUP", "ISTIO_GATEWAY", "CLUSTER_DOMAIN"):
        monkeypatch.delenv(k, raising=False)


def seeded_notebook(seed: int) -> dict:
    """new_notebook's arguments drawn from the seed."""
    rng = np.random.default_rng(seed)
    return {"name": f"nb{int(rng.integers(100))}",
            "cpu": str(float(rng.integers(1, 9)) / 2),
            "memory": f"{int(rng.integers(1, 33))}Gi",
            "gpus": int(rng.choice([1, 4, 8]))}


def new_notebook(side: str, name: str, namespace: str = "default",
                 gpus: int = 0, **kw) -> dict:
    if side == "jax":
        return RT.new_notebook(name, namespace, tpu_chips=gpus, **kw)
    return PT.new_notebook(name, namespace, gpus=gpus, **kw)


class World:
    """One package's Notebook controller on its own FakeCluster, its
    probe answering `last_activity`; the port's metrics in a registry
    of its own, the JAX package's counters read as deltas of
    prometheus_client's default registry."""

    def __init__(self, side: str, cache: bool = True, cluster=None):
        jax = side == "jax"
        self.side = side
        self.cluster = cluster or (RCluster if jax else PCluster)()
        self.last_activity = None
        self.registry = None if jax else MetricsRegistry()
        probe = lambda nb: self.last_activity  # noqa: E731
        if jax:
            self.ctl = r_seed(RC.build_controller(self.cluster, probe=probe,
                                                  cache=cache))
        else:
            self.ctl = p_seed(PC.build_controller(
                self.cluster, probe=probe, cache=cache,
                registry=self.registry))
        self.T, self.ob = (RT, rob) if jax else (PT, pob)
        self.C, self.cull = (RC, RCull) if jax else (PC, PCull)
        self.base = {n: self.metric(n) for n in COUNTERS}

    def metric(self, name: str) -> float:
        """A notebook_* counter's value, or the culling timestamp."""
        if self.side == "jax":
            fn = {"notebook_create_total": RC.nb_created,
                  "notebook_culling_total": RC.nb_culled,
                  "notebook_create_failed_total": RC.nb_create_failed,
                  "last_notebook_culling_timestamp_seconds":
                      RC.nb_culling_timestamp}[name]
            return fn()._value.get()
        return sum(v for _, v in self.registry.series(name))

    def moved(self) -> dict:
        """Which counters moved since the world began, and by how much
        (the timestamp gauge: whether it moved)."""
        out = {}
        for n in COUNTERS:
            d = self.metric(n) - self.base[n]
            out[n] = d > 0 if n.startswith("last_") else d
        return out

    def create(self, obj: dict) -> dict:
        got = self.cluster.create(obj)
        drain(self.ctl)
        return got

    def sts(self, name: str, ns: str = "default") -> dict:
        return self.cluster.get("apps/v1", "StatefulSet", name, ns)


COUNTERS = ("notebook_create_total", "notebook_culling_total",
            "notebook_create_failed_total",
            "last_notebook_culling_timestamp_seconds")


def pair(**kw) -> tuple[World, World]:
    return World("jax", **kw), World("port", **kw)


def same(ref: World, port: World, what: str = "") -> None:
    assert_views_equal(ref.cluster, port.cluster, what)
    assert port.moved() == ref.moved(), what


@pytest.mark.parametrize("seed", [0, 1])
def test_statefulset_and_service(seed):
    args = seeded_notebook(seed)
    ref, port = pair()
    for w in (ref, port):
        w.create(new_notebook(w.side, args["name"], gpus=args["gpus"],
                              cpu=args["cpu"], memory=args["memory"]))
    same(ref, port)
    sts = port.sts(args["name"])
    assert sts["spec"]["replicas"] == 1
    c0 = sts["spec"]["template"]["spec"]["containers"][0]
    assert c0["resources"]["limits"] == {RESOURCE_GPU: args["gpus"]}
    assert c0["image"] == NOTEBOOK_IMAGE
    env = {e["name"]: e["value"] for e in c0["env"]}
    assert env[PT.ENV_NB_PREFIX] == f"/notebook/default/{args['name']}"
    assert sts["spec"]["template"]["spec"]["securityContext"]["fsGroup"] == 100
    port_ = port.cluster.get("v1", "Service", args["name"], "default")
    assert port_["spec"]["ports"][0]["targetPort"] == 8888
    assert port.moved()["notebook_create_total"] == 1


def test_gpu_template_keeps_its_selectors():
    """A template that names a GPU product and node pool (as the JWA's
    form writes it) reaches the StatefulSet's pod template as written."""
    ref, port = pair()
    sel = {"tpu": {"cloud.google.com/gke-tpu-accelerator":
                   "tpu-v5-lite-podslice",
                   "cloud.google.com/gke-tpu-topology": "2x2"},
           "gpu": {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb",
                   "cloud.google.com/gke-nodepool": "pool-2x2"}}
    for w in (ref, port):
        nb = new_notebook(w.side, "gpu-nb", gpus=1)
        nb["spec"]["template"]["spec"]["nodeSelector"] = \
            sel["tpu" if w.side == "jax" else "gpu"]
        w.create(nb)
    same(ref, port)
    assert port.sts("gpu-nb")["spec"]["template"]["spec"][
        "nodeSelector"] == sel["gpu"]


@pytest.mark.parametrize("env", [{}, {"ADD_FSGROUP": "false"},
                                 {"USE_ISTIO": "true"},
                                 {"USE_ISTIO": "true",
                                  "ISTIO_GATEWAY": "team/gw",
                                  "CLUSTER_DOMAIN": "corp.local"}])
def test_virtual_service_and_env_knobs(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ref, port = pair()
    for w in (ref, port):
        w.create(new_notebook(w.side, "nb2"))
    same(ref, port)
    vs = port.cluster.get_or_none("networking.istio.io/v1alpha3",
                                  "VirtualService", "notebook-default-nb2",
                                  "default")
    assert (vs is not None) == ("USE_ISTIO" in env)


def _pod(w: World, ready: bool) -> dict:
    pod = w.ob.new_object("v1", "Pod", "nb1-0", "default",
                          labels={w.T.LABEL_NOTEBOOK_NAME: "nb1"},
                          spec={"containers": [{"name": "nb1"}]})
    pod["status"] = {"phase": "Running", "containerStatuses": [
        {"name": "nb1", "ready": ready,
         "state": {"running": {"startedAt": "2026-01-01T00:00:00Z"}}}]}
    return pod


@pytest.mark.parametrize("cache", [True, False])
def test_status_tracks_pod_readiness_and_forwards_events(cache):
    ref, port = pair(cache=cache)
    for w in (ref, port):
        w.create(new_notebook(w.side, "nb1"))
        pod = w.cluster.create(_pod(w, ready=False))
        w.cluster.record_event(pod, "Pulled", "image pulled")
        drain(w.ctl)
    same(ref, port, "not ready")
    for w in (ref, port):
        pod = w.cluster.get("v1", "Pod", "nb1-0", "default")
        pod["status"]["containerStatuses"][0]["ready"] = True
        w.cluster.update_status(pod)
        drain(w.ctl)
    same(ref, port, "ready")
    nb = port.cluster.get(PT.API_VERSION, PT.KIND, "nb1", "default")
    assert nb["status"]["readyReplicas"] == 1 and pob.cond_is_true(nb, "Ready")
    reasons = [e["reason"] for e in port.cluster.list("v1", "Event")
               if e["involvedObject"]["kind"] == "Notebook"]
    assert "Pulled" in reasons and "NotebookReady" in reasons


def test_culling_scales_to_zero_and_restarts(monkeypatch):
    monkeypatch.setenv("ENABLE_CULLING", "true")
    monkeypatch.setenv("CULL_IDLE_TIME", "60")
    ref, port = pair()
    for w in (ref, port):
        w.create(new_notebook(w.side, "nb1"))
    same(ref, port, "active")
    for w in (ref, port):
        w.last_activity = ANCIENT
        drain(w.ctl)
        drain(w.ctl)
    same(ref, port, "culled")
    assert port.sts("nb1")["spec"]["replicas"] == 0
    assert port.moved()["notebook_culling_total"] == 1
    assert port.moved()["last_notebook_culling_timestamp_seconds"]
    for w in (ref, port):
        w.last_activity = None
        nb = w.cluster.get(w.T.API_VERSION, w.T.KIND, "nb1", "default")
        del w.ob.meta(nb)["annotations"][w.T.STOP_ANNOTATION]
        w.cluster.update(nb)
        drain(w.ctl)
    same(ref, port, "restarted")
    assert port.sts("nb1")["spec"]["replicas"] == 1


def test_stopped_notebook_is_not_probed(monkeypatch):
    monkeypatch.setenv("ENABLE_CULLING", "true")
    ref, port = pair()
    probed = {"jax": 0, "port": 0}
    for w in (ref, port):
        def probe(nb, side=w.side):
            probed[side] += 1
            return ANCIENT
        w.ctl.reconciler.probe = probe
        nb = new_notebook(w.side, "nb1")
        w.cull.set_stop_annotation(nb)
        w.create(nb)
    same(ref, port)
    assert port.sts("nb1")["spec"]["replicas"] == 0
    assert probed == {"jax": 0, "port": 0}


@pytest.mark.parametrize("when, last", [
    ("2026-01-01T12:00:00Z", "2026-01-01T10:00:00Z"),
    ("2026-01-01T12:00:00Z", "2026-01-01T11:30:00Z"),
    ("2026-01-01T12:00:00Z", "2026-01-01T10:59:59.123456Z"),
    ("2026-01-01T12:00:00Z", None), ("2026-01-01T12:00:00Z", "garbage")])
def test_is_idle_and_needs_culling_equal_the_reference(when, last,
                                                       monkeypatch):
    monkeypatch.setenv("CULL_IDLE_TIME", "60")
    now = datetime.datetime.strptime(when, RCull.TIME_FMT).replace(
        tzinfo=datetime.timezone.utc)
    assert PCull.is_idle(last, now=now) == RCull.is_idle(last, now=now)
    for enabled in ("false", "true"):
        monkeypatch.setenv("ENABLE_CULLING", enabled)
        for stopped in (False, True):
            nbs = [new_notebook("jax", "n"), new_notebook("port", "n")]
            if stopped:
                RCull.set_stop_annotation(nbs[0])
                PCull.set_stop_annotation(nbs[1])
            assert PCull.needs_culling(nbs[1], lambda n: last, now) == \
                RCull.needs_culling(nbs[0], lambda n: last, now)
    assert (PCull.enabled(), PCull.requeue_seconds()) == \
        (RCull.enabled(), RCull.requeue_seconds())


def _statefulsets(w: World) -> None:
    for ns, name in [("team-a", "nb1"), ("team-a", "nb2"), ("team-b", "nb3")]:
        w.cluster.create(new_notebook(w.side, name, ns))
    drain(w.ctl)
    # labelled like a notebook's, its template naming another: passes
    # the server-side selector, fails the metrics.go template check
    sts = w.ob.new_object("apps/v1", "StatefulSet", "liar", "team-a",
                          labels={"notebook-name": "somebody-else"})
    sts["spec"] = {"template": {"metadata": {"labels": {
        "notebook-name": "somebody-else"}}}}
    w.cluster.create(sts)


def _running(ref: World, port: World) -> tuple[dict, dict]:
    """notebook_running's samples: the JAX collector through
    prometheus_client, the port's through its registry's render."""
    from prometheus_client import CollectorRegistry, generate_latest

    reg = CollectorRegistry()
    RC.RunningNotebooksCollector(ref.cluster).register(reg)
    registry = MetricsRegistry()
    PC.RunningNotebooksCollector(port.cluster).register(registry)
    out = []
    for text in (generate_latest(reg).decode(), registry.render()):
        out.append({ln.split(" ")[0]: float(ln.split(" ")[1])
                    for ln in text.splitlines()
                    if ln.startswith("notebook_running{")})
    return out[0], out[1]


def test_running_notebooks_gauge_reads_live_statefulsets():
    ref, port = pair()
    for w in (ref, port):
        _statefulsets(w)
    want, got = _running(ref, port)
    assert got == want == {'notebook_running{namespace="team-a"}': 2.0,
                           'notebook_running{namespace="team-b"}': 1.0}
    for w in (ref, port):
        w.cluster.delete("apps/v1", "StatefulSet", "nb2", "team-a")
        w.cluster.delete("apps/v1", "StatefulSet", "nb3", "team-b")
    want, got = _running(ref, port)
    assert got == want == {'notebook_running{namespace="team-a"}': 1.0}


def test_running_notebooks_gauge_when_the_apiserver_fails():
    class Down(PCluster):
        def list(self, *a, **kw):
            raise OSError("apiserver down")

    registry = MetricsRegistry()
    PC.RunningNotebooksCollector(Down()).register(registry)
    text = registry.render()
    assert "# TYPE notebook_running gauge" in text
    assert "notebook_running{" not in text


def test_create_failure_counter_and_retry():
    worlds = []
    for side, Base in (("jax", RCluster), ("port", PCluster)):
        ob = rob if side == "jax" else pob

        class Refusing(Base):
            def create(self, obj, ob=ob):
                if obj.get("kind") == "StatefulSet":
                    raise ob.ApiError("quota exceeded")
                return super().create(obj)

        w = World(side, cluster=Refusing())
        w.create(new_notebook(side, "doomed"))
        worlds.append(w)
    ref, port = worlds
    assert port.cluster.get_or_none("apps/v1", "StatefulSet", "doomed",
                                    "default") is None
    assert port.moved()["notebook_create_failed_total"] >= 1
    assert (port.moved()["notebook_create_failed_total"] > 0) == \
        (ref.moved()["notebook_create_failed_total"] > 0)


# -- the status probe on the standard library ----------------------------------


class _Jupyter(http.server.BaseHTTPRequestHandler):
    """A stand-in for Jupyter's /api/status."""

    answer = (200, {"last_activity": "2026-01-01T10:00:00.123Z"})

    def do_GET(self):
        code, body = self.answer
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


@pytest.fixture()
def jupyter():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Jupyter)
    t = threading.Thread(target=srv.serve_forever, args=(0.05,), daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    srv.server_close()


@pytest.mark.parametrize("answer, want", [
    ((200, {"last_activity": "2026-01-01T10:00:00.123Z"}),
     "2026-01-01T10:00:00.123Z"),
    ((200, {"started": "x"}), None),
    ((503, {"last_activity": "2026-01-01T10:00:00Z"}), None),
    ((200, b"not json"), None)])
def test_status_probe_reads_a_local_jupyter(jupyter, answer, want,
                                            monkeypatch):
    monkeypatch.setattr(_Jupyter, "answer", answer)
    url = f"http://127.0.0.1:{jupyter.server_address[1]}/notebook/ns/nb/api/status"
    assert PCull.probe_status(url) == want


def test_status_probe_answers_none_where_nothing_listens():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert PCull.probe_status(f"http://127.0.0.1:{port}/api/status",
                              timeout=1.0) is None
    # the notebook's in-cluster address does not resolve here either
    nb = PT.new_notebook("nb1", "team-a")
    assert PCull.status_url(nb) == ("http://nb1.team-a.svc.cluster.local"
                                    "/notebook/team-a/nb1/api/status")
    assert PCull.PROBE_TIMEOUT_S == 5.0
