"""The port's REST client and apiserver (kubeflow_tpu_torch/control/k8s/
rest.py, apiserver.py) against the JAX package's.

One sequence of `tests/test_rest_apiserver.py`'s verbs — CRUD, PUT
/status, merge and json patch, label and field selectors, cluster-scoped
objects, 404/409, stale-rv patch, server-side apply, a chunked list that
follows continue tokens, a watch resumed after a dropped connection, and
a watch whose resume point left the history window (410, relist, a
synthesized DELETED) — runs through the JAX client on the JAX server and
through the port's client on the port's server and on the JAX server
(the wire is the same): the transcripts are equal. The port's JAXJob
controller in run() mode over HTTP makes the pods it makes on a
FakeCluster directly, and a watch blocked on an idle stream ends within
2 s of stop().
"""

import threading
import time

import pytest

from kubeflow_tpu.control.k8s import apiserver as RA
from kubeflow_tpu.control.k8s import fake as RF
from kubeflow_tpu.control.k8s import objects as RO
from kubeflow_tpu_torch.control.jaxjob import controller as PC
from kubeflow_tpu_torch.control.jaxjob import types as PT
from kubeflow_tpu_torch.control.k8s import apiserver as PA
from kubeflow_tpu_torch.control.k8s import fake as PF
from kubeflow_tpu_torch.control.k8s import objects as PO
from kubeflow_tpu_torch.control.runtime import seed_controller

from test_torch_control_jaxjob import _strip

SIDES = {"jax": (RA, RF, RO), "port": (PA, PF, PO)}
JOB = ("kubeflow.org/v1alpha1", "JAXJob")


def _wait(fn, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.01)
    raise TimeoutError("condition not met")


class _Consumer:
    """Iterate a watch stream on a thread, collecting its events."""

    def __init__(self, stream, cluster):
        self.stream, self.events = stream, []
        before = len(cluster._watches)
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        # the server registered this stream's watch: later writes reach it
        _wait(lambda: len(cluster._watches) > before)

    def _run(self):
        for ev in self.stream:
            self.events.append((ev.type, ev.object))

    def names(self, n):
        _wait(lambda: len(self.events) >= n)
        return [(t, o["metadata"]["name"]) for t, o in self.events[:n]]


def _call(record, ob, fn, *args, **kw):
    """Run one verb; record its result, or the error kind it raised."""
    try:
        out = fn(*args, **kw)
    except ob.ApiError as e:
        record.append(type(e).__name__)
        return None
    record.append(_strip(out, None))
    return out


def sequence(client_side: str, server_side: str) -> list:
    """The verbs of tests/test_rest_apiserver.py through one client and
    one server; returns what each call gave."""
    srv_mod, fake, _ = SIDES[server_side]
    cli_mod, _, ob = SIDES[client_side]
    out: list = []
    server = srv_mod.ApiServer(fake.FakeCluster()).serve_background()
    # frequent heartbeats flush the JAX client's buffered stream reads
    server.bookmark_interval = 0.1
    try:
        c = cli_mod.client_for(server)
        cm = ob.new_object("v1", "ConfigMap", "cm", "default")
        cm["data"] = {"a": "1"}
        _call(out, ob, c.create, cm)
        _call(out, ob, c.create, cm)                       # 409
        _call(out, ob, c.get, "v1", "ConfigMap", "nope", "default")  # 404
        out.append(c.get_or_none("v1", "ConfigMap", "nope", "default"))
        fresh = c.get("v1", "ConfigMap", "cm", "default")
        stale = ob.deep_copy(fresh)
        fresh["data"]["a"] = "2"
        _call(out, ob, c.update, fresh)
        stale["data"]["a"] = "3"
        _call(out, ob, c.update, stale)                    # stale rv: 409
        _call(out, ob, c.patch, "v1", "ConfigMap", "cm", {"data": {"b": "2"}},
              "default")
        _call(out, ob, c.patch, "v1", "ConfigMap", "cm",
              [{"op": "remove", "path": "/data/a"}], "default")
        _call(out, ob, c.patch, "v1", "ConfigMap", "cm",
              {"metadata": {"resourceVersion": "1"}, "data": {"c": "3"}},
              "default")                                   # stale: 409
        job = ob.new_object(*JOB, "j1", "default", spec={"replicas": 1})
        _call(out, ob, c.create, job)
        job = c.get(*JOB, "j1", "default")
        job["status"] = {"conditions": [{"type": "Created",
                                         "status": "True"}]}
        job["spec"]["replicas"] = 99                       # /status ignores
        _call(out, ob, c.update_status, job)
        _call(out, ob, c.get, *JOB, "j1", "default")
        for i, role in enumerate(["web", "web", "db"]):
            _call(out, ob, c.create, ob.new_object(
                "v1", "Pod", f"p{i}", "default", labels={"role": role}))
        _call(out, ob, c.list, "v1", "Pod", "default",
              label_selector={"matchLabels": {"role": "web"}})
        _call(out, ob, c.list, "v1", "Pod", "default",
              field_selector={"metadata.name": "p2"})
        _call(out, ob, c.create, ob.new_object("v1", "Namespace", "team-x"))
        _call(out, ob, c.get, "v1", "Namespace", "team-x")
        _call(out, ob, c.delete, "v1", "Pod", "p2", "default")
        _call(out, ob, c.get_or_none, "v1", "Pod", "p2", "default")
        desired = ob.new_object("v1", "ConfigMap", "ssa", "default")
        desired["data"] = {"k": "v"}
        _call(out, ob, c.apply, desired, field_manager="a")
        desired["data"] = {"k": "w"}
        _call(out, ob, c.apply, desired, field_manager="b")   # 409
        _call(out, ob, c.apply, desired, field_manager="b", force=True)
        for i in range(7):
            c.create(ob.new_object("v1", "Secret", f"s{i}", "default"))
        c.list_chunk = 3                                   # three pages
        _call(out, ob, c.list, "v1", "Secret", "default")
        # a watch resumed after a dropped connection loses nothing
        w = _Consumer(c.watch("v1", "ConfigMap", "default"), server.cluster)
        c.create(ob.new_object("v1", "ConfigMap", "a", "default"))
        w.names(1)
        server.drop_watches()
        c.create(ob.new_object("v1", "ConfigMap", "b", "default"))
        c.create(ob.new_object("v1", "ConfigMap", "c", "default"))
        out.append(w.names(3))
        w.stream.stop()
    finally:
        server.shutdown()
    return out


def relist(client_side: str, server_side: str) -> dict:
    """A watch whose resume point fell out of a 4-event history: the
    reconnect 410s, the relist re-yields the live objects and
    synthesizes DELETED, with the last full state, for one deleted in
    the gap. Returns each object's last event type and the DELETED's
    labels (whether the deletion arrived live or synthesized depends
    on when the reconnect lands; the outcome does not)."""
    srv_mod, fake, _ = SIDES[server_side]
    _, _, ob = SIDES[client_side]
    server = srv_mod.ApiServer(fake.FakeCluster(history_limit=4))
    server.serve_background()
    try:
        c = SIDES[client_side][0].client_for(server)
        w = _Consumer(c.watch("v1", "ConfigMap", "default"), server.cluster)
        c.create(ob.new_object("v1", "ConfigMap", "doomed", "default",
                               labels={"owner-label": "gang-a"}))
        c.create(ob.new_object("v1", "ConfigMap", "keeper", "default"))
        w.names(2)
        server.drop_watches()
        c.delete("v1", "ConfigMap", "doomed", "default")
        for i in range(8):          # truncate the history past it
            c.create(ob.new_object("v1", "Secret", f"z{i}", "default"))
        c.create(ob.new_object("v1", "ConfigMap", "second", "default"))
        _wait(lambda: any(t == "DELETED" for t, _ in w.events)
              and any(o["metadata"]["name"] == "second"
                      for _, o in w.events))
        w.stream.stop()
        last = {}
        for t, o in w.events:
            last[o["metadata"]["name"]] = "gone" if t == "DELETED" else "live"
        dead = [o for t, o in w.events if t == "DELETED"]
        return {"last": last,
                "deleted_labels": [o["metadata"].get("labels") for o in dead]}
    finally:
        server.shutdown()


@pytest.fixture(scope="module")
def reference():
    """The JAX client on the JAX server, once for both cases."""
    return sequence("jax", "jax"), relist("jax", "jax")


@pytest.mark.parametrize("client_side,server_side",
                         [("port", "port"), ("port", "jax")],
                         ids=["port-client-port-server",
                              "port-client-jax-server"])
def test_the_rest_sequence_equals_the_jax_client_on_the_jax_server(
        client_side, server_side, reference):
    want, want_relist = reference
    got = sequence(client_side, server_side)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g, w)
    # the errors are the ones the verbs must raise
    assert [x for x in got if isinstance(x, str)] == [
        "Conflict", "NotFound", "Conflict", "Conflict", "Conflict"]
    assert got[-1] == [("ADDED", "a"), ("ADDED", "b"), ("ADDED", "c")]
    assert relist(client_side, server_side) == want_relist == {
        "last": {"doomed": "gone", "keeper": "live", "second": "live"},
        "deleted_labels": [{"owner-label": "gang-a"}]}


def test_the_jaxjob_controller_over_rest_makes_the_pods_it_makes_directly():
    server = PA.ApiServer().serve_background()
    client = PA.client_for(server)
    ctl = PC.build_controller(client)
    ctl.run(workers=1)
    job = dict(replicas=2, product="nvidia-h100-80gb", node_pool="pool-a",
               gpus_per_worker=1, gang_schedule=True)
    try:
        client.create(PT.new_jaxjob("train", **job))
        _wait(lambda: len(client.list("v1", "Pod", "default")) == 2)
        _wait(lambda: (client.get(PT.API_VERSION, PT.KIND, "train",
                                  "default").get("status") or {})
              .get("conditions"))
        http_pods = client.list("v1", "Pod", "default")
    finally:
        t0 = time.monotonic()
        ctl.stop()
        stopped_s = time.monotonic() - t0
        server.shutdown()
    fake = PF.FakeCluster()
    fctl = seed_controller(PC.build_controller(fake))
    fake.create(PT.new_jaxjob("train", **job))
    for _ in range(4):
        fctl.run_until_idle(advance_delayed=True)
    fake_pods = fake.list("v1", "Pod", namespace="default")

    def view(pods):
        pods = sorted(pods, key=lambda p: p["metadata"]["name"])
        trace = pods[0]["metadata"]["annotations"].get(
            "obs.kubeflow.org/traceparent")
        for p in pods:
            p["metadata"].pop("ownerReferences", None)   # the owner's uid
        return _strip(pods, trace)

    assert view(http_pods) == view(fake_pods)
    assert [p["spec"]["containers"][0]["resources"]["limits"]
            for p in http_pods] == [{PT.RESOURCE_GPU: 1}] * 2
    # the watch threads ended with their streams, not at a timeout
    assert stopped_s < 2.0 and not ctl._threads


def test_stop_ends_a_blocked_watch_within_two_seconds():
    server = PA.ApiServer().serve_background()
    server.bookmark_interval = 3600.0      # nothing ever arrives
    try:
        stream = PA.client_for(server).watch("v1", "ConfigMap", "default")
        w = _Consumer(stream, server.cluster)
        time.sleep(0.2)                    # blocked in the socket read
        t0 = time.monotonic()
        stream.stop()
        w.thread.join(2.0)
        assert not w.thread.is_alive()
        assert time.monotonic() - t0 < 2.0
        assert w.events == []
    finally:
        server.shutdown()


def scripted_server(codes: list):
    """An HTTP server answering each request with the next status of
    ``codes`` (503s with Retry-After: 0.3), then 200 with a ConfigMap;
    it records the verbs it saw."""
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    seen = []

    class Handler(BaseHTTPRequestHandler):
        def _answer(self):
            seen.append(self.command)
            length = int(self.headers.get("Content-Length") or 0)
            self.rfile.read(length)
            code = codes.pop(0) if codes else 200
            body = json.dumps({"kind": "ConfigMap", "metadata": {
                "name": "cm"}} if code == 200 else
                {"kind": "Status", "message": f"scripted {code}"}).encode()
            self.send_response(code)
            if code == 503:
                self.send_header("Retry-After", "0.3")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        do_GET = do_POST = _answer

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, seen


def test_retries_and_backoff_follow_the_jax_schedule():
    from kubeflow_tpu.control.k8s.rest import RestClient as RClient
    from kubeflow_tpu_torch.control.k8s.rest import RestClient as PClient

    codes: list = []
    srv, seen = scripted_server(codes)
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def run(cls, ob):
        got = []
        for verb, script in (("GET", [503, 500, 429]), ("POST", [500]),
                             ("POST", [503, 503, 503, 503, 503])):
            codes[:] = script
            seen.clear()
            c = cls(base_url=url)
            slept = []
            c._sleep = slept.append
            try:
                if verb == "GET":
                    out = c.get("v1", "ConfigMap", "cm", "default")
                else:
                    out = c.create(ob.new_object("v1", "ConfigMap", "cm",
                                                 "default"))
                out = out["metadata"]["name"]
            except ob.ApiError as e:
                out = (type(e).__name__, getattr(e, "code", None))
            got.append((out, list(seen), [round(x, 9) for x in slept]))
        return got

    try:
        want = run(RClient, RO)
        got = run(PClient, PO)
    finally:
        srv.shutdown()
        srv.server_close()
    assert got == want
    # GET replays 5xx and refusals; POST replays only refusals, and
    # Retry-After floors the jittered delay
    assert [len(s) for _, s, _ in got] == [4, 1, 5]
    assert got[1][0] == ("ApiError", 500)
    assert got[2][0] == ("ApiError", 503) and min(got[2][2]) >= 0.3
