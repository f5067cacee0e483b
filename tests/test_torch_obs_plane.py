"""The port's assembled observability plane (kubeflow_tpu_torch/obs/
plane.py) and `ServingSLO.from_store` against the JAX package's.

Each package's `FleetPlane` runs on one virtual clock over its own
FakeCluster: a JAXService whose endpoints annotation publishes a live
replica exposition (served over HTTP by the port's `HttpService`, so
discovery, the HTTP scrape and the router's in-process registry all
feed it), the default rule pack, and a `RemediationEngine` over
`default_remediations(client=cluster)`. Through calm traffic, KV-page
exhaustion (pending, firing, the scale-up nudge), a silence, recovery
and the replica's loss (up 0, its series stale), every tick's scrape,
transitions and decisions, the alerts with their routes and silences,
the queries, the audit, goodput, chargeback, the Events and the
clusters' JAXServices are equal. `SilenceStore` and `route_for` are held
on their own, and `default_plane()` self-scrapes the port's REGISTRY.
"""

import json

import numpy as np
import pytest

from kubeflow_tpu.control.jaxservice import types as RST
from kubeflow_tpu.control.k8s.fake import FakeCluster as RCluster
from kubeflow_tpu.obs import goodput as RG
from kubeflow_tpu.obs import plane as RPL
from kubeflow_tpu.obs import remediate as RM
from kubeflow_tpu.obs import trace as RTR
from kubeflow_tpu.obs import tsdb as RS
from kubeflow_tpu.obs.events import EventRecorder as REvents
from kubeflow_tpu.runtime.metrics import MetricsRegistry as RRegistry
from kubeflow_tpu.serving import router as RR
from kubeflow_tpu_torch.control.jaxservice import types as PST
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster as PCluster
from kubeflow_tpu_torch.obs import goodput as PG
from kubeflow_tpu_torch.obs import plane as PPL
from kubeflow_tpu_torch.obs import remediate as PM
from kubeflow_tpu_torch.obs import trace as PTR
from kubeflow_tpu_torch.obs import tsdb as PS
from kubeflow_tpu_torch.obs.events import EventRecorder as PEvents
from kubeflow_tpu_torch.runtime.metrics import REGISTRY
from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry as PRegistry
from kubeflow_tpu_torch.serving import router as PR
from kubeflow_tpu_torch.utils import httpd
from test_torch_control_profile import event_row
from test_torch_obs_tsdb import (REQUEST_BUCKETS, Clock, Twin, assert_close,
                                 view)

# -- silences and routes ----------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_silence_store_equal(seed):
    rng = np.random.default_rng(seed)
    clock = Clock(100.0)
    stores = Twin(PPL.SilenceStore(clock=clock, limit=4),
                  RPL.SilenceStore(clock=clock, limit=4))
    for _ in range(60):
        clock.t += float(rng.choice([0.0, 10.0, 60.0]))
        k = int(rng.integers(5))
        if k == 0:
            matchers = {}
            if rng.random() < 0.9:
                matchers["alertname"] = ("KVPagesExhausted",
                                         "NodeSLOBurn")[int(rng.integers(2))]
            if rng.random() < 0.5:
                matchers["namespace"] = ("default", "team-b")[
                    int(rng.integers(2))]
            until = clock.t + float(rng.choice([5.0, 100.0, 1000.0]))
            outs = []
            for s in (stores.port, stores.ref):
                try:
                    outs.append(("ok", s.add(matchers, until, comment="c",
                                             created_by="u")))
                except ValueError as e:
                    outs.append(("error", str(e)))
            assert outs[0] == outs[1]
        elif k == 1:
            sid = f"s{int(rng.integers(1, 12))}"
            got, want = stores.call("delete", sid)
            assert got == want
        elif k == 2:
            got, want = stores.call("list")
            assert got == want
        else:
            labels = {"namespace": ("default", "team-b")[int(rng.integers(2))]}
            for alert in ("KVPagesExhausted", "NodeSLOBurn"):
                at = None if rng.random() < 0.5 else clock.t + 50
                got, want = stores.call("silenced", alert, labels, at)
                assert got == want


def test_routes_equal():
    routes = lambda M: (M.Route("oncall-prod", severity="critical",  # noqa: E731
                                matchers={"namespace": "prod"}),
                        *M.DEFAULT_ROUTES)
    planes = [M.FleetPlane(registry=Reg(), clock=Clock(), routes=routes(M),
                           collector=T.TraceCollector())
              for M, Reg, T in ((PPL, PRegistry, PTR), (RPL, RRegistry, RTR))]
    for sev in ("critical", "warning", "info", ""):
        for labels in (None, {}, {"namespace": "prod"}, {"namespace": "x"}):
            assert planes[0].route_for("A", sev, labels) == \
                planes[1].route_for("A", sev, labels)
    assert planes[0].route_for("A", "critical", {"namespace": "prod"}) == \
        "oncall-prod"


# -- the plane drill ------------------------------------------------------------------


def spans(T):
    """A job's training spans and a scheduler pass, equal in both
    packages: step, compile, checkpoint and a restart, two tenants."""
    out = []
    for i, (name, start, end, attrs) in enumerate([
        ("jaxjob.provision", 10.0, 12.0, {"namespace": "team-a"}),
        ("train.step", 20.0, 30.0, {"compile": True, "namespace": "team-a"}),
        ("train.step", 30.0, 60.0, {"namespace": "team-a"}),
        ("train.checkpoint", 55.0, 70.0, {"namespace": "team-a"}),
        ("jaxjob.provision", 80.0, 95.0, {"namespace": "team-a"}),
        ("train.step", 100.0, 200.0, {"tenant": "team-b"}),
        ("elastic.rebuild", 210.0, 230.0, {"tenant": "team-b"}),
        ("scheduler.pass", 15.0, 16.0, {}),
    ]):
        out.append(T.Span(name, "t" * 32, f"{i:016x}", start=start, end=end,
                          attrs=dict(attrs), pid=1, tid=1))
    return out


class Side:
    """One package's plane over its own cluster, with a router registry
    and the shared replica exposition discovered through the cluster."""

    def __init__(self, pkg, clock, replica_url):
        port = pkg == "port"
        self.ST = PST if port else RST
        self.S = PS if port else RS
        self.M = PM if port else RM
        router_mod = PR if port else RR
        self.cluster = (PCluster if port else RCluster)()
        svc = self.ST.new_jaxservice("chat", "default", min_replicas=1,
                                     max_replicas=3)
        svc["metadata"]["annotations"] = {
            router_mod.ANNOTATION_ENDPOINTS: router_mod.render_endpoints([
                {"name": "chat-replica-0", "addr": replica_url,
                 "state": "active"}])}
        self.cluster.create(svc)
        got = self.cluster.get(self.ST.API_VERSION, self.ST.KIND, "chat",
                               "default")
        got["status"] = {"targetReplicas": 1}
        self.cluster.update_status(got)
        self.router = (PRegistry if port else RRegistry)()
        self.prober = (PRegistry if port else RRegistry)()
        self.self_reg = (PRegistry if port else RRegistry)()
        collector = (PTR if port else RTR).TraceCollector()
        for s in spans(PTR if port else RTR):
            collector.add(s)
        recorder = (PEvents if port else REvents)(self.cluster,
                                                  component="obs")
        PL = PPL if port else RPL
        self.plane = PL.FleetPlane(
            registry=self.self_reg, recorder=recorder,
            targets=[self.S.RegistryTarget("router", self.router,
                                           labels={"job": "router"}),
                     self.S.RegistryTarget("prober", self.prober,
                                           labels={"job": "prober"})],
            discover=lambda: self.S.jaxservice_targets(self.cluster),
            clock=clock, collector=collector,
            remediator=self.M.RemediationEngine(
                self.M.default_remediations(client=self.cluster),
                recorder=recorder, registry=self.self_reg, clock=clock))


def router_requests(regs, rng, n, slow: float) -> None:
    for _ in range(n):
        tenant = ("team-a", "team-b")[int(rng.integers(2))]
        lat = 2.0 if rng.random() < slow else 0.04
        for reg in regs:
            reg.histogram("router_request_seconds", lat,
                          buckets=REQUEST_BUCKETS, namespace="default",
                          service="chat", tenant=tenant)
            reg.counter_inc("router_requests_total", namespace="default",
                            service="chat", tenant=tenant,
                            outcome="completed")


QUERIES = ("up", "serving_kv_pages_free", "slo:router_burn:short",
           "slo:router_p95:short", 'ALERTS{alertstate="firing"}',
           "sum by (tenant) (increase(router_requests_total[2m]))",
           "obs_scrape_targets")


def test_plane_drill_equal():
    replica = PRegistry()
    server = _expose(replica)
    clock = Clock(0.0)
    sides = [Side(pkg, clock, f"http://127.0.0.1:{server.port}")
             for pkg in ("port", "jax")]
    rng = np.random.default_rng(3)
    seen = []
    try:
        for c in range(30):
            clock.t += 15.0
            pages = 0.0 if 6 <= c < 12 else 72.0
            replica.gauge("serving_kv_pages_free", pages, model="chat")
            router_requests([s.router for s in sides], rng, 6,
                            slow=0.6 if 8 <= c < 14 else 0.0)
            for s in sides:
                s.prober.gauge("kubeflow_availability", 1.0 if c < 24 else 0,
                               target="replica")
            if c == 9:
                for s in sides:
                    s.plane.silences.add({"alertname": "RouterLatencySLOBurn"},
                                         until=clock.t + 60.0)
            if c == 24:
                server.shutdown()
            at = None if c % 2 else clock.t
            got, want = (s.plane.tick(at=at) for s in sides)
            assert_close(got, want)
            seen += [(t["alert"], t["to"]) for t in got["transitions"]]
            seen += [(d["action"], d["result"]) for d in got["remediations"]]
            assert_close(sides[0].plane.alerts(), sides[1].plane.alerts())
            for q in QUERIES:
                assert_close(sides[0].plane.query(q), sides[1].plane.query(q))
    finally:
        if c < 24:
            server.shutdown()
    assert ("KVPagesExhausted", "firing") in seen
    assert ("KVPagesExhausted", "resolved") in seen
    assert ("jaxservice-scale-up", "executed") in seen
    assert sides[0].plane.query('up{instance="default/chat-replica-0"}') \
        ["result"][0]["value"] == 0.0
    assert sides[0].plane.query("serving_kv_pages_free")["result"] == []
    for s in sides:
        svc = s.cluster.get(s.ST.API_VERSION, s.ST.KIND, "chat", "default")
        assert svc["metadata"]["annotations"][
            s.ST.ANNOTATION_SCALE_NUDGE] == "2"
    assert view(sides[0].plane.store) == view(sides[1].plane.store)
    assert sides[0].self_reg.render() == sides[1].self_reg.render()
    assert_close(*(s.plane.remediation_audit() for s in sides))
    for kw in ({}, {"chips": 4, "window_s": 120.0},
               {"window_s": 0.4, "at": 200.0}):
        assert_close(*(s.plane.goodput(**kw) for s in sides))
    for kw in ({}, {"window_s": 200.0, "chips_by_tenant": {"team-b": 8}},
               {"window_s": 1e6, "at": clock.t, "default_chips": 2}):
        assert_close(*(s.plane.chargeback(**kw) for s in sides))
    events = [sorted(map(event_row, s.cluster.list("v1", "Event")),
                     key=repr) for s in sides]
    assert events[0] == events[1] and events[0]


def _expose(reg) -> httpd.HttpService:
    r = httpd.Router("replica")
    r.route("GET", "/metrics", lambda req: httpd.HttpResp(
        body=reg.render().encode(),
        content_type="text/plain; version=0.0.4"))
    return httpd.HttpService(r, "127.0.0.1", 0).serve_background()


# -- the serving SLO from the store -------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_serving_slo_from_store_equal(seed):
    """`from_store` answers alike in both packages over windows,
    services and tenants (a fractional window rounds, floored at 1 s);
    over the scraped span of a router registry it counts what
    `from_registry` counted since the series' first scrape."""
    rng = np.random.default_rng(seed)
    clock = Clock(0.0)
    regs = PRegistry(), RRegistry()
    loops = (PS.ScrapeLoop(PS.TimeSeriesStore(),
                           [PS.RegistryTarget("router", regs[0])],
                           clock=clock),
             RS.ScrapeLoop(RS.TimeSeriesStore(),
                           [RS.RegistryTarget("router", regs[1])],
                           clock=clock))
    router_requests(regs, rng, 3, slow=0.5)
    clock.t = 15.0
    for loop in loops:
        loop.scrape_once()
    slo = PG.ServingSLO(latency_target_s=0.5, objective=0.9)
    ref = RG.ServingSLO(latency_target_s=0.5, objective=0.9)
    first = slo.from_registry(regs[0], "default", "chat")
    for c in range(12):
        router_requests(regs, rng, int(rng.integers(1, 8)),
                        slow=float(rng.random()))
        clock.t += 15.0
        for loop in loops:
            loop.scrape_once()
    assert view(loops[0].store) == view(loops[1].store)
    for window in (0.4, 14.6, 60.0, 300.0, 1e5):
        for kw in ({}, {"service": "chat"}, {"tenant": "team-b"},
                   {"service": "code"}):
            got = slo.from_store(loops[0].store, clock.t, window, **kw)
            assert_close(got, ref.from_store(loops[1].store, clock.t, window,
                                             **kw))
    whole = slo.from_store(loops[0].store, clock.t, 1e5, service="chat")
    last = slo.from_registry(regs[0], "default", "chat")
    assert last == ref.from_registry(regs[1], "default", "chat")
    assert whole["requests"] == last["requests"] - first["requests"] > 0
    # attainment is rounded to 6 places in both packages' answers
    assert whole["attainment"] == pytest.approx(
        (last["attainment"] * last["requests"]
         - first["attainment"] * first["requests"]) / whole["requests"],
        abs=1e-5)


def test_default_plane_self_scrapes_the_port_registry():
    plane = PPL.default_plane()
    try:
        assert PPL.default_plane() is plane
        assert plane._thread is not None and plane._thread.daemon
        REGISTRY.gauge("obs_plane_test_gauge", 3.0, help_="a probe")
        plane.tick()
        got = plane.query('obs_plane_test_gauge{instance="self"}')
        assert [r["value"] for r in got["result"]] == [3.0]
        assert json.dumps(plane.alerts())
    finally:
        plane.stop()
        PPL._default = None
