"""The port's TSDB and scrape loop (kubeflow_tpu_torch/obs/tsdb.py)
against the JAX package's.

Seeded appends and staleness marks (with the ring and the series cap
both biting) leave equal stores: every instant, window, dump, latest
point and count. Seeded scrape cycles over in-process registries, a
target that fails on some cycles, discovery whose membership moves and
fails once, and live HTTP `/metrics` endpoints leave equal stores, cycle
stats, `up` and self-metrics. `jaxservice_targets` finds the same
targets in both packages' clusters and caches.

The helpers (`Clock`, `view`, `Twin`, `registry_ops`) are shared with the
other obs parity files.
"""

import math

import numpy as np
import pytest

from kubeflow_tpu.control.cache import ClusterCache as RCache
from kubeflow_tpu.control.jaxservice import types as RST
from kubeflow_tpu.control.k8s.fake import FakeCluster as RCluster
from kubeflow_tpu.obs import expofmt as rexpo
from kubeflow_tpu.obs import tsdb as RS
from kubeflow_tpu.runtime.metrics import MetricsRegistry as RRegistry
from kubeflow_tpu.serving import router as RR
from kubeflow_tpu_torch.control.cache import ClusterCache as PCache
from kubeflow_tpu_torch.control.jaxservice import types as PST
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster as PCluster
from kubeflow_tpu_torch.obs import expofmt as pexpo
from kubeflow_tpu_torch.obs import tsdb as PS
from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry as PRegistry
from kubeflow_tpu_torch.serving import router as PR
from kubeflow_tpu_torch.utils import httpd

# the router's latency buckets, as both packages' routers observe them
REQUEST_BUCKETS = PR.REQUEST_BUCKETS
assert REQUEST_BUCKETS == RR.REQUEST_BUCKETS


class Clock:
    """An injected clock: the test moves ``t``."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def norm(v: float):
    """A sample value compared across packages: the staleness marker and
    NaN by name (NaN != NaN), every other value as itself."""
    if pexpo.is_stale(v):
        assert rexpo.is_stale(v)
        return "stale"
    return "nan" if math.isnan(v) else v


def view(store, since=None) -> list:
    return [(name, labels, [(t, norm(v)) for t, v in pts])
            for name, labels, pts in store.dump_since(since)]


def vec_view(vec) -> list:
    return [(labels, norm(v)) for labels, v in vec]


def window_view(series) -> tuple:
    labels, pts = series
    return labels, [(t, norm(v)) for t, v in pts]


def assert_close(got, want, rel: float = 1e-12):
    """Nested equality, floats within ``rel`` relative."""
    if isinstance(want, float) and isinstance(got, float):
        if math.isnan(want) or math.isnan(got):
            assert math.isnan(want) and math.isnan(got)
        else:
            assert got == pytest.approx(want, rel=rel, abs=1e-300)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (
            sorted(got), sorted(want))
        for k in want:
            assert_close(got[k], want[k], rel)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (got, want)
        for a, b in zip(got, want):
            assert_close(a, b, rel)
    else:
        assert got == want


class Twin:
    """One object per package, called alike; ``call`` returns both
    answers."""

    def __init__(self, port, ref):
        self.port, self.ref = port, ref

    def call(self, name, *a, **kw):
        return getattr(self.port, name)(*a, **kw), \
            getattr(self.ref, name)(*a, **kw)


def registry_ops(rng, n: int, services=("chat", "code"),
                 tenants=("team-a", "team-b"), nodes=("gpu-node-0",
                                                      "gpu-node-1")):
    """``n`` seeded writes of the series the rule packs read: router
    latency histograms and request counters by service, tenant, revision
    and node; reconcile and scheduler-pass series; KV pages; checkpoint
    failures; retry tokens."""
    ops = []
    for _ in range(n):
        k = int(rng.integers(8))
        svc = services[int(rng.integers(len(services)))]
        ten = tenants[int(rng.integers(len(tenants)))]
        rev = ("r1", "r2")[int(rng.integers(2))]
        node = nodes[int(rng.integers(len(nodes)))]
        labels = dict(namespace="default", service=svc, tenant=ten,
                      revision=rev, node=node)
        if k in (0, 1, 2):
            lat = float(rng.choice([0.03, 0.2, 0.45, 0.7, 3.0, 400.0]))
            ops.append(("histogram", "router_request_seconds", lat,
                        dict(buckets=REQUEST_BUCKETS, **labels)))
            outcome = ("ok", "ok", "failed", "deadline", "shed")[
                int(rng.integers(5))]
            ops.append(("counter_inc", "router_requests_total", 1.0,
                        dict(outcome=outcome, **labels)))
        elif k == 3:
            ops.append(("counter_inc", "controller_reconcile_total", 1.0,
                        dict(controller=("jaxjob", "notebook")[
                            int(rng.integers(2))],
                             result=("ok", "ok", "error")[
                                 int(rng.integers(3))])))
        elif k == 4:
            ops.append(("histogram", "scheduler_pass_seconds",
                        float(rng.choice([0.01, 0.3, 2.0, 4.0])), {}))
        elif k == 5:
            ops.append(("gauge", "serving_kv_pages_free",
                        float(rng.choice([0, 0, 3, 17, 72])),
                        dict(model=svc)))
        elif k == 6:
            ops.append(("counter_inc", "checkpoint_failures_total",
                        float(rng.integers(0, 2)), {}))
        else:
            ops.append(("counter_inc", "router_tenant_retry_tokens_total",
                        float(rng.integers(1, 40)), dict(tenant=ten)))
    return ops


def apply_ops(reg, ops) -> None:
    for kind, name, value, labels in ops:
        labels = dict(labels)
        if kind == "gauge":
            reg.gauge(name, value, **labels)
        elif kind == "counter_inc":
            reg.counter_inc(name, by=value, **labels)
        else:
            reg.histogram(name, value, **labels)


# -- the store ----------------------------------------------------------------

NAMES = ("a_total", "b", "c_bucket")


@pytest.mark.parametrize("seed", range(5))
def test_store_seeded_ops_equal(seed):
    rng = np.random.default_rng(seed)
    stores = Twin(PS.TimeSeriesStore(max_points=6, max_series=7),
                  RS.TimeSeriesStore(max_points=6, max_series=7))
    t = 0.0
    for _ in range(300):
        t += float(rng.choice([0.0, 0.5, 1.0, 7.0]))
        name = NAMES[int(rng.integers(len(NAMES)))]
        labels = {"i": str(int(rng.integers(4)))}
        if rng.random() < 0.3:
            labels["le"] = str(float(rng.choice([0.5, 1.0])))
        if rng.random() < 0.1:
            key = PS.series_key(name, labels)
            assert key == RS.series_key(name, labels)
            stores.call("mark_stale", key, t)
        else:
            v = float(rng.choice([0.0, 1.5, -2.0, math.nan, math.inf,
                                  float(rng.integers(100))]))
            got, want = stores.call("append", name, labels, v, t)
            assert got == want
    got, want = stores.call("stats")
    assert got == want and want["dropped"] > 0
    assert view(stores.port) == view(stores.ref)
    for since in (None, t / 3, t / 2, t):
        assert view(stores.port, since) == view(stores.ref, since)
    for at in np.linspace(0, t + 10, 9):
        for name in NAMES:
            for m in (None, {"i": "1"}, {"le": "0.5"}, {"i": "9"}):
                for lb in (5.0, 30.0, 300.0):
                    got, want = stores.call("instant", name, m, float(at),
                                            lb)
                    assert sorted(vec_view(got), key=repr) == \
                        sorted(vec_view(want), key=repr)
                got, want = stores.call("window", name, m, float(at) - 20,
                                        float(at))
                assert sorted(map(window_view, got), key=repr) == \
                    sorted(map(window_view, want), key=repr)
    for name in NAMES:
        for i in range(4):
            got, want = stores.call("latest", PS.series_key(name, {"i": str(i)}))
            assert (got and (got[0], norm(got[1]))) == \
                (want and (want[0], norm(want[1])))
        assert stores.call("series_count", name)[0] == \
            stores.ref.series_count(name)
    assert stores.call("names")[0] == stores.ref.names()
    assert stores.port.series_count() == stores.ref.series_count()


# -- the scrape loop ------------------------------------------------------------


class Flaky:
    """A target wrapper failing on the cycles in ``down``."""

    def __init__(self, target, down: set, clock):
        self.target, self.down, self.clock = target, down, clock
        self.instance, self.labels = target.instance, target.labels

    def fetch(self) -> str:
        if round(self.clock.t) in self.down:
            raise OSError("connection refused")
        return self.target.fetch()


def scrape_world(pkg, regs, clock, rng_members, down):
    """A ScrapeLoop of one package: two static targets (one flaky), and
    discovery over the seeded member lists (None: discovery fails)."""
    S = PS if pkg is PS else RS
    static = [S.RegistryTarget("router", regs[0], labels={"job": "router"}),
              Flaky(S.RegistryTarget("prober", regs[1]), down, clock)]

    def discover():
        members = rng_members[round(clock.t)]
        if members is None:
            raise ConnectionError("apiserver down")
        return [S.RegistryTarget(f"default/chat-replica-{i}", regs[2 + i],
                                 labels={"job": "jaxservice",
                                         "replica": f"chat-replica-{i}"})
                for i in members]

    self_reg = PRegistry() if pkg is PS else RRegistry()
    return S.ScrapeLoop(S.TimeSeriesStore(max_points=64), targets=static,
                        discover=discover, interval_s=15.0, clock=clock,
                        registry=self_reg), self_reg


@pytest.mark.parametrize("seed", range(5))
def test_scrape_loop_seeded_equal(seed):
    rng = np.random.default_rng(seed)
    clock = Clock(0.0)
    pregs = [PRegistry() for _ in range(5)]
    rregs = [RRegistry() for _ in range(5)]
    cycles = 14
    members = {}
    for c in range(cycles):
        t = 15 * (c + 1)
        members[t] = (None if rng.random() < 0.1 else
                      sorted(set(int(i) for i in rng.integers(0, 3, 2))))
    down = {15 * (c + 1) for c in range(cycles) if rng.random() < 0.3}
    ploop, pself = scrape_world(PS, pregs, clock, members, down)
    rloop, rself = scrape_world(RS, rregs, clock, members, down)
    for c in range(cycles):
        clock.t = 15.0 * (c + 1)
        ops = registry_ops(rng, 6)
        for i in range(5):
            if rng.random() < 0.7:
                apply_ops(pregs[i], ops)
                apply_ops(rregs[i], ops)
            if rng.random() < 0.15:
                # a label set a target stops exposing goes stale
                pregs[i] = PRegistry()
                rregs[i] = RRegistry()
        for loop, regs in ((ploop, pregs), (rloop, rregs)):
            loop.targets[0].registry = regs[0]
            loop.targets[1].target.registry = regs[1]
        assert pregs[0].render() == rregs[0].render()
        got, want = ploop.scrape_once(), rloop.scrape_once()
        assert got == want
        for inst in ("router", "prober", "default/chat-replica-0",
                     "default/chat-replica-1", "default/chat-replica-2"):
            assert ploop.up(inst) == rloop.up(inst)
        assert pself.render() == rself.render()
    assert ploop.stats() == rloop.stats()
    assert view(ploop.store) == view(rloop.store)
    stale = sum(1 for _, _, pts in view(ploop.store) for _, v in pts
                if v == "stale")
    assert stale > 0


def _serve(reg) -> httpd.HttpService:
    r = httpd.Router("exposition")
    r.route("GET", "/metrics", lambda req: httpd.HttpResp(
        body=reg.render().encode(),
        content_type="text/plain; version=0.0.4"))
    return httpd.HttpService(r, "127.0.0.1", 0).serve_background()


def test_http_targets_equal():
    """Both packages' HttpTargets scrape a live exposition (the port's
    registry rendered by the port's HttpService) into equal stores; a
    target whose server went away reads up 0 with its series stale."""
    rng = np.random.default_rng(7)
    reg = PRegistry()
    apply_ops(reg, registry_ops(rng, 40))
    svc = _serve(reg)
    clock = Clock(15.0)
    url = f"http://127.0.0.1:{svc.port}/metrics"
    loops = Twin(PS.ScrapeLoop(PS.TimeSeriesStore(),
                               [PS.HttpTarget("r0", url, {"job": "x"})],
                               clock=clock),
                 RS.ScrapeLoop(RS.TimeSeriesStore(),
                               [RS.HttpTarget("r0", url, {"job": "x"})],
                               clock=clock))
    try:
        got, want = loops.call("scrape_once")
        assert got == want and got["ok"] == 1 and got["samples"] > 20
        apply_ops(reg, registry_ops(rng, 10))
        clock.t = 30.0
        got, want = loops.call("scrape_once")
        assert got == want
    finally:
        svc.shutdown()
    clock.t = 45.0
    got, want = loops.call("scrape_once")
    assert got == want and got["failed"] == 1
    assert view(loops.port.store) == view(loops.ref.store)
    up = loops.port.store.instant("up", {"instance": "r0"}, 45.0)
    assert up == [({"instance": "r0", "job": "x"}, 0.0)]
    assert loops.port.store.instant("serving_kv_pages_free", None, 45.0) \
        == []


# -- discovery ------------------------------------------------------------------

ENDPOINTS = [
    ("default", "chat", [
        {"name": "chat-replica-0", "addr": "http://10.0.0.1:8500",
         "state": "active"},
        {"name": "chat-replica-1", "addr": "10.0.0.2:8500/",
         "state": "cordoned"},
        {"name": "chat-replica-2", "addr": "", "state": "active"}]),
    ("team-b", "chat", [
        {"name": "chat-replica-0", "addr": "http://10.1.0.1:8500",
         "state": "active", "revision": "r2"}]),
    ("team-b", "code", None),
    ("team-c", "broken", "{not json"),
]


def discovery_clusters():
    rc, pc = RCluster(), PCluster()
    for ns, name, eps in ENDPOINTS:
        for cluster, T, router in ((rc, RST, RR), (pc, PST, PR)):
            obj = T.new_jaxservice(name, ns)
            if eps is not None:
                obj["metadata"].setdefault("annotations", {})[
                    router.ANNOTATION_ENDPOINTS] = (
                        eps if isinstance(eps, str)
                        else router.render_endpoints(eps))
            cluster.create(obj)
    return pc, rc


def _targets(ts) -> list:
    return [(type(t).__name__, t.instance, t.url, t.labels) for t in ts]


@pytest.mark.parametrize("namespace", [None, "default", "team-b", "none"])
def test_jaxservice_targets_equal(namespace):
    pc, rc = discovery_clusters()
    got = _targets(PS.jaxservice_targets(pc, namespace=namespace))
    want = _targets(RS.jaxservice_targets(rc, namespace=namespace))
    assert got == want
    if namespace is None:
        assert [t[1] for t in got] == ["default/chat-replica-0",
                                       "default/chat-replica-1",
                                       "team-b/chat-replica-0"]
        assert got[1][2] == "http://10.0.0.2:8500/metrics"
    pcache = PCache(pc, kinds=((PST.API_VERSION, PST.KIND),)).connect()
    rcache = RCache(rc, kinds=((RST.API_VERSION, RST.KIND),)).connect()
    pcache.refresh()
    rcache.refresh()
    assert _targets(PS.jaxservice_targets(pcache, namespace=namespace)) \
        == _targets(RS.jaxservice_targets(rcache, namespace=namespace)) \
        == want
