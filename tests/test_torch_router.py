"""The port's token router (kubeflow_tpu_torch/serving/router.py, a copy
of the jax-free kubeflow_tpu/serving/router.py) against the reference.

One scripted sequence (membership with revisions, a canary split,
submits of mixed bands, tenants and deadlines, completions, transport
failures with and without requeue, a cordon, hedging, a breaker that
trips and cools off, a removed member whose tickets are shed and
re-dispatched, a full queue, close) runs through the JAX package's
TokenRouter and the port's, each with an injected clock, its own
MetricsRegistry and an on_decision tap. The dispatch log, the decision
stream and every registry series must be equal: the core is
deterministic, so nothing is compared with a tolerance. Then a live
RouterFrontend over HttpTransport in front of two port ModelServer
replicas on the CPU: every response equals a direct call of a replica,
both replicas serve, and the queue and in-flight gauges return to 0.
"""

import concurrent.futures as cf
import json
import urllib.request

import pytest

from kubeflow_tpu.obs import trace as jax_trace
from kubeflow_tpu.runtime.metrics import MetricsRegistry as JaxRegistry
from kubeflow_tpu.serving import router as JR
from kubeflow_tpu_torch.obs import trace as port_trace
from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry
from kubeflow_tpu_torch.serving import router as PR

SIDES = {"jax": (JR, jax_trace, JaxRegistry, {"prom_sink": False}),
         "port": (PR, port_trace, MetricsRegistry, {})}


def _run(side: str, resilient: bool, budget: int) -> dict:
    R, trace, registry_cls, extra = SIDES[side]
    now = [0.0]
    decisions: list = []
    log: list = []
    reg = registry_cls()
    res = (R.ResilienceConfig(breaker_failures=2, breaker_cooloff_s=1.5,
                              hedge_min_samples=3, hedge_min_s=0.05,
                              retry_budget_ratio=0.5, retry_budget_cap=4.0)
           if resilient else None)
    router = R.TokenRouter(
        service="svc", namespace="ns", max_queue=6, replica_token_budget=budget,
        clock=lambda: now[0], registry=reg, tracer=trace.Tracer(),
        resilience=res, on_decision=decisions.append, canary_seed=11,
        **extra)

    def note(what, tickets):
        log.append((what, [(t.tokens, t.member.name if t.member else None,
                            t.revision, t.dropped_reason) for t in tickets]))

    def tick(dt):
        now[0] = round(now[0] + dt, 6)

    note("members", router.set_members(
        [R.Member("a", revision="r1"), R.Member("b", revision="r1"),
         R.Member("c", revision="r2")]))
    router.set_canary("r2", 0.4)
    tickets = []
    plan = [(40, "default", None, None), (24, "critical", None, "team-x"),
            (60, "sheddable", None, None), (32, "default", 4.0, None),
            (48, "default", None, "team-y"), (16, "sheddable", 2.0, None),
            (72, "critical", None, None), (20, "default", None, "team-x"),
            (36, "sheddable", None, None), (28, "default", 9.0, "team-y")]
    for i, (tok, band, dl, tenant) in enumerate(plan):
        tick(0.1)
        try:
            t = router.submit(tok, item=i, band=band, tenant=tenant,
                              deadline=None if dl is None else now[0] + dl)
            tickets.append(t)
            note(f"submit{i}", [t])
        except (R.RouterBusy, R.DeadlineExceeded) as e:
            log.append((f"submit{i}", type(e).__name__))
    live = [t for t in tickets if t.member is not None]
    for j, t in enumerate(live[:4]):
        tick(0.2 + 0.1 * j)
        note(f"complete{j}", router.complete(t))
    log.append(("hedge_delay", router.hedge_delay()))
    busy = [t for t in tickets if t.member is not None and not t.resolved]
    if busy:
        tick(2.5)                  # past the hedge delay
        h = router.try_hedge(busy[0])
        log.append(("hedge", None if h is None else h.name))
        tick(0.1)
        note("hedge_complete", router.complete(
            busy[0], winner=None if h is None else h.name))
    # transport failures: one retried, one surfaced to its client
    busy = [t for t in tickets if t.member is not None and not t.resolved]
    for j, t in enumerate(busy[:2]):
        tick(0.05)
        note(f"fail{j}", router.fail(t, requeue=(j == 0)))
    router.cordon("b")
    log.append(("members", router.members()))
    tick(0.3)
    # a burst past max_queue: sheddable first, then critical arrivals
    # that evict queued sheddable work, then plain refusals
    for i in range(10):
        try:
            t = router.submit(30 + i, item=100 + i,
                              band="sheddable" if i < 4 else "critical")
            tickets.append(t)
            note(f"late{i}", [t])
        except (R.RouterBusy, R.DeadlineExceeded) as e:
            log.append((f"late{i}", type(e).__name__))
    # trip a's breaker with repeated failures, then let it cool off
    for j in range(3):
        on_a = [t for t in tickets if t.member is not None
                and t.member.name == "a" and not t.resolved]
        if not on_a:
            break
        tick(0.05)
        note(f"fail_a{j}", router.fail(on_a[0]))
    log.append(("breakers", router.breaker_states()))
    tick(2.0)
    note("kick", router.kick())
    # remove c: its in-flight tickets go back to the front of the queue
    note("remove_c", router.set_members(
        [R.Member("a", revision="r1"),
         R.Member("b", state=R.STATE_CORDONED, revision="r1")]))
    router.uncordon("b")
    tick(5.0)                      # past every deadline
    note("kick2", router.kick())
    for j, t in enumerate([t for t in tickets if t.member is not None
                           and not t.resolved]):
        tick(0.1)
        note(f"drain{j}", router.complete(t, tokens_done=t.tokens // 2))
    log.append(("state", router.queue_depth(), router.inflight_tokens(),
                router.retry_after(), router.retry_budget(),
                router.drained("a"), router.canary()))
    note("close", router.close())
    series = {}
    for name in sorted(reg._metrics):
        series[name] = sorted((tuple(sorted(lbl.items())), v)
                              for lbl, v in reg.series(name))
    return {"log": log, "decisions": decisions, "series": series,
            "render": reg.render()}


@pytest.mark.parametrize("resilient,budget,kinds", [
    (False, 96, {"deadline"}),
    (True, 96, {"breaker", "deadline", "shed"}),
    (True, 112, {"breaker", "deadline", "hedge", "hedge_win",
                 "retry_budget_drop"}),
], ids=["plain", "resilience-shed", "resilience-hedge"])
def test_scripted_sequence_equals_reference(resilient, budget, kinds):
    want = _run("jax", resilient, budget)
    got = _run("port", resilient, budget)
    assert got["log"] == want["log"]
    assert got["decisions"] == want["decisions"]
    assert got["series"] == want["series"]
    assert got["render"] == want["render"]
    # the sequence reaches the paths it is meant to hold
    assert {d["kind"] for d in got["decisions"]} == kinds


def test_endpoint_helpers_and_estimates_match():
    service = {"metadata": {"annotations": {JR.ANNOTATION_ENDPOINTS: json.dumps(
        [{"name": "r0", "addr": "http://h0:8500", "state": "active"},
         {"name": "r1", "addr": "http://h1:8500", "state": "cordoned",
          "revision": "v2"}])}}, "spec": {"resilience": {
              "defaultBand": "critical", "deadlineSeconds": 3, "hedge": False}}}
    assert PR.ANNOTATION_ENDPOINTS == JR.ANNOTATION_ENDPOINTS
    assert PR.parse_endpoints(service) == JR.parse_endpoints(service)
    eps = PR.parse_endpoints(service)
    assert PR.render_endpoints(eps) == JR.render_endpoints(eps)
    from kubeflow_tpu.control.jaxservice.types import resilience_spec

    for spec in (service["spec"], {}, {"resilience": "bad"}):
        assert PR.resilience_spec(spec) == resilience_spec(spec)
    for inst, n in (([{"tokens": [1, 2, 3]}, {"tokens": [4]}], 8), ([], 5),
                    ([[1, 2], 3], 2)):
        assert PR.estimate_tokens(inst, n) == JR.estimate_tokens(inst, n)
    for header in ("00-" + "a" * 32 + "-" + "b" * 16 + "-01", "junk", None,
                   "00-" + "0" * 32 + "-" + "b" * 16 + "-01"):
        a, b = (port_trace.parse_traceparent(header),
                jax_trace.parse_traceparent(header))
        assert (a is None) == (b is None)
        if a is not None:
            assert a.to_traceparent() == b.to_traceparent()


def test_registry_signals_read_the_router_series():
    reg = MetricsRegistry()
    router = PR.TokenRouter(service="s", namespace="n", registry=reg)
    router.set_members([PR.Member("a"), PR.Member("b")])
    t1, t2 = router.submit(10), router.submit(7)
    for source in (reg, reg.render):
        sig = PR.RegistrySignals(source)
        assert sig.queue_depth("n", "s") == 0
        assert sig.inflight_tokens("n", "s") == 17
        assert not sig.replica_drained("n", "s", t1.member.name)
    router.complete(t1)
    router.complete(t2)
    sig = PR.RegistrySignals(reg)
    assert sig.tokens_total("n", "s") == 17
    assert sig.replica_drained("n", "s", "a")


class _Counting:
    """A transport that counts the predicts it carries."""

    def __init__(self, inner, counts: dict, name: str):
        self.inner, self.counts, self.name = inner, counts, name

    def predict(self, model, body, headers=None):
        self.counts[self.name] = self.counts.get(self.name, 0) + 1
        return self.inner.predict(model, body, headers)


def test_live_frontend_over_two_port_replicas():
    from kubeflow_tpu_torch.serving.server import (
        ModelServer, serve_lm_generator)

    replicas = []
    for _ in range(2):
        srv = ModelServer()
        srv.register(serve_lm_generator(
            "lm", "transformer-test", prompt_len=8, max_new_tokens=4,
            vocab_size=64, dtype="float32", continuous_batching=True,
            decode_slots=4, kv_pages=33, kv_page_size=4, device="cpu"))
        replicas.append((srv, srv.serve(host="127.0.0.1", port=0)
                         .serve_background()))
    counts: dict = {}
    reg = MetricsRegistry()
    router = PR.TokenRouter(service="live", namespace="default",
                            max_queue=64, replica_token_budget=24,
                            registry=reg)
    router.sync_endpoints(
        [{"name": f"r{i}", "addr": f"http://127.0.0.1:{svc.port}",
          "state": PR.STATE_ACTIVE} for i, (_, svc) in enumerate(replicas)],
        transport_factory=lambda ep: _Counting(
            PR.HttpTransport(ep["addr"]), counts, ep["name"]))
    front = PR.RouterFrontend(router, max_new_tokens=4)
    fsvc = front.serve(host="127.0.0.1", port=0).serve_background()
    prompts = [[1 + (3 * i + j) % 60 for j in range(2 + i % 6)]
               for i in range(12)]

    def post(port, prompt):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/models/lm:predict",
            data=json.dumps({"instances": [{"tokens": prompt}]}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())["predictions"][0]

    try:
        with cf.ThreadPoolExecutor(max_workers=8) as pool:
            routed = list(pool.map(lambda p: post(fsvc.port, p), prompts))
        direct = [post(replicas[0][1].port, p) for p in prompts]
    finally:
        fsvc.shutdown()
        for srv, svc in replicas:
            svc.shutdown()
            srv.close()
    assert routed == direct
    assert set(counts) == {"r0", "r1"} and sum(counts.values()) == 12
    assert router.queue_depth() == 0 and router.inflight_tokens() == 0
    sig = PR.RegistrySignals(reg)
    assert sig.queue_depth("default", "live") == 0
    assert sig.inflight_tokens("default", "live") == 0
    with pytest.raises(NotImplementedError, match="control plane"):
        PR.main(["--apiserver", "http://127.0.0.1:1"])
