"""The port's PromQL-lite, rules and alerting (kubeflow_tpu_torch/obs/
rules.py) against the JAX package's.

- A Hypothesis strategy over the query grammar (selectors with matchers
  and ranges, numbers with exponents, rate/increase, aggregations with
  and without ``by``, histogram_quantile, abs/clamp_min/clamp_max,
  unary minus, arithmetic, comparisons, and/or, parentheses) and over
  token soup: both parsers accept the same strings, and each accepted
  query evaluates to the same vector on equal stores, floats within
  1e-12 relative, or both raise the same error.
- A virtual-time drill of each rule pack (default, node, tenant,
  canary): seeded traffic through registries, scrape cycles and rule
  passes, a storm then a calm; every pass's transitions, the active
  alerts, the recorded series, the Events (silenced ones muted) and the
  engine's self-metrics equal; each pack fires and resolves.
- `CanaryAnalysis` verdicts and their per-window detail.
"""


import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from kubeflow_tpu.control.k8s.fake import FakeCluster as RCluster
from kubeflow_tpu.obs import rules as RQ
from kubeflow_tpu.obs import tsdb as RS
from kubeflow_tpu.obs.events import EventRecorder as REvents
from kubeflow_tpu.runtime.metrics import MetricsRegistry as RRegistry
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster as PCluster
from kubeflow_tpu_torch.obs import rules as PQ
from kubeflow_tpu_torch.obs import tsdb as PS
from kubeflow_tpu_torch.obs.events import EventRecorder as PEvents
from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry as PRegistry
from test_torch_control_profile import event_row
from test_torch_obs_tsdb import (REQUEST_BUCKETS, Clock, Twin, apply_ops,
                                 assert_close, registry_ops, view)

INTERVAL = 15.0


class Plane:
    """Both packages' registries (a router, a replica, a scheduler),
    scrape loops and stores on one clock; ``cycle(ops)`` writes the same
    ops into both and scrapes."""

    def __init__(self, t0: float = 0.0):
        self.clock = Clock(t0)
        self.regs = {"p": [PRegistry() for _ in range(3)],
                     "r": [RRegistry() for _ in range(3)]}
        self.loops = {}
        for side, S in (("p", PS), ("r", RS)):
            targets = [S.RegistryTarget(f"default/{n}", reg,
                                        labels={"job": n})
                       for n, reg in zip(("router", "replica", "scheduler"),
                                         self.regs[side])]
            self.loops[side] = S.ScrapeLoop(S.TimeSeriesStore(),
                                            targets=targets,
                                            clock=self.clock)

    @property
    def stores(self):
        return self.loops["p"].store, self.loops["r"].store

    def cycle(self, ops_by_target) -> None:
        self.clock.t += INTERVAL
        for i, ops in enumerate(ops_by_target):
            apply_ops(self.regs["p"][i], ops)
            apply_ops(self.regs["r"][i], ops)
        got = self.loops["p"].scrape_once()
        assert got == self.loops["r"].scrape_once()


def storm_ops(rng, services=("chat", "code")):
    return [registry_ops(rng, n, services=services) for n in (12, 4, 2)]


def calm_ops(rng, services=("chat", "code")):
    """Fast, successful traffic; free pages; a quick scheduler."""
    router = []
    for svc in services:
        for ten in ("team-a", "team-b"):
            for node in ("gpu-node-0", "gpu-node-1"):
                for rev in ("r1", "r2"):
                    labels = dict(namespace="default", service=svc,
                                  tenant=ten, revision=rev, node=node)
                    router.append(("histogram", "router_request_seconds",
                                   0.03, dict(buckets=REQUEST_BUCKETS, **labels)))
                    router.append(("counter_inc", "router_requests_total",
                                   1.0, dict(outcome="ok", **labels)))
    replica = [("gauge", "serving_kv_pages_free", 72.0, dict(model=m))
               for m in services]
    sched = [("histogram", "scheduler_pass_seconds", 0.01, {})]
    return [router, replica, sched]


@pytest.fixture(scope="module")
def plane():
    """Equal stores after 24 seeded cycles, with the default pack's
    recorded series in them."""
    rng = np.random.default_rng(11)
    pl = Plane()
    engines = (PQ.RuleEngine(pl.stores[0], PQ.default_rule_pack(),
                             clock=pl.clock),
               RQ.RuleEngine(pl.stores[1], RQ.default_rule_pack(),
                             clock=pl.clock))
    for c in range(24):
        pl.cycle(storm_ops(rng) if c % 6 < 4 else calm_ops(rng))
        assert engines[0].evaluate_once() == engines[1].evaluate_once()
    assert view(pl.stores[0]) == view(pl.stores[1])
    return pl


# -- the grammar ------------------------------------------------------------------

NAMES = ("router_request_seconds_bucket", "router_request_seconds_count",
         "router_requests_total", "serving_kv_pages_free", "up",
         "controller_reconcile_total", "scheduler_pass_seconds_bucket",
         "checkpoint_failures_total", "slo:router_burn:short",
         "slo:router_p95:short", "ALERTS", "no_such_series")
KEYS = ("service", "tenant", "le", "outcome", "instance", "job", "node",
        "revision", "model", "result", "alertname")
VALUES = ("chat", "code", "team-a", "0.5", "+Inf", "ok", "failed",
          "default/router", "router", 'x\\"y', "", "KVPagesExhausted")
DURATIONS = ("30s", "1m", "5m", "90s", "1.5m", "2h", "0s", "500ms", "1d",
             "10m")

numbers = st.one_of(
    st.integers(0, 2000).map(str),
    st.floats(0, 1e6, allow_nan=False, allow_infinity=False).map(repr),
    st.sampled_from(["1e-05", ".5", "2.5E3", "0.95", "0.99", "1.00000000003e-05"]))


@st.composite
def selectors(draw, ranged=None):
    text = draw(st.sampled_from(NAMES))
    if draw(st.booleans()):
        pairs = draw(st.lists(st.tuples(st.sampled_from(KEYS),
                                        st.sampled_from(VALUES)),
                              max_size=3))
        body = ",".join(f'{k}="{v}"' for k, v in pairs)
        text += "{" + body + ("," if pairs and draw(st.booleans()) else "") \
            + "}"
    if ranged is None:
        ranged = draw(st.booleans())
    if ranged:
        text += f"[{draw(st.sampled_from(DURATIONS))}]"
    return text


def _extend(children):
    binops = st.sampled_from(["+", "-", "*", "/", ">", "<", ">=", "<=",
                              "==", "!=", "and", "or"])
    aggrs = st.sampled_from(["sum", "avg", "max", "min", "count"])
    by = st.lists(st.sampled_from(KEYS), max_size=3).map(
        lambda ks: f" by ({', '.join(ks)}) ")
    return st.one_of(
        st.tuples(st.sampled_from(["rate", "increase"]),
                  st.one_of(selectors(ranged=True), children)).map(
            lambda a: f"{a[0]}({a[1]})"),
        st.tuples(aggrs, st.one_of(st.just(""), by), children).map(
            lambda a: f"{a[0]}{a[1]}({a[2]})"),
        st.tuples(numbers, children).map(
            lambda a: f"histogram_quantile({a[0]}, {a[1]})"),
        st.tuples(st.sampled_from(["abs", "clamp_min", "clamp_max"]),
                  children, numbers).map(
            lambda a: f"{a[0]}({a[1]})" if a[0] == "abs"
            else f"{a[0]}({a[1]}, {a[2]})"),
        children.map(lambda c: f"({c})"),
        children.map(lambda c: f"-{c}"),
        st.tuples(children, binops, children).map(
            lambda a: f"{a[0]} {a[1]} {a[2]}"),
    )


queries = st.recursive(st.one_of(selectors(), numbers), _extend,
                       max_leaves=6)
soup = st.lists(st.sampled_from(
    ["(", ")", "{", "}", "[", "]", ",", "=", "==", "!=", ">", "<", "+",
     "-", "*", "/", "and", "or", "by", "sum", "rate", "5m", '"x"', "1",
     "up", "le", " "]), max_size=10).map("".join)


def outcome(Q, text: str, store, at: float):
    """("ok", vector) or ("error", its type, its message)."""
    try:
        node = Q.parse_query(text)
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return ("parse-error", type(e).__name__, str(e))
    try:
        return ("ok", Q.Evaluator(store, lookback_s=60.0).evaluate(node, at))
    except Exception as e:  # noqa: BLE001
        return ("eval-error", type(e).__name__, str(e))


def assert_same(text, plane):
    for at in (plane.clock.t, plane.clock.t - 100.0, 7.5):
        got = outcome(PQ, text, plane.stores[0], at)
        want = outcome(RQ, text, plane.stores[1], at)
        assert got[0] == want[0], (text, got, want)
        if got[0] == "ok":
            assert_close(got[1], want[1])
        else:
            assert got[1:] == want[1:], text
            assert got[1] == "QueryError", (text, got)


@settings(max_examples=250, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.function_scoped_fixture])
@given(text=queries)
def test_grammar_property(plane, text):
    assert_same(text, plane)


@settings(max_examples=150, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=soup)
def test_token_soup_property(plane, text):
    assert_same(text, plane)


@pytest.mark.parametrize("text", [
    'sum by (service) (rate(router_requests_total{outcome="failed"}[5m]))'
    ' / sum by (service) (rate(router_requests_total[5m]))',
    "histogram_quantile(0.95, sum by (service, le) "
    "(rate(router_request_seconds_bucket[1m])))",
    "serving_kv_pages_free == 0",
    "up == 1 or serving_kv_pages_free > 10",
    "slo:router_burn:short > 1 and slo:router_burn:long > 1",
    "increase(checkpoint_failures_total[10m]) > 0",
    "-clamp_max(abs(serving_kv_pages_free - 40), 5) * 2",
    "count(up) + 1", "1 + 1", "1 > 0", "rate(up)", "up[5m]",
    "sum(1)", "histogram_quantile(up, up)", "foo{le=0.5}", "rate(x[5q])",
    "sum(up", "", "by", "up{,}", "1 / 0", "up / 0",
])
def test_named_queries(plane, text):
    assert_same(text, plane)


def test_shipped_packs_parse_and_render_equal():
    for name in ("default_rule_pack", "node_burn_rules", "tenant_rule_pack",
                 "canary_rule_pack"):
        for kw in ({}, {"latency_target_s": 1, "objective": 0.99999}):
            got, want = getattr(PQ, name)(**kw), getattr(RQ, name)(**kw)
            assert [vars(r) for r in got] == [vars(r) for r in want]
            assert [type(r).__name__ for r in got] == \
                [type(r).__name__ for r in want]
            for r in got:
                PQ.parse_query(r.expr)
    for args in ((0.5, 0.99, "1m"), (1, 0.999, "5m", "node"),
                 (0.25, 0.9, "30s", "service, revision")):
        assert PQ.burn_rate_expr(*args) == RQ.burn_rate_expr(*args)
    for text in ("30s", "1.5m", "2h", "10ms", "1d", "5", "m", "1 m", "-1s"):
        try:
            want = RQ.parse_duration(text)
        except RQ.QueryError:
            with pytest.raises(PQ.QueryError):
                PQ.parse_duration(text)
        else:
            assert PQ.parse_duration(text) == want


# -- the rule packs on virtual time -------------------------------------------------

PACKS = ("default_rule_pack", "node_burn_rules", "tenant_rule_pack",
         "canary_rule_pack")


def silenced(alertname, labels, at):
    """Mutes the tenant team-b's notifications, and every
    SchedulerPassSlow for one minute of the drill."""
    return labels.get("tenant") == "team-b" or (
        alertname == "SchedulerPassSlow" and 600 <= at < 660)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("pack", PACKS)
def test_rule_pack_drill(pack, seed):
    rng = np.random.default_rng(100 + seed)
    pl = Plane()
    clusters = PCluster(), RCluster()
    regs = PRegistry(), RRegistry()
    engines = Twin(
        PQ.RuleEngine(pl.stores[0], getattr(PQ, pack)(),
                      recorder=PEvents(clusters[0], component="obs"),
                      registry=regs[0], clock=pl.clock, lookback_s=60.0,
                      silenced=silenced),
        RQ.RuleEngine(pl.stores[1], getattr(RQ, pack)(),
                      recorder=REvents(clusters[1], component="obs"),
                      registry=regs[1], clock=pl.clock, lookback_s=60.0,
                      silenced=silenced))
    seen = []
    for c in range(26):
        pl.cycle(storm_ops(rng, ("chat",)) if 2 <= c < 12
                 else calm_ops(rng, ("chat",)))
        got, want = engines.call("evaluate_once")
        assert_close(got, want)
        seen += [t["to"] for t in got]
        assert_close(*engines.call("active_alerts"))
        assert regs[0].render() == regs[1].render()
    assert {"pending", "firing", "resolved"} <= set(seen), seen
    assert view(pl.stores[0]) == view(pl.stores[1])
    p_events = sorted(map(event_row, clusters[0].list("v1", "Event")),
                      key=repr)
    r_events = sorted(map(event_row, clusters[1].list("v1", "Event")),
                      key=repr)
    assert p_events == r_events and p_events
    q = "sum by (alertname, alertstate) (ALERTS)"
    assert_close(*engines.call("query", q))


def test_failing_rule_counts_and_recording_skips_nan():
    clock = Clock(100.0)
    stores = PS.TimeSeriesStore(), RS.TimeSeriesStore()
    for s in stores:
        for le, v in (("0.5", 0.0), ("+Inf", 0.0)):
            s.append("h_bucket", {"le": le}, v, 100.0)
    rules = lambda Q: [Q.RecordingRule("q", "histogram_quantile(0.5, h_bucket)"),  # noqa: E731
                       Q.RecordingRule("bad", "rate(up)"),
                       Q.AlertRule("A", "histogram_quantile(0.5, h_bucket) "
                                        "> -1")]
    regs = PRegistry(), RRegistry()
    got = PQ.RuleEngine(stores[0], rules(PQ), registry=regs[0],
                        clock=clock).evaluate_once()
    want = RQ.RuleEngine(stores[1], rules(RQ), registry=regs[1],
                         clock=clock).evaluate_once()
    assert got == want == []
    assert regs[0].render() == regs[1].render()
    assert "obs_rule_eval_failures_total 1" in regs[0].render()
    assert view(stores[0]) == view(stores[1])


# -- canary analysis ------------------------------------------------------------------


def canary_store(S, rng, fail_canary: float, slow_canary: float):
    store = S.TimeSeriesStore()
    counts = {}
    t = 0.0
    for _ in range(24):
        t += INTERVAL
        for rev, fail, slow in (("r1", 0.02, 0.0), ("r2", fail_canary,
                                                    slow_canary)):
            n = int(rng.integers(2, 6))
            for ten in ("team-a", "team-b"):
                for outcome in ("ok", "failed", "shed"):
                    k = (rev, ten, outcome)
                    share = {"failed": fail, "shed": 0.1}.get(outcome, 1.0)
                    counts[k] = counts.get(k, 0.0) + round(n * share)
                    store.append("router_requests_total", {
                        "service": "chat", "revision": rev, "tenant": ten,
                        "outcome": outcome}, counts[k], t)
            for le in ("0.1", "0.5", "1.0", "+Inf"):
                k = (rev, le)
                frac = {"0.1": 0.97 - slow, "0.5": 0.99 - slow,
                        "1.0": 1.0 - slow}.get(le, 1.0)
                counts[k] = counts.get(k, 0.0) + n * frac
                store.append("router_request_seconds_bucket", {
                    "service": "chat", "revision": rev, "le": le},
                    counts[k], t)
    return store, t


@pytest.mark.parametrize("fail,slow", [(0.0, 0.0), (0.4, 0.0), (0.0, 0.6),
                                       (0.3, 0.5)])
def test_canary_analysis_equal(fail, slow):
    stores = []
    for S in (PS, RS):
        store, t = canary_store(S, np.random.default_rng(5), fail, slow)
        stores.append(store)
    gates = (PQ.CanaryAnalysis(stores[0]), RQ.CanaryAnalysis(stores[1]))
    gates_tight = (PQ.CanaryAnalysis(stores[0], windows_s=(30.0,),
                                     min_requests=1.0),
                   RQ.CanaryAnalysis(stores[1], windows_s=(30.0,),
                                     min_requests=1.0))
    verdicts = []
    for pg, rg in (gates, gates_tight):
        for args in (("default", "chat", "r1", "r2", t),
                     ("default", "chat", "r1", "r2", t - 200.0),
                     ("default", "chat", "r1", "r1", t),
                     ("default", "chat", "", "r2", t),
                     ("default", "code", "r1", "r2", t),
                     ("default", "chat", "r1", "r2", 10_000.0)):
            got, want = pg(*args), rg(*args)
            assert got == want, args
            assert_close(pg.last, rg.last)
            verdicts.append(got)
    assert (False in verdicts) == (fail > 0.1 or slow > 0.1)
