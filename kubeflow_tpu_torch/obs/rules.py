"""PromQL-lite: query evaluation, recording rules, alerting.

A small, deterministic query language over ``obs/tsdb.py`` — enough of
PromQL to express the SLOs the serving and control planes already
measure, nothing more:

- instant selectors         ``router_queue_depth{service="chat"}``
- range selectors           ``router_request_seconds_count[5m]``
- ``rate()`` / ``increase()`` with counter-reset handling
- aggregation               ``sum by (service) (...)``, ``max/min/avg/count``
- ``histogram_quantile(0.95, rate(name_bucket[5m]))`` over the registry's
  native histograms (cumulative ``le`` buckets)
- arithmetic (``+ - * /``), comparisons as filters (``expr > 0.5``),
  ``and``/``or`` vector matching — the multi-window burn-rate shape
  ``short > T and long > T``.

Deviations from Prometheus, chosen for determinism and smallness:
``rate`` uses the observed sample span without boundary extrapolation;
a division whose denominator is 0 drops the sample (no ±Inf alerts);
vector-vector binary ops match on the intersection of SHARED label
names (ignoring ``instance``), which subsumes ``on()`` for the rule
shapes shipped here.

Recording rules materialize derived series back into the store under
PromQL's ``level:metric:operations`` naming convention, so dashboards
and alert expressions read them like any scraped series. Alerting
rules run a per-label-set ``inactive -> pending -> firing -> resolved``
state machine (``for:`` duration on the engine's injectable clock);
transitions emit dedup'd k8s Events through the ``EventRecorder``
and are returned structurally for the dashboard's ``GET /api/alerts``.

``default_rule_pack()`` ships the fleet's always-on rules: router p95
latency SLO burn (multi-window), reconcile error rate, scheduler pass
duration, KV-page exhaustion, checkpoint failures.

Port of `kubeflow_tpu/obs/rules.py`, whole: the same grammar, evaluation
(and its deviations from Prometheus), rules, state machine, rule packs
and canary gate over the port's store and event recorder, so the two
packages parse the same strings and answer the same vectors.
"""

from __future__ import annotations

import logging
import math
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

from kubeflow_tpu_torch.obs.tsdb import TimeSeriesStore

log = logging.getLogger("kubeflow_tpu_torch.obs.rules")

# Instant-selector lookback: how far back "the current value" may be.
DEFAULT_LOOKBACK_S = 300.0

_DURATION_RE = re.compile(r"^(\d+(?:\.\d+)?)(ms|s|m|h|d)$")
_DURATION_UNITS = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0,
                   "d": 86400.0}


def parse_duration(text: str) -> float:
    m = _DURATION_RE.match(text)
    if not m:
        raise QueryError(f"bad duration {text!r}")
    return float(m.group(1)) * _DURATION_UNITS[m.group(2)]


class QueryError(ValueError):
    """Malformed or unsupported query text."""


# -- lexer -------------------------------------------------------------------

# numbers accept an exponent: interpolated thresholds (a five-nines
# SLO budget reprs as 1.00000000003e-05) must stay parseable
_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<num>(?:\d+\.\d+|\d+|\.\d+)(?:[eE][+-]?\d+)?)
  | (?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)
  | (?P<str>"(?:[^"\\]|\\.)*")
  | (?P<op>==|!=|>=|<=|[><+\-*/(),{}=\[\]])
""", re.VERBOSE)

_KEYWORDS = {"and", "or", "by", "rate", "increase", "sum", "avg", "max",
             "min", "count", "histogram_quantile", "abs", "clamp_min",
             "clamp_max"}
_AGGRS = {"sum", "avg", "max", "min", "count"}
_FUNCS = {"rate", "increase", "histogram_quantile", "abs", "clamp_min",
          "clamp_max"}


def _tokenize(text: str) -> list[tuple[str, str]]:
    out: list[tuple[str, str]] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise QueryError(f"bad token at {text[pos:pos + 12]!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        out.append((m.lastgroup, m.group()))
    out.append(("eof", ""))
    return out


# -- AST ---------------------------------------------------------------------

# An instant vector is a list of (labels: dict, value: float); a range
# vector is a list of (labels, [(t, v), ...]).
Vector = list


@dataclass
class Num:
    value: float


@dataclass
class Selector:
    name: str
    matchers: dict[str, str]
    range_s: float | None = None  # set -> range selector


@dataclass
class Call:
    func: str
    args: list


@dataclass
class Aggr:
    op: str
    by: tuple[str, ...] | None
    arg: object


@dataclass
class BinOp:
    op: str
    left: object
    right: object


class _Parser:
    def __init__(self, text: str):
        self.toks = _tokenize(text)
        self.i = 0

    def peek(self) -> tuple[str, str]:
        return self.toks[min(self.i, len(self.toks) - 1)]

    def next(self) -> tuple[str, str]:
        t = self.peek()
        self.i = min(self.i + 1, len(self.toks))
        return t

    def expect(self, value: str) -> None:
        kind, tok = self.next()
        if tok != value:
            raise QueryError(f"expected {value!r}, got {tok!r}")

    def parse(self):
        node = self.parse_or()
        if self.peek()[0] != "eof":
            raise QueryError(f"trailing input at {self.peek()[1]!r}")
        return node

    def parse_or(self):
        node = self.parse_and()
        while self.peek() == ("name", "or"):
            self.next()
            node = BinOp("or", node, self.parse_and())
        return node

    def parse_and(self):
        node = self.parse_cmp()
        while self.peek() == ("name", "and"):
            self.next()
            node = BinOp("and", node, self.parse_cmp())
        return node

    def parse_cmp(self):
        node = self.parse_add()
        if self.peek()[1] in (">", "<", ">=", "<=", "==", "!="):
            op = self.next()[1]
            node = BinOp(op, node, self.parse_add())
        return node

    def parse_add(self):
        node = self.parse_mul()
        while self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            node = BinOp(op, node, self.parse_mul())
        return node

    def parse_mul(self):
        node = self.parse_unary()
        while self.peek()[1] in ("*", "/"):
            op = self.next()[1]
            node = BinOp(op, node, self.parse_unary())
        return node

    def parse_unary(self):
        kind, tok = self.peek()
        if tok == "(":
            self.next()
            node = self.parse_or()
            self.expect(")")
            return node
        if tok == "-":
            self.next()
            inner = self.parse_unary()
            return BinOp("*", Num(-1.0), inner)
        if kind == "num":
            self.next()
            return Num(float(tok))
        if kind == "name":
            if tok in _AGGRS:
                return self.parse_aggr()
            if tok in _FUNCS:
                return self.parse_func()
            return self.parse_selector()
        raise QueryError(f"unexpected {tok!r}")

    def parse_aggr(self):
        op = self.next()[1]
        by: tuple[str, ...] | None = None
        if self.peek() == ("name", "by"):
            self.next()
            self.expect("(")
            names = []
            while self.peek()[0] == "name":
                names.append(self.next()[1])
                if self.peek()[1] == ",":
                    self.next()
            self.expect(")")
            by = tuple(names)
        self.expect("(")
        arg = self.parse_or()
        self.expect(")")
        return Aggr(op, by, arg)

    def parse_func(self):
        func = self.next()[1]
        self.expect("(")
        args = [self.parse_or()]
        while self.peek()[1] == ",":
            self.next()
            args.append(self.parse_or())
        self.expect(")")
        return Call(func, args)

    def parse_selector(self):
        name = self.next()[1]
        if name in _KEYWORDS:
            raise QueryError(f"{name!r} is a keyword, not a metric")
        matchers: dict[str, str] = {}
        if self.peek()[1] == "{":
            self.next()
            while self.peek()[0] == "name":
                key = self.next()[1]
                self.expect("=")
                kind, raw = self.next()
                if kind != "str":
                    raise QueryError(f"label value must be quoted: {raw!r}")
                matchers[key] = raw[1:-1].replace('\\"', '"') \
                    .replace("\\\\", "\\")
                if self.peek()[1] == ",":
                    self.next()
            self.expect("}")
        range_s = None
        if self.peek()[1] == "[":
            self.next()
            num = self.next()[1]
            unit = self.next()[1] if self.peek()[0] == "name" else ""
            range_s = parse_duration(num + unit)
            self.expect("]")
        return Selector(name, matchers, range_s)


def parse_query(text: str):
    """Query text -> AST (raises QueryError)."""
    return _Parser(text).parse()


# -- evaluation --------------------------------------------------------------


def _labels_key(labels: dict, drop: tuple[str, ...] = ()) -> tuple:
    return tuple(sorted((k, v) for k, v in labels.items()
                        if k not in drop))


def _counter_increase(points: list[tuple[float, float]]) -> float:
    """Total increase over the window, counter resets handled the
    Prometheus way: a sample LOWER than its predecessor is a reset, and
    the post-reset value counts from zero."""
    if len(points) < 2:
        return 0.0
    total = 0.0
    prev = points[0][1]
    for _, v in points[1:]:
        total += v if v < prev else v - prev
        prev = v
    return total


class Evaluator:
    """Evaluates parsed queries against a TimeSeriesStore at a fixed
    instant ``at`` — pure reads, no state: the engine below owns
    rule state and clocks."""

    def __init__(self, store: TimeSeriesStore,
                 lookback_s: float = DEFAULT_LOOKBACK_S):
        self.store = store
        self.lookback_s = lookback_s

    def evaluate(self, node, at: float) -> Vector:
        """-> instant vector ``[(labels, value), ...]``; deterministic
        order (sorted by labels)."""
        out = self._eval(node, at)
        if isinstance(out, Num):
            return [({}, out.value)]
        return sorted(out, key=lambda s: _labels_key(s[0]))

    def query(self, text: str, at: float) -> Vector:
        return self.evaluate(parse_query(text), at)

    # -- internals -----------------------------------------------------------

    def _eval(self, node, at: float):
        if isinstance(node, Num):
            return node
        if isinstance(node, Selector):
            if node.range_s is not None:
                raise QueryError(
                    f"range selector {node.name}[...] needs rate()/"
                    "increase()/histogram_quantile(rate())")
            return self.store.instant(node.name, node.matchers, at,
                                      self.lookback_s)
        if isinstance(node, Call):
            return self._eval_call(node, at)
        if isinstance(node, Aggr):
            return self._eval_aggr(node, at)
        if isinstance(node, BinOp):
            return self._eval_binop(node, at)
        raise QueryError(f"cannot evaluate {node!r}")

    def _range_arg(self, node, at: float, func: str):
        if not isinstance(node, Selector) or node.range_s is None:
            raise QueryError(f"{func}() needs a range selector argument")
        return self.store.window(node.name, node.matchers,
                                 at - node.range_s, at), node.range_s

    def _eval_call(self, node: Call, at: float):
        func = node.func
        if func in ("rate", "increase"):
            if len(node.args) != 1:
                raise QueryError(f"{func}() takes exactly one argument")
            windows, range_s = self._range_arg(node.args[0], at, func)
            out = []
            for labels, points in windows:
                inc = _counter_increase(points)
                if func == "rate":
                    span = points[-1][0] - points[0][0]
                    out.append((labels, inc / span if span > 0 else 0.0))
                else:
                    out.append((labels, inc))
            return out
        if func == "histogram_quantile":
            if len(node.args) != 2:
                raise QueryError(
                    "histogram_quantile(q, vector) takes two arguments")
            q_node = node.args[0]
            if not isinstance(q_node, Num):
                raise QueryError("histogram_quantile q must be a literal")
            vec = self._eval(node.args[1], at)
            if isinstance(vec, Num):
                raise QueryError("histogram_quantile needs a vector")
            return _histogram_quantile(q_node.value, vec)
        if func == "abs":
            return self._map1(node, at, abs)
        if func == "clamp_min":
            lo = self._scalar_arg(node, 1)
            return self._map1(node, at, lambda v: max(v, lo))
        if func == "clamp_max":
            hi = self._scalar_arg(node, 1)
            return self._map1(node, at, lambda v: min(v, hi))
        raise QueryError(f"unknown function {func!r}")

    def _scalar_arg(self, node: Call, idx: int) -> float:
        if len(node.args) <= idx or not isinstance(node.args[idx], Num):
            raise QueryError(f"{node.func}() argument {idx + 1} must be "
                             "a number literal")
        return node.args[idx].value

    def _map1(self, node: Call, at: float, fn) -> Vector:
        vec = self._eval(node.args[0], at)
        if isinstance(vec, Num):
            return Num(fn(vec.value))
        return [(labels, fn(v)) for labels, v in vec]

    def _eval_aggr(self, node: Aggr, at: float):
        vec = self._eval(node.arg, at)
        if isinstance(vec, Num):
            raise QueryError(f"{node.op}() needs a vector")
        groups: dict[tuple, list[float]] = {}
        labelsets: dict[tuple, dict] = {}
        for labels, v in vec:
            if node.by is None:
                key, kept = (), {}
            else:
                kept = {k: labels[k] for k in node.by if k in labels}
                key = _labels_key(kept)
            groups.setdefault(key, []).append(v)
            labelsets[key] = kept
        out = []
        for key, values in groups.items():
            if node.op == "sum":
                v = sum(values)
            elif node.op == "avg":
                v = sum(values) / len(values)
            elif node.op == "max":
                v = max(values)
            elif node.op == "min":
                v = min(values)
            else:
                v = float(len(values))
            out.append((labelsets[key], v))
        return out

    def _eval_binop(self, node: BinOp, at: float):
        left = self._eval(node.left, at)
        right = self._eval(node.right, at)
        op = node.op
        if op in ("and", "or"):
            return self._set_op(op, left, right)
        if isinstance(left, Num) and isinstance(right, Num):
            v = _arith(op, left.value, right.value, None)
            if v is None:
                raise QueryError(f"scalar-only {op} expression is not "
                                 "supported (needs a vector operand)")
            return Num(v)
        if isinstance(left, Num):
            # scalar OP vector: comparison keeps the VECTOR sample
            out = []
            for labels, v in right:
                r = _arith(op, left.value, v, v)
                if r is not None:
                    out.append((labels, r))
            return out
        if isinstance(right, Num):
            out = []
            for labels, v in left:
                r = _arith(op, v, right.value, v)
                if r is not None:
                    out.append((labels, r))
            return out
        # vector OP vector: match on shared label names (instance
        # excluded — a recorded series and a scraped series must still
        # pair up)
        return self._vector_op(op, left, right)

    @staticmethod
    def _set_op(op: str, left, right) -> Vector:
        if isinstance(left, Num) or isinstance(right, Num):
            raise QueryError(f"{op} needs vectors on both sides")
        right_keys = {_labels_key(labels, ("instance",))
                      for labels, _ in right}
        if op == "and":
            return [(labels, v) for labels, v in left
                    if _labels_key(labels, ("instance",)) in right_keys]
        out = list(left)
        left_keys = {_labels_key(labels, ("instance",))
                     for labels, _ in left}
        out.extend((labels, v) for labels, v in right
                   if _labels_key(labels, ("instance",)) not in left_keys)
        return out

    @staticmethod
    def _vector_op(op: str, left: Vector, right: Vector) -> Vector:
        shared: set[str] | None = None
        names_l = set()
        for labels, _ in left:
            names_l |= set(labels)
        names_r = set()
        for labels, _ in right:
            names_r |= set(labels)
        shared = (names_l & names_r) - {"instance"}
        index: dict[tuple, float] = {}
        for labels, v in right:
            key = tuple(sorted((k, labels[k]) for k in shared
                               if k in labels))
            index[key] = v
        out = []
        for labels, v in left:
            key = tuple(sorted((k, labels[k]) for k in shared
                               if k in labels))
            if key not in index:
                continue
            r = _arith(op, v, index[key], v)
            if r is not None:
                out.append((labels, r))
        return out


def _arith(op: str, a: float, b: float, keep) -> float | None:
    """Arithmetic returns the result; comparisons implement PromQL
    filter semantics — the VECTOR sample (passed as ``keep``) survives
    when true, else None (dropped; also the division-by-zero path).
    ``keep is None`` marks a scalar-only context where comparisons are
    unsupported."""
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        return a / b if b != 0 else None
    ok = {">": a > b, "<": a < b, ">=": a >= b, "<=": a <= b,
          "==": a == b, "!=": a != b}[op]
    return keep if ok else None


def _histogram_quantile(q: float, bucket_vec: Vector) -> Vector:
    """Prometheus histogram_quantile over cumulative ``le`` buckets.

    Groups samples by labels-minus-``le``, sorts buckets, finds the
    target rank and linearly interpolates within the bucket. Matches
    the Prometheus edge cases the tests pin:

    - rank landing EXACTLY on a bucket's cumulative count -> that
      bucket's upper bound (no interpolation past it);
    - empty histogram (total count 0) -> NaN (callers/alerts drop it);
    - quantile in the +Inf bucket -> the highest finite bound.
    """
    groups: dict[tuple, list[tuple[float, float]]] = {}
    labelsets: dict[tuple, dict] = {}
    for labels, v in bucket_vec:
        le = labels.get("le")
        if le is None:
            continue
        try:
            bound = float(le)
        except ValueError:
            continue
        rest = {k: val for k, val in labels.items() if k != "le"}
        key = _labels_key(rest)
        groups.setdefault(key, []).append((bound, v))
        labelsets[key] = rest
    out = []
    for key, buckets in groups.items():
        buckets.sort()
        total = buckets[-1][1] if buckets else 0.0
        if total <= 0 or not buckets:
            out.append((labelsets[key], float("nan")))
            continue
        q_ = min(max(q, 0.0), 1.0)
        rank = q_ * total
        value = None
        prev_bound, prev_count = 0.0, 0.0
        for bound, count in buckets:
            if count >= rank:
                if math.isinf(bound):
                    # the quantile lives in +Inf: report the highest
                    # finite bound (Prometheus behavior)
                    finite = [b for b, _ in buckets if not math.isinf(b)]
                    value = finite[-1] if finite else float("nan")
                    break
                if count == prev_count:
                    value = bound
                    break
                frac = (rank - prev_count) / (count - prev_count)
                value = prev_bound + (bound - prev_bound) * frac
                break
            prev_bound, prev_count = bound, count
        if value is None:
            finite = [b for b, _ in buckets if not math.isinf(b)]
            value = finite[-1] if finite else float("nan")
        out.append((labelsets[key], value))
    return out


# -- rules -------------------------------------------------------------------


@dataclass
class RecordingRule:
    """``record: name  expr: ...`` — evaluated every engine pass, the
    result appended into the store under ``name`` (with the result's
    labels plus ``labels``). Derived series are then selectable like
    any scraped one (the ``level:metric:op`` naming convention)."""

    name: str
    expr: str
    labels: dict = field(default_factory=dict)


# Alert state machine states.
INACTIVE = "inactive"
PENDING = "pending"
FIRING = "firing"


@dataclass
class AlertRule:
    """``alert: name  expr: ...  for: duration`` — the expression's
    result vector is the active set; each label set runs its own
    pending -> firing -> resolved machine."""

    name: str
    expr: str
    for_s: float = 0.0
    severity: str = "warning"
    summary: str = ""
    labels: dict = field(default_factory=dict)


@dataclass
class AlertState:
    labels: dict
    state: str = PENDING
    active_since: float = 0.0
    firing_since: float | None = None
    value: float = 0.0


class RuleEngine:
    """Evaluates recording rules then alert rules against the store on
    each ``evaluate_once(at=...)`` pass (injectable clock for drills
    and the bench; ``ScrapeLoop``-style thread shells belong to the
    caller).

    Alert transitions:

    - emit dedup'd k8s Events through an ``EventRecorder`` when one is
      wired (``AlertFiring`` Warning / ``AlertResolved`` Normal against
      a synthetic ``obs.kubeflow.org/v1 AlertRule`` object, namespaced
      by the alert's ``namespace`` label when present);
    - append an ``ALERTS{alertname=,alertstate=}`` series into the
      store (the Prometheus convention) so alert history is queryable;
    - publish ``obs_alerts{alertname=,state=}`` gauges and an
      ``obs_alert_transitions_total{alertname=,to=}`` counter into the
      plane's MetricsRegistry.

    Returns each pass's transition list — the deterministic decision
    log the obs bench fingerprints.
    """

    def __init__(self, store: TimeSeriesStore,
                 rules: list | None = None,
                 recorder=None, registry=None,
                 clock: Callable[[], float] = time.time,
                 lookback_s: float = DEFAULT_LOOKBACK_S,
                 silenced: Callable[[str, dict, float], bool] | None = None):
        self.store = store
        self.rules: list = list(rules or [])
        self.recorder = recorder
        self.registry = registry
        self.clock = clock
        # silenced(alertname, labels, now) -> bool. Alertmanager
        # semantics: a silence mutes NOTIFICATION (the k8s Events),
        # never the state machine — the alert still walks
        # pending/firing/resolved, still publishes gauges, still
        # appears in transitions, so un-silencing reveals true state.
        self.silenced = silenced
        self.evaluator = Evaluator(store, lookback_s=lookback_s)
        # (alert name, labels key) -> AlertState. One lock serializes
        # evaluation passes against dashboard reads: the FleetPlane
        # tick thread mutates _active while ThreadingHTTPServer
        # handlers iterate it in active_alerts() — unlocked, that's a
        # dict-changed-during-iteration 500 on the alert surface at the
        # exact moment an operator is watching a transition.
        self._lock = threading.Lock()
        self._active: dict[tuple[str, tuple], AlertState] = {}
        self._evals = 0
        self._failures = 0

    # -- evaluation pass -----------------------------------------------------

    def evaluate_once(self, at: float | None = None) -> list[dict]:
        """One pass at ``at`` (default: the engine clock). Returns the
        alert transitions performed, in deterministic order."""
        now = self.clock() if at is None else at
        transitions: list[dict] = []
        with self._lock:
            for rule in self.rules:
                try:
                    if isinstance(rule, RecordingRule):
                        self._record(rule, now)
                    else:
                        transitions.extend(self._alert(rule, now))
                except QueryError as e:
                    self._failures += 1
                    log.warning("rule %s failed: %s", rule.name, e)
            self._evals += 1
            self._publish()
        return transitions

    def _record(self, rule: RecordingRule, now: float) -> None:
        for labels, value in self.evaluator.query(rule.expr, now):
            if math.isnan(value):
                continue
            self.store.append(rule.name, {**labels, **rule.labels},
                              value, now)

    def _alert(self, rule: AlertRule, now: float) -> list[dict]:
        result = self.evaluator.query(rule.expr, now)
        active = {}
        for labels, value in result:
            if math.isnan(value):
                continue  # an empty histogram must not fire an alert
            merged = {**labels, **rule.labels}
            active[_labels_key(merged)] = (merged, value)
        transitions: list[dict] = []
        # appearing / persisting label sets
        for key, (labels, value) in sorted(active.items()):
            st = self._active.get((rule.name, key))
            if st is None:
                st = AlertState(labels=labels, state=PENDING,
                                active_since=now, value=value)
                self._active[(rule.name, key)] = st
                transitions.append(self._transition(
                    rule, st, PENDING, now))
            st.value = value
            if st.state == PENDING and now - st.active_since >= rule.for_s:
                st.state = FIRING
                st.firing_since = now
                transitions.append(self._transition(rule, st, FIRING, now))
        # disappeared label sets resolve
        for (name, key) in sorted(k for k in self._active
                                  if k[0] == rule.name):
            if key in active:
                continue
            st = self._active.pop((name, key))
            if st.state == FIRING:
                transitions.append(self._transition(
                    rule, st, "resolved", now))
            # a pending alert that clears never fired: no event, no
            # transition — pending is the for-duration damping working
        for key, (labels, value) in active.items():
            st = self._active[(rule.name, key)]
            self.store.append(
                "ALERTS", {"alertname": rule.name, "alertstate": st.state,
                           **labels}, 1.0, now)
        return transitions

    def _transition(self, rule: AlertRule, st: AlertState, to: str,
                    now: float) -> dict:
        muted = False
        if self.silenced is not None:
            try:
                muted = bool(self.silenced(rule.name, st.labels, now))
            except Exception:
                log.exception("silence check failed")
        if self.recorder is not None and not muted \
                and to in (FIRING, "resolved"):
            involved = {
                "apiVersion": "obs.kubeflow.org/v1",
                "kind": "AlertRule",
                "metadata": {
                    "name": rule.name.lower(),
                    "namespace": st.labels.get("namespace", "default"),
                },
            }
            label_str = ",".join(f"{k}={v}"
                                 for k, v in sorted(st.labels.items()))
            try:
                if to == FIRING:
                    self.recorder.event(
                        involved, "AlertFiring",
                        f"{rule.name} firing ({label_str}): "
                        f"{rule.summary or rule.expr}", etype="Warning")
                else:
                    self.recorder.event(
                        involved, "AlertResolved",
                        f"{rule.name} resolved ({label_str})")
            except Exception:  # telemetry must never break the pass
                log.exception("alert event emit failed")
        if self.registry is not None:
            self.registry.counter_inc(
                "obs_alert_transitions_total",
                help_="alert state transitions by target state",
                alertname=rule.name, to=to)
        return {"alert": rule.name, "to": to,
                "labels": dict(sorted(st.labels.items())),
                "value": round(st.value, 9), "at": now}

    def _publish(self) -> None:
        if self.registry is None:
            return
        counts: dict[tuple[str, str], int] = {}
        for (name, _key), st in self._active.items():
            counts[(name, st.state)] = counts.get((name, st.state), 0) + 1
        seen_names = {name for name, _ in counts}
        for rule in self.rules:
            if isinstance(rule, AlertRule):
                seen_names.add(rule.name)
        for name in sorted(seen_names):
            for state in (PENDING, FIRING):
                self.registry.gauge(
                    "obs_alerts", counts.get((name, state), 0),
                    help_="active alerts by rule and state",
                    alertname=name, state=state)
        self.registry.gauge("obs_rule_evals_total", self._evals,
                            help_="rule-engine evaluation passes")
        self.registry.gauge("obs_rule_eval_failures_total", self._failures,
                            help_="rules that failed to evaluate")

    # -- introspection (dashboard /api/alerts) -------------------------------

    def active_alerts(self) -> list[dict]:
        # snapshot field values UNDER the lock: a tick thread mutating
        # an AlertState mid-read must not produce a torn (state, value)
        with self._lock:
            return [{
                "alert": name, "state": st.state,
                "labels": dict(sorted(st.labels.items())),
                "active_since": st.active_since,
                "firing_since": st.firing_since,
                "value": st.value,
            } for (name, _key), st in sorted(self._active.items())]

    def query(self, text: str, at: float | None = None) -> Vector:
        return self.evaluator.query(
            text, self.clock() if at is None else at)


# -- the default rule pack ---------------------------------------------------


def burn_rate_expr(latency_target_s: float, objective: float,
                   window: str, by: str = "service") -> str:
    """Error-budget burn rate for the router latency SLO over one
    window: (fraction of requests slower than the target) divided by
    the budget (1 - objective). 1.0 = burning exactly the budget;
    >1 = burning faster. The bucket bound must exist in
    ``REQUEST_BUCKETS`` — use a bound, not an arbitrary number.
    ``by`` picks the blast-radius dimension: ``service`` (the SLO as
    the user sees it) or ``node`` (scoping a burn to the machine whose
    replicas are producing it, the cordon-and-drain trigger)."""
    budget = max(1.0 - objective, 1e-9)
    # normalized through float(): the registry renders le bounds as
    # str(float) ("0.5", "1.0"), so an int-valued target must still
    # match the bucket series
    le = str(float(latency_target_s))
    return (
        f"(1 - sum by ({by}) "
        f"(rate(router_request_seconds_bucket{{le=\"{le}\"}}"
        f"[{window}])) / sum by ({by}) "
        f"(rate(router_request_seconds_count[{window}]))) / {budget}"
    )


def node_burn_rules(latency_target_s: float = 0.5,
                    objective: float = 0.99,
                    short_window: str = "1m",
                    long_window: str = "5m",
                    burn_threshold: float = 1.0) -> list:
    """Node-scoped burn: the same multi-window SLO-burn shape as the
    router rules, grouped by the ``node`` label replicas stamp on
    their request histograms. A single machine burning the budget
    while the service-wide burn stays green is the cordon-and-drain
    signal — the remediation engine's node action requires the
    ``node`` label this grouping provides."""
    short_burn = burn_rate_expr(latency_target_s, objective,
                                short_window, by="node")
    long_burn = burn_rate_expr(latency_target_s, objective,
                               long_window, by="node")
    return [
        RecordingRule("slo:node_burn:short", short_burn),
        RecordingRule("slo:node_burn:long", long_burn),
        AlertRule(
            "NodeSLOBurn",
            f"slo:node_burn:short > {burn_threshold} "
            f"and slo:node_burn:long > {burn_threshold}",
            for_s=30.0, severity="critical",
            summary=f"a node's replicas are burning the latency error "
                    f"budget >{burn_threshold}x (target "
                    f"{latency_target_s}s @ {objective:.2%})"),
    ]


def tenant_rule_pack(latency_target_s: float = 0.5,
                     objective: float = 0.99,
                     short_window: str = "1m",
                     long_window: str = "5m",
                     burn_threshold: float = 1.0,
                     storm_tokens_per_s: float = 0.5) -> list:
    """Tenant-scoped rules over the tenant label the router stamps:
    the same multi-window SLO-burn shape as the service rules grouped
    ``by (tenant)`` (which tenant's traffic is burning the budget),
    a retry-storm alert over the tenant's retry/hedge budget spend
    (the noisy-neighbor signal PR-20-era fair-share will bound), and a
    first-error tripwire. All three depend on the router pre-
    registering a fresh tenant's counters at 0 — ``rate()`` over a
    series born non-zero reports nothing."""
    short_burn = burn_rate_expr(latency_target_s, objective,
                                short_window, by="tenant")
    long_burn = burn_rate_expr(latency_target_s, objective,
                               long_window, by="tenant")
    return [
        RecordingRule("slo:tenant_burn:short", short_burn),
        RecordingRule("slo:tenant_burn:long", long_burn),
        AlertRule(
            "TenantSLOBurn",
            f"slo:tenant_burn:short > {burn_threshold} "
            f"and slo:tenant_burn:long > {burn_threshold}",
            for_s=30.0, severity="warning",
            summary=f"one tenant's traffic is burning the latency "
                    f"error budget >{burn_threshold}x (target "
                    f"{latency_target_s}s @ {objective:.2%})"),
        AlertRule(
            "TenantRetryStorm",
            "sum by (tenant) "
            f"(rate(router_tenant_retry_tokens_total[{short_window}])) "
            f"> {storm_tokens_per_s}",
            for_s=30.0, severity="warning",
            summary=f"a tenant is spending retry/hedge budget faster "
                    f"than {storm_tokens_per_s}/s (retry storm)"),
        AlertRule(
            "TenantRequestFailures",
            "sum by (tenant) (increase("
            "router_requests_total{outcome=\"failed\"}"
            f"[{long_window}])) > 0",
            for_s=0.0, severity="warning",
            summary="a tenant's requests are failing"),
    ]


# -- canary analysis ---------------------------------------------------------


# Outcomes that count against a revision in canary analysis. ``shed``/
# ``shed_band``/``rejected`` are load-control verdicts the ROUTER made
# — blaming the canary for them would abort every rollout that happens
# during a traffic spike.
CANARY_ERROR_OUTCOMES = ("failed", "deadline")


class CanaryAnalysis:
    """The SLO gate a rollout must pass: canary error-rate and
    latency-quantile vs the baseline revision, read straight from the
    TimeSeriesStore over the ``revision`` label the router stamps.

    Matches the controller's ``rollout_analysis`` hook shape —
    ``__call__(namespace, service, baseline_rev, canary_rev, now) ->
    bool`` (healthy) — and is deterministic: pure store reads at the
    caller's clock, no internal state beyond the last verdict kept for
    audit.

    Multi-window by construction (the burn-rate lesson): the canary is
    UNHEALTHY only when **every** window agrees — the short window
    proves it's happening now, the long window proves it's not a blip.
    Low volume is inconclusive, and inconclusive is HEALTHY: a rollout
    must not abort because nobody sent traffic during the window (the
    time ladder, not the gate, paces such rollouts).

    Verdict per window::

        error_bad   = canary_err_rate > baseline_err_rate * max_error_ratio
                      and canary_err_rate > min_error_rate
        latency_bad = canary_q > baseline_q * max_latency_ratio
        window_bad  = error_bad or latency_bad

    The absolute ``min_error_rate`` floor keeps a zero-error baseline
    from making any single canary failure fatal (ratio against zero is
    degenerate)."""

    def __init__(self, store: TimeSeriesStore,
                 windows_s: tuple[float, ...] = (30.0, 120.0),
                 latency_quantile: float = 0.95,
                 max_error_ratio: float = 2.0,
                 min_error_rate: float = 0.05,
                 max_latency_ratio: float = 2.0,
                 min_requests: float = 5.0):
        self.store = store
        self.windows_s = tuple(float(w) for w in windows_s)
        self.latency_quantile = float(latency_quantile)
        self.max_error_ratio = float(max_error_ratio)
        self.min_error_rate = float(min_error_rate)
        self.max_latency_ratio = float(max_latency_ratio)
        self.min_requests = float(min_requests)
        # the last verdict's per-window numbers, for events/benches
        self.last: dict = {}

    def __call__(self, namespace: str, service: str, baseline: str,
                 canary: str, now: float) -> bool:
        if not baseline or not canary or baseline == canary:
            return True
        verdicts = []
        detail = []
        for window_s in self.windows_s:
            v = self._window_verdict(service, baseline, canary,
                                     now - window_s, now)
            verdicts.append(v["bad"])
            detail.append({"window_s": window_s, **v})
        self.last = {"service": service, "baseline": baseline,
                     "canary": canary, "at": now, "windows": detail}
        # unhealthy only when EVERY window is bad AND conclusive
        return not (verdicts and all(verdicts))

    # -- internals -----------------------------------------------------------

    def _window_verdict(self, service: str, baseline: str, canary: str,
                        start: float, end: float) -> dict:
        b_total, b_err = self._outcomes(service, baseline, start, end)
        c_total, c_err = self._outcomes(service, canary, start, end)
        if c_total < self.min_requests or b_total < self.min_requests:
            return {"bad": False, "inconclusive": True,
                    "baseline_requests": b_total,
                    "canary_requests": c_total}
        b_rate = b_err / b_total
        c_rate = c_err / c_total
        error_bad = (c_rate > b_rate * self.max_error_ratio
                     and c_rate > self.min_error_rate)
        b_q = self._quantile(service, baseline, start, end)
        c_q = self._quantile(service, canary, start, end)
        latency_bad = (b_q is not None and c_q is not None and b_q > 0
                       and c_q > b_q * self.max_latency_ratio)
        return {"bad": error_bad or latency_bad, "inconclusive": False,
                "error_bad": error_bad, "latency_bad": latency_bad,
                "baseline_error_rate": round(b_rate, 9),
                "canary_error_rate": round(c_rate, 9),
                "baseline_q": b_q, "canary_q": c_q,
                "baseline_requests": b_total,
                "canary_requests": c_total}

    def _outcomes(self, service: str, revision: str, start: float,
                  end: float) -> tuple[float, float]:
        """-> (total request increase, error increase) for one revision
        over the window, summed across tenants."""
        total = err = 0.0
        for labels, points in self.store.window(
                "router_requests_total",
                {"service": service, "revision": revision}, start, end):
            inc = _counter_increase(points)
            total += inc
            if labels.get("outcome") in CANARY_ERROR_OUTCOMES:
                err += inc
        return total, err

    def _quantile(self, service: str, revision: str, start: float,
                  end: float) -> float | None:
        """Latency quantile from the revision's bucket increases over
        the window; None when the histogram saw nothing."""
        by_le: dict[str, float] = {}
        for labels, points in self.store.window(
                "router_request_seconds_bucket",
                {"service": service, "revision": revision}, start, end):
            le = labels.get("le")
            if le is None:
                continue
            by_le[le] = by_le.get(le, 0.0) + _counter_increase(points)
        if not by_le or sum(by_le.values()) <= 0:
            return None
        vec = [({"le": le}, v) for le, v in sorted(by_le.items())]
        out = _histogram_quantile(self.latency_quantile, vec)
        if not out or math.isnan(out[0][1]):
            return None
        return out[0][1]


def canary_rule_pack(latency_target_s: float = 0.5,
                     objective: float = 0.99,
                     short_window: str = "1m",
                     long_window: str = "5m",
                     error_rate_threshold: float = 0.05,
                     burn_threshold: float = 1.0) -> list:
    """Dashboard/alert companions to the programmatic ``CanaryAnalysis``
    gate: the same signals grouped ``by (service, revision)`` so an
    operator watching a rollout sees canary-vs-baseline burn as named
    series. The controller's abort decision comes from the gate, not
    these alerts — they are the audit surface."""
    short_burn = burn_rate_expr(latency_target_s, objective,
                                short_window, by="service, revision")
    long_burn = burn_rate_expr(latency_target_s, objective,
                               long_window, by="service, revision")
    return [
        RecordingRule("slo:revision_burn:short", short_burn),
        RecordingRule("slo:revision_burn:long", long_burn),
        AlertRule(
            "RevisionSLOBurn",
            f"slo:revision_burn:short > {burn_threshold} "
            f"and slo:revision_burn:long > {burn_threshold}",
            for_s=30.0, severity="warning",
            summary=f"one revision's traffic is burning the latency "
                    f"error budget >{burn_threshold}x (target "
                    f"{latency_target_s}s @ {objective:.2%}) — "
                    "canary-vs-baseline burn dimension"),
        AlertRule(
            "RevisionErrorRate",
            "sum by (service, revision) (rate("
            "router_requests_total{outcome=\"failed\"}"
            f"[{short_window}])) / sum by (service, revision) "
            f"(rate(router_requests_total[{short_window}])) "
            f"> {error_rate_threshold}",
            for_s=30.0, severity="warning",
            summary=f"a revision is failing more than "
                    f"{error_rate_threshold:.0%} of its requests"),
    ]


def default_rule_pack(latency_target_s: float = 0.5,
                      objective: float = 0.99,
                      short_window: str = "1m",
                      long_window: str = "5m",
                      burn_threshold: float = 1.0) -> list:
    """The fleet's always-on rules. Each maps to a series the platform
    already exports (docs/observability.md catalog); thresholds are
    conservative defaults an operator overrides per deployment."""
    short_burn = burn_rate_expr(latency_target_s, objective, short_window)
    long_burn = burn_rate_expr(latency_target_s, objective, long_window)
    return [
        # Derived series first: recording rules materialize the burn
        # rates so the alert (and the dashboard) read one name.
        RecordingRule("slo:router_burn:short", short_burn),
        RecordingRule("slo:router_burn:long", long_burn),
        RecordingRule(
            "slo:router_p95:short",
            "histogram_quantile(0.95, sum by (service, le) "
            f"(rate(router_request_seconds_bucket[{short_window}])))"),
        AlertRule(
            "RouterLatencySLOBurn",
            # multi-window: the short window proves it's happening NOW,
            # the long window proves it's not a blip
            f"slo:router_burn:short > {burn_threshold} "
            f"and slo:router_burn:long > {burn_threshold}",
            for_s=30.0, severity="critical",
            summary=f"router p95 latency error budget burning >"
                    f"{burn_threshold}x (target {latency_target_s}s "
                    f"@ {objective:.2%})"),
        AlertRule(
            "ReconcileErrorRate",
            "sum by (controller) "
            "(rate(controller_reconcile_total{result=\"error\"}[5m])) "
            "/ sum by (controller) "
            "(rate(controller_reconcile_total[5m])) > 0.1",
            for_s=60.0, severity="warning",
            summary="a controller is failing >10% of reconciles"),
        AlertRule(
            "SchedulerPassSlow",
            "histogram_quantile(0.99, sum by (le) "
            "(rate(scheduler_pass_seconds_bucket[10m]))) > 1",
            for_s=120.0, severity="warning",
            summary="scheduler p99 pass duration above 1s"),
        AlertRule(
            "KVPagesExhausted",
            "serving_kv_pages_free == 0",
            for_s=30.0, severity="warning",
            summary="a replica's paged KV cache has zero free pages "
                    "(admission is stalled)"),
        AlertRule(
            "CheckpointFailures",
            "increase(checkpoint_failures_total[10m]) > 0",
            for_s=0.0, severity="critical",
            summary="checkpoint saves/restores are failing"),
    ]
