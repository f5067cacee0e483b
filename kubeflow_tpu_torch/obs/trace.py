"""Span API: ids, context propagation, a collector, the tree helpers and
the JSONL dump (port of kubeflow_tpu/obs/trace.py: what the serving
router, the trainer and the launcher use; the dump stays readable by
tools/trace2perfetto.py).

Design constraints, in order:

- **Zero dependencies.** Runs in the control plane, the launcher pod,
  and CI images with nothing but the stdlib.
- **Monotonic durations.** Every duration is a ``time.perf_counter()``
  delta; wall-clock (``time.time()``) appears exactly once, as the
  module-level anchor that converts perf_counter readings into epoch
  timestamps for export.
- **Never lose the exception.** ``Tracer.span`` records status=ERROR
  and re-raises; instrumentation must not change control flow.
- **Bounded memory.** The collector is a ring (default 8192 spans) so a
  million-step training run cannot OOM its own telemetry.

Propagation uses the W3C trace-context wire format
(``00-<32 hex trace id>-<16 hex span id>-<2 hex flags>``) carried in
the ``TRACEPARENT`` env var across processes and in the
``obs.kubeflow.org/traceparent`` annotation across k8s objects.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Iterator

# One authoritative spelling of the propagation carriers (jaxjob stamps
# them, scheduler/launcher/trainer read them).
TRACEPARENT_ENV = "TRACEPARENT"
TRACEPARENT_ANNOTATION = "obs.kubeflow.org/traceparent"

# Wall-clock anchor: epoch seconds at the instant perf_counter read 0.
# Span timestamps are anchor + perf_counter — one wall reading at
# import, monotonic deltas ever after.
_EPOCH = time.time() - time.perf_counter()


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclasses.dataclass(frozen=True)
class SpanContext:
    """The propagatable identity of a span: what children parent on."""

    trace_id: str
    span_id: str
    sampled: bool = True

    def to_traceparent(self) -> str:
        flags = "01" if self.sampled else "00"
        return f"00-{self.trace_id}-{self.span_id}-{flags}"


def parse_traceparent(value) -> SpanContext | None:
    """Decode a W3C traceparent header; None for anything malformed
    (propagation is best-effort — a bad header must never raise)."""
    if not isinstance(value, str):
        return None
    parts = value.strip().lower().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if (len(version), len(trace_id), len(span_id), len(flags)) != (2, 32, 16, 2):
        return None
    try:
        int(version, 16), int(trace_id, 16), int(span_id, 16)
        flag_bits = int(flags, 16)
    except ValueError:
        return None
    if version == "ff" or set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None  # spec: invalid version / all-zero ids
    return SpanContext(trace_id, span_id, bool(flag_bits & 1))


def context_from_env(environ=None) -> SpanContext | None:
    env = os.environ if environ is None else environ
    return parse_traceparent(env.get(TRACEPARENT_ENV, ""))


@dataclasses.dataclass
class Span:
    """One timed operation. ``start``/``end`` are epoch seconds derived
    from the perf_counter anchor; ``end is None`` while still open."""

    name: str
    trace_id: str
    span_id: str
    parent_id: str | None = None
    start: float = 0.0
    end: float | None = None
    attrs: dict = dataclasses.field(default_factory=dict)
    status: str = "OK"  # OK | ERROR
    error: str | None = None
    pid: int = dataclasses.field(default_factory=os.getpid)
    tid: int = dataclasses.field(default_factory=threading.get_ident)

    @property
    def duration(self) -> float:
        assert self.end is not None, f"span {self.name!r} still open"
        return self.end - self.start

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class TraceCollector:
    """Thread-safe bounded span sink (a ring: old spans age out)."""

    def __init__(self, capacity: int = 8192):
        self._lock = threading.Lock()
        self._spans: deque[Span] = deque(maxlen=capacity)

    def add(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def trace(self, trace_id: str) -> list[Span]:
        with self._lock:
            return [s for s in self._spans if s.trace_id == trace_id]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


# The ambient span context: children parent on it implicitly. A
# contextvar (not a thread-local) so the scheduler's synchronous
# admission pass and async test harnesses both nest correctly.
_CURRENT: contextvars.ContextVar[SpanContext | None] = contextvars.ContextVar(
    "kftpu_torch_span_context", default=None)


class Tracer:
    """Span factory bound to a collector.

    Two API shapes: ``span()`` (context manager — exception-safe, for
    lexically scoped work) and ``begin()``/``finish()`` (for spans held
    open across calls, e.g. a controller's per-object root span)."""

    def __init__(self, collector: TraceCollector | None = None):
        self.collector = collector if collector is not None else TraceCollector()

    # -- ambient context ---------------------------------------------------

    def current(self) -> SpanContext | None:
        return _CURRENT.get()

    def attach(self, ctx: SpanContext | None):
        """Install ``ctx`` as the ambient parent (e.g. the launcher
        installing the pod's TRACEPARENT); returns a reset token."""
        return _CURRENT.set(ctx)

    def detach(self, token) -> None:
        _CURRENT.reset(token)

    # -- span lifecycle ----------------------------------------------------

    def begin(self, name: str, parent: SpanContext | None = None,
              context: SpanContext | None = None, detached: bool = False,
              **attrs) -> Span:
        """Open a span. ``parent`` overrides the ambient context;
        ``context`` pins the span's OWN ids (the jaxjob root span must
        be exactly the ids stamped into the pod traceparent).
        ``detached`` skips ambient installation — required when finish()
        will run in a different call stack (e.g. a later reconcile)."""
        if context is not None:
            trace_id, span_id = context.trace_id, context.span_id
            parent_id = parent.span_id if parent is not None else None
        else:
            up = parent if parent is not None else _CURRENT.get()
            trace_id = up.trace_id if up is not None else new_trace_id()
            parent_id = up.span_id if up is not None else None
            span_id = new_span_id()
        t0 = time.perf_counter()
        span = Span(name=name, trace_id=trace_id, span_id=span_id,
                    parent_id=parent_id, start=_EPOCH + t0, attrs=dict(attrs))
        span._t0 = t0
        span._token = None if detached else _CURRENT.set(span.context())
        return span

    def finish(self, span: Span, duration: float | None = None) -> Span:
        """Close `span` now, or at start + `duration` seconds when that
        is given (work timed on the device, read after it ended)."""
        span.end = span.start + (time.perf_counter() - span._t0
                                 if duration is None else duration)
        token = getattr(span, "_token", None)
        if token is not None:
            span._token = None
            try:
                _CURRENT.reset(token)
            except ValueError:
                pass  # finished from a different context: leave ambient alone
        self.collector.add(span)
        return span

    @contextlib.contextmanager
    def span(self, name: str, parent: SpanContext | None = None,
             **attrs) -> Iterator[Span]:
        sp = self.begin(name, parent=parent, **attrs)
        try:
            yield sp
        except BaseException as e:
            sp.status = "ERROR"
            sp.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            self.finish(sp)


COLLECTOR = TraceCollector()
TRACER = Tracer(COLLECTOR)


# -- tree helpers ------------------------------------------------------------

def children_index(spans: list[Span]) -> dict[str | None, list[Span]]:
    out: dict[str | None, list[Span]] = {}
    for s in spans:
        out.setdefault(s.parent_id, []).append(s)
    return out


def reachable(spans: list[Span], root_span_id: str) -> set[str]:
    """Span ids reachable from ``root_span_id`` via parent links —
    the acceptance check that a trace is one connected tree."""
    index = children_index(spans)
    seen: set[str] = {root_span_id}
    frontier = [root_span_id]
    while frontier:
        for child in index.get(frontier.pop(), []):
            if child.span_id not in seen:
                seen.add(child.span_id)
                frontier.append(child.span_id)
    return seen


# -- exporters ---------------------------------------------------------------

def to_jsonl(spans: list[Span]) -> str:
    """Compact one-span-per-line dump (the ``trace2perfetto`` input)."""
    return "".join(json.dumps(s.to_dict(), sort_keys=True) + "\n"
                   for s in spans)


def from_jsonl(text: str) -> list[Span]:
    return [Span.from_dict(json.loads(line))
            for line in text.splitlines() if line.strip()]


def write_jsonl(path: str, spans: list[Span]) -> None:
    """Atomic dump (utils/fsatomic.py): the launcher writes this at
    exit — often BECAUSE the worker is being preempted — and a kill mid-
    write must leave the previous dump intact, not a torn half-file."""
    from kubeflow_tpu_torch.utils.fsatomic import atomic_write_text

    atomic_write_text(path, to_jsonl(spans))


def read_jsonl(path: str) -> list[Span]:
    with open(path) as fh:
        return from_jsonl(fh.read())
