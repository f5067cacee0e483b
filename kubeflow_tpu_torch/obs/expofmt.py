"""Prometheus text-exposition (0.0.4) parsing (port of
kubeflow_tpu/obs/expofmt.py): what the serving router's
`RegistrySignals` uses to read a scraped `/metrics` body back into
signals. Parsing `MetricsRegistry.render()` output round-trips the
registry's own structured samples.

The grammar is the subset our registries emit: ``# HELP``/``# TYPE``
comment lines, then ``name{label="value",...} number`` samples. Label
values reverse the writer's escaping (``\\``, ``\"``, ``\n`` —
``runtime/metrics.py`` `_escape_label`); values inside quotes may contain
commas and ``}``, which the naive ``split(",")`` parser this replaces
got wrong. Unparseable lines are SKIPPED, never raised: a scrape of a
half-written or foreign exposition must degrade to the samples it can
read (the Prometheus contract).
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass
from typing import Iterator

# metric/series names (PromQL also allows ':' in recorded-rule names)
NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>[^\s]+)"
    r"(?:\s+(?P<ts>-?\d+))?\s*$")
_LABEL_RE = re.compile(
    r'\s*(?P<key>[a-zA-Z_][a-zA-Z0-9_]*)\s*=\s*'
    r'"(?P<value>(?:[^"\\]|\\.)*)"\s*(?:,|$)')
_UNESCAPE = {"\\\\": "\\", '\\"': '"', "\\n": "\n"}


def _unescape(value: str) -> str:
    out = []
    i = 0
    while i < len(value):
        pair = value[i:i + 2]
        if pair in _UNESCAPE:
            out.append(_UNESCAPE[pair])
            i += 2
        else:
            out.append(value[i])
            i += 1
    return "".join(out)


@dataclass(frozen=True)
class Sample:
    """One exposition sample. ``name`` is the SERIES name — a histogram
    family renders as distinct ``_bucket``/``_sum``/``_count`` series
    and stays that way here (the TSDB and PromQL-lite operate on
    series, exactly like Prometheus)."""

    name: str
    labels: tuple[tuple[str, str], ...]
    value: float

    def labels_dict(self) -> dict[str, str]:
        return dict(self.labels)


def parse_labels(body: str) -> tuple[tuple[str, str], ...] | None:
    """``k1="v1",k2="v2"`` -> sorted tuple; None when malformed."""
    out: list[tuple[str, str]] = []
    pos = 0
    body = body.strip()
    while pos < len(body):
        m = _LABEL_RE.match(body, pos)
        if not m:
            return None
        out.append((m.group("key"), _unescape(m.group("value"))))
        pos = m.end()
    return tuple(sorted(out))


def parse_line(line: str) -> Sample | None:
    """One sample line -> Sample; None for comments/blank/garbage."""
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    m = _SAMPLE_RE.match(line)
    if not m:
        return None
    labels_body = m.group("labels")
    labels = parse_labels(labels_body) if labels_body else ()
    if labels is None:
        return None
    try:
        value = float(m.group("value"))
    except ValueError:
        return None
    return Sample(m.group("name"), labels, value)


def parse(text: str) -> Iterator[Sample]:
    """Every parseable sample in an exposition body, document order."""
    for line in text.splitlines():
        s = parse_line(line)
        if s is not None:
            yield s


def samples(text: str, name: str) -> list[tuple[dict, float]]:
    """All samples of ONE series name as ``(labels, value)`` pairs —
    the shape ``MetricsRegistry.series()`` returns, so a scraped-body
    signal source and the in-process fast path are interchangeable
    (``RegistrySignals`` consumes both)."""
    return [(s.labels_dict(), s.value) for s in parse(text)
            if s.name == name]


# The staleness marker is Prometheus's SPECIFIC NaN bit pattern
# (0x7ff0000000000002), not "any NaN": a target legitimately exporting
# `jaxrt_loss NaN` after divergence must stay visible as data — only
# the marker the TSDB itself wrote may hide a series.
STALE_NAN = struct.unpack("<d", struct.pack("<Q", 0x7ff0000000000002))[0]
_STALE_BITS = struct.pack("<d", STALE_NAN)


def is_stale(value: float) -> bool:
    """True only for the exact staleness bit pattern the TSDB writes —
    ordinary NaN data (which compares unequal to everything, including
    itself) is NOT stale."""
    try:
        return struct.pack("<d", value) == _STALE_BITS
    except (struct.error, TypeError):
        return False
