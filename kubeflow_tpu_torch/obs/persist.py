"""TSDB durability: snapshot + segment persistence and remote-write.

The ``TimeSeriesStore`` is a bounded in-memory ring — a process
restart (the preemption steady state) loses every series, alert
history included. This module makes the plane durable without giving
up the store's boundedness or determinism:

- ``TsdbPersister`` — a flush loop that writes *segments* (the samples
  appended since the last flush) and, every ``snapshot_every``
  flushes, a full *snapshot* that supersedes them. Every file — both
  kinds — goes through ``utils/fsatomic.atomic_write_text``, the ONE
  spelling of temp + fsync + rename: a kill mid-write leaves at worst
  a stale ``.tmp`` sibling, never a torn live file, so
  ``restore()`` never sees a partial document. The recovery contract
  is therefore exactly the flush interval: samples appended after the
  last completed flush are the only ones a kill can lose.
- ``RemoteWriteExporter`` — batched JSONL POST of new samples to a
  fleet-level aggregator, with the REST client's capped-jittered backoff
  (``delay = min(cap, base * 2^attempt)`` then full jitter), so many
  per-process planes can feed one fleet TSDB without thundering herds.

Format notes: the staleness marker is a specific NaN *bit pattern*
(``expofmt.STALE_NAN``) that a JSON float roundtrip destroys, so
points encode it as the string ``"stale"``; ordinary NaN/Inf data uses
Python's JSON literals. Snapshot/segment documents are versioned
(``"v": 1``) single JSON objects.

Port of `kubeflow_tpu/obs/persist.py`: the same documents and JSONL
bodies, written through the port's ``utils/fsatomic``, so a store
persisted by either package restores in the other.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable

from kubeflow_tpu_torch.obs import expofmt
from kubeflow_tpu_torch.obs.tsdb import STALE, TimeSeriesStore
from kubeflow_tpu_torch.utils.fsatomic import atomic_write_text

log = logging.getLogger("kubeflow_tpu_torch.obs.persist")

SNAPSHOT_FILE = "snapshot.json"
SEGMENT_PREFIX = "segment-"


def _encode_value(v: float):
    if expofmt.is_stale(v):
        return "stale"
    return v


def _decode_value(v) -> float:
    if v == "stale":
        return STALE
    return float(v)


def _encode_samples(dump) -> list:
    """``dump_since`` output -> JSON-safe nested lists."""
    return [[name, labels, [[t, _encode_value(v)] for t, v in pts]]
            for name, labels, pts in dump]


class TsdbPersister:
    """Snapshot + segment persistence for one ``TimeSeriesStore``.

    ``flush(at=)`` writes one segment holding every sample with
    ``watermark < t <= at``; ``snapshot_every`` flushes, the persister
    writes a full snapshot instead and deletes the segments it
    subsumes. ``restore()`` (call before the scrape loop starts)
    replays snapshot + segments in order, skipping any unparseable
    file (an interrupted write's ``.tmp`` sibling is not even
    considered — only completed renames are visible).

    The loop shell (``start``/``stop``) mirrors ``ScrapeLoop``:
    injectable clock, daemon thread, deterministic when driven
    manually via ``flush(at=...)``."""

    def __init__(self, store: TimeSeriesStore, directory: str,
                 clock: Callable[[], float] = time.time,
                 flush_interval_s: float = 15.0,
                 snapshot_every: int = 20,
                 registry=None):
        self.store = store
        self.directory = directory
        self.clock = clock
        self.flush_interval_s = flush_interval_s
        self.snapshot_every = max(1, int(snapshot_every))
        self.registry = registry
        self._watermark: float | None = None  # highest persisted t
        self._seq = 0           # next segment sequence number
        self._flushes = 0
        self._samples_written = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- paths ---------------------------------------------------------------

    def _snapshot_path(self) -> str:
        return os.path.join(self.directory, SNAPSHOT_FILE)

    def _segment_path(self, seq: int) -> str:
        return os.path.join(self.directory, f"{SEGMENT_PREFIX}{seq:08d}.json")

    def _segment_files(self) -> list[str]:
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(n for n in names
                      if n.startswith(SEGMENT_PREFIX)
                      and n.endswith(".json"))

    # -- restore -------------------------------------------------------------

    def restore(self) -> dict:
        """Replay snapshot + segments into the store. Returns counts;
        tolerates a missing directory (first boot) and skips corrupt
        documents (which atomic writes make unreachable in practice —
        belt and braces for operator-copied files)."""
        restored = {"snapshot_samples": 0, "segment_samples": 0,
                    "segments": 0}
        snap = self._read_doc(self._snapshot_path())
        if snap is not None:
            restored["snapshot_samples"] = self._replay(snap)
        for fname in self._segment_files():
            doc = self._read_doc(os.path.join(self.directory, fname))
            if doc is None:
                continue
            restored["segments"] += 1
            restored["segment_samples"] += self._replay(doc)
            seq = doc.get("seq")
            if isinstance(seq, int) and seq >= self._seq:
                self._seq = seq + 1
        if self.registry is not None:
            self.registry.counter_inc(
                "obs_persist_restored_samples_total",
                help_="samples replayed into the store on restore",
                by=restored["snapshot_samples"]
                + restored["segment_samples"])
        return restored

    def _read_doc(self, path: str) -> dict | None:
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except FileNotFoundError:
            return None
        except (OSError, ValueError):
            log.warning("persist: skipping unreadable %s", path)
            return None
        if not isinstance(doc, dict) or doc.get("v") != 1:
            log.warning("persist: skipping unknown-format %s", path)
            return None
        return doc

    def _replay(self, doc: dict) -> int:
        n = 0
        # the doc-start watermark, NOT the running one: within a doc,
        # series replay sequentially and one series' newest points must
        # not mask another's older ones
        floor = self._watermark
        for entry in doc.get("series") or []:
            try:
                name, labels, pts = entry
            except (TypeError, ValueError):
                continue
            for t, v in pts:
                t = float(t)
                # skip points at/below the floor: a kill between the
                # snapshot rename and segment cleanup leaves segments
                # the snapshot subsumes, and replaying them must be
                # idempotent (scrape time is globally monotonic across
                # docs, so the doc-start high-water mark is exact)
                if floor is not None and t <= floor:
                    continue
                self.store.append(name, labels, _decode_value(v), t)
                if self._watermark is None or t > self._watermark:
                    self._watermark = t
                n += 1
        return n

    # -- flush / snapshot ----------------------------------------------------

    def flush(self, at: float | None = None) -> dict:
        """One persistence step at ``at``: a segment of new samples, or
        (every ``snapshot_every``-th call) a superseding snapshot."""
        now = self.clock() if at is None else at
        self._flushes += 1
        if self._flushes % self.snapshot_every == 0:
            return self.snapshot_now(at=now)
        dump = self.store.dump_since(self._watermark)
        samples = sum(len(pts) for _, _, pts in dump)
        if samples:
            doc = {"v": 1, "seq": self._seq, "at": now,
                   "series": _encode_samples(dump)}
            os.makedirs(self.directory, exist_ok=True)
            atomic_write_text(self._segment_path(self._seq),
                              json.dumps(doc))
            self._seq += 1
            self._samples_written += samples
            self._watermark = max(
                (t for _, _, pts in dump for t, _ in pts),
                default=self._watermark)
        self._publish()
        return {"kind": "segment", "samples": samples, "at": now}

    def snapshot_now(self, at: float | None = None) -> dict:
        """Full snapshot superseding every segment: written first (so a
        kill between write and cleanup only leaves redundant segments,
        re-replayed idempotently into the rings), segments deleted
        after."""
        now = self.clock() if at is None else at
        dump = self.store.dump_since(None)
        samples = sum(len(pts) for _, _, pts in dump)
        doc = {"v": 1, "at": now, "series": _encode_samples(dump)}
        os.makedirs(self.directory, exist_ok=True)
        atomic_write_text(self._snapshot_path(), json.dumps(doc))
        for fname in self._segment_files():
            try:
                os.unlink(os.path.join(self.directory, fname))
            except OSError:
                pass
        self._samples_written += samples
        self._watermark = max(
            (t for _, _, pts in dump for t, _ in pts),
            default=self._watermark)
        self._publish()
        return {"kind": "snapshot", "samples": samples, "at": now}

    def _publish(self) -> None:
        if self.registry is None:
            return
        self.registry.gauge("obs_persist_flushes_total", self._flushes,
                            help_="persistence flush passes")
        self.registry.gauge("obs_persist_samples_total",
                            self._samples_written,
                            help_="samples written to disk")
        self.registry.gauge("obs_persist_segments",
                            len(self._segment_files()),
                            help_="live segment files awaiting the "
                                  "next snapshot")

    # -- thread shell (mirrors ScrapeLoop) -----------------------------------

    def start(self) -> "TsdbPersister":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="tsdb-persist", daemon=True)
            self._thread.start()
        return self

    def stop(self, final_flush: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if final_flush:
            try:
                self.flush()
            except Exception:
                log.exception("persist: final flush failed")

    def _run(self) -> None:
        while not self._stop.wait(self.flush_interval_s):
            try:
                self.flush()
            except Exception:  # durability must never kill the plane
                log.exception("persist: flush failed")


# -- remote write -------------------------------------------------------------


def _default_post(url: str, body: bytes) -> None:
    import urllib.request

    req = urllib.request.Request(
        url, data=body,
        headers={"Content-Type": "application/x-ndjson"},
        method="POST")
    with urllib.request.urlopen(req, timeout=10) as resp:
        if resp.status >= 300:
            raise OSError(f"remote write: HTTP {resp.status}")


class RemoteWriteExporter:
    """Ship new samples to a fleet aggregator as batched JSONL.

    Each ``export_once(at=)`` collects samples past the watermark,
    splits them into ``batch`` -sized JSONL bodies (one sample per
    line: ``{"name","labels","t","v"}``), and POSTs each with the REST
    client's retry shape — capped exponential backoff with full jitter
    (``random.uniform(0, min(cap, base * 2^attempt))``). A batch that
    exhausts retries is dropped and counted, and the watermark still
    advances: remote write is lossy-by-design telemetry, local
    persistence (``TsdbPersister``) is the durable copy."""

    def __init__(self, store: TimeSeriesStore, url: str,
                 post: Callable[[str, bytes], None] | None = None,
                 batch: int = 500,
                 clock: Callable[[], float] = time.time,
                 retry_base: float = 0.1, retry_cap: float = 2.0,
                 max_retries: int = 5,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Callable[[], float] | None = None,
                 registry=None):
        import random

        self.store = store
        self.url = url
        self.post = post or _default_post
        self.batch = max(1, int(batch))
        self.clock = clock
        self.retry_base = retry_base
        self.retry_cap = retry_cap
        self.max_retries = max_retries
        self.sleep = sleep
        self.rng = rng if rng is not None else random.random
        self.registry = registry
        self._watermark: float | None = None
        self._sent = 0
        self._dropped = 0

    def export_once(self, at: float | None = None) -> int:
        now = self.clock() if at is None else at
        dump = self.store.dump_since(self._watermark)
        lines: list[str] = []
        newest = self._watermark
        for name, labels, pts in dump:
            for t, v in pts:
                lines.append(json.dumps(
                    {"name": name, "labels": labels, "t": t,
                     "v": _encode_value(v)}, sort_keys=True))
                if newest is None or t > newest:
                    newest = t
        sent = 0
        for i in range(0, len(lines), self.batch):
            body = ("\n".join(lines[i:i + self.batch]) + "\n").encode()
            if self._post_with_backoff(body):
                sent += self.batch if i + self.batch <= len(lines) \
                    else len(lines) - i
            else:
                self._dropped += len(lines[i:i + self.batch])
        # lossy-by-design: the watermark advances past failures too
        self._watermark = newest
        self._sent += sent
        if self.registry is not None:
            self.registry.gauge("obs_remote_write_sent_total", self._sent,
                                help_="samples shipped to the remote "
                                      "aggregator")
            self.registry.gauge("obs_remote_write_dropped_total",
                                self._dropped,
                                help_="samples dropped after retry "
                                      "exhaustion")
        return sent

    def _post_with_backoff(self, body: bytes) -> bool:
        for attempt in range(self.max_retries + 1):
            try:
                self.post(self.url, body)
                return True
            except Exception as e:
                if attempt >= self.max_retries:
                    log.warning("remote write: dropping batch after "
                                "%d attempts: %s", attempt + 1, e)
                    return False
                delay = min(self.retry_cap,
                            self.retry_base * (2 ** attempt))
                self.sleep(self.rng() * delay)
        return False

    @property
    def dropped(self) -> int:
        return self._dropped
