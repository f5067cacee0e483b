"""The gang queue: priority + FIFO admission order with requeue backoff.

One entry per gang (namespace/job). ``ready()`` yields entries in strict
admission order — higher priority first, FIFO within a priority — and
gates each entry on its backoff deadline. A gang that failed admission
is ``requeue()``d with exponential backoff (base * 2^(attempts-1),
capped), so an unplaceable gang polls the cluster ever more slowly
instead of hammering it; ``remove()`` on admission drops the entry and
its backoff state.

The clock is injectable (tests drive a fake clock; production uses
time.monotonic). All state lives behind one lock: entries are frozen
dataclasses replaced wholesale under ``_lock`` (the fresh-container
idiom).

Port of `kubeflow_tpu/control/scheduler/queue.py`: the same code over the port's own modules.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time


@dataclasses.dataclass(frozen=True)
class Entry:
    """One queued gang. Frozen: updates replace the entry under the
    queue lock (never mutate in place)."""

    namespace: str
    name: str
    priority: int
    seq: int
    enqueued_at: float
    attempts: int = 0
    not_before: float = 0.0

    @property
    def key(self) -> tuple[str, str]:
        return (self.namespace, self.name)


class GangQueue:
    def __init__(
        self,
        clock=time.monotonic,
        base_backoff: float = 0.5,
        max_backoff: float = 30.0,
        jitter: float = 0.0,
        rng: random.Random | None = None,
    ):
        self.clock = clock
        self.base_backoff = base_backoff
        self.max_backoff = max_backoff
        # jitter spreads same-shaped gangs' retries apart (thundering-
        # herd control after a big node comes back); 0.0 (default) keeps
        # the schedule exactly pinnable in tests. rng injectable so a
        # seeded chaos run replays the same jittered schedule; the
        # default is seeded too (DET602), so enabling jitter without
        # wiring an rng still replays byte-identically.
        self.jitter = jitter
        self._rng = rng if rng is not None else random.Random(0)
        self._lock = threading.Lock()
        self._entries: dict[tuple[str, str], Entry] = {}
        # namespaces ever queued: keeps the queue-depth gauge reporting
        # an explicit 0 after a namespace drains (Prometheus semantics)
        self._namespaces: dict[str, None] = {}
        self._seq = 0

    def offer(self, namespace: str, name: str, priority: int = 0) -> Entry:
        """Add a gang (idempotent). A re-offer keeps the entry's seq and
        backoff state but tracks a changed priority."""
        now = self.clock()
        with self._lock:
            key = (namespace, name)
            cur = self._entries.get(key)
            if cur is None:
                self._seq += 1
                cur = Entry(namespace, name, priority, self._seq, now)
                self._entries[key] = cur
                self._namespaces[namespace] = None
            elif cur.priority != priority:
                cur = dataclasses.replace(cur, priority=priority)
                self._entries[key] = cur
            return cur

    def remove(self, namespace: str, name: str) -> None:
        with self._lock:
            self._entries.pop((namespace, name), None)

    def requeue(self, namespace: str, name: str) -> float:
        """Admission failed: back the gang off exponentially. Returns
        the delay until the entry is ready again (0.0 if unknown)."""
        now = self.clock()
        with self._lock:
            key = (namespace, name)
            cur = self._entries.get(key)
            if cur is None:
                return 0.0
            attempts = cur.attempts + 1
            delay = min(self.base_backoff * (2 ** (attempts - 1)),
                        self.max_backoff)
            if self.jitter > 0:
                delay *= 1.0 + self.jitter * self._rng.random()
            self._entries[key] = dataclasses.replace(
                cur, attempts=attempts, not_before=now + delay)
            return delay

    def kick(self) -> None:
        """Expire every entry's backoff deadline (keep attempt counts):
        new capacity just appeared, so waiting out the rest of an
        exponential delay would only idle the fleet. The next failed
        admission still backs off from the accumulated attempts."""
        with self._lock:
            for key, e in list(self._entries.items()):
                if e.not_before:
                    self._entries[key] = dataclasses.replace(
                        e, not_before=0.0)

    def kick_one(self, namespace: str, name: str) -> None:
        """Expire ONE gang's backoff: its own pod set just changed (a
        worker appeared or fell over), so retry on the new state now."""
        with self._lock:
            key = (namespace, name)
            cur = self._entries.get(key)
            if cur is not None and cur.not_before:
                self._entries[key] = dataclasses.replace(
                    cur, not_before=0.0)

    def ordered(self) -> list[Entry]:
        """ALL entries in admission order: priority descending, then
        FIFO (seq). The scheduling pass walks this so a backed-off head
        still blocks lower-priority gangs (strict FIFO) — backoff only
        paces the head's own retries, it never lets others jump it."""
        with self._lock:
            entries = list(self._entries.values())
        return sorted(entries, key=lambda e: (-e.priority, e.seq))

    def ready(self, now: float | None = None) -> list[Entry]:
        """Entries whose backoff has expired, in admission order."""
        if now is None:
            now = self.clock()
        return [e for e in self.ordered() if e.not_before <= now]

    def ordered_by_namespace(self) -> dict[str, list[Entry]]:
        """Admission order per namespace (the scheduling pass walks each
        namespace independently: one tenant's stuck head must not block
        another's admission)."""
        out: dict[str, list[Entry]] = {}
        for e in self.ordered():
            out.setdefault(e.namespace, []).append(e)
        return out

    def next_wakeup(self, now: float | None = None) -> float | None:
        """Seconds until the earliest backed-off entry becomes ready;
        None when nothing is waiting on a deadline."""
        if now is None:
            now = self.clock()
        with self._lock:
            future = [e.not_before for e in self._entries.values()
                      if e.not_before > now]
        if not future:
            return None
        return max(min(future) - now, 0.0)

    def get(self, namespace: str, name: str) -> Entry | None:
        with self._lock:
            return self._entries.get((namespace, name))

    def depth(self) -> int:
        with self._lock:
            return len(self._entries)

    def depths(self) -> dict[str, int]:
        """Queue depth per namespace, including 0 for just-drained ones.
        A drained namespace is reported at 0 once and then pruned — a
        fleet churning through ephemeral tenant namespaces must not
        grow this map (or the gauge's update set) forever."""
        with self._lock:
            out = {ns: 0 for ns in self._namespaces}
            for ns, _name in self._entries:
                out[ns] = out.get(ns, 0) + 1
            for ns, n in out.items():
                if n == 0:
                    self._namespaces.pop(ns, None)
            return out
