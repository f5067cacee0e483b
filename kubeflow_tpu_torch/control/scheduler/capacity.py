"""Indexed free-capacity model: sorted per-pool buckets + bisect best-fit.

Port of `kubeflow_tpu/control/scheduler/capacity.py`, over GPUs. Nodes
live in per-``(product, node pool)`` buckets — the label pair every
gang worker's nodeSelector names — each bucket a list of
``(free_gpus, name)`` kept in sorted order, so best-fit is a
``bisect_left`` to the first node with enough room followed by a short
walk to the first FEASIBLE one (readiness/taints/extra selector keys
still checked per node; the bucket only pre-filters the label pair).
The order is the reference's: the node with the fewest remaining GPUs,
ties broken by the lexicographically-first name.

``Capacity`` is an immutable snapshot (built by ``ClusterCache`` from
its incremental indexes, or from a one-shot relist on the legacy path);
``CapacityTxn`` overlays what-if placement on it copy-on-write, so
all-or-nothing trial assignments and preemption what-ifs never disturb
the snapshot they simulate against.
"""

from __future__ import annotations

import bisect

from kubeflow_tpu_torch.control.jaxjob import types as JT
from kubeflow_tpu_torch.control.scheduler import nodes as N

# Bucket key for nodes whose labels (or pods whose selectors) don't pin
# the (product, node pool) pair — they fall into the catch-all bucket
# holding every node, so placement stays correct, just unbucketed.
ALL_NODES = None

# best_fit(bucket_key=...) sentinel: "derive the bucket from the pod's
# selector" (ALL_NODES/None is itself a meaningful key, so the default
# can't be None).
AUTO_BUCKET = object()


def node_bucket_key(labels: dict) -> tuple | None:
    """The (product, node pool) pool a node belongs to, or None."""
    product = labels.get(JT.NODESELECTOR_ACCEL)
    pool = labels.get(JT.NODESELECTOR_POOL)
    if product is None or pool is None:
        return ALL_NODES
    return (product, pool)


def pod_bucket_key(pod: dict) -> tuple | None:
    """The bucket a pod's placement search may be confined to: only when
    its selector names BOTH pool labels is the bucket a superset of the
    feasible set — any other selector shape searches the catch-all."""
    sel = (pod.get("spec") or {}).get("nodeSelector") or {}
    product = sel.get(JT.NODESELECTOR_ACCEL)
    pool = sel.get(JT.NODESELECTOR_POOL)
    if product is None or pool is None:
        return ALL_NODES
    return (product, pool)


class Bucket:
    """One pool's nodes as parallel sorted ``(free, name)`` lists: every
    node, and the spot-pool subset (elastic gangs best-fit spot FIRST so
    reclaim-tolerant work burns reclaimable capacity)."""

    __slots__ = ("items", "spot")

    def __init__(self):
        self.items: list[tuple[int, str]] = []
        self.spot: list[tuple[int, str]] = []

    def clone(self) -> "Bucket":
        b = Bucket()
        b.items = list(self.items)
        b.spot = list(self.spot)
        return b

    def add(self, free: int, name: str, is_spot: bool) -> None:
        bisect.insort(self.items, (free, name))
        if is_spot:
            bisect.insort(self.spot, (free, name))

    def remove(self, free: int, name: str, is_spot: bool) -> None:
        _discard(self.items, (free, name))
        if is_spot:
            _discard(self.spot, (free, name))

    def adjust(self, old_free: int, new_free: int, name: str,
               is_spot: bool) -> None:
        self.remove(old_free, name, is_spot)
        self.add(new_free, name, is_spot)


def _discard(items: list, entry: tuple) -> None:
    i = bisect.bisect_left(items, entry)
    if i < len(items) and items[i] == entry:
        del items[i]


class Capacity:
    """A placement snapshot: node views, per-node free GPUs, and the
    sorted buckets. Immutable by contract — trials go through txn()."""

    __slots__ = ("views", "free", "buckets", "scanned")

    def __init__(self, views: dict[str, N.NodeView], free: dict[str, int],
                 buckets: dict[tuple | None, Bucket]):
        self.views = views
        self.free = free
        self.buckets = buckets
        # nodes examined by best-fit walks across every txn on this
        # snapshot — the scheduler publishes it per admission attempt
        # (scheduler_nodes_scanned_total)
        self.scanned = 0

    @classmethod
    def from_views(cls, views: dict[str, N.NodeView],
                   free: dict[str, int]) -> "Capacity":
        """Build the bucket index from a one-shot (view, free) read —
        the legacy relist path and small tests share this constructor;
        ClusterCache maintains the same shape incrementally."""
        buckets: dict[tuple | None, Bucket] = {ALL_NODES: Bucket()}
        for name, v in views.items():
            f = free.get(name, 0)
            buckets[ALL_NODES].add(f, name, v.spot)
            key = node_bucket_key(v.labels)
            if key is not ALL_NODES:
                buckets.setdefault(key, Bucket()).add(f, name, v.spot)
        return cls(views, free, buckets)

    def txn(self) -> "CapacityTxn":
        return CapacityTxn(self)


class CapacityTxn:
    """Copy-on-write what-if placement over a Capacity snapshot.

    Forks form a lifecycle: every ``fork()`` must end
    in exactly one ``commit()`` (replay this trial's net takes onto the
    parent) or ``rollback()`` (drop them) — a fork abandoned on an
    exceptional path silently diverges the caller's ledger from what
    was actually placed, which is precisely the bug shape the
    exception-edge dataflow rule exists to catch."""

    __slots__ = ("cap", "_delta", "_over", "_parent", "_base", "_closed")

    def __init__(self, cap: Capacity, _delta=None, _over=None,
                 _parent: "CapacityTxn | None" = None):
        self.cap = cap
        self._delta: dict[str, int] = dict(_delta) if _delta else {}
        self._over: dict[tuple | None, Bucket] = \
            {k: b.clone() for k, b in _over.items()} if _over else {}
        self._parent = _parent
        # the fork point: commit() replays only shifts made AFTER this
        self._base: dict[str, int] = dict(self._delta)
        self._closed = False

    def fork(self) -> "CapacityTxn":
        """An independent trial continuing from this txn's state (the
        preemption loop forks once per what-if assignment so cumulative
        victim credits persist while each trial's takes do not)."""
        return CapacityTxn(self.cap, self._delta, self._over,
                           _parent=self)

    @property
    def closed(self) -> bool:
        return self._closed

    def commit(self) -> None:
        """Replay this fork's net per-node shifts onto its parent and
        close the fork. The replay goes through the parent's own
        ``_shift`` so its bucket overlays stay sorted-correct."""
        if self._parent is None:
            raise ValueError("commit() on a root txn: root transactions "
                             "are scratch overlays with nothing to "
                             "merge into")
        if self._closed:
            raise ValueError("commit() on a closed txn")
        self._closed = True
        for name, total in self._delta.items():
            rel = total - self._base.get(name, 0)
            if rel:
                self._parent._shift(name, rel)

    def rollback(self) -> None:
        """Close the fork, discarding its shifts. Idempotence is NOT
        offered on purpose — a double close is a lifecycle bug."""
        if self._closed:
            raise ValueError("rollback() on a closed txn")
        self._closed = True

    def free_of(self, name: str) -> int:
        return self.cap.free.get(name, 0) + self._delta.get(name, 0)

    def _bucket(self, key: tuple | None) -> Bucket | None:
        b = self._over.get(key)
        if b is not None:
            return b
        return self.cap.buckets.get(key)

    def _bucket_for_write(self, key: tuple | None) -> Bucket:
        b = self._over.get(key)
        if b is None:
            base = self.cap.buckets.get(key)
            b = base.clone() if base is not None else Bucket()
            self._over[key] = b
        return b

    def _shift(self, name: str, by: int) -> None:
        view = self.cap.views.get(name)
        if view is None:
            return
        old = self.free_of(name)
        self._delta[name] = self._delta.get(name, 0) + by
        new = old + by
        keys: list[tuple | None] = [ALL_NODES]
        nk = node_bucket_key(view.labels)
        if nk is not ALL_NODES:
            keys.append(nk)
        for key in keys:
            self._bucket_for_write(key).adjust(old, new, name, view.spot)

    def take(self, name: str, gpus: int) -> None:
        self._shift(name, -gpus)

    def credit(self, name: str, gpus: int) -> None:
        """Return GPUs to a node (preemption what-if: a victim gang's
        GPUs free the moment its eviction status lands)."""
        self._shift(name, gpus)

    def bucket_keys(self) -> list[tuple]:
        """The REAL (product, node pool) pool keys of the underlying
        snapshot (never ALL_NODES). Pool membership is label-static, so
        a txn's overlays can only re-sort nodes within these keys."""
        return [k for k in self.cap.buckets if k is not ALL_NODES]

    def bucket_free(self, key: tuple | None) -> int:
        """Total free GPUs in one pool AS THIS TXN SEES IT — the
        pool-level best-fit ordering key for slice-aware admission."""
        b = self._bucket(key)
        if b is None:
            return 0
        return sum(f for f, _ in b.items)

    def best_fit(self, pod: dict, need: int, prefer_spot: bool = False,
                 bucket_key=AUTO_BUCKET) -> str | None:
        """The node this pod best-fits onto, or None. Spot preference is
        a preference: when no feasible spot node has room, placement
        falls back to the whole bucket (legacy semantics, pinned).

        ``bucket_key`` confines the search to ONE explicit pool instead
        of the pod's selector-derived bucket — slice-aware admission
        places every worker of a slice in a single (product, node pool)
        pool even when the pod's selector names no node pool."""
        key = pod_bucket_key(pod) if bucket_key is AUTO_BUCKET \
            else bucket_key
        bucket = self._bucket(key)
        if bucket is None:
            return None
        if prefer_spot:
            name = self._walk(bucket.spot, pod, need)
            if name is not None:
                return name
        return self._walk(bucket.items, pod, need)

    def _walk(self, items: list[tuple[int, str]], pod: dict,
              need: int) -> str | None:
        i = bisect.bisect_left(items, (need, ""))
        while i < len(items):
            _free, name = items[i]
            self.cap.scanned += 1
            if N.feasible(pod, self.cap.views[name]):
                return name
            i += 1
        return None
