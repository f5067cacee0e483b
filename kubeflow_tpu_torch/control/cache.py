"""ClusterCache — an informer-style indexed cluster cache.

Every controller so far re-listed its world from the apiserver on each
pass: the gang scheduler alone called ``client.list("v1", "Pod")`` per
admission attempt, per health pass, and per victim scan — O(store) deep
copies each time, fine at 4 nodes, quadratic death at 5k.
This is the client-go informer/kube-scheduler-snapshot analogue: ONE
initial list per kind, then the cache maintains itself incrementally
from watch events, exposing snapshot reads with secondary indexes:

- nodes by name → ``NodeView`` plus per-``(product, node pool)``
  sorted free-capacity buckets (``scheduler/capacity.py``), free GPUs
  kept current on every pod bind/unbind/terminal transition;
- pods by ``nodeName`` (bound, non-terminal — the set that holds
  GPUs) and by gang label (``LABEL_JOB_NAME``), so gang and health
  reads are O(bucket) instead of O(cluster).

Consistency model (the informer contract, not linearizability):

- ``refresh()`` drains pending watch events from pollable streams —
  the hermetic FakeCluster delivers events synchronously at write
  time, so a refresh at reconcile start observes everything the
  triggering event did (read-your-watches);
- ``note_write()`` folds a write RESPONSE into the cache immediately
  (kube-scheduler's assumed-pod cache): against a real apiserver the
  watch is asynchronous, and a scheduler must see its own binds before
  the next admission in the same pass;
- a dropped or erroring watch resubscribes from the last seen
  resourceVersion; 410 Expired (or a backend without watch-cache
  resume) falls back to a full relist;
- stale deliveries are resourceVersion-guarded: an out-of-order
  MODIFIED older than the cached object is dropped, so replayed
  events (chaos relists re-yield live objects) cannot roll state back.

All state lives behind one lock, mutated only in locked methods (the
fresh-container idiom). Snapshot reads return internal
object references without copying (the whole point); callers treat
them as READ-ONLY and mutate only through the client.

Port of `kubeflow_tpu/control/cache.py`: the same code over the port's own modules.
"""

from __future__ import annotations

import logging
import threading

from kubeflow_tpu_torch.control.jaxjob import types as JT
from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.control.scheduler import capacity as C
from kubeflow_tpu_torch.control.scheduler import nodes as N

log = logging.getLogger("kubeflow_tpu_torch.cache")

NODE = ("v1", "Node")
POD = ("v1", "Pod")
DEFAULT_KINDS = (NODE, POD)

# Deleted-object memory (see _apply): bounded — entries only need to
# outlive the assume-note window of the pass that raced the delete.
TOMBSTONE_CAP = 2048


def _rv_of(obj: dict) -> int | None:
    try:
        return int(ob.meta(obj).get("resourceVersion", ""))
    except (TypeError, ValueError):
        return None


class _Sub:
    """One kind's watch subscription (single consumer: either the
    owning controller's reconcile-time refresh() or one pump thread)."""

    __slots__ = ("api_version", "kind", "stream", "last_rv")

    def __init__(self, api_version: str, kind: str):
        self.api_version = api_version
        self.kind = kind
        self.stream = None
        self.last_rv = ""

    @property
    def key(self) -> tuple[str, str]:
        return (self.api_version, self.kind)


class ClusterCache:
    def __init__(self, client, kinds=DEFAULT_KINDS,
                 pod_labels: tuple[str, ...] = (JT.LABEL_JOB_NAME,)):
        # ``pod_labels``: label keys to maintain secondary pod indexes
        # for. The gang label is the scheduler's; other controllers
        # (jaxservice, notebook) pass their own grouping label so their
        # per-reconcile "pods of X" reads stay O(bucket).
        self._client = client
        self._lock = threading.RLock()
        # Stream management (teardown + resubscribe) is serialized
        # separately: a pump thread and a reconcile-time refresh()
        # discovering the same dead stream must not both resubscribe —
        # the loser's stream would leak, subscribed but never consumed.
        self._mgmt = threading.Lock()
        self._subs = [_Sub(api, kind) for api, kind in kinds]
        self._objects: dict[tuple[str, str], dict[tuple[str, str], dict]] = \
            {s.key: {} for s in self._subs}
        self._dirty: dict[tuple[str, str], None] = {}  # kinds needing relist
        # node-derived state
        self._views: dict[str, N.NodeView] = {}
        self._used: dict[str, int] = {}    # GPUs held per node (any node
        #                                    name a bound pod references)
        self._free: dict[str, int] = {}    # per KNOWN node: alloc - used
        self._buckets: dict[tuple | None, C.Bucket] = {C.ALL_NODES: C.Bucket()}
        # pod-derived indexes
        self._pod_use: dict[tuple[str, str], tuple[str, int]] = {}
        self._by_node: dict[str, dict[tuple[str, str], None]] = {}
        # generic per-kind namespace buckets: kind key -> ns -> okey set
        # (a namespaced read over a high-cardinality kind — the notebook
        # Event forward — must be O(namespace), not O(cluster))
        self._by_ns: dict[tuple[str, str],
                          dict[str, dict[tuple[str, str], None]]] = \
            {s.key: {} for s in self._subs}
        # label key -> (namespace, value) -> ordered okey set
        self._pod_labels = tuple(pod_labels)
        self._by_label: dict[str, dict[tuple[str, str],
                                       dict[tuple[str, str], None]]] = \
            {lbl: {} for lbl in self._pod_labels}
        # (kind key, object key) -> highest rv seen at deletion. A
        # note_write racing a pump-applied DELETED would otherwise
        # re-insert the dead object (the rv guard below only compares
        # against a CACHED old); rvs are globally monotonic, so a
        # genuine recreation carries a higher rv and passes.
        self._tombstones: dict[tuple, int] = {}
        self._stats: dict[str, int] = {
            "events": 0, "stale_events": 0, "relists": 0,
            "resubscribes": 0, "refreshes": 0, "reads": 0,
        }
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------------

    def connect(self) -> "ClusterCache":
        """Subscribe the watches, then take the ONE initial list per
        kind. Failures (a chaotic or absent apiserver) mark the kind
        dirty; refresh() keeps retrying — a cache that cannot list yet
        serves an empty snapshot and the level-triggered reconciles
        converge once it can."""
        for sub in self._subs:
            self._ensure_stream(sub)
            self._try_relist(sub)
        return self

    def start(self) -> "ClusterCache":
        """Production mode: pump each watch stream on a daemon thread
        (streams without poll() — a real apiserver — cannot be drained
        at reconcile time). Hermetic tests skip this and rely on
        refresh()'s synchronous poll-drain."""
        with self._lock:
            if self._threads:
                return self
            self._stop.clear()
            threads = [
                threading.Thread(target=self._pump, args=(sub,),
                                 daemon=True,
                                 name=f"cache-{sub.kind}")
                for sub in self._subs
            ]
            self._threads = threads
        for t in threads:
            t.start()
        return self

    @property
    def pumped(self) -> bool:
        """True when pump threads own the streams — refresh() cannot
        drain them, so snapshots may trail the event that triggered the
        current reconcile (the scheduler confirms destructive decisions
        against the apiserver in this mode)."""
        with self._lock:
            return bool(self._threads)

    def stop(self) -> None:
        self._stop.set()
        for sub in self._subs:
            stream = sub.stream
            if stream is not None:
                try:
                    stream.stop()
                except Exception:
                    pass
        with self._lock:
            self._threads = []

    def _pump(self, sub: _Sub) -> None:
        """Pump one stream and OUTLIVE it (control/runtime.py's
        _watch_loop discipline): a raising stream resubscribes and
        relists rather than silently killing the thread."""
        while not self._stop.is_set():
            stream = sub.stream
            try:
                if stream is not None:
                    for ev in stream:
                        if self._stop.is_set():
                            return
                        self._ingest(sub, ev)
            except Exception:
                log.exception("cache: watch stream for %s failed; "
                              "resubscribing", sub.kind)
            if self._stop.is_set():
                return
            self._stop.wait(0.2)
            self._resubscribe(sub)

    # -- feeding -------------------------------------------------------------

    def refresh(self) -> int:
        """Catch the snapshot up: retry any dirty kind's relist, then
        drain every pollable stream. Returns events applied. Errors
        never propagate — the cache serves its last consistent
        snapshot and retries on the next refresh (informer semantics;
        the reconcile that called us stays level-triggered)."""
        applied = 0
        with self._lock:
            self._stats["refreshes"] += 1
            dirty = set(self._dirty)
            pumped = bool(self._threads)
        for sub in self._subs:
            if pumped:
                # pump threads own the streams (consumption AND
                # resubscription); draining or resubscribing here would
                # race their stream management. Dirty relists are safe:
                # idempotent wholesale replacement under the lock.
                if sub.key in dirty:
                    self._try_relist(sub)
                continue
            if sub.stream is None:
                self._resubscribe(sub)
            elif sub.key in dirty:
                self._try_relist(sub)
            stream = sub.stream
            if stream is None or not hasattr(stream, "poll"):
                continue
            while True:
                try:
                    ev = stream.poll()
                except Exception:
                    log.exception("cache: poll on %s watch failed; "
                                  "resubscribing", sub.kind)
                    self._resubscribe(sub)
                    break
                if ev is None:
                    break
                self._ingest(sub, ev)
                applied += 1
        return applied

    def note_write(self, obj: dict) -> None:
        """Fold a write response in immediately (assume-cache): the rv
        guard makes it idempotent against the watch's later delivery
        of the same change."""
        if obj and obj.get("kind"):
            self._apply("MODIFIED", obj)

    def note_delete(self, obj: dict) -> None:
        if obj and obj.get("kind"):
            self._apply("DELETED", obj)

    def mark_dirty(self, kinds=None) -> int:
        """Force a relist of ``kinds`` (``[(api_version, kind), ...]``;
        None = every subscribed kind) on the next ``refresh()`` — the
        cache's own watch-gap repair path, exposed for operators and
        the remediation engine (a slow scheduler pass with a healthy
        fleet usually means a drifted index). Returns how many kinds
        were marked."""
        wanted = None if kinds is None else {tuple(k) for k in kinds}
        marked = 0
        with self._lock:
            for sub in self._subs:
                if wanted is None or sub.key in wanted:
                    self._dirty[sub.key] = None
                    marked += 1
        return marked

    def _ingest(self, sub: _Sub, ev) -> None:
        rv = ob.meta(ev.object).get("resourceVersion")
        if rv:
            sub.last_rv = rv
        self._apply(ev.type, ev.object)

    def _ensure_stream(self, sub: _Sub) -> bool:
        if sub.stream is not None:
            return True
        try:
            sub.stream = self._client.watch(sub.api_version, sub.kind)
        except Exception:
            log.exception("cache: watch subscribe for %s failed; will "
                          "retry", sub.kind)
            with self._lock:
                self._dirty[sub.key] = None
            return False
        return True

    def _resubscribe(self, sub: _Sub) -> None:
        with self._mgmt:
            old = sub.stream
            if old is not None:
                try:
                    old.stop()
                except Exception:
                    pass
                sub.stream = None
                with self._lock:
                    self._stats["resubscribes"] += 1
            stream = None
            if sub.last_rv:
                # resume from the last seen rv: replays the gap, no
                # relist
                try:
                    stream = self._client.watch(sub.api_version, sub.kind,
                                                since_rv=sub.last_rv)
                except ob.Expired:
                    log.info("cache: %s resume rv=%s expired (410) -> "
                             "relist", sub.kind, sub.last_rv)
                except TypeError:
                    pass  # backend without watch-cache resume: relist
                except Exception:
                    log.exception("cache: %s watch resume failed; will "
                                  "relist", sub.kind)
            if stream is not None:
                sub.stream = stream
                if old is not None:
                    return  # resumed exactly: the replay covers the gap
            else:
                # subscribe FIRST, then relist: changes landing between
                # the two are replayed by the fresh stream, never lost
                if not self._ensure_stream(sub):
                    return
        self._try_relist(sub)

    def _try_relist(self, sub: _Sub) -> bool:
        """One full list for this kind, replacing its slice of the
        snapshot. Prefers the backend's no-copy read-only snapshot path
        (``FakeCluster.list_snapshot``) — the cache never mutates what
        it ingests, so copying every object only to index it is waste."""
        snap = getattr(self._client, "list_snapshot", None)
        try:
            if snap is not None:
                items, rv = snap(sub.api_version, sub.kind)
            else:
                items = self._client.list(sub.api_version, sub.kind)
                rv = ""
        except Exception:
            log.exception("cache: relist of %s failed; serving the last "
                          "snapshot", sub.kind)
            with self._lock:
                self._dirty[sub.key] = None
            return False
        with self._lock:
            self._objects[sub.key] = {
                (ob.meta(o).get("namespace") or "", ob.meta(o)["name"]): o
                for o in items
            }
            self._dirty.pop(sub.key, None)
            self._stats["relists"] += 1
            self._rebuild_locked()
        if rv:
            sub.last_rv = rv
        elif items:
            sub.last_rv = max(
                (ob.meta(o).get("resourceVersion", "") for o in items),
                key=lambda s: int(s) if s.isdigit() else 0)
        return True

    # -- applying ------------------------------------------------------------

    def _apply(self, etype: str, obj: dict) -> None:
        key = (obj.get("apiVersion", ""), obj.get("kind", ""))
        if key not in self._objects:
            return
        m = ob.meta(obj)
        okey = (m.get("namespace") or "", m.get("name") or "")
        with self._lock:
            store = self._objects[key]
            old = store.get(okey)
            if etype == "DELETED":
                rv_new = _rv_of(obj)
                rv_old = _rv_of(old) if old is not None else None
                if old is not None and rv_new is not None \
                        and rv_old is not None and rv_new < rv_old:
                    # late/replayed DELETED for an OLDER incarnation:
                    # the cached object is a same-name recreation (e.g.
                    # folded in by a reconciler's note_write before the
                    # old incarnation's watch DELETED arrived). Evicting
                    # it — and tombstoning at ITS rv, as the max() below
                    # would — makes the live object unresurrectable when
                    # its own ADDED is delivered. Tombstone only the
                    # dead incarnation's rv; keep the live object.
                    self._tombstone_locked((key, okey), rv_new)
                    self._stats["stale_events"] += 1
                    return
                tomb = max((r for r in (rv_new, rv_old)
                            if r is not None), default=None)
                if tomb is not None:
                    self._tombstone_locked((key, okey), tomb)
                if old is None:
                    return
                del store[okey]
                bucket = self._by_ns[key].get(okey[0])
                if bucket is not None:
                    bucket.pop(okey, None)
                    if not bucket:
                        del self._by_ns[key][okey[0]]
                new = None
            else:
                # rv guard: never let an out-of-order or replayed event
                # roll an object backwards
                rv_new, rv_old = _rv_of(obj), _rv_of(old) if old else None
                if old is not None and rv_new is not None \
                        and rv_old is not None and rv_new <= rv_old:
                    self._stats["stale_events"] += 1
                    return
                if old is None:
                    # delete-then-note race: the pump applied DELETED,
                    # then an older write response (or replayed event)
                    # arrives — without a cached old the rv guard above
                    # cannot catch it, the tombstone does
                    tomb = self._tombstones.get((key, okey))
                    if tomb is not None and (rv_new is None
                                             or rv_new <= tomb):
                        self._stats["stale_events"] += 1
                        return
                store[okey] = new = obj
                self._by_ns[key].setdefault(okey[0], {})[okey] = None
                self._tombstones.pop((key, okey), None)
            self._stats["events"] += 1
            if key == NODE:
                self._apply_node_locked(okey[1], old, new)
            elif key == POD:
                self._apply_pod_locked(okey, old, new)

    def _tombstone_locked(self, tkey: tuple, rv: int) -> None:
        rv = max(rv, self._tombstones.pop(tkey, 0))  # re-add: keep FIFO fresh
        self._tombstones[tkey] = rv
        while len(self._tombstones) > TOMBSTONE_CAP:
            self._tombstones.pop(next(iter(self._tombstones)))

    def _apply_node_locked(self, name: str, old: dict | None,
                           new: dict | None) -> None:
        old_view = self._views.get(name)
        if old_view is not None:
            old_free = self._free.get(name, 0)
            self._bucket_remove_locked(old_view, old_free)
            del self._views[name]
            self._free.pop(name, None)
        if new is None:
            return
        view = N.node_view(new)
        free = view.allocatable_gpus - self._used.get(name, 0)
        self._views[name] = view
        self._free[name] = free
        self._bucket_add_locked(view, free)

    def _bucket_add_locked(self, view: N.NodeView, free: int) -> None:
        self._buckets[C.ALL_NODES].add(free, view.name, view.spot)
        key = C.node_bucket_key(view.labels)
        if key is not C.ALL_NODES:
            self._buckets.setdefault(key, C.Bucket()).add(
                free, view.name, view.spot)

    def _bucket_remove_locked(self, view: N.NodeView, free: int) -> None:
        self._buckets[C.ALL_NODES].remove(free, view.name, view.spot)
        key = C.node_bucket_key(view.labels)
        if key is not C.ALL_NODES:
            b = self._buckets.get(key)
            if b is not None:
                b.remove(free, view.name, view.spot)

    @staticmethod
    def _pod_contrib(pod: dict | None) -> tuple[str, int] | None:
        """(node, GPUs) a pod holds: bound and non-terminal, else None."""
        if pod is None:
            return None
        node = (pod.get("spec") or {}).get("nodeName")
        if not node:
            return None
        if (pod.get("status") or {}).get("phase") in N.TERMINAL_PHASES:
            return None
        return (node, N.pod_gpu_request(pod))

    def _apply_pod_locked(self, okey: tuple[str, str], old: dict | None,
                          new: dict | None) -> None:
        # label indexes (gang label + any controller-configured keys)
        for lbl in self._pod_labels:
            old_val = ob.labels_of(old).get(lbl) if old else None
            new_val = ob.labels_of(new).get(lbl) if new else None
            if old_val == new_val:
                continue
            index = self._by_label[lbl]
            if old_val:
                bucket = index.get((okey[0], old_val))
                if bucket is not None:
                    bucket.pop(okey, None)
                    if not bucket:
                        del index[(okey[0], old_val)]
            if new_val:
                index.setdefault((okey[0], new_val), {})[okey] = None
        # chip accounting + by-node index
        old_use = self._pod_use.get(okey)
        new_use = self._pod_contrib(new)
        if old_use == new_use:
            return
        if old_use is not None:
            node, gpus = old_use
            del self._pod_use[okey]
            bucket = self._by_node.get(node)
            if bucket is not None:
                bucket.pop(okey, None)
                if not bucket:
                    del self._by_node[node]
            self._shift_node_locked(node, gpus)
        if new_use is not None:
            node, gpus = new_use
            self._pod_use[okey] = new_use
            self._by_node.setdefault(node, {})[okey] = None
            self._shift_node_locked(node, -gpus)

    def _shift_node_locked(self, node: str, by: int) -> None:
        self._used[node] = self._used.get(node, 0) - by
        if not self._used[node]:
            del self._used[node]
        view = self._views.get(node)
        if view is None:
            return
        old_free = self._free.get(node, 0)
        new_free = old_free + by
        self._free[node] = new_free
        self._buckets[C.ALL_NODES].adjust(old_free, new_free, node,
                                          view.spot)
        key = C.node_bucket_key(view.labels)
        if key is not C.ALL_NODES:
            b = self._buckets.get(key)
            if b is not None:
                b.adjust(old_free, new_free, node, view.spot)

    def _rebuild_locked(self) -> None:
        """Rebuild every derived index from the raw object maps (after
        a relist replaced a kind's slice wholesale)."""
        self._views = {}
        self._used = {}
        self._free = {}
        self._buckets = {C.ALL_NODES: C.Bucket()}
        self._pod_use = {}
        self._by_node = {}
        self._by_label = {lbl: {} for lbl in self._pod_labels}
        self._by_ns = {k: {} for k in self._objects}
        for k, kind_store in self._objects.items():
            for okey in kind_store:
                self._by_ns[k].setdefault(okey[0], {})[okey] = None
        for okey, pod in self._objects.get(POD, {}).items():
            labels = ob.labels_of(pod)
            for lbl in self._pod_labels:
                val = labels.get(lbl)
                if val:
                    self._by_label[lbl].setdefault(
                        (okey[0], val), {})[okey] = None
            use = self._pod_contrib(pod)
            if use is not None:
                node, gpus = use
                self._pod_use[okey] = use
                self._by_node.setdefault(node, {})[okey] = None
                self._used[node] = self._used.get(node, 0) + gpus
        for okey, node_obj in self._objects.get(NODE, {}).items():
            view = N.node_view(node_obj)
            free = view.allocatable_gpus - self._used.get(view.name, 0)
            self._views[view.name] = view
            self._free[view.name] = free
            self._bucket_add_locked(view, free)

    # -- snapshot reads (read-only references; never mutate) -----------------

    def objects(self, api_version: str, kind: str) -> dict:
        """{(namespace, name): object} for one kind — diffable against
        a fresh relist (the cache-correctness property tests)."""
        with self._lock:
            return dict(self._objects.get((api_version, kind), {}))

    def objects_ns(self, api_version: str, kind: str,
                   namespace: str) -> list[dict]:
        """One kind's objects in one namespace — O(namespace bucket),
        the namespaced-list analogue for snapshot reads."""
        key = (api_version, kind)
        with self._lock:
            self._stats["reads"] += 1
            store = self._objects.get(key, {})
            keys = self._by_ns.get(key, {}).get(namespace, ())
            return [store[k] for k in keys if k in store]

    def gang_pods(self, namespace: str, job: str) -> list[dict]:
        """Pods carrying the gang label, name-sorted (O(gang))."""
        return self.pods_by_label(JT.LABEL_JOB_NAME, namespace, job)

    def pods_by_label(self, label: str, namespace: str,
                      value: str) -> list[dict]:
        """Pods carrying ``label == value``, name-sorted (O(bucket)).
        The label must be in this cache's ``pod_labels`` — an unindexed
        key is a wiring bug, not a slow path."""
        with self._lock:
            self._stats["reads"] += 1
            store = self._objects[POD]
            keys = self._by_label[label].get((namespace, value), ())
            pods = [store[k] for k in keys if k in store]
        return sorted(pods, key=lambda p: ob.meta(p)["name"])

    def pods_on_node(self, node: str) -> list[dict]:
        """Bound, non-terminal pods holding this node's GPUs."""
        with self._lock:
            self._stats["reads"] += 1
            store = self._objects[POD]
            return [store[k] for k in self._by_node.get(node, ())
                    if k in store]

    def bound_pods(self) -> list[dict]:
        """Every bound, non-terminal pod (the preemption victim scan)."""
        with self._lock:
            self._stats["reads"] += 1
            store = self._objects[POD]
            return [store[k] for keys in self._by_node.values()
                    for k in keys if k in store]

    def node_views(self) -> dict[str, N.NodeView]:
        with self._lock:
            self._stats["reads"] += 1
            return dict(self._views)

    def node(self, name: str) -> dict | None:
        """The raw cached Node object (read-only reference) — for
        callers whose health semantics need more than a NodeView (e.g.
        the jaxjob slice-health check distinguishes 'no Ready condition
        yet' from 'Ready False')."""
        with self._lock:
            self._stats["reads"] += 1
            return self._objects[NODE].get(("", name))

    def unhealthy_bound_nodes(self) -> dict[str, str]:
        """Nodes that hold bound pods but are gone or NotReady —
        empty in the healthy steady state, which is what lets the
        health pass short-circuit without listing a single pod."""
        with self._lock:
            self._stats["reads"] += 1
            out: dict[str, str] = {}
            for node in self._by_node:
                v = self._views.get(node)
                if v is None:
                    out[node] = "deleted"
                elif not v.ready:
                    out[node] = "NotReady"
            return out

    def capacity(self) -> C.Capacity:
        """A placement snapshot: O(nodes) primitive copies (no object
        deep-copies, no relist) — the admission pass trials against it
        via CapacityTxn overlays."""
        with self._lock:
            self._stats["reads"] += 1
            return C.Capacity(
                dict(self._views), dict(self._free),
                {k: b.clone() for k, b in self._buckets.items()})

    def stats(self) -> dict[str, int]:
        with self._lock:
            return dict(self._stats)
