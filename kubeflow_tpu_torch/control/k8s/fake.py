"""FakeCluster — an in-memory Kubernetes apiserver.

The reference has *no* hermetic backend: its controllers are tested with
either injected fakes (bootstrap/cmd/bootstrap/app/kfctlServer.go:66-67)
or kubebuilder envtest binaries, and all distributed behavior runs on
real per-CI GKE clusters (SURVEY.md §4). This class is the deliberate
improvement: a single in-memory store with enough apiserver semantics —
resource versions + optimistic concurrency, label/field selectors,
finalizers + deletionTimestamp, ownerReference cascade GC, and watch
streams — that every controller in kubeflow_tpu_torch.control is testable in
milliseconds, and the same Client interface retargets a live cluster via
``rest.RestClient``.

Port of `kubeflow_tpu/control/k8s/fake.py`: the same code over the port's own modules.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import queue
import threading
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

from kubeflow_tpu_torch.control.k8s import objects as ob


# Identity/system fields excluded from server-side-apply ownership:
# shared by construction, never conflict, never removed.
_SSA_IDENTITY = {("apiVersion",), ("kind",), ("metadata", "name"),
                 ("metadata", "namespace")}


def _ssa_leaf_paths(obj: dict, prefix: tuple = ()) -> set[tuple]:
    """Leaf field paths of an apply intent (scalars, lists and empty
    dicts are leaves; non-empty dicts recurse), minus identity fields."""
    out: set[tuple] = set()
    for k, v in obj.items():
        p = prefix + (k,)
        if isinstance(v, dict) and v:
            out |= _ssa_leaf_paths(v, p)
        elif p not in _SSA_IDENTITY:
            out.add(p)
    return out


def _ssa_overlaps(p: tuple, q: tuple) -> bool:
    """True when one path is the other (or an ancestor of it) — i.e.
    writing p restructures the field at q or vice versa."""
    n = min(len(p), len(q))
    return p[:n] == q[:n]


def _ssa_get(obj: dict, path: tuple) -> tuple[Any, bool]:
    cur = obj
    for k in path:
        if not isinstance(cur, dict) or k not in cur:
            return None, False
        cur = cur[k]
    return cur, True


def _ssa_set(obj: dict, path: tuple, value: Any) -> None:
    cur = obj
    for k in path[:-1]:
        nxt = cur.get(k)
        if not isinstance(nxt, dict):
            nxt = cur[k] = {}
        cur = nxt
    cur[path[-1]] = value


def _ssa_delete(obj: dict, path: tuple) -> None:
    """Delete a leaf and prune now-empty parent dicts."""
    parents = []
    cur = obj
    for k in path[:-1]:
        if not isinstance(cur, dict) or k not in cur:
            return
        parents.append((cur, k))
        cur = cur[k]
    if isinstance(cur, dict):
        cur.pop(path[-1], None)
    for parent, k in reversed(parents):
        if parent[k] == {}:
            del parent[k]


def _ssa_managed_fields(owners: dict[tuple, set]) -> list[dict]:
    by_mgr: dict[str, list] = {}
    for path, mgrs in owners.items():
        for mg in mgrs:
            by_mgr.setdefault(mg, []).append(list(path))
    return [{"manager": mg, "operation": "Apply", "fields": sorted(fs)}
            for mg, fs in sorted(by_mgr.items())]


@dataclass(frozen=True)
class Key:
    api_version: str
    kind: str
    namespace: str  # "" for cluster-scoped
    name: str


@dataclass
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED
    object: dict


@dataclass
class _Watch:
    api_version: str
    kind: str
    namespace: str | None
    q: "queue.Queue[WatchEvent]" = field(default_factory=queue.Queue)
    closed: bool = False


class FakeCluster:
    """In-memory apiserver + Client.

    The Client surface (create/get/list/update/update_status/patch/delete/
    watch/events) is shared with rest.RestClient, so controllers are
    written once against either backend.
    """

    def __init__(self, history_limit: int = 1024):
        self._lock = threading.RLock()
        self._store: dict[Key, dict] = {}
        # Secondary index: (apiVersion, kind) -> namespace -> name -> obj,
        # so list() scans only the matching kind/namespace bucket instead
        # of the whole store (a 5k-node fleet's Pod list must
        # not pay for its ConfigMaps). Every store mutation goes through
        # _store_put/_store_pop to keep the two views in lockstep.
        self._kinds: dict[tuple[str, str], dict[str, dict[str, dict]]] = {}
        # Op-count stats (read via .stats/reset_stats): the scale
        # benchmark and the tier-1 op-budget smoke assert list-scan work
        # in objects, which is deterministic where wall time is not.
        self.stats: dict[str, int] = collections.defaultdict(int)
        self._recorder = None  # lazy EventRecorder (obs/events.py)
        self._rv = 0
        self._watches: list[_Watch] = []
        # Mutating-webhook style interceptors: fn(verb, obj) -> obj.
        # Lets tests wire the PodDefault webhook in-process exactly where
        # the real admission chain sits (pod CREATE).
        self._admission: list[Callable[[str, dict], dict]] = []
        # Bounded change history for watch resume-from-resourceVersion
        # (etcd's watch cache). When a requested RV falls below the
        # retained window the watch gets 410 Gone and the client relists —
        # exactly the real apiserver contract controllers must survive.
        self._history: collections.deque[tuple[int, WatchEvent]] = \
            collections.deque(maxlen=history_limit)
        self._truncated_below = 0  # RVs <= this may be missing from history
        # Snapshots backing list continue tokens: a paginated list reads a
        # consistent snapshot even under concurrent writes (etcd MVCC).
        self._continues: collections.OrderedDict[
            str, tuple[list[dict], str]] = \
            collections.OrderedDict()

    # -- internals ----------------------------------------------------------

    def _next_rv(self) -> str:
        self._rv += 1
        return str(self._rv)

    def _key(self, obj: dict) -> Key:
        m = ob.meta(obj)
        return Key(obj["apiVersion"], obj["kind"], m.get("namespace") or "", m["name"])

    def _store_put(self, key: Key, obj: dict) -> None:
        self._store[key] = obj
        self._kinds.setdefault((key.api_version, key.kind), {}) \
            .setdefault(key.namespace, {})[key.name] = obj

    def _store_pop(self, key: Key) -> dict | None:
        found = self._store.pop(key, None)
        if found is not None:
            buckets = self._kinds.get((key.api_version, key.kind))
            if buckets is not None:
                ns = buckets.get(key.namespace)
                if ns is not None:
                    ns.pop(key.name, None)
                    if not ns:
                        del buckets[key.namespace]
        return found

    def reset_stats(self) -> None:
        with self._lock:
            self.stats = collections.defaultdict(int)

    @contextlib.contextmanager
    def stats_paused(self):
        """Suspend op counting for harness reads: a benchmark's own
        assertions and completion sweeps must not pollute the op
        budgets it is measuring."""
        with self._lock:
            saved, self.stats = self.stats, collections.defaultdict(int)
        try:
            yield
        finally:
            with self._lock:
                self.stats = saved

    def _notify(self, etype: str, obj: dict) -> None:
        ev = WatchEvent(etype, ob.deep_copy(obj))
        if len(self._history) == self._history.maxlen and self._history:
            self._truncated_below = self._history[0][0]
        self._history.append((self._rv, ev))
        for w in self._watches:
            if w.closed:
                continue
            if (w.api_version, w.kind) != (obj["apiVersion"], obj["kind"]):
                continue
            ns = ob.meta(obj).get("namespace") or ""
            if w.namespace is not None and w.namespace != ns:
                continue
            w.q.put(WatchEvent(etype, ob.deep_copy(obj)))

    @property
    def current_rv(self) -> str:
        """The cluster's latest resourceVersion (ListMeta.resourceVersion)."""
        with self._lock:
            return str(self._rv)

    # -- admission ----------------------------------------------------------

    def add_admission_hook(self, fn: Callable[[str, dict], dict]) -> None:
        self._admission.append(fn)

    # -- verbs --------------------------------------------------------------

    def create(self, obj: dict) -> dict:
        with self._lock:
            obj = ob.deep_copy(obj)
            for hook in self._admission:
                obj = hook("CREATE", obj)
            key = self._key(obj)
            if key in self._store:
                raise ob.Conflict(f"{key.kind} {key.namespace}/{key.name} already exists")
            m = ob.meta(obj)
            m.setdefault("uid", str(uuid.uuid4()))
            m["resourceVersion"] = self._next_rv()
            m.setdefault("creationTimestamp", ob.now_iso())
            m.setdefault("generation", 1)
            self._store_put(key, obj)
            self.stats["create"] += 1
            self._notify("ADDED", obj)
            self._gc_if_orphaned(key)
            return ob.deep_copy(obj)

    def _gc_if_orphaned(self, key: Key) -> None:
        """Reap a just-created child whose owner died between the
        reconciler's read and this create (the check-then-act window the
        race tier's happens-before tracer exposed): the kube garbage
        collector deletes dependents with dangling owner uids on its
        next sync, so without this the fake leaks orphans forever."""
        obj = self._store.get(key)
        if obj is None:
            return
        refs = ob.meta(obj).get("ownerReferences") or []
        if not refs:
            return
        live = {ob.meta(o).get("uid") for o in self._store.values()}
        keep = [r for r in refs if not r.get("uid") or r["uid"] in live]
        if len(keep) == len(refs):
            return
        # replace, never mutate in place: list_snapshot hands out store
        # references as frozen-at-their-rv snapshots (informer caches
        # alias them), so every rv bump must land on a FRESH dict
        obj = ob.deep_copy(obj)
        m = ob.meta(obj)
        if keep:
            # prune dangling refs only — with the rv bump + MODIFIED
            # every other mutation path performs, or a watcher's cache
            # could resurrect the dangling ref through update()
            m["ownerReferences"] = keep
            m["resourceVersion"] = self._next_rv()
            self._store_put(key, obj)
            self._notify("MODIFIED", obj)
        elif m.get("finalizers"):
            m.pop("ownerReferences", None)
            m["deletionTimestamp"] = m.get("deletionTimestamp") or ob.now_iso()
            m["resourceVersion"] = self._next_rv()
            self._store_put(key, obj)
            self._notify("MODIFIED", obj)
        else:
            self._delete_now(key)

    def get(self, api_version: str, kind: str, name: str, namespace: str | None = None) -> dict:
        with self._lock:
            key = Key(api_version, kind, namespace or "", name)
            found = self._store.get(key)
            if found is None:
                raise ob.NotFound(f"{kind} {namespace or ''}/{name} not found")
            self.stats["get"] += 1
            return ob.deep_copy(found)

    def list(
        self,
        api_version: str,
        kind: str,
        namespace: str | None = None,
        label_selector: dict | str | None = None,
        field_selector: dict[str, str] | None = None,
    ) -> list[dict]:
        with self._lock:
            out = [ob.deep_copy(o) for o in self._select(
                api_version, kind, namespace, label_selector, field_selector)]
            self.stats["list_copied"] += len(out)
            return out

    def list_snapshot(
        self,
        api_version: str,
        kind: str,
        namespace: str | None = None,
        label_selector: dict | str | None = None,
        field_selector: dict[str, str] | None = None,
    ) -> tuple[list[dict], str]:
        """``(items, resourceVersion)`` WITHOUT copying: the internal
        read-only fast path for informer caches (``control/cache.py``)
        whose initial sync would otherwise deep-copy the whole store
        only to index it. Items are the STORED objects — callers must
        treat them as immutable and write only through the verbs."""
        with self._lock:
            return (self._select(api_version, kind, namespace,
                                 label_selector, field_selector),
                    str(self._rv))

    def _select(
        self,
        api_version: str,
        kind: str,
        namespace: str | None,
        label_selector: dict | str | None,
        field_selector: dict[str, str] | None,
    ) -> list[dict]:
        """Matching stored objects (no copy), via the kind/namespace
        index: list cost is O(matching bucket), not O(store)."""
        if isinstance(label_selector, str):
            label_selector = ob.parse_label_selector(label_selector)
        buckets = self._kinds.get((api_version, kind)) or {}
        if namespace is not None:
            spaces = [buckets.get(namespace or "", {})]
        else:
            spaces = list(buckets.values())
        out = []
        self.stats["list_calls"] += 1
        for ns in spaces:
            self.stats["list_scanned"] += len(ns)
            for obj in ns.values():
                if not ob.match_labels(ob.labels_of(obj), label_selector):
                    continue
                if not ob.match_fields(obj, field_selector):
                    continue
                out.append(obj)
        out.sort(key=lambda o: (ob.meta(o).get("namespace") or "",
                                ob.meta(o)["name"]))
        return out

    def list_page(
        self,
        api_version: str,
        kind: str,
        namespace: str | None = None,
        label_selector: dict | str | None = None,
        field_selector: dict[str, str] | None = None,
        limit: int | None = None,
        continue_token: str | None = None,
    ) -> tuple[list[dict], str, str]:
        """Paginated list: (items, continue, resourceVersion).

        A continue token pins the ORIGINAL snapshot, so later pages are
        consistent with page one even under concurrent writes (the etcd
        MVCC property kube's limit/continue contract guarantees)."""
        with self._lock:
            if continue_token:
                entry = self._continues.pop(continue_token, None)
                if entry is None:
                    raise ob.Expired(
                        f"continue token {continue_token!r} expired")
                remaining, rv = entry
            else:
                remaining = self.list(api_version, kind, namespace,
                                      label_selector, field_selector)
                rv = str(self._rv)
            # every page reports the SNAPSHOT's rv, not the current one:
            # a watch resumed from a paginated list's rv must replay
            # events for objects created mid-pagination (they are absent
            # from the snapshot) — the real apiserver's contract
            if limit is None or len(remaining) <= limit:
                return remaining, "", rv
            page, rest = remaining[:limit], remaining[limit:]
            token = uuid.uuid4().hex
            self._continues[token] = (rest, rv)
            while len(self._continues) > 64:  # bound snapshot memory
                self._continues.popitem(last=False)
            return page, token, rv

    def _update(self, obj: dict, subresource: str | None = None) -> dict:
        with self._lock:
            obj = ob.deep_copy(obj)
            key = self._key(obj)
            found = self._store.get(key)
            if found is None:
                raise ob.NotFound(f"{key.kind} {key.namespace}/{key.name} not found")
            m, fm = ob.meta(obj), ob.meta(found)
            if m.get("resourceVersion") and m["resourceVersion"] != fm["resourceVersion"]:
                raise ob.Conflict(
                    f"{key.kind} {key.name}: resourceVersion {m['resourceVersion']} "
                    f"!= {fm['resourceVersion']} (object was modified)"
                )
            if subresource == "status":
                # status updates cannot touch spec/metadata
                new = ob.deep_copy(found)
                new["status"] = obj.get("status", {})
            else:
                new = obj
                # generation bumps on spec change (apiserver semantics)
                if new.get("spec") != found.get("spec"):
                    ob.meta(new)["generation"] = fm.get("generation", 1) + 1
                else:
                    ob.meta(new)["generation"] = fm.get("generation", 1)
                new["metadata"] = {**fm, **ob.meta(new), "generation": ob.meta(new)["generation"]}
                # immutable fields
                new["metadata"]["uid"] = fm["uid"]
                new["metadata"]["creationTimestamp"] = fm["creationTimestamp"]
                if "deletionTimestamp" in fm:
                    new["metadata"]["deletionTimestamp"] = fm["deletionTimestamp"]
            ob.meta(new)["resourceVersion"] = self._next_rv()
            self._store_put(key, new)
            self.stats["update"] += 1
            self._notify("MODIFIED", new)
            self._maybe_finalize(key)
            return ob.deep_copy(self._store[key]) if key in self._store else ob.deep_copy(new)

    def update(self, obj: dict) -> dict:
        return self._update(obj)

    def update_status(self, obj: dict) -> dict:
        return self._update(obj, subresource="status")

    def patch(
        self,
        api_version: str,
        kind: str,
        name: str,
        patch: dict | list,
        namespace: str | None = None,
    ) -> dict:
        """dict → JSON merge patch; list → RFC6902 JSON patch."""
        with self._lock:
            self.stats["patch"] += 1
            cur = self.get(api_version, kind, name, namespace)
            # a patch carrying metadata.resourceVersion is an optimistic-
            # concurrency precondition: stale -> 409 (apiserver semantics)
            claimed = None
            if isinstance(patch, dict):
                claimed = (patch.get("metadata") or {}).get("resourceVersion")
            if claimed and claimed != ob.meta(cur)["resourceVersion"]:
                raise ob.Conflict(
                    f"{kind} {name}: patch resourceVersion {claimed} != "
                    f"{ob.meta(cur)['resourceVersion']} (object was modified)")
            if isinstance(patch, list):
                new = ob.json_patch(cur, patch)
            else:
                new = ob.merge_patch(cur, patch)
            ob.meta(new)["resourceVersion"] = ob.meta(cur)["resourceVersion"]
            return self._update(new)

    def apply(self, obj: dict, *, field_manager: str,
              force: bool = False) -> dict:
        """Server-side apply (simplified SSA — the apiserver's
        `application/apply-patch+yaml` PATCH; reference controllers'
        CreateOrUpdate flows assume a live apiserver provides this).

        `obj` is the manager's full declarative intent. Semantics kept
        from the real thing:
          - per-field ownership tracked in metadata.managedFields
            (one entry per manager, `fields` = list of leaf paths);
          - changing a field owned by another manager is a 409 Conflict
            naming the owner, unless force=true transfers ownership;
          - applying the same value as another manager shares ownership;
          - a field this manager owned but no longer applies is REMOVED
            (unless co-owned) — the declarative-deletion contract that
            merge-patch cannot express.
        Simplifications (documented, tested): leaf granularity is
        scalars/lists/empty-dicts (lists replace atomically — no
        strategic-merge list keys), and only Apply operations take
        ownership (plain updates don't steal fields).
        """
        if not field_manager:
            raise ob.Invalid("fieldManager is required for server-side apply")
        with self._lock:
            intent = ob.deep_copy(obj)
            m = ob.meta(intent)
            for sys_field in ("managedFields", "resourceVersion", "uid",
                              "creationTimestamp", "generation"):
                m.pop(sys_field, None)
            key = self._key(intent)
            paths = _ssa_leaf_paths(intent)
            found = self._store.get(key)
            if found is None:
                m["managedFields"] = _ssa_managed_fields(
                    {p: {field_manager} for p in paths})
                return self.create(intent)

            owners: dict[tuple, set] = {}
            for entry in ob.meta(found).get("managedFields") or []:
                for ps in entry.get("fields", []):
                    owners.setdefault(tuple(ps), set()).add(entry["manager"])
            conflicts = []
            for p in sorted(paths):
                # ownership guards the whole subtree: an intent path that
                # is a strict ancestor or descendant of another manager's
                # leaf (e.g. applying spec.resources.cpu under an owned
                # spec.resources scalar) restructures that field just as
                # surely as rewriting the exact path
                for q, mgrs in list(owners.items()):
                    others = mgrs - {field_manager}
                    if not others or not _ssa_overlaps(p, q):
                        continue
                    if p == q:
                        cur_val, has = _ssa_get(found, p)
                        new_val, _ = _ssa_get(intent, p)
                        if has and cur_val == new_val:
                            continue  # same value: share ownership
                        if new_val == {} and isinstance(cur_val, dict):
                            # re-asserting a map that now has entries
                            # composes, exactly like the ancestor case
                            continue
                    elif len(p) < len(q):
                        iv, _ = _ssa_get(intent, p)
                        if iv == {}:
                            # asserting an empty map composes with deeper
                            # owners (entries are preserved, not cleared)
                            continue
                    else:
                        cv, has = _ssa_get(found, q)
                        if has and isinstance(cv, dict):
                            # q's owner asserted a map; a deeper write
                            # adds/updates an entry, it does not
                            # restructure their field
                            continue
                    if force:
                        owners[q] -= others  # ownership transfers
                        if not owners[q]:
                            del owners[q]
                    else:
                        conflicts.append((p, q, sorted(others)))
            if conflicts:
                raise ob.Conflict(
                    f"{key.kind} {key.name}: server-side apply conflicts "
                    f"for manager {field_manager!r}: " + "; ".join(
                        (f"{'.'.join(p)}" if p == q
                         else f"{'.'.join(p)} (under {'.'.join(q)})")
                        + f" owned by {', '.join(o)}"
                        for p, q, o in conflicts))

            new = ob.deep_copy(found)
            prev = {p for p, mgrs in owners.items() if field_manager in mgrs}
            for p in prev - paths:
                # only q AT or BELOW p blocks deletion: a strict-ancestor
                # empty-map assert owns the map's existence, not this
                # leaf — counting it would orphan the field forever
                others_hold = any(
                    q[:len(p)] == p and (mgrs - {field_manager})
                    for q, mgrs in owners.items())
                if others_hold:
                    # co- or sub-owned (e.g. this manager owned the map,
                    # another owns an entry under it): relinquish only
                    owners[p].discard(field_manager)
                    if not owners[p]:
                        del owners[p]
                    continue
                _ssa_delete(new, p)
                owners.pop(p, None)
            for p in sorted(paths):
                val, _ = _ssa_get(intent, p)
                if val == {}:
                    cur, has = _ssa_get(new, p)
                    if has and isinstance(cur, dict):
                        # owning an empty map asserts its existence, it
                        # does not clear entries other managers put there
                        owners.setdefault(p, set()).add(field_manager)
                        continue
                _ssa_set(new, p, ob.deep_copy(val))
                owners.setdefault(p, set()).add(field_manager)
            ob.meta(new)["managedFields"] = _ssa_managed_fields(owners)
            ob.meta(new)["resourceVersion"] = \
                ob.meta(found)["resourceVersion"]
            return self._update(new)

    def delete(
        self,
        api_version: str,
        kind: str,
        name: str,
        namespace: str | None = None,
    ) -> None:
        with self._lock:
            key = Key(api_version, kind, namespace or "", name)
            found = self._store.get(key)
            if found is None:
                raise ob.NotFound(f"{kind} {namespace or ''}/{name} not found")
            if ob.meta(found).get("finalizers"):
                # graceful deletion: mark and wait for finalizers to clear
                # (the Profile finalizer path — profile_controller.go:48).
                # Replace-not-mutate: snapshot aliases stay frozen.
                if "deletionTimestamp" not in ob.meta(found):
                    found = ob.deep_copy(found)
                    m = ob.meta(found)
                    m["deletionTimestamp"] = ob.now_iso()
                    m["resourceVersion"] = self._next_rv()
                    self._store_put(key, found)
                    self._notify("MODIFIED", found)
                return
            self._delete_now(key)

    def _delete_now(self, key: Key) -> None:
        found = self._store_pop(key)
        if found is None:
            return
        self.stats["delete"] += 1
        # the DELETED event carries a fresh RV (apiserver semantics) — and
        # watch resume replays strictly-greater RVs, so reusing the prior
        # event's RV would silently drop deletions from resumed streams
        ob.meta(found)["resourceVersion"] = self._next_rv()
        self._notify("DELETED", found)
        self._gc_orphans(found)

    def _maybe_finalize(self, key: Key) -> None:
        """If an object marked for deletion has no finalizers left, reap it."""
        found = self._store.get(key)
        if found is None:
            return
        m = ob.meta(found)
        if "deletionTimestamp" in m and not m.get("finalizers"):
            self._delete_now(key)

    def _gc_orphans(self, deleted: dict) -> None:
        """OwnerReference cascade: children of a deleted controller-owner
        are deleted too (kube-controller-manager garbage collector; this is
        what lets JAXJob/Notebook deletion tear down pods/services)."""
        uid = ob.meta(deleted).get("uid")
        if not uid:
            return
        victims = [
            k
            for k, o in self._store.items()
            if any(r.get("uid") == uid for r in ob.meta(o).get("ownerReferences") or [])
        ]
        for k in victims:
            obj = self._store.get(k)
            if obj is None:
                continue
            refs = [r for r in ob.meta(obj).get("ownerReferences") or []
                    if r.get("uid") != uid]
            # replace-not-mutate (see _gc_if_orphaned): snapshot aliases
            # must stay frozen at the rv they were handed out under
            obj = ob.deep_copy(obj)
            m = ob.meta(obj)
            if refs:
                m["ownerReferences"] = refs
                self._store_put(k, obj)
                continue
            if m.get("finalizers"):
                m.pop("ownerReferences", None)
                m["deletionTimestamp"] = m.get("deletionTimestamp") or ob.now_iso()
                m["resourceVersion"] = self._next_rv()
                self._store_put(k, obj)
                self._notify("MODIFIED", obj)
            else:
                self._delete_now(k)

    # -- watch --------------------------------------------------------------

    def watch(
        self, api_version: str, kind: str, namespace: str | None = None,
        since_rv: str | None = None,
    ) -> "FakeWatchStream":
        """Subscribe to changes. With ``since_rv``, events AFTER that
        resourceVersion are replayed first (watch-cache resume); an RV
        older than the retained history raises 410 Expired and the
        client must relist."""
        with self._lock:
            w = _Watch(api_version, kind, namespace)
            if since_rv:
                rv = int(since_rv)
                if rv < self._truncated_below:
                    raise ob.Expired(
                        f"resourceVersion {since_rv} is too old "
                        f"(retained history starts at {self._truncated_below})")
                for ev_rv, ev in self._history:
                    if ev_rv <= rv:
                        continue
                    o = ev.object
                    if (o["apiVersion"], o["kind"]) != (api_version, kind):
                        continue
                    ns = ob.meta(o).get("namespace") or ""
                    if namespace is not None and namespace != ns:
                        continue
                    w.q.put(WatchEvent(ev.type, ob.deep_copy(o)))
            self._watches.append(w)
            return FakeWatchStream(self, w)

    # -- events (corev1 Events; consumed by the notebook controller's
    #    event-forwarding watch, notebook_controller.go:565-613, and JWA) --

    def record_event(
        self,
        involved: dict,
        reason: str,
        message: str,
        etype: str = "Normal",
        component: str = "kubeflow-tpu",
    ) -> dict:
        """Record through the shared EventRecorder (obs/events.py): real
        Event objects with count-dedup — a controller re-recording the
        same decision bumps count instead of flooding the store."""
        with self._lock:
            if self._recorder is None:
                from kubeflow_tpu_torch.obs.events import EventRecorder

                self._recorder = EventRecorder(self)
            recorder = self._recorder
        return recorder.event(involved, reason, message, etype,
                              component=component)

    # -- convenience --------------------------------------------------------

    def dump(self) -> list[dict]:
        """Snapshot of every stored object (copies) — test/harness helper
        for whole-cluster assertions like apply idempotency."""
        with self._lock:
            return [copy.deepcopy(o) for o in self._store.values()]

    def get_or_none(self, api_version: str, kind: str, name: str, namespace: str | None = None):
        try:
            return self.get(api_version, kind, name, namespace)
        except ob.NotFound:
            return None

    def remove_finalizer(self, obj: dict, finalizer: str) -> dict:
        cur = self.get(
            obj["apiVersion"], obj["kind"], ob.meta(obj)["name"], ob.meta(obj).get("namespace")
        )
        fins = [f for f in ob.meta(cur).get("finalizers") or [] if f != finalizer]
        ob.meta(cur)["finalizers"] = fins
        return self.update(cur)


class FakeWatchStream:
    def __init__(self, cluster: FakeCluster, w: _Watch):
        self._cluster = cluster
        self._w = w

    def __iter__(self) -> Iterator[WatchEvent]:
        while not self._w.closed:
            try:
                yield self._w.q.get(timeout=0.1)
            except queue.Empty:
                continue

    def poll(self, timeout: float = 0.0) -> WatchEvent | None:
        try:
            return self._w.q.get(timeout=timeout) if timeout else self._w.q.get_nowait()
        except queue.Empty:
            return None

    def stop(self) -> None:
        self._w.closed = True
        with self._cluster._lock:
            if self._w in self._cluster._watches:
                self._cluster._watches.remove(self._w)
