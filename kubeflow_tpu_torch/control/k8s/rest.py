"""RestClient — the same Client interface against a real apiserver.

Port of `kubeflow_tpu/control/k8s/rest.py`. The reference's controllers
get this from client-go / controller-runtime; here it is a thin HTTP(S)
layer with in-cluster config loading (serviceaccount token + CA, exactly
what client-go's rest.InClusterConfig does). Controllers written against
FakeCluster run unmodified against a live cluster by swapping this in.

The JAX package speaks HTTP through ``requests``; the card's machine has
no ``requests``, so this client speaks it through the standard library
(``http.client``), as the router's ``HttpTransport`` does. Kept from the
JAX client: the in-cluster token and CA, capped exponential backoff with
jitter that honours Retry-After, the retry matrix by verb, chunked lists
with continue tokens, and the relisting watch stream. Added: a watch's
``stop()`` shuts its socket down, so a reader blocked on it returns at
once instead of after the read timeout.
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import random
import socket
import ssl
import string
import threading
import time
from typing import Any
from urllib.parse import urlencode, urlsplit

from kubeflow_tpu_torch.control.k8s import objects as ob

log = logging.getLogger("kubeflow_tpu_torch.rest")

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

# Statuses where the server itself says "try again": it REFUSED the
# request, so no mutation was applied and retrying any verb is safe.
_REFUSED_STATUS = (429, 503)
# Statuses (and connection-level failures) where the request MAY have
# been applied before things went wrong — only verbs that are safe to
# replay get retried. GET re-reads; DELETE re-deleting is a 404 the
# callers already treat as done; PUT carries a resourceVersion
# precondition, so a replay of an applied update is a benign 409.
# POST (create) and PATCH (no precondition in general) are NOT replayed.
_AMBIGUOUS_STATUS = (500, 502, 504)
_REPLAY_SAFE = frozenset({"GET", "PUT", "DELETE"})
# What a failed exchange raises below the HTTP status: refused or reset
# connections, timeouts (OSError), and malformed or cut responses
_WIRE_ERRORS = (OSError, http.client.HTTPException)

# kind → (plural, cluster_scoped). CRDs registered by our operators are
# included so no discovery round-trip is needed for the common path.
_KINDS: dict[str, tuple[str, bool]] = {
    "Pod": ("pods", False),
    "Service": ("services", False),
    "Endpoints": ("endpoints", False),
    "Event": ("events", False),
    "Namespace": ("namespaces", True),
    "Node": ("nodes", True),
    "ConfigMap": ("configmaps", False),
    "Secret": ("secrets", False),
    "ServiceAccount": ("serviceaccounts", False),
    "PersistentVolumeClaim": ("persistentvolumeclaims", False),
    "ResourceQuota": ("resourcequotas", False),
    "Deployment": ("deployments", False),
    "StatefulSet": ("statefulsets", False),
    "Role": ("roles", False),
    "RoleBinding": ("rolebindings", False),
    "ClusterRole": ("clusterroles", True),
    "ClusterRoleBinding": ("clusterrolebindings", True),
    "StorageClass": ("storageclasses", True),
    "CustomResourceDefinition": ("customresourcedefinitions", True),
    "MutatingWebhookConfiguration": ("mutatingwebhookconfigurations", True),
    "Lease": ("leases", False),
    "VirtualService": ("virtualservices", False),
    "Gateway": ("gateways", False),
    "AuthorizationPolicy": ("authorizationpolicies", False),
    # kubeflow_tpu CRDs (the port keeps their kinds and plurals)
    "JAXJob": ("jaxjobs", False),
    "JAXService": ("jaxservices", False),
    "Notebook": ("notebooks", False),
    "Profile": ("profiles", True),
    "Tensorboard": ("tensorboards", False),
    "PodDefault": ("poddefaults", False),
    "StudyJob": ("studyjobs", False),
    "TpuDef": ("tpudefs", True),
}


# A resource name is the kind in lower-case ASCII (the control plane's
# one string normaliser, scheduler/topology.py, is for pool keys only)
_RESOURCE_CASE = str.maketrans(string.ascii_uppercase, string.ascii_lowercase)


def plural_of(kind: str) -> tuple[str, bool]:
    if kind in _KINDS:
        return _KINDS[kind]
    p = kind.translate(_RESOURCE_CASE)
    p = p + "es" if p.endswith(("s", "x", "ch")) else p[:-1] + "ies" if p.endswith("y") else p + "s"
    return p, False


def _label_selector_str(sel: dict | str | None) -> str | None:
    if sel is None or isinstance(sel, str):
        return sel
    parts = [f"{k}={v}" for k, v in (sel.get("matchLabels") or {}).items()]
    for e in sel.get("matchExpressions") or []:
        if e["operator"] == "Exists":
            parts.append(e["key"])
        elif e["operator"] == "In" and len(e.get("values", [])) == 1:
            parts.append(f"{e['key']}={e['values'][0]}")
        elif e["operator"] == "NotIn" and len(e.get("values", [])) == 1:
            parts.append(f"{e['key']}!={e['values'][0]}")
        else:
            raise ob.Invalid("string selectors support only single-value In/NotIn/Exists")
    return ",".join(parts)


class _Response:
    """A finished exchange: status, headers and the whole body."""

    def __init__(self, status: int, headers, body: bytes):
        self.status_code = status
        self.headers = headers
        self.content = body

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", errors="replace")

    def json(self) -> Any:
        return json.loads(self.content)


class RestClient:
    def __init__(
        self,
        base_url: str | None = None,
        token: str | None = None,
        ca_cert: str | bool | None = None,
        namespace: str | None = None,
        max_retries: int = 4,
        retry_base: float = 0.1,
        retry_cap: float = 2.0,
        rng: random.Random | None = None,
    ):
        if base_url is None:  # in-cluster config (rest.InClusterConfig analogue)
            host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            base_url = f"https://{host}:{port}"
            tok_path = os.path.join(SA_DIR, "token")
            if token is None and os.path.exists(tok_path):
                with open(tok_path) as f:
                    token = f.read().strip()
            ca_path = os.path.join(SA_DIR, "ca.crt")
            if ca_cert is None and os.path.exists(ca_path):
                ca_cert = ca_path
            ns_path = os.path.join(SA_DIR, "namespace")
            if namespace is None and os.path.exists(ns_path):
                with open(ns_path) as f:
                    namespace = f.read().strip()
        self.base_url = base_url.rstrip("/")
        url = urlsplit(self.base_url)
        if url.scheme not in ("http", "https") or not url.hostname:
            raise ValueError(f"apiserver URL {base_url!r} is not http(s)://host")
        self._host = url.hostname
        self._port = url.port or (443 if url.scheme == "https" else 80)
        self._prefix = url.path.rstrip("/")
        self._tls = None
        if url.scheme == "https":
            # ca_cert: a CA bundle path verifies the server; None/False
            # skip verification (the JAX client's verify=False default)
            if isinstance(ca_cert, str):
                self._tls = ssl.create_default_context(cafile=ca_cert)
            else:
                self._tls = ssl._create_unverified_context()
        self.namespace = namespace or "default"
        # transient-fault retry policy (client-go's rest.Request retries
        # 429/5xx the same way); _sleep/_rng injectable so tests pin the
        # schedule against a fake clock instead of actually sleeping
        self.max_retries = max_retries
        self.retry_base = retry_base
        self.retry_cap = retry_cap
        # seeded by default (DET discipline): the jitter schedule is
        # replayable unless a caller injects entropy on purpose
        self._sleep = time.sleep
        self._rng = rng if rng is not None else random.Random(0)
        self._headers = {"Accept": "application/json"}
        if token:
            self._headers["Authorization"] = f"Bearer {token}"
        # eager (not lazy-on-first-event): two worker threads racing a
        # lazy init would build two recorders with split dedup maps
        from kubeflow_tpu_torch.obs.events import EventRecorder

        self._event_recorder = EventRecorder(self)

    # -- the wire -----------------------------------------------------------

    def _connect(self, timeout: float) -> http.client.HTTPConnection:
        if self._tls is not None:
            return http.client.HTTPSConnection(
                self._host, self._port, timeout=timeout, context=self._tls)
        return http.client.HTTPConnection(self._host, self._port,
                                          timeout=timeout)

    def _open(self, method: str, path: str, params: dict | None = None,
              body: bytes | None = None, headers: dict | None = None,
              timeout: float = 30.0):
        """Send one request on a connection of its own; returns the
        connection and the response, whose body the caller reads (a
        watch reads it line by line) and then closes the connection."""
        url = self._prefix + path
        if params:
            url += "?" + urlencode(params)
        hdrs = dict(self._headers)
        if body is not None:
            hdrs.setdefault("Content-Type", "application/json")
        hdrs.update(headers or {})
        conn = self._connect(timeout)
        try:
            conn.request(method, url, body=body, headers=hdrs)
            return conn, conn.getresponse()
        except BaseException:
            conn.close()
            raise

    def _exchange(self, method: str, path: str, **kw) -> _Response:
        conn, resp = self._open(method, path, **kw)
        try:
            return _Response(resp.status, resp.headers, resp.read())
        finally:
            conn.close()

    # -- path construction --------------------------------------------------

    def _path(self, api_version: str, kind: str, namespace: str | None, name: str | None) -> str:
        prefix = "/api/v1" if api_version == "v1" else f"/apis/{api_version}"
        plural, cluster_scoped = plural_of(kind)
        parts = [prefix]
        if not cluster_scoped and namespace:
            parts += ["namespaces", namespace]
        parts.append(plural)
        if name:
            parts.append(name)
        return "/".join(parts)

    def _backoff(self, attempt: int, retry_after: str | None) -> float:
        """Capped exponential backoff with full jitter; a parseable
        Retry-After (seconds form) raises the floor — the server knows
        better than our schedule when it will be ready."""
        delay = min(self.retry_cap, self.retry_base * (2 ** attempt))
        delay *= self._rng.uniform(0.5, 1.5)
        if retry_after:
            try:
                delay = max(delay, float(retry_after))
            except ValueError:
                pass  # HTTP-date form: keep the computed backoff
        return delay

    def _req(self, method: str, path: str, params: dict | None = None,
             body: Any = None, data: str | None = None,
             headers: dict | None = None) -> Any:
        """One verb against the apiserver, with transient-fault retries.

        Retry matrix (see _REFUSED_STATUS/_AMBIGUOUS_STATUS above): a
        429/503 response is an explicit refusal — the mutation was not
        applied, so every verb retries, honoring Retry-After. 5xx
        responses and connection-level errors are ambiguous (the write
        may have landed), so only replay-safe verbs (GET/PUT/DELETE)
        retry; POST/PATCH surface the error to the reconcile loop,
        whose level-triggered retry re-reads before re-writing."""
        payload = None
        if body is not None:
            payload = json.dumps(body).encode()
        elif data is not None:
            payload = data.encode()
        attempt = 0
        while True:
            try:
                r = self._exchange(method, path, params=params,
                                   body=payload, headers=headers)
            except _WIRE_ERRORS as e:
                if method in _REPLAY_SAFE and attempt < self.max_retries:
                    delay = self._backoff(attempt, None)
                    log.warning("%s %s: connection error (%s); retry %d/%d "
                                "in %.2fs", method, path, e, attempt + 1,
                                self.max_retries, delay)
                    self._sleep(delay)
                    attempt += 1
                    continue
                raise
            code = r.status_code
            retryable = (
                code in _REFUSED_STATUS
                or (code in _AMBIGUOUS_STATUS and method in _REPLAY_SAFE))
            if retryable and attempt < self.max_retries:
                delay = self._backoff(attempt, r.headers.get("Retry-After"))
                log.warning("%s %s: HTTP %d; retry %d/%d in %.2fs",
                            method, path, code, attempt + 1,
                            self.max_retries, delay)
                self._sleep(delay)
                attempt += 1
                continue
            break

        def errtext() -> str:
            # surface the Status message (client-go behavior) — the
            # actionable part of e.g. an SSA conflict is its tail, which
            # raw-body truncation would cut. Non-dict JSON bodies (a
            # proxy's bare string/null) fall back to raw text.
            try:
                doc = r.json()
            except ValueError:
                doc = None
            if isinstance(doc, dict) and doc.get("message"):
                return doc["message"]
            return r.text[:300]

        if r.status_code == 404:
            raise ob.NotFound(f"{method} {path}: {errtext()}")
        if r.status_code == 409:
            raise ob.Conflict(f"{method} {path}: {errtext()}")
        if r.status_code == 422:
            raise ob.Invalid(f"{method} {path}: {errtext()}")
        if r.status_code >= 400:
            err = ob.ApiError(f"{method} {path}: HTTP {r.status_code}: {r.text[:500]}")
            err.code = r.status_code
            raise err
        return r.json() if r.content else None

    # -- Client verbs -------------------------------------------------------

    def create(self, obj: dict) -> dict:
        m = ob.meta(obj)
        path = self._path(obj["apiVersion"], obj["kind"], m.get("namespace"), None)
        return self._req("POST", path, body=obj)

    def get(self, api_version: str, kind: str, name: str, namespace: str | None = None) -> dict:
        return self._req("GET", self._path(api_version, kind, namespace, name))

    def get_or_none(self, api_version: str, kind: str, name: str, namespace: str | None = None):
        try:
            return self.get(api_version, kind, name, namespace)
        except ob.NotFound:
            return None

    # client-go's default list chunk size; page N+1 is fetched with the
    # server's continue token so large collections never need one
    # monolithic response
    list_chunk = 500

    def list(
        self,
        api_version: str,
        kind: str,
        namespace: str | None = None,
        label_selector: dict | str | None = None,
        field_selector: dict[str, str] | None = None,
    ) -> list[dict]:
        params: dict[str, str] = {}
        sel = _label_selector_str(label_selector)
        if sel:
            params["labelSelector"] = sel
        if field_selector:
            params["fieldSelector"] = ",".join(f"{k}={v}" for k, v in field_selector.items())
        items, _rv = self._list_chunked(api_version, kind, namespace, params)
        return items

    def _list_chunked(
        self, api_version: str, kind: str, namespace: str | None,
        params: dict[str, str],
    ) -> tuple[list[dict], str]:
        """Follow limit/continue pages; returns (items, list rv). A 410
        on a continue token (snapshot expired mid-pagination) restarts
        the list from scratch, as client-go does."""
        params = dict(params)
        if self.list_chunk:
            params["limit"] = str(self.list_chunk)
        path = self._path(api_version, kind, namespace, None)
        items: list[dict] = []
        rv = ""
        while True:
            try:
                out = self._req("GET", path, params=params)
            except ob.ApiError as e:
                if getattr(e, "code", None) == 410 and "continue" in params:
                    params.pop("continue")
                    items = []
                    continue
                raise
            items.extend(out.get("items", []))
            meta = out.get("metadata") or {}
            rv = meta.get("resourceVersion", rv)
            cont = meta.get("continue", "")
            if not cont:
                break
            params["continue"] = cont
        for it in items:  # apiserver omits these on list items
            it.setdefault("apiVersion", api_version)
            it.setdefault("kind", kind)
        return items, rv

    def update(self, obj: dict) -> dict:
        m = ob.meta(obj)
        path = self._path(obj["apiVersion"], obj["kind"], m.get("namespace"), m["name"])
        return self._req("PUT", path, body=obj)

    def update_status(self, obj: dict) -> dict:
        m = ob.meta(obj)
        path = self._path(obj["apiVersion"], obj["kind"], m.get("namespace"), m["name"]) + "/status"
        return self._req("PUT", path, body=obj)

    def patch(
        self,
        api_version: str,
        kind: str,
        name: str,
        patch: dict | list,
        namespace: str | None = None,
    ) -> dict:
        path = self._path(api_version, kind, namespace, name)
        ctype = (
            "application/json-patch+json"
            if isinstance(patch, list)
            else "application/merge-patch+json"
        )
        return self._req(
            "PATCH", path, data=json.dumps(patch), headers={"Content-Type": ctype}
        )

    def apply(self, obj: dict, *, field_manager: str,
              force: bool = False) -> dict:
        """Server-side apply: PATCH the manager's full intent with the
        apply-patch content type. Conflicting fields owned by another
        manager raise Conflict (409) unless force=True transfers
        ownership. Same signature as FakeCluster.apply, so controllers
        written against either backend can declare state identically."""
        m = ob.meta(obj)
        path = self._path(obj["apiVersion"], obj["kind"],
                          m.get("namespace"), m["name"])
        params = {"fieldManager": field_manager}
        if force:
            params["force"] = "true"
        return self._req(
            "PATCH", path, params=params, data=json.dumps(obj),
            headers={"Content-Type": "application/apply-patch+yaml"})

    def delete(self, api_version: str, kind: str, name: str, namespace: str | None = None) -> None:
        self._req("DELETE", self._path(api_version, kind, namespace, name))

    def record_event(
        self,
        involved: dict,
        reason: str,
        message: str,
        etype: str = "Normal",
        component: str = "kubeflow-tpu",
    ) -> dict:
        """Same EventRecorder (count-dedup) as FakeCluster.record_event —
        controllers get identical event semantics on either backend."""
        return self._event_recorder.event(involved, reason, message, etype,
                                          component=component)

    def watch(self, api_version: str, kind: str, namespace: str | None = None):
        """Streaming watch (chunked JSON lines), reconnecting on EOF."""
        return _RestWatchStream(self, api_version, kind, namespace)


class _RestWatchStream:
    """Reconnecting watch with the conformance behaviors controllers rely
    on against a real apiserver (notebook_controller.go:519-613's informer
    machinery provides the same): resume-from-resourceVersion after a
    dropped connection, BOOKMARK heartbeats so the resume point advances
    on idle streams, and 410 Gone -> relist. The relist re-yields every
    live object as MODIFIED (a resync for level-triggered reconcilers)
    and — informer-style — synthesizes DELETED for objects this stream
    had seen that vanished during the gap (objects that existed before
    the stream started are outside its view, as with any watch-from-now).

    ``stop()`` ends the stream from any thread: it shuts the open
    connection's socket down, which wakes a reader blocked on it."""

    def __init__(self, client: RestClient, api_version: str, kind: str, namespace: str | None):
        self._c = client
        self._args = (api_version, kind, namespace)
        self._stopped = threading.Event()
        self._lock = threading.Lock()
        self._conn: http.client.HTTPConnection | None = None
        # last-known FULL object per (ns, name) this stream has yielded
        # and not seen deleted — the informer store the 410 relist diffs
        # against. Synthesized DELETED events must carry the full last
        # state (labels, ownerReferences): owner/label mappers in the
        # controllers read them, and a bare {name} event would be
        # silently dropped (client-go's DeletedFinalStateUnknown exists
        # for exactly this).
        self._known: dict[tuple[str, str], dict] = {}

    @staticmethod
    def _key(obj: dict) -> tuple[str, str]:
        m = ob.meta(obj)
        return (m.get("namespace") or "", m.get("name") or "")

    def _relist(self):
        from kubeflow_tpu_torch.control.k8s.fake import WatchEvent

        api_version, kind, namespace = self._args
        items, rv = self._c._list_chunked(api_version, kind, namespace, {})
        live: dict[tuple[str, str], dict] = {}
        for it in items:
            live[self._key(it)] = it
            yield WatchEvent("MODIFIED", it)
        for key, last_state in self._known.items():
            if key not in live:
                yield WatchEvent("DELETED", last_state)
        self._known = live
        return rv

    def _connect(self, params: dict):
        """Open the watch request; None when stopped meanwhile."""
        api_version, kind, namespace = self._args
        path = self._c._path(api_version, kind, namespace, None)
        conn, resp = self._c._open("GET", path, params=params, timeout=300)
        with self._lock:
            if self._stopped.is_set():
                conn.close()
                return None
            self._conn = conn
        return resp

    def _disconnect(self) -> None:
        with self._lock:
            conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()

    def __iter__(self):
        from kubeflow_tpu_torch.control.k8s.fake import WatchEvent

        rv = ""
        while not self._stopped.is_set():
            params = {"watch": "1", "allowWatchBookmarks": "true"}
            if rv:
                params["resourceVersion"] = rv
            try:
                resp = self._connect(params)
            except _WIRE_ERRORS:
                if self._stopped.wait(0.2):
                    return
                continue
            if resp is None:
                return
            if resp.status not in (200, 410):
                self._disconnect()  # a refusal: retry after a pause
                if self._stopped.wait(0.2):
                    return
                continue
            if resp.status == 410:
                # our resume point predates the server's watch cache:
                # relist and resume from the fresh list's RV. A failed
                # relist must not kill the stream — retry (the next
                # reconnect 410s again and lands back here).
                self._disconnect()
                try:
                    gen = self._relist()
                    while True:
                        try:
                            yield next(gen)
                        except StopIteration as fin:
                            rv = fin.value or ""
                            break
                except (ob.ApiError, *_WIRE_ERRORS):
                    self._stopped.wait(0.2)
                continue
            try:
                while True:
                    line = resp.readline()
                    if self._stopped.is_set() or not line:
                        break
                    line = line.strip()
                    if not line:
                        continue
                    ev = json.loads(line)
                    obj = ev.get("object", {})
                    etype = ev.get("type")
                    rv = ob.meta(obj).get("resourceVersion", rv)
                    if etype == "BOOKMARK":
                        continue
                    if etype in ("ADDED", "MODIFIED"):
                        self._known[self._key(obj)] = obj
                    elif etype == "DELETED":
                        self._known.pop(self._key(obj), None)
                    if etype in ("ADDED", "MODIFIED", "DELETED"):
                        yield WatchEvent(etype, obj)
            except (ValueError, *_WIRE_ERRORS):
                pass  # a cut or garbled stream: reconnect from rv
            finally:
                self._disconnect()

    def stop(self):
        self._stopped.set()
        with self._lock:
            conn = self._conn
        sock = getattr(conn, "sock", None)
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # already closed
