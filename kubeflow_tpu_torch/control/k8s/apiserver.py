"""HTTP apiserver speaking Kubernetes JSON, backed by FakeCluster.

This is the bridge that lets RestClient (control/k8s/rest.py) — the
client-go analogue the controllers use against a live cluster — be
exercised hermetically: the full HTTP surface (CRUD, PUT /status,
merge/json PATCH, label/field selectors, 404/409 status codes, chunked
watch streams) is served by a real ThreadingHTTPServer in front of the
same in-memory store the unit tests use. A controller runs identically
on FakeCluster (direct) and RestClient->ApiServer->FakeCluster (HTTP);
tests/test_torch_control_rest.py asserts exactly that.

The reference had nothing like this: its controllers are only integration
-tested against per-CI GKE clusters (SURVEY.md §4 tier 4).

Port of `kubeflow_tpu/control/k8s/apiserver.py`: the same code over the
port's own modules. It serves every kind of the port's REST client's
table, JAXService among them.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster
from kubeflow_tpu_torch.control.k8s.rest import _KINDS

log = logging.getLogger("kubeflow_tpu_torch.apiserver")

# plural -> (Kind, cluster_scoped), inverted from the client's table so
# both sides of the HTTP boundary share one source of truth.
_BY_PLURAL: dict[str, tuple[str, bool]] = {
    plural: (kind, cluster_scoped)
    for kind, (plural, cluster_scoped) in _KINDS.items()
}


def _status(code: int, message: str, reason: str = "") -> dict:
    return {"kind": "Status", "apiVersion": "v1", "status": "Failure",
            "code": code, "reason": reason, "message": message}


class _Parsed:
    def __init__(self, api_version: str, kind: str, namespace: str | None,
                 name: str | None, subresource: str | None):
        self.api_version = api_version
        self.kind = kind
        self.namespace = namespace
        self.name = name
        self.subresource = subresource


def parse_api_path(path: str) -> _Parsed:
    """/api/v1/... or /apis/{group}/{version}/... ->
    (api_version, Kind, namespace, name, subresource)."""
    parts = [p for p in path.split("/") if p]
    if not parts:
        raise ValueError("empty path")
    if parts[0] == "api":
        if len(parts) < 2 or parts[1] != "v1":
            raise ValueError(f"unknown core version {path}")
        api_version, rest = "v1", parts[2:]
    elif parts[0] == "apis":
        if len(parts) < 3:
            raise ValueError(f"bad group path {path}")
        api_version, rest = f"{parts[1]}/{parts[2]}", parts[3:]
    else:
        raise ValueError(f"not an api path: {path}")

    namespace = None
    # "namespaces" is a scope prefix only when a resource segment follows
    # (/api/v1/namespaces/{ns}/{plural}...); /api/v1/namespaces[/{name}]
    # addresses the Namespace resource itself.
    if rest and rest[0] == "namespaces" and len(rest) >= 3:
        namespace, rest = rest[1], rest[2:]
    if not rest:
        raise ValueError(f"no resource in path {path}")
    plural, rest = rest[0], rest[1:]
    if plural not in _BY_PLURAL:
        raise LookupError(f"unknown resource {plural!r}")
    kind, cluster_scoped = _BY_PLURAL[plural]
    if cluster_scoped:
        namespace = None
    name = rest[0] if rest else None
    subresource = rest[1] if len(rest) > 1 else None
    return _Parsed(api_version, kind, namespace, name, subresource)


class ApiServer:
    """Serves a FakeCluster over the Kubernetes REST wire format."""

    def __init__(self, cluster: FakeCluster | None = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.cluster = cluster if cluster is not None else FakeCluster()
        self._shutting_down = False
        self._drop_generation = 0  # bumped by drop_watches()
        self.bookmark_interval = 1.0  # seconds of idle between BOOKMARKs
        server_ref = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                log.debug("%s %s", self.address_string(), fmt % args)

            def _body(self):
                length = int(self.headers.get("Content-Length") or 0)
                return self.rfile.read(length) if length else b""

            def _send_json(self, code: int, payload) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _fail(self, e: Exception) -> None:
                if isinstance(e, ob.NotFound):
                    self._send_json(404, _status(404, str(e), "NotFound"))
                elif isinstance(e, ob.Conflict):
                    self._send_json(409, _status(409, str(e), "Conflict"))
                elif isinstance(e, ob.Expired):
                    self._send_json(410, _status(410, str(e), "Expired"))
                elif isinstance(e, ob.Invalid):
                    # 422 round-trips to ob.Invalid in RestClient._req:
                    # a controller catching Invalid behaves identically
                    # on FakeCluster and over HTTP
                    self._send_json(422, _status(422, str(e), "Invalid"))
                elif isinstance(e, (ValueError, LookupError)):
                    self._send_json(400, _status(400, str(e), "BadRequest"))
                else:
                    log.exception("apiserver internal error")
                    self._send_json(500, _status(500, str(e), "InternalError"))

            def _handle(self, verb: str) -> None:
                try:
                    url = urlparse(self.path)
                    q = parse_qs(url.query)
                    p = parse_api_path(url.path)
                    server_ref._dispatch(self, verb, p, q)
                except Exception as e:  # noqa: BLE001 — maps to Status codes
                    try:
                        self._fail(e)
                    except (BrokenPipeError, ConnectionResetError):
                        pass

            def do_GET(self):
                self._handle("GET")

            def do_POST(self):
                self._handle("POST")

            def do_PUT(self):
                self._handle("PUT")

            def do_PATCH(self):
                self._handle("PATCH")

            def do_DELETE(self):
                self._handle("DELETE")

        class _Server(ThreadingHTTPServer):
            def handle_error(self, request, client_address):
                # watch clients disconnect routinely (reconnect loops,
                # process exit); a reset mid-request-read is not an error
                import sys as _sys

                etype = _sys.exc_info()[0]
                if etype in (BrokenPipeError, ConnectionResetError):
                    return
                super().handle_error(request, client_address)

        self._server = _Server((host, port), _Handler)
        self.port = self._server.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._thread: threading.Thread | None = None

    # -- request dispatch ---------------------------------------------------

    def _dispatch(self, h, verb: str, p: _Parsed, q: dict) -> None:
        c = self.cluster
        if verb == "GET" and p.name is None and q.get("watch", ["0"])[0] in ("1", "true"):
            self._serve_watch(h, p, q)
            return
        if verb == "GET" and p.name is None:
            label = (q.get("labelSelector") or [None])[0]
            fields = None
            fsel = (q.get("fieldSelector") or [None])[0]
            if fsel:
                fields = dict(kv.split("=", 1) for kv in fsel.split(","))
            limit = (q.get("limit") or [None])[0]
            cont = (q.get("continue") or [None])[0]
            items, next_cont, rv = c.list_page(
                p.api_version, p.kind, p.namespace,
                label_selector=label, field_selector=fields,
                limit=int(limit) if limit else None, continue_token=cont)
            meta: dict = {"resourceVersion": rv}
            if next_cont:
                meta["continue"] = next_cont
            h._send_json(200, {"apiVersion": p.api_version,
                               "kind": f"{p.kind}List", "metadata": meta,
                               "items": items})
            return
        if verb == "GET":
            h._send_json(200, c.get(p.api_version, p.kind, p.name, p.namespace))
            return
        if verb == "POST":
            obj = json.loads(h._body())
            obj.setdefault("apiVersion", p.api_version)
            obj.setdefault("kind", p.kind)
            if p.namespace:
                ob.meta(obj).setdefault("namespace", p.namespace)
            h._send_json(201, c.create(obj))
            return
        if verb == "PUT":
            obj = json.loads(h._body())
            if p.subresource == "status":
                h._send_json(200, c.update_status(obj))
            else:
                h._send_json(200, c.update(obj))
            return
        if verb == "PATCH":
            patch = json.loads(h._body())
            ctype = h.headers.get("Content-Type") or ""
            if "apply-patch" in ctype:
                # server-side apply: PATCH with apply-patch content type
                # (the body is the manager's full intent; JSON is a YAML
                # subset, so kubectl-style +yaml bodies parse fine)
                fm = (q.get("fieldManager") or [""])[0]
                force = (q.get("force") or ["false"])[0] in ("1", "true")
                patch.setdefault("apiVersion", p.api_version)
                patch.setdefault("kind", p.kind)
                ob.meta(patch).setdefault("name", p.name)
                if p.namespace:
                    ob.meta(patch).setdefault("namespace", p.namespace)
                # a body naming a DIFFERENT object than the URL must be
                # a 400, never a silent apply elsewhere (apiserver
                # semantics: the URL is authoritative)
                got = (patch["apiVersion"], patch["kind"],
                       ob.meta(patch).get("name"),
                       ob.meta(patch).get("namespace") or None)
                want = (p.api_version, p.kind, p.name, p.namespace)
                if got != want:
                    raise ValueError(
                        f"apply body addresses {got}, URL addresses "
                        f"{want}")
                h._send_json(200, c.apply(patch, field_manager=fm,
                                          force=force))
                return
            h._send_json(200, c.patch(p.api_version, p.kind, p.name, patch,
                                      p.namespace))
            return
        if verb == "DELETE":
            c.delete(p.api_version, p.kind, p.name, p.namespace)
            h._send_json(200, {"kind": "Status", "status": "Success"})
            return
        h._send_json(405, _status(405, f"verb {verb} not supported"))

    def _serve_watch(self, h, p: _Parsed, q: dict | None = None) -> None:
        """Chunked stream of {"type", "object"} JSON lines — the
        watch wire format RestClient._RestWatchStream consumes.

        Honors ``resourceVersion`` (resume: replay missed events, or 410
        Gone past the retained window), and ``allowWatchBookmarks``
        (periodic BOOKMARK events carrying the latest RV so a resumed
        watch never rewinds further than its last heartbeat)."""
        q = q or {}
        since_rv = (q.get("resourceVersion") or [None])[0]
        bookmarks = (q.get("allowWatchBookmarks") or ["false"])[0] in (
            "1", "true")
        try:
            stream = self.cluster.watch(p.api_version, p.kind, p.namespace,
                                        since_rv=since_rv)
        except ob.Expired as e:
            h._send_json(410, _status(410, str(e), "Expired"))
            return
        gen = self._drop_generation
        try:
            h.send_response(200)
            h.send_header("Content-Type", "application/json")
            h.send_header("Transfer-Encoding", "chunked")
            h.end_headers()

            def chunk(data: bytes) -> None:
                h.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                h.wfile.flush()

            idle = 0.0
            while not self._shutting_down:
                if gen != self._drop_generation:
                    break  # test hook: forcibly drop active watch streams
                # snapshot BEFORE polling: an event that lands during the
                # poll window is delivered by it; one landing after
                # postdates this rv — either way the bookmark never
                # advertises an rv covering an undelivered event
                rv_snapshot = self.cluster.current_rv
                ev = stream.poll(timeout=0.1)
                if ev is None:
                    idle += 0.1
                    if bookmarks and idle >= self.bookmark_interval:
                        idle = 0.0
                        bm = {"type": "BOOKMARK",
                              "object": {"apiVersion": p.api_version,
                                         "kind": p.kind,
                                         "metadata": {"resourceVersion":
                                                      rv_snapshot}}}
                        chunk(json.dumps(bm).encode() + b"\n")
                    continue
                idle = 0.0
                line = json.dumps({"type": ev.type, "object": ev.object})
                chunk(line.encode() + b"\n")
            chunk(b"")  # terminating chunk on clean shutdown / drop
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away: normal watch teardown
        finally:
            stream.stop()

    def drop_watches(self) -> None:
        """Failure injection: terminate every active watch stream (the
        mid-stream disconnect a real apiserver/LB produces on timeouts);
        clients must resume from their last seen resourceVersion."""
        self._drop_generation += 1

    # -- lifecycle ----------------------------------------------------------

    def serve_background(self) -> "ApiServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="fake-apiserver")
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._shutting_down = True
        self._server.shutdown()
        self._server.server_close()


def client_for(server: ApiServer):
    """A RestClient wired to this apiserver (plain HTTP, no auth)."""
    from kubeflow_tpu_torch.control.k8s.rest import RestClient

    return RestClient(base_url=server.url, token="test-token", ca_cert=False)
