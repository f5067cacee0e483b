"""Tiny stdlib HTTP service toolkit (port of kubeflow_tpu/utils/httpd.py):
a method+path-pattern router over ThreadingHTTPServer with JSON helpers,
health routes and a Prometheus /metrics endpoint that renders the port's
own registry (runtime/metrics.py REGISTRY).

Routes are registered as ("GET", "/api/namespaces/{ns}/notebooks", fn);
``{name}`` segments capture path params passed to fn(req) via req.params.
Handlers return (status, body) | body — dicts are JSON-encoded.
"""

from __future__ import annotations

import json
import logging
import re
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable
from urllib.parse import parse_qs, urlparse

log = logging.getLogger("kubeflow_tpu_torch.httpd")


@dataclass
class HttpReq:
    method: str
    path: str
    params: dict[str, str]
    query: dict[str, list[str]]
    headers: dict[str, str]
    body: bytes = b""

    def json(self) -> Any:
        return json.loads(self.body or b"null")

    def header(self, name: str, default: str = "") -> str:
        return self.headers.get(name.lower(), default)

    def q1(self, name: str, default: str = "") -> str:
        vals = self.query.get(name)
        return vals[0] if vals else default


@dataclass
class HttpResp:
    status: int = 200
    body: bytes = b""
    content_type: str = "application/json"
    headers: dict[str, str] = field(default_factory=dict)


Handler = Callable[[HttpReq], Any]


def _compile(pattern: str) -> re.Pattern:
    # {name} captures one path segment; {name*} captures the rest of the
    # path including slashes (catch-all routes: redirect/echo services).
    rx = re.sub(r"\{([a-zA-Z_][a-zA-Z0-9_]*)\*\}", r"(?P<\1>.+)", pattern)
    rx = re.sub(r"\{([a-zA-Z_][a-zA-Z0-9_]*)\}", r"(?P<\1>[^/]+)", rx)
    return re.compile("^" + rx + "$")


class Router:
    def __init__(self, name: str = "svc"):
        self.name = name
        self._routes: list[tuple[str, re.Pattern, Handler]] = []
        self._middlewares: list[Callable[[HttpReq], HttpResp | None]] = []

    def route(self, method: str, pattern: str, fn: Handler) -> None:
        self._routes.append((method.upper(), _compile(pattern), fn))

    def middleware(self, fn: Callable[[HttpReq], "HttpResp | None"]) -> None:
        """Runs before routing; returning an HttpResp short-circuits."""
        self._middlewares.append(fn)

    def dispatch(self, req: HttpReq) -> HttpResp:
        for mw in self._middlewares:
            resp = mw(req)
            if resp is not None:
                return resp
        for method, rx, fn in self._routes:
            if method != req.method:
                continue
            m = rx.match(req.path)
            if m:
                req.params = m.groupdict()
                try:
                    return to_resp(fn(req))
                except ApiHttpError as e:
                    return json_resp({"error": e.message}, e.status,
                                     headers=e.headers)
                except Exception as e:  # 500 with structured body
                    log.exception("%s: %s %s failed", self.name, req.method, req.path)
                    return json_resp({"error": str(e)}, 500)
        return json_resp({"error": f"no route for {req.method} {req.path}"}, 404)


class ApiHttpError(Exception):
    def __init__(self, status: int, message: str,
                 headers: dict[str, str] | None = None):
        super().__init__(message)
        self.status = status
        self.message = message
        # extra response headers (e.g. Retry-After on a 429/503)
        self.headers = headers or {}


def json_resp(obj: Any, status: int = 200,
              headers: dict[str, str] | None = None) -> HttpResp:
    return HttpResp(status=status, body=json.dumps(obj).encode(),
                    headers=headers or {})


def to_resp(out: Any) -> HttpResp:
    if isinstance(out, HttpResp):
        return out
    if isinstance(out, tuple) and len(out) == 2 and isinstance(out[0], int):
        status, body = out
        return json_resp(body, status) if not isinstance(body, HttpResp) else body
    if isinstance(out, (dict, list)):
        return json_resp(out)
    if isinstance(out, str):
        return HttpResp(body=out.encode(), content_type="text/plain; charset=utf-8")
    if out is None:
        return HttpResp(status=204)
    raise TypeError(f"handler returned unsupported type {type(out)}")


def add_metrics_route(router: Router) -> None:
    """Expose the port's metrics registry at /metrics (text format
    0.0.4)."""

    def metrics(req: HttpReq) -> HttpResp:
        from kubeflow_tpu_torch.runtime.metrics import REGISTRY

        return HttpResp(body=REGISTRY.render().encode(),
                        content_type="text/plain; version=0.0.4")

    router.route("GET", "/metrics", metrics)


def add_health_routes(router: Router) -> None:
    """Liveness and readiness routes."""
    router.route("GET", "/healthz", lambda r: {"status": "ok"})
    router.route("GET", "/readyz", lambda r: {"status": "ok"})


class HttpService:
    """ThreadingHTTPServer wrapper; serve_background() for tests and
    embedding, port 0 picks a free port."""

    def __init__(self, router: Router, host: str = "0.0.0.0", port: int = 0):
        self.router = router
        router_ref = router

        class _Handler(BaseHTTPRequestHandler):
            def _serve(self):
                parsed = urlparse(self.path)
                length = int(self.headers.get("Content-Length") or 0)
                req = HttpReq(
                    method=self.command,
                    path=parsed.path,
                    params={},
                    query=parse_qs(parsed.query),
                    headers={k.lower(): v for k, v in self.headers.items()},
                    body=self.rfile.read(length) if length else b"",
                )
                resp = router_ref.dispatch(req)
                self.send_response(resp.status)
                self.send_header("Content-Type", resp.content_type)
                self.send_header("Content-Length", str(len(resp.body)))
                for k, v in resp.headers.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(resp.body)

            do_GET = do_POST = do_PUT = do_PATCH = do_DELETE = _serve

            def log_message(self, fmt, *args):  # route through logging
                log.debug("%s %s", self.address_string(), fmt % args)

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self.port = self._server.server_address[1]
        self._thread: threading.Thread | None = None

    def serve_background(self) -> "HttpService":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name=f"http-{self.router.name}"
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._server.serve_forever()

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
