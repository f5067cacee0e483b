"""tpctl REST plane: create/get deployments + worker pool + GC.

Port of `kubeflow_tpu/tpctl/server.py`; its subprocess workers run
`python -m kubeflow_tpu_torch.tpctl.cli apply`.

The router/kfctlServer/gcServer triple of the reference
(bootstrap/cmd/bootstrap/app/{router,kfctlServer,gcServer}.go) collapsed
into one process:

- POST /tpctl/apps/v1/create  — enqueue a deployment (router.go:407;
  per-deployment serialization through a channel, kfctlServer.go:87)
- POST /tpctl/apps/v1/get     — poll status (kfctlServer.go:373-384)
- one worker thread per deployment name (the per-deployment StatefulSet
  pod of router.go:275-357 becomes a thread; same isMatch conflict
  rejection, kfctlServer.go:531)
- GC loop deleting deployments idle past TTL (gcServer.go:56-86,
  LastRequestTime annotation)
"""

from __future__ import annotations

import logging
import queue
import threading
import time

from kubeflow_tpu_torch.tpctl.apply import Coordinator
from kubeflow_tpu_torch.tpctl.tpudef import TpuDef
from kubeflow_tpu_torch.utils import httpd
from kubeflow_tpu_torch.utils.httpd import ApiHttpError, HttpReq, Router

log = logging.getLogger("kubeflow_tpu_torch.tpctl.server")

DEFAULT_TTL_S = 3600.0


class _Worker:
    """Per-deployment worker: owns a queue (cap 10, kfctlServer.go:87)."""

    def __init__(self, name: str, coordinator: Coordinator | None):
        self.name = name
        self.coordinator = coordinator
        self.q: "queue.Queue[TpuDef]" = queue.Queue(maxsize=10)
        self.last_request = time.monotonic()
        self.current_spec: dict | None = None
        self.error: str | None = None
        # applies submitted but not yet finished (queued + in flight):
        # incremented under the server lock in submit(), decremented by
        # the worker thread when an apply completes. GC must never reap
        # a worker with pending > 0 — a reaped-but-still-applying worker
        # plus a fresh one for the same name would break the
        # per-deployment serialization this class exists to provide.
        self.pending = 0
        self._plock = threading.Lock()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name=f"tpctl-worker-{name}")
        self.thread.start()

    def _apply(self, cfg: TpuDef) -> None:
        self.coordinator.apply(cfg)

    def _run(self):
        while True:
            cfg = self.q.get()
            if cfg is None:
                return
            try:
                self._apply(cfg)
                self.error = None
            except Exception as e:
                log.exception("deployment %s failed", self.name)
                self.error = str(e)
            finally:
                with self._plock:
                    self.pending -= 1

    def submit(self, cfg: TpuDef) -> None:
        spec = cfg.to_object()["spec"]
        if self.current_spec is not None and self.current_spec != spec:
            # isMatch guard (kfctlServer.go:531): same name, different spec
            # is a conflict, not a silent overwrite
            raise ApiHttpError(409, f"deployment {self.name} exists with a "
                               "different spec; delete it first")
        self.current_spec = spec
        self.last_request = time.monotonic()
        try:
            # never block: submit() runs under the server-wide lock, and a
            # blocking put on a full queue would freeze the whole REST
            # plane for up to one apply duration (30 min in subprocess
            # mode). A full queue is backpressure — tell the client.
            self.q.put_nowait(cfg)
        except queue.Full:
            raise ApiHttpError(
                429, f"deployment {self.name} has {self.q.maxsize} applies "
                     "queued; retry later")
        with self._plock:
            self.pending += 1

    @property
    def busy(self) -> bool:
        with self._plock:
            return self.pending > 0


class _SubprocessWorker(_Worker):
    """Per-deployment OS-process isolation: the apply runs in a child
    `tpctl apply` process against the apiserver, so a poisoned apply —
    segfault in a native dep, OOM kill, runaway memory — takes down one
    deployment's worker, never the REST plane. This is the
    StatefulSet-pod-per-deployment isolation of router.go:275-357 with a
    subprocess standing in for the pod; the thread mode keeps the
    capability without the isolation for hermetic/dry-run servers."""

    APPLY_TIMEOUT_S = 1800.0

    def __init__(self, name: str, apiserver_url: str):
        self.apiserver_url = apiserver_url
        self.last_pid: int | None = None
        super().__init__(name, coordinator=None)

    def _apply(self, cfg: TpuDef) -> None:
        import subprocess
        import sys
        import tempfile

        with tempfile.NamedTemporaryFile(
                "w", suffix=".yaml", prefix=f"tpudef-{self.name}-",
                delete=False) as f:
            f.write(cfg.dump())
            path = f.name
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", "kubeflow_tpu_torch.tpctl.cli", "apply",
                 "-f", path, "--server", self.apiserver_url],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            self.last_pid = proc.pid
            try:
                out, _ = proc.communicate(timeout=self.APPLY_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                # communicate() does NOT kill on timeout: an orphaned
                # child would keep mutating the cluster while the next
                # queue item spawns a concurrent apply for the same
                # deployment — kill and reap before surfacing the error
                proc.kill()
                proc.communicate()
                raise RuntimeError(
                    f"apply subprocess killed after "
                    f"{self.APPLY_TIMEOUT_S:.0f}s timeout")
            if proc.returncode != 0:
                raise RuntimeError(
                    f"apply subprocess exited {proc.returncode}: "
                    f"{(out or '').strip()[-500:]}")
        finally:
            import os

            os.unlink(path)


class TpctlServer:
    # Request-path access checks get a short retry budget: a create
    # handler must not pin a server thread for the offline-job default
    # of 60s (cloudauth.check_project_access) during a CRM outage.
    ACCESS_CHECK_BUDGET_S = 8.0

    def __init__(self, client, ttl_s: float = DEFAULT_TTL_S,
                 crm_backend=None, coordinator_factory=None,
                 isolation: str = "thread", apiserver_url: str = ""):
        if isolation not in ("thread", "subprocess"):
            raise ValueError(f"isolation must be thread|subprocess, "
                             f"got {isolation!r}")
        if isolation == "subprocess" and not apiserver_url:
            raise ValueError("subprocess isolation needs apiserver_url "
                             "(the child tpctl process dials it)")
        self.client = client
        self.ttl_s = ttl_s
        self.isolation = isolation
        self.apiserver_url = apiserver_url
        self.workers: dict[str, _Worker] = {}
        self._lock = threading.Lock()
        self._coordinator = coordinator_factory or (lambda: Coordinator(self.client))
        # Cloud-credential validity gate (kfctlServer.go:519/:545): when a
        # cloudauth.CrmBackend is provided, cloud-platform deployments
        # must carry a bearer token that grants setIamPolicy on the
        # project, and the per-project RefreshableTokenSource is kept
        # fresh for later platform calls.
        self.crm = crm_backend
        self._token_sources: dict[str, object] = {}

    def _check_cloud_access(self, req: HttpReq, cfg: TpuDef) -> None:
        if self.crm is None or cfg.platform == "existing":
            return
        import functools

        from kubeflow_tpu_torch.tpctl import cloudauth

        if not cfg.project:
            raise ApiHttpError(400, "cloud platform deployments require "
                               "spec.platform.project")
        auth = req.header("authorization") or ""
        token = auth.split(" ", 1)[1] if auth.lower().startswith("bearer ") else ""
        if not token:
            raise ApiHttpError(401, "cloud platform deployments require a "
                               "bearer token")
        checker = functools.partial(cloudauth.check_project_access,
                                    max_elapsed=self.ACCESS_CHECK_BUDGET_S)
        with self._lock:
            ts = self._token_sources.get(cfg.project)
            if ts is None:
                ts = cloudauth.RefreshableTokenSource(
                    cfg.project, self.crm, checker=checker)
                self._token_sources[cfg.project] = ts
        try:
            ts.refresh(token)  # validates via CheckProjectAccess
        except (PermissionError, ValueError) as e:
            raise ApiHttpError(403, str(e))
        except Exception as e:  # CRM outage is not a credentials verdict
            raise ApiHttpError(
                503, f"cloud access check unavailable: {e}")

    # -- endpoints ----------------------------------------------------------

    def create(self, req: HttpReq):
        try:
            body = req.json() or {}
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
            cfg = TpuDef.from_dict(body)
        except (ValueError, TypeError) as e:  # malformed JSON / bad TpuDef
            raise ApiHttpError(400, f"invalid TpuDef: {e}")
        self._check_cloud_access(req, cfg)
        with self._lock:
            w = self.workers.get(cfg.name)
            if w is None:
                if self.isolation == "subprocess":
                    w = _SubprocessWorker(cfg.name, self.apiserver_url)
                else:
                    w = _Worker(cfg.name, self._coordinator())
                self.workers[cfg.name] = w
            w.submit(cfg)
        return 200, {"name": cfg.name, "status": "enqueued"}

    def get(self, req: HttpReq):
        body = req.json() or {}
        name = body.get("name") or req.q1("name")
        if not name:
            raise ApiHttpError(400, "name required")
        with self._lock:
            w = self.workers.get(name)
            if w:
                w.last_request = time.monotonic()
        obj = self._coordinator().status(name)
        if obj is None and (w is None or w.error is None):
            raise ApiHttpError(404, f"deployment {name} not found")
        return {
            "name": name,
            "conditions": (obj or {}).get("status", {}).get("conditions", []),
            "error": w.error if w else None,
        }

    def openapi(self, req: HttpReq):
        from kubeflow_tpu_torch.tpctl.apispec import openapi

        return openapi()

    def router(self) -> Router:
        r = Router("tpctl")
        r.route("POST", "/tpctl/apps/v1/create", self.create)
        r.route("POST", "/tpctl/apps/v1/get", self.get)
        r.route("GET", "/tpctl/apps/v1/get", self.get)
        # machine-readable contract (bootstrap/api/swagger.yaml analogue)
        r.route("GET", "/tpctl/apps/v1/openapi.json", self.openapi)
        httpd.add_health_routes(r)
        httpd.add_metrics_route(r)
        return r

    def serve(self, host: str = "0.0.0.0", port: int = 0) -> httpd.HttpService:
        self.start_gc()
        return httpd.HttpService(self.router(), host, port)

    # -- GC (gcServer.go:56-86) ---------------------------------------------

    def gc_once(self, now: float | None = None) -> list[str]:
        now = time.monotonic() if now is None else now
        reaped = []
        with self._lock:
            for name, w in list(self.workers.items()):
                if now - w.last_request > self.ttl_s:
                    # idle means NOTHING pending: a worker with queued or
                    # in-flight applies must keep its identity (reaping
                    # it would let a re-submit start a SECOND concurrent
                    # apply for the same deployment). submit() holds the
                    # same lock, so pending can't grow under us.
                    if w.busy:
                        continue
                    try:
                        w.q.put_nowait(None)
                    except queue.Full:  # defensive; empty when not busy
                        continue
                    del self.workers[name]
                    reaped.append(name)
        return reaped

    def start_gc(self, period_s: float = 60.0) -> None:
        def loop():
            while True:
                time.sleep(period_s)
                reaped = self.gc_once()
                if reaped:
                    log.info("gc reaped idle deployments: %s", reaped)

        threading.Thread(target=loop, daemon=True, name="tpctl-gc").start()
