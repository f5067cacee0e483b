"""HTTP client for the tpctl deployment server.

Port of `kubeflow_tpu/tpctl/client.py`.

Mirrors bootstrap/cmd/kfctlClient (main.go:141 `main`, :59 `run`, :45
`checkAccess` and the go-kit client in app/kfctlClient.go): POST the
declarative config to `/tpctl/apps/v1/create`, then poll
`/tpctl/apps/v1/get` until the deployment reports Available (or
Degraded/timeout). Stdlib-only, like every HTTP surface in this repo.
"""

from __future__ import annotations

import json
import logging
import time
import urllib.error
import urllib.request

from kubeflow_tpu_torch.tpctl.tpudef import COND_AVAILABLE, COND_DEGRADED, TpuDef

log = logging.getLogger("kubeflow_tpu_torch.tpctl.client")


class DeploymentFailed(RuntimeError):
    pass


class TpctlClient:
    def __init__(self, base_url: str, timeout_s: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s

    def _post(self, path: str, body: dict) -> dict:
        req = urllib.request.Request(
            self.base_url + path,
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return json.load(r)
        except urllib.error.HTTPError as e:
            raise DeploymentFailed(
                f"{path}: HTTP {e.code}: {e.read().decode(errors='replace')}"
            ) from e

    def check_access(self) -> bool:
        """kfctlClient main.go:45 checkAccess analogue: is the plane up?"""
        try:
            with urllib.request.urlopen(self.base_url + "/healthz",
                                        timeout=self.timeout_s) as r:
                return r.status == 200
        except OSError:
            return False

    def create(self, cfg: TpuDef) -> dict:
        # full object form: {metadata, spec} — what TpuDef.from_dict reads
        obj = cfg.to_object()
        return self._post("/tpctl/apps/v1/create",
                          {"metadata": obj["metadata"], "spec": obj["spec"]})

    def get(self, name: str) -> dict:
        return self._post("/tpctl/apps/v1/get", {"name": name})

    def wait_available(self, name: str, timeout_s: float = 600.0,
                       poll_s: float = 2.0, clock=time.monotonic,
                       sleep=time.sleep) -> dict:
        """Poll until TpuDefAvailable=True (run :59's status loop).
        Raises DeploymentFailed on Degraded=True or worker error."""
        deadline = clock() + timeout_s
        last: dict = {}
        while clock() < deadline:
            try:
                last = self.get(name)
            except DeploymentFailed as e:
                if "404" not in str(e):
                    raise
                last = {}
            if last.get("error"):
                raise DeploymentFailed(f"{name}: {last['error']}")
            conds = {c.get("type"): c.get("status")
                     for c in last.get("conditions", [])}
            if conds.get(COND_DEGRADED) == "True":
                raise DeploymentFailed(f"{name}: degraded: {last}")
            if conds.get(COND_AVAILABLE) == "True":
                return last
            sleep(poll_s)
        raise TimeoutError(f"{name} not available after {timeout_s}s: {last}")

    def apply_and_wait(self, cfg: TpuDef, timeout_s: float = 600.0,
                       **kw) -> dict:
        self.create(cfg)
        return self.wait_available(cfg.name, timeout_s=timeout_s, **kw)
