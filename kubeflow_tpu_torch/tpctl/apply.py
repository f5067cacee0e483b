"""Coordinator: Apply(PLATFORM) -> Apply(K8S) with retry and conditions.

Port of `kubeflow_tpu/tpctl/apply.py`. Mirrors
kfctlServer.handleDeployment (kfctlServer.go:105-327): write the config,
apply the platform (cloud infra), then apply the K8S manifests with x3
constant backoff (:290-294), appending KfAvailable/KfDegraded status
conditions (:320-327). A second apply is a no-op on an unchanged config
(the kfctl_second_apply.py contract). Its deploy metrics go to the
port's registry (runtime/metrics.py: the card's machine has no
prometheus_client).

Platform providers are pluggable: `existing` targets a cluster that is
already up; `gke-gpu` shells out to gcloud to create a GKE GPU node pool
(the JAX package's `gke-tpu` creates TPU node pools).
"""

from __future__ import annotations

import json
import logging
import subprocess
import time

from kubeflow_tpu_torch.control.jaxjob.types import (
    NODESELECTOR_ACCEL,
    NODESELECTOR_POOL,
)
from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.control.scheduler.topology import normalize_pool
from kubeflow_tpu_torch.runtime.metrics import REGISTRY, MetricsRegistry
from kubeflow_tpu_torch.tpctl import manifests
from kubeflow_tpu_torch.tpctl.tpudef import (
    API_VERSION,
    COND_AVAILABLE,
    COND_DEGRADED,
    KIND,
    TpuDef,
)

log = logging.getLogger("kubeflow_tpu_torch.tpctl")

# deploy metrics of bootstrap/cmd/bootstrap/app/server.go:68-132
DEPLOY_REQUESTS = ("tpctl_deploy_requests_total", "deploy requests")
DEPLOY_FAILURES = ("tpctl_deployments_failure_total", "failed deploys")
DEPLOY_DURATION = ("tpctl_dep_duration_seconds", "deployment wall time")
DURATION_BUCKETS = tuple(30 * i for i in range(1, 16))  # 30s linear x15 (:112)


class PlatformProvider:
    def apply(self, cfg: TpuDef) -> None: ...

    def delete(self, cfg: TpuDef) -> None: ...


class ExistingCluster(PlatformProvider):
    def apply(self, cfg: TpuDef) -> None:
        log.info("platform=existing: nothing to provision")

    def delete(self, cfg: TpuDef) -> None:
        pass


class GkeGpuPlatform(PlatformProvider):
    """GPU node-pool provisioning via gcloud (the DM/kfctl-gcp analogue;
    the JAX package's GkeTpuPlatform).

    The gcloud CLI contract is pinned by an offline stateful double
    (tests/test_torch_tpctl_gcloud.py runs a fake `gcloud` on PATH
    through the real subprocess path):

    - describe-before-create/delete makes apply and delete idempotent
      (re-applies and double deletes are normal coordinator behavior);
    - the machine type and its GPUs a node derive from the product;
    - the node count is max(1, gpus // GPUs a node), so a pool smaller
      than one machine still gets one whole node;
    - the pool is named `normalize_pool("<name>-gpu")` and labelled with
      the product and that name, the two selectors the port's gang
      scheduler matches (`cloud.google.com/gke-accelerator`,
      `cloud.google.com/gke-nodepool`); a pool of more than one node is
      placed compactly (`--placement-type=COMPACT`), where a TPU pool
      passes its topology.
    """

    # GKE GPU product -> (machine type, GPUs a node), as GKE's GPU
    # machine types document them
    MACHINE_TYPES = {
        "nvidia-h100-80gb": ("a3-highgpu-8g", 8),
        "nvidia-h100-mega-80gb": ("a3-megagpu-8g", 8),
        "nvidia-h200-141gb": ("a3-ultragpu-8g", 8),
        "nvidia-a100-80gb": ("a2-ultragpu-8g", 8),
        "nvidia-tesla-a100": ("a2-highgpu-8g", 8),
        "nvidia-l4": ("g2-standard-96", 8),
    }

    def __init__(self, runner=subprocess.run):
        self.runner = runner

    @staticmethod
    def pool_name(cfg: TpuDef) -> str:
        return normalize_pool(f"{cfg.name}-gpu")

    def _machine(self, cfg: TpuDef) -> tuple[str, int, int]:
        """(machine type, GPUs a node, nodes)."""
        if cfg.accelerator not in self.MACHINE_TYPES:
            raise ValueError(
                f"unknown GPU product {cfg.accelerator!r}; known: "
                f"{sorted(self.MACHINE_TYPES)} (a typo here would "
                "provision the wrong GPU generation)")
        machine, per_node = self.MACHINE_TYPES[cfg.accelerator]
        return machine, per_node, max(1, cfg.pool_gpus() // per_node)

    def _scope(self, cfg: TpuDef) -> list[str]:
        return [f"--project={cfg.project}", f"--zone={cfg.zone}",
                f"--cluster={cfg.name}"]

    def _run(self, cmd: list[str]) -> None:
        """check=True with stderr preserved: CalledProcessError's message
        omits captured output, and 'Insufficient quota ...' must reach
        the operator's Degraded condition, not vanish."""
        r = self.runner(cmd, check=False, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"{' '.join(cmd[:4])} failed rc={r.returncode}: "
                f"{(r.stderr or r.stdout or '').strip()[-500:]}")

    def describe_pool(self, cfg: TpuDef) -> dict | None:
        """The live pool document, None if absent. Any OTHER describe
        failure (expired credentials, network, API outage) raises: an
        auth error must never read as 'pool already gone'."""
        r = self.runner(
            ["gcloud", "container", "node-pools", "describe",
             self.pool_name(cfg), *self._scope(cfg), "--format=json"],
            check=False, capture_output=True, text=True)
        if r.returncode == 0:
            try:
                return json.loads(r.stdout) or {}
            except ValueError:
                return {}
        err = (r.stderr or r.stdout or "").lower()
        if "not found" in err or "404" in err:
            return None
        raise RuntimeError(
            f"gcloud describe failed rc={r.returncode}: "
            f"{(r.stderr or '').strip()[-500:]}")

    def pool_exists(self, cfg: TpuDef) -> bool:
        return self.describe_pool(cfg) is not None

    def commands(self, cfg: TpuDef) -> list[list[str]]:
        machine, per_node, nodes = self._machine(cfg)
        # the scheduler's selectors: the product and the pool's name
        labels = (f"{NODESELECTOR_ACCEL}={cfg.accelerator},"
                  f"{NODESELECTOR_POOL}={self.pool_name(cfg)}")
        cmd = [
            "gcloud", "container", "node-pools", "create", self.pool_name(cfg),
            *self._scope(cfg),
            f"--machine-type={machine}",
            f"--accelerator=type={cfg.accelerator},count={per_node}",
            f"--num-nodes={nodes}",
            f"--node-labels={labels}",
        ]
        if nodes > 1:
            # multi-node pool: keep its nodes on one network fabric
            cmd.append("--placement-type=COMPACT")
        return [cmd]

    def apply(self, cfg: TpuDef) -> None:
        live = self.describe_pool(cfg)
        if live is not None:
            # idempotent only if the live pool MATCHES the spec: silently
            # keeping a stale 8-GPU pool under a 16-GPU TpuDef would report
            # Available while the workload can never schedule
            machine, per_node, nodes = self._machine(cfg)
            config = live.get("config") or {}
            accel = (config.get("accelerators") or [{}])[0]
            drift = []
            if config.get("machineType") not in (None, machine):
                drift.append(f"machineType {config['machineType']} "
                             f"!= {machine}")
            if accel.get("acceleratorType") not in (None, cfg.accelerator):
                drift.append(f"accelerator {accel['acceleratorType']} "
                             f"!= {cfg.accelerator}")
            count = accel.get("acceleratorCount")
            if count is not None and int(count) != per_node:
                drift.append(f"GPUs a node {count} != {per_node}")
            if live.get("initialNodeCount") not in (None, nodes):
                drift.append(f"nodes {live['initialNodeCount']} != {nodes}")
            if drift:
                raise RuntimeError(
                    f"node pool {self.pool_name(cfg)} exists with a "
                    f"different shape ({'; '.join(drift)}); delete it "
                    "before re-applying the changed TpuDef")
            log.info("node pool %s exists and matches; skipping create",
                     self.pool_name(cfg))
            return
        for cmd in self.commands(cfg):
            log.info("platform exec: %s", " ".join(cmd))
            self._run(cmd)

    def delete(self, cfg: TpuDef) -> None:
        if self.describe_pool(cfg) is None:
            return  # genuinely gone: delete is idempotent
        self._run([
            "gcloud", "container", "node-pools", "delete", self.pool_name(cfg),
            *self._scope(cfg), "--quiet",
        ])


PROVIDERS = {"existing": ExistingCluster, "gke-gpu": GkeGpuPlatform}


class Coordinator:
    K8S_RETRIES = 3  # kfctlServer.go:290-294

    def __init__(self, client, provider: PlatformProvider | None = None,
                 registry: MetricsRegistry | None = None):
        self.client = client
        self.provider = provider
        self.registry = registry if registry is not None else REGISTRY

    def _provider_for(self, cfg: TpuDef) -> PlatformProvider:
        if self.provider is not None:
            return self.provider
        cls = PROVIDERS.get(cfg.platform)
        if cls is None:
            raise ValueError(f"unknown platform {cfg.platform!r}; "
                             f"valid: {sorted(PROVIDERS)}")
        return cls()

    def apply(self, cfg: TpuDef) -> dict:
        """Full deployment; returns the stored TpuDef object with
        conditions. Idempotent: an identical spec re-applies cleanly."""
        self.registry.counter_inc(*DEPLOY_REQUESTS)
        t0 = time.monotonic()
        stored = self._store_tpudef(cfg)
        try:
            self._provider_for(cfg).apply(cfg)
            self._apply_k8s(cfg)
        except Exception as e:
            self.registry.counter_inc(*DEPLOY_FAILURES)
            ob.cond_set(stored, COND_DEGRADED, "True", "ApplyFailed", str(e)[:500])
            self._update_status(stored)
            raise
        name, help_ = DEPLOY_DURATION
        self.registry.histogram(name, time.monotonic() - t0, help_,
                                buckets=DURATION_BUCKETS)
        ob.cond_set(stored, COND_AVAILABLE, "True", "ApplySucceeded",
                    f"{len(cfg.applications)} applications applied")
        ob.cond_set(stored, COND_DEGRADED, "False", "ApplySucceeded", "")
        return self._update_status(stored)

    def _store_tpudef(self, cfg: TpuDef) -> dict:
        obj = cfg.to_object()
        existing = self.client.get_or_none(obj["apiVersion"], obj["kind"],
                                           ob.meta(obj)["name"])
        if existing is None:
            return self.client.create(obj)
        if existing.get("spec") != obj.get("spec"):
            existing["spec"] = obj["spec"]
            return self.client.update(existing)
        return existing

    def _update_status(self, obj: dict) -> dict:
        fresh = self.client.get(obj["apiVersion"], obj["kind"], ob.meta(obj)["name"])
        fresh["status"] = obj.get("status", {})
        return self.client.update_status(fresh)

    def _apply_k8s(self, cfg: TpuDef) -> None:
        objs = manifests.render(cfg)
        last_err: Exception | None = None
        for attempt in range(self.K8S_RETRIES):
            try:
                for o in objs:
                    self._apply_one(o)
                return
            except ob.ApiError as e:
                last_err = e
                log.warning("k8s apply attempt %d failed: %s", attempt + 1, e)
                time.sleep(0.01 * (attempt + 1))
        raise last_err  # type: ignore[misc]

    def _apply_one(self, desired: dict) -> None:
        """Server-side-apply-ish create-or-update keyed on spec equality."""
        m = ob.meta(desired)
        found = self.client.get_or_none(
            desired["apiVersion"], desired["kind"], m["name"], m.get("namespace"))
        if found is None:
            self.client.create(desired)
            return
        merged = ob.merge_patch(found, {k: v for k, v in desired.items()
                                        if k not in ("metadata", "status")})
        # labels are additive, like the reconcilehelper policy
        want_labels = {**(ob.labels_of(found)), **(ob.labels_of(desired))}
        if merged != found or want_labels != ob.labels_of(found):
            ob.meta(merged).setdefault("labels", {}).update(want_labels)
            self.client.update(merged)

    def delete(self, cfg: TpuDef) -> None:
        """Teardown: platform resources + the TpuDef (children GC)."""
        self._provider_for(cfg).delete(cfg)
        for o in reversed(manifests.render(cfg)):
            m = ob.meta(o)
            try:
                self.client.delete(o["apiVersion"], o["kind"], m["name"],
                                   m.get("namespace"))
            except ob.NotFound:
                pass
        try:
            self.client.delete(API_VERSION, KIND, cfg.name)
        except ob.NotFound:
            pass

    def status(self, name: str) -> dict | None:
        return self.client.get_or_none(API_VERSION, KIND, name)
