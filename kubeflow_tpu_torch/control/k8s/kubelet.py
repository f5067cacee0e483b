"""Fake kubelets: drive Pod phases against the FakeCluster.

Two levels, matching the test tiers SURVEY.md §4 prescribes:

- ``FakeKubelet`` — phase simulation for controller unit tests
  (Pending -> Running via step(); tests flip terminal phases explicitly).
- ``LocalPodExecutor`` — actually EXECUTES pod container commands as
  local subprocesses with the pod's env (plus overrides), mapping exit
  codes to Succeeded/Failed. This is what lets a JAXJob e2e test run a
  real multi-process `torch.distributed` training gang on one machine —
  the hermetic stand-in for the reference's per-CI-run GKE clusters.

Port of `kubeflow_tpu/control/k8s/kubelet.py`: the same code over the port's own modules.
"""

from __future__ import annotations

import logging
import os
import subprocess
import threading
import time

from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster

log = logging.getLogger("kubeflow_tpu_torch.kubelet")


def _set_phase(cluster: FakeCluster, pod: dict, phase: str, **status_extra) -> dict | None:
    m = ob.meta(pod)
    try:
        cur = cluster.get("v1", "Pod", m["name"], m.get("namespace"))
    except ob.NotFound:
        return None
    cur.setdefault("status", {})
    cur["status"]["phase"] = phase
    cur["status"].update(status_extra)
    return cluster.update_status(cur)


class FakeKubelet:
    """Pending -> Running on step(); terminal phases are test-driven.

    This fake stands in for the whole node fleet, not one kubelet: it
    runs any pod BOUND to any node (spec.nodeName set) and never runs a
    pod still carrying a scheduling gate. ``auto_bind`` (default, the
    pre-gang-scheduler behavior) additionally stands in for
    kube-scheduler: unbound ungated pods are bound to ``node_name``
    (creating that Node, Ready, if absent — slice-health checks treat a
    missing node as failed) and then run. Gang-scheduler tests pass
    ``auto_bind=False`` so only scheduler-bound pods execute.
    """

    def __init__(self, cluster: FakeCluster, auto_bind: bool = True,
                 node_name: str = "fake-node"):
        self.cluster = cluster
        self.auto_bind = auto_bind
        self.node_name = node_name

    def _ensure_node(self) -> None:
        if self.cluster.get_or_none("v1", "Node", self.node_name) is None:
            node = ob.new_object("v1", "Node", self.node_name)
            node["status"] = {
                "conditions": [{"type": "Ready", "status": "True"}]}
            try:
                self.cluster.create(node)
            except ob.Conflict:
                pass

    def step(self) -> int:
        moved = 0
        for pod in self.cluster.list("v1", "Pod"):
            if (pod.get("status") or {}).get("phase", "Pending") != "Pending":
                continue
            spec = pod.get("spec") or {}
            if spec.get("schedulingGates"):
                continue  # not admitted by the gang scheduler yet
            if not spec.get("nodeName"):
                if not self.auto_bind:
                    continue  # kubelets run only bound pods
                self._ensure_node()
                m = ob.meta(pod)
                try:
                    pod = self.cluster.patch(
                        "v1", "Pod", m["name"],
                        {"spec": {"nodeName": self.node_name}},
                        m.get("namespace"))
                except ob.NotFound:
                    continue
            _set_phase(
                self.cluster, pod, "Running",
                startTime=ob.now_iso(),
                containerStatuses=[
                    {"name": c.get("name", "main"),
                     "state": {"running": {"startedAt": ob.now_iso()}},
                     "ready": True}
                    for c in pod["spec"].get("containers", [])
                ],
            )
            moved += 1
        return moved

    def succeed(self, name: str, namespace: str = "default") -> None:
        pod = self.cluster.get("v1", "Pod", name, namespace)
        _set_phase(self.cluster, pod, "Succeeded")

    def fail(self, name: str, namespace: str = "default", message: str = "boom",
             exit_code: int = 1) -> None:
        pod = self.cluster.get("v1", "Pod", name, namespace)
        containers = (pod.get("spec") or {}).get("containers") or []
        main = containers[0].get("name", "main") if containers else "main"
        _set_phase(
            self.cluster, pod, "Failed",
            containerStatuses=[{
                "name": main,
                "state": {"terminated": {"exitCode": exit_code,
                                         "message": message}},
                "ready": False,
            }],
        )


class LocalPodExecutor:
    """Run pod containers as local subprocesses.

    Watches the cluster for pods (optionally label-filtered), launches
    `spec.containers[0].command + args` with the container env exported,
    and reflects process state back into pod.status.phase. DNS-style
    coordinator addresses can't resolve locally, so callers provide
    ``env_overrides`` per pod (e.g. rewrite JAXJOB_COORDINATOR_ADDRESS to
    127.0.0.1) via a hook.

    With ``log_dir`` each process's output goes to its own file there
    (``<namespace>.<pod>.<uid>.log``) instead of a pipe read at exit, so
    a worker that prints more than a pipe holds never blocks, and its
    output stays readable after the pod is gone. ``logs`` lists one
    entry per launched incarnation, in launch order: namespace, name,
    uid, path, the wall time it started and, once it ended, its exit
    code ``rc`` (negative: killed by that signal, as when its pod was
    deleted under it).
    """

    def __init__(
        self,
        cluster: FakeCluster,
        label_selector: dict | None = None,
        env_hook=None,  # fn(pod, env: dict) -> dict
        cwd: str | None = None,
        node_name: str | None = None,
        log_dir: str | None = None,
    ):
        self.cluster = cluster
        self.log_dir = log_dir
        self.logs: list[dict] = []
        self._log_of: dict[int, dict] = {}   # pid -> its logs entry
        self.label_selector = label_selector
        self.env_hook = env_hook
        self.cwd = cwd
        # scheduler-binding simulation: launched pods get spec.nodeName
        # so slice-health (node NotReady/taint) paths see real bindings.
        # Mutable: tests re-point it to model rescheduling onto a healthy
        # node after a drain.
        self.node_name = node_name
        # key -> (pod uid, process). The uid is the pod's identity: a
        # gang restart recreates a pod under the same name, and the old
        # incarnation's process must be reaped before the new one runs
        # (kubelet semantics — otherwise a relaunched worker can reach
        # the previous incarnation's coordinator).
        self._procs: dict[tuple[str, str], tuple[str, subprocess.Popen]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()

    def _pod_env(self, pod: dict) -> dict[str, str]:
        env = dict(os.environ)
        for c in pod["spec"].get("containers", [])[:1]:
            for e in c.get("env", []):
                if "value" in e:
                    env[e["name"]] = str(e["value"])
        if self.env_hook:
            env = self.env_hook(pod, env)
        return env

    def poll_once(self) -> None:
        """Reap stale/finished processes, then launch new pods.

        Reaping runs first so that a gang-restarted pod set (delete +
        recreate under the same names) has its previous incarnation's
        processes killed — and the coordinator port released — before
        the new gang launches in the same pass.
        """
        pods = self.cluster.list("v1", "Pod", label_selector=self.label_selector)
        with self._lock:
            # -- harvest / reap ------------------------------------------
            for key, (uid, proc) in list(self._procs.items()):
                ns, name = key
                rc = proc.poll()
                pod = self.cluster.get_or_none("v1", "Pod", name, ns)
                if pod is None or ob.meta(pod).get("uid") != uid:
                    # pod deleted or replaced by a new incarnation (gang
                    # restart): kill + reap; never touch the new pod's
                    # status from the old process's exit code.
                    if rc is None:
                        proc.kill()
                    self._ended(proc, proc.wait(timeout=10))
                    if proc.stdout:
                        proc.stdout.close()
                    del self._procs[key]
                    continue
                if rc is None:
                    continue
                out = self._output(proc, self._ended(proc, rc))
                del self._procs[key]
                if rc == 0:
                    _set_phase(self.cluster, pod, "Succeeded")
                else:
                    log.warning("pod %s failed rc=%d\n%s", name, rc, out[-2000:])
                    _set_phase(
                        self.cluster, pod, "Failed",
                        containerStatuses=[{
                            "name": pod["spec"]["containers"][0].get(
                                "name", "main"),
                            "state": {"terminated": {"exitCode": rc,
                                                     "message": out[-500:]}},
                        }],
                    )
            # -- launch --------------------------------------------------
            for pod in pods:
                m = ob.meta(pod)
                key = (m.get("namespace") or "default", m["name"])
                phase = (pod.get("status") or {}).get("phase", "Pending")
                if pod["spec"].get("schedulingGates"):
                    continue  # gated: the gang scheduler has not admitted it
                if phase == "Pending" and key not in self._procs:
                    c = pod["spec"]["containers"][0]
                    cmd = list(c.get("command") or []) + list(c.get("args") or [])
                    log.info("exec pod %s: %s", m["name"], " ".join(cmd))
                    if self.node_name and not pod["spec"].get("nodeName"):
                        # bind-once: re-read and only self-bind if still
                        # unbound — the gang scheduler may have placed
                        # this pod between our list() and now, and its
                        # binding must win (never rebind a bound pod)
                        fresh = self.cluster.get_or_none("v1", "Pod",
                                                         m["name"], key[0])
                        if fresh is not None and fresh["spec"].get("nodeName"):
                            pod = fresh
                        elif fresh is not None:
                            fresh["spec"]["nodeName"] = self.node_name
                            pod = self.cluster.update(fresh)
                    stdout = subprocess.PIPE
                    if self.log_dir:
                        path = os.path.join(
                            self.log_dir,
                            f"{key[0]}.{m['name']}.{m.get('uid', '')}.log")
                        entry = {"namespace": key[0], "name": m["name"],
                                 "uid": m.get("uid", ""), "path": path,
                                 "started": time.time()}
                        self.logs.append(entry)
                        stdout = open(path, "wb")
                    try:
                        proc = subprocess.Popen(
                            cmd,
                            env=self._pod_env(pod),
                            cwd=self.cwd,
                            stdout=stdout,
                            stderr=subprocess.STDOUT,
                        )
                    finally:
                        if stdout is not subprocess.PIPE:
                            stdout.close()  # the child holds its own
                    self._procs[key] = (m.get("uid", ""), proc)
                    if self.log_dir:
                        self._log_of[proc.pid] = entry
                    _set_phase(self.cluster, pod, "Running", startTime=ob.now_iso())

    def _ended(self, proc: subprocess.Popen, rc: int) -> dict | None:
        """Record a process's exit code in its logs entry (if any)."""
        entry = self._log_of.pop(proc.pid, None)
        if entry is not None:
            entry["rc"] = rc
        return entry

    @staticmethod
    def _output(proc: subprocess.Popen, entry: dict | None) -> str:
        """A finished process's output: its pipe, or the tail of its
        log file."""
        if proc.stdout is not None:
            return (proc.stdout.read() or b"").decode(errors="replace")
        if entry is None:
            return ""
        with open(entry["path"], "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - 4096))
            return f.read().decode(errors="replace")

    def alive_count(self) -> int:
        """Number of tracked worker processes still running."""
        with self._lock:
            return sum(1 for _uid, p in self._procs.values() if p.poll() is None)

    def kill_pod(self, name: str, namespace: str = "default",
                 sig: int | None = None) -> bool:
        """Signal the process backing a pod (fault injection for e2e
        tests — the hermetic stand-in for a preempted GPU worker).
        Default SIGKILL = hard node loss; sig=SIGTERM = the kubelet's
        graceful-eviction notice ahead of node maintenance.
        Returns False when no live process backs that pod."""
        with self._lock:
            entry = self._procs.get((namespace, name))
            if entry is None or entry[1].poll() is not None:
                return False
            if sig is None:
                entry[1].kill()
            else:
                entry[1].send_signal(sig)
            return True

    def settle(self, timeout: float = 60.0, poll: float = 0.1) -> bool:
        """Harvest until no tracked process is alive, or ``timeout``
        passes; returns whether all exited. A gang whose ranks stop
        together (a preemption they agreed on) reports every rank's exit
        in its pods' status this way before a controller reacts to the
        first — as a kubelet's grace period lets them finish."""
        deadline = time.monotonic() + timeout
        while True:
            self.poll_once()
            if not self.alive_count():
                return True
            if time.monotonic() > deadline:
                return False
            time.sleep(poll)

    def run_until_settled(self, timeout: float = 120.0, poll: float = 0.2) -> None:
        """Poll until no tracked process is alive and no Pending pods remain."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.poll_once()
            pods = self.cluster.list("v1", "Pod", label_selector=self.label_selector)
            pending = any(
                (p.get("status") or {}).get("phase", "Pending") in ("Pending", "Running")
                for p in pods
            )
            if not pending and not self._procs:
                return
            time.sleep(poll)
        raise TimeoutError("pods did not settle in time")

    def shutdown(self) -> None:
        self._stop.set()
        with self._lock:
            for _uid, proc in self._procs.values():
                if proc.poll() is None:
                    proc.kill()
            self._procs.clear()
