"""The job path end to end on the CPU: a JAXJob on the port's
FakeCluster, placed by the port's gang scheduler on a GPU node, its pods
run by the port's LocalPodExecutor as two port launchers (`python -m
kubeflow_tpu_torch.runtime.launcher`, the default command, with
`--config ... --device cpu`) forming one gloo world from the pods'
JAXJOB_* env.

(a) transformer-test, f32, 3 steps, to Succeeded: the pods claim
    nvidia.com/gpu and run on the node the scheduler bound, both ranks
    log the same losses.
(b) a SIGTERM to one pod after its step 2: both ranks exit 75 at one
    step, the job counts one preemption and no restart, the recreated
    gang resumes at that step and ends Succeeded with params within
    1e-6 of a straight run in this process (loss within 1e-5).

One world at a time; the coordinator port of each gang incarnation is
drawn as tests/test_torch_dist.py draws them (below the ephemeral
range), and a crash restart is accepted only where rank 0 could not
bind it (the one failure run_world reruns)."""

import json
import os
import re
import signal
import sys
import time

import numpy as np

from kubeflow_tpu_torch.control.jaxjob import types as T
from kubeflow_tpu_torch.control.jaxjob.controller import build_controller
from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster
from kubeflow_tpu_torch.control.k8s.kubelet import LocalPodExecutor
from kubeflow_tpu_torch.control.runtime import seed_controller
from kubeflow_tpu_torch.control.scheduler.nodes import new_gpu_node
from kubeflow_tpu_torch.control.scheduler.scheduler import build_scheduler
from kubeflow_tpu_torch.runtime.checkpoint import restore_params
from test_torch_dist import _BIND_FAILED, NICE, ROOT, free_port

CFG = dict(model="transformer-test", task="lm", global_batch=4, seq_len=16,
           vocab_size=256, optimizer="sgdm", learning_rate=0.05,
           warmup_steps=0, log_every=1, model_kwargs={"dtype": "float32"})
PRODUCT = "nvidia-h100-80gb"
TIMEOUT = 180


class Gang:
    """The port's controller and scheduler on a FakeCluster with one
    2-GPU node, and a LocalPodExecutor running the pods' commands."""

    def __init__(self, tmp_path, cfg: dict):
        self.tmp = tmp_path
        self.cluster = FakeCluster()
        self.ctls = [seed_controller(build_controller(self.cluster)),
                     seed_controller(build_scheduler(self.cluster,
                                                     record_events=False))]
        self.cluster.create(new_gpu_node("gpu-node-0", product=PRODUCT,
                                         node_pool="train", gpus=2))
        # `python` in the pods' command is this interpreter, at a lower
        # priority (the ranks yield the CPU to the tests beside them)
        shim = tmp_path / "bin"
        shim.mkdir()
        (shim / "python").write_text(
            f"#!/bin/sh\nexec {' '.join(NICE)} {sys.executable} \"$@\"\n")
        (shim / "python").chmod(0o755)
        self.ports: dict[str, int] = {}

        def env_hook(pod, env):
            # one coordinator port per gang incarnation (its epoch)
            epoch = ob.annotations_of(pod)[T.ANNOTATION_EPOCH]
            port = self.ports.setdefault(epoch, free_port())
            env[T.ENV_COORD] = f"127.0.0.1:{port}"
            env["PATH"] = f"{shim}{os.pathsep}{env.get('PATH', '')}"
            env.update(JAXRT_METRICS_PORT="0", OMP_NUM_THREADS="1")
            return env

        self.executor = LocalPodExecutor(self.cluster, env_hook=env_hook,
                                         cwd=str(ROOT), log_dir=str(tmp_path))
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps(cfg))
        job = T.new_jaxjob("gang", replicas=2, product=PRODUCT,
                           node_pool="train", gpus_per_worker=1,
                           gang_schedule=True)
        job["spec"]["template"]["spec"]["containers"][0]["args"] = [
            "--config", str(path), "--device", "cpu"]
        self.cluster.create(job)

    def poll(self) -> dict:
        for c in self.ctls:
            c.run_until_idle(advance_delayed=True)
        self.executor.poll_once()
        if any((p.get("status") or {}).get("phase") == "Failed"
               for p in self.cluster.list("v1", "Pod")):
            # ranks that stopped together end together: every exit
            # reaches the pods before the controller reacts to the first
            assert self.executor.settle(), self.tails()
        return self.cluster.get(T.API_VERSION, T.KIND, "gang", "default")

    def drive(self, until, pause: float = 0.1) -> dict:
        deadline = time.monotonic() + TIMEOUT
        while time.monotonic() < deadline:
            job = self.poll()
            if until(job):
                return job
            if ob.cond_is_true(job, T.COND_FAILED):
                raise AssertionError(self.tails())
            time.sleep(pause)
        raise AssertionError("the job did not reach the expected state\n"
                             + self.tails())

    def log(self, entry: dict) -> str:
        with open(entry["path"], errors="replace") as f:
            return f.read()

    def tails(self) -> str:
        return "\n".join(f"--- {e['name']} ({e['uid'][:8]})\n"
                         f"{self.log(e)[-2000:]}" for e in self.executor.logs)

    def bind_failures(self) -> int:
        """Incarnations whose rank 0 could not bind its coordinator
        port: their crash restarts are the harness's, not the job's."""
        return sum(1 for e in self.executor.logs
                   if e["name"].endswith("-0")
                   and any(m in self.log(e) for m in _BIND_FAILED))

    def runs(self) -> list[dict]:
        """The summary and logged losses of every incarnation's ranks
        that ran to a summary, in launch order."""
        out = []
        for e in self.executor.logs:
            text = self.log(e)
            lines = [ln for ln in text.splitlines()
                     if ln.startswith('{"summary"')]
            if lines:
                out.append({"pod": e["name"], "uid": e["uid"], "text": text,
                            "summary": json.loads(lines[-1])["summary"],
                            "losses": re.findall(r"\bstep \d+ loss=(\S+)",
                                                 text)})
        return out


def test_jaxjob_runs_two_port_launchers_to_succeeded(tmp_path):
    g = Gang(tmp_path, dict(CFG, total_steps=3))
    try:
        job = g.drive(lambda j: ob.cond_is_true(j, T.COND_SUCCEEDED))
    finally:
        g.executor.shutdown()
    assert job["status"].get("restarts", 0) == g.bind_failures()
    assert job["status"]["replicaStatuses"]["succeeded"] == 2
    for p in g.cluster.list("v1", "Pod", namespace="default"):
        c = p["spec"]["containers"][0]
        assert c["resources"]["limits"] == {"nvidia.com/gpu": 1}
        assert c["command"] == ["python", "-m",
                                "kubeflow_tpu_torch.runtime.launcher"]
        assert p["spec"]["nodeName"] == "gpu-node-0"
    runs = g.runs()[-2:]
    assert sorted(r["pod"] for r in runs) == ["gang-worker-0",
                                             "gang-worker-1"]
    assert "process 0/2" in runs[0]["text"] + runs[1]["text"]
    assert "process 1/2" in runs[0]["text"] + runs[1]["text"]
    # every step after the first logs its loss (the first logs its time)
    assert runs[0]["losses"] == runs[1]["losses"] and \
        len(runs[0]["losses"]) == 2


def test_sigterm_preempts_the_gang_and_it_resumes_exactly(tmp_path):
    from kubeflow_tpu_torch.runtime.trainer import TrainConfig, Trainer

    total = 40
    ckpt = tmp_path / "ckpt"
    g = Gang(tmp_path, dict(CFG, total_steps=total, checkpoint_dir=str(ckpt)))
    sent = []

    def sigterm_after_step_2(job):
        if not sent:
            e = next((e for e in reversed(g.executor.logs)
                      if e["name"] == "gang-worker-1"), None)
            if e is not None and re.search(r"\bstep 2 loss=", g.log(e)):
                assert g.executor.kill_pod("gang-worker-1",
                                           sig=signal.SIGTERM)
                sent.append(e["uid"])
        return ob.cond_is_true(job, T.COND_SUCCEEDED)

    try:
        job = g.drive(sigterm_after_step_2, pause=0.005)
    finally:
        g.executor.shutdown()
    status = job["status"]
    assert sent, "the gang finished before the SIGTERM"
    assert status.get("preemptions") == 1, status
    assert status.get("restarts", 0) == g.bind_failures()
    runs = g.runs()
    stopped = [r for r in runs if r["summary"].get("preempted")]
    assert sorted(r["pod"] for r in stopped) == ["gang-worker-0",
                                                "gang-worker-1"]
    assert [e["rc"] for e in g.executor.logs
            if e["uid"] in {r["uid"] for r in stopped}] == [75, 75]
    steps = {int(re.search(r"preempted at step (\d+)", r["text"]).group(1))
             for r in stopped}
    assert len(steps) == 1
    step = steps.pop()
    assert 2 <= step < total
    resumed = [r for r in runs if r["summary"].get("start_step") == step]
    assert sorted(r["pod"] for r in resumed) == ["gang-worker-0",
                                                "gang-worker-1"]
    assert resumed[0]["losses"] == resumed[1]["losses"]
    # exit 75 is a preemption: the restart event says so, no crash
    events = [e["reason"] for e in g.cluster.list("v1", "Event",
                                                  namespace="default")]
    assert "GangRestart" in events and "JAXJobSucceeded" in events

    straight = Trainer(TrainConfig.from_dict(dict(CFG, total_steps=total)),
                       device="cpu")
    want = straight.fit()
    np.testing.assert_allclose(resumed[0]["summary"]["final"]["loss"],
                               want["final"]["loss"], atol=1e-5)
    got, at = restore_params(str(ckpt))
    assert at == total
    for k, v in straight.model.state_dict().items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-6,
                                   err_msg=k)
