"""The port's StudyJob controller (kubeflow_tpu_torch/tune/) against the
JAX package's, each on its own FakeCluster with its own JAXJob controller
and FakeKubelet; then a sweep whose trials train.

Suggestions: all four algorithms (grid, random, bayesianoptimization,
hyperband) give equal suggestions for equal seeds and observations, over
rounds of observations drawn with numpy. Sweeps: one script (trials
reported with an objective drawn from the trial's parameters, the
kubelet's pods run and succeed) gives equal study status (conditions,
trial counts, bestTrial) and equal trial JAXJobs and pods after the GPU
mapping: the template's ``tpu: {accelerator, topology, chipsPerWorker}``
is the port's ``gpu: {product, nodePool, gpusPerWorker}``, and the
pods' TPU limit, selectors, command and image map as in
tests/test_torch_control_jaxjob.py `gpu_view`. The default trial is
the port's launcher on its image. The cases mirror
tests/test_studyjob.py.

Last, a two-trial grid StudyJob through the port's StudyJob and JAXJob
controllers, its gang scheduler and LocalPodExecutor: each trial runs
`python -m kubeflow_tpu_torch.runtime.launcher --config <its ${opt}
config> --device cpu` at transformer-test size, and a collector reads
`final.loss` from the trial pod's summary line into the objective
annotation.
"""

import copy
import json
import math
import os
import re
import sys
import time

import numpy as np
import pytest

from kubeflow_tpu.control.jaxjob import types as RJT
from kubeflow_tpu.control.jaxjob.controller import build_controller as r_jobs
from kubeflow_tpu.control.k8s import objects as rob
from kubeflow_tpu.control.k8s.fake import FakeCluster as RCluster
from kubeflow_tpu.control.k8s.kubelet import FakeKubelet as RKubelet
from kubeflow_tpu.control.runtime import seed_controller as r_seed
from kubeflow_tpu.tune import studyjob as RS
from kubeflow_tpu_torch.control.jaxjob import types as PJT
from kubeflow_tpu_torch.control.jaxjob.controller import build_controller as p_jobs
from kubeflow_tpu_torch.control.jaxjob.controller import worker_name
from kubeflow_tpu_torch.control.k8s import objects as pob
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster as PCluster
from kubeflow_tpu_torch.control.k8s.kubelet import FakeKubelet as PKubelet
from kubeflow_tpu_torch.control.k8s.kubelet import LocalPodExecutor
from kubeflow_tpu_torch.control.runtime import seed_controller as p_seed
from kubeflow_tpu_torch.control.scheduler import GATE_GANG, SCHEDULER_NAME
from kubeflow_tpu_torch.control.scheduler.nodes import new_gpu_node
from kubeflow_tpu_torch.control.scheduler.scheduler import build_scheduler
from kubeflow_tpu_torch.tune import studyjob as PS
from test_torch_control_jaxjob import PRODUCT, gpu_view as pod_view, pool_of
from test_torch_control_profile import JAX_COMMAND, gpu_view, strip
from test_torch_dist import NICE, ROOT

PARAMS = [
    {"name": "lr", "parameterType": "double",
     "feasible": {"min": 0.01, "max": 0.03, "steps": 3}},
    {"name": "opt", "parameterType": "categorical",
     "feasible": {"list": ["sgd", "adamw"]}},
]
MORE_PARAMS = PARAMS + [
    {"name": "layers", "parameterType": "int",
     "feasible": {"min": 2, "max": 12, "steps": 4}},
    {"name": "drop", "type": "discrete", "list": [0.0, 0.1, 0.2]}]
JAX_TEMPLATE = {
    "spec": {
        "replicas": 1,
        "tpu": {"accelerator": "tpu-v5-lite-podslice", "topology": "2x2",
                "chipsPerWorker": 4},
        "template": {"spec": {"containers": [{
            "name": "jax", "image": "kubeflow-tpu/jaxrt:latest",
            "command": ["python", "-m", "kubeflow_tpu.runtime.launcher",
                        "--config=/cfg/${opt}-${lr}.json"],
        }]}},
    }
}
TRACE = re.compile(r"00-[0-9a-f]{32}-[0-9a-f]{16}-0[01]")
BUDGET_PARAMS = [{"name": "lr", "parameterType": "double",
                  "feasible": {"min": 0.01, "max": 0.03, "steps": 3}}]


def template_view(tmpl: dict) -> dict:
    """The port's trial template for the JAX package's: spec.tpu ->
    spec.gpu, the container through gpu_view (image, command)."""
    tmpl = gpu_view(copy.deepcopy(tmpl))
    spec = tmpl.get("spec", tmpl)
    tpu = spec.pop("tpu", None)
    if tpu:
        spec["gpu"] = {"product": PRODUCT[tpu["accelerator"]],
                       "nodePool": pool_of(tpu["topology"]),
                       "gpusPerWorker": tpu["chipsPerWorker"]}
    return tmpl


def job_view(job: dict) -> dict:
    """A JAX trial JAXJob as the port's: its spec's tpu as gpu, the
    template's container mapped."""
    job = copy.deepcopy(job)
    job["spec"] = template_view({"spec": job["spec"]})["spec"]
    return job


# -- suggestions --------------------------------------------------------------


def _study(mod, algo: str, params, seed: int, max_trials: int,
           goal: str = "minimize", **algo_kw) -> dict:
    sj = mod.new_studyjob("s", algorithm=algo, parameters=params, seed=seed,
                          max_trials=max_trials, goal=goal)
    sj["spec"]["algorithm"].update(algo_kw)
    return sj


@pytest.mark.parametrize("algo, kw", [
    ("grid", {}), ("random", {}), ("bayesianoptimization", {}),
    ("bayes", {}), ("hyperband", {}),
    ("successivehalving", {"minBudget": 5, "maxBudget": 40,
                           "reduction": 2})])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_suggestions_equal_the_reference(algo, kw, seed):
    """Rounds of observations: after each, the first `done` suggestions
    are observed with an objective drawn from the seed (some failed,
    None), and both packages suggest again from them."""
    rng = np.random.default_rng(seed)
    goal = ["minimize", "maximize"][seed % 2]
    max_trials = int(rng.integers(4, 13))
    params = MORE_PARAMS if algo != "successivehalving" else BUDGET_PARAMS
    ref = RS.StudyJobReconciler()
    port = PS.StudyJobReconciler()
    obs: list[dict] = []
    for _ in range(4):
        want = ref._suggestions(_study(RS, algo, params, seed, max_trials,
                                       goal, **kw), obs)
        got = port._suggestions(_study(PS, algo, params, seed, max_trials,
                                       goal, **kw), obs)
        assert got == want
        obs = [{"trial": f"s-trial-{i}", "parameters": s,
                "objective": (None if rng.random() < 0.15
                              else float(rng.normal()))}
               for i, s in enumerate(want[:len(obs) + int(
                   rng.integers(1, 5))])]


def test_suggestion_functions_equal_the_reference():
    obs = [{"parameters": {"lr": x}, "objective": (x - 0.012) ** 2}
           for x in (0.012, 0.3, 0.6, 0.9)]
    lr = [{"name": "lr", "parameterType": "double",
           "feasible": {"min": 0.0, "max": 1.0}}]
    for fn, args in (("grid_suggestions", (MORE_PARAMS, 7)),
                     ("random_suggestions", (MORE_PARAMS, 5, 7)),
                     ("bayes_suggestions", (lr, 16, 3, obs, "minimize")),
                     ("sha_suggestions", (lr, 2, 0, [],
                                          "minimize", {"minBudget": 1,
                                                       "maxBudget": 4}))):
        assert getattr(PS, fn)(*args) == getattr(RS, fn)(*args), fn
    for algo in ({"minBudget": 10, "maxBudget": 90, "reduction": 3}, {},
                 {"reduction": 1, "minBudget": 0}):
        assert PS.sha_rungs(algo) == RS.sha_rungs(algo)
    for n, rungs, eta in ((6, [5, 10], 2), (4, [5, 10], 2),
                          (1, [5, 10, 20], 2), (14, [200, 400, 800], 2)):
        assert PS.sha_bracket(n, rungs, eta) == RS.sha_bracket(n, rungs, eta)


def test_template_substitution_and_the_default_trial():
    params = {"lr": 0.02, "opt": "adamw", "n": 4}
    tmpl = {"spec": {"replicas": "${n}", "args": ["--config=/c/${opt}.json",
                                                  "${lr}"]}}
    assert PS._substitute(tmpl, params) == RS._substitute(tmpl, params)
    assert PS._substitute(tmpl, params)["spec"]["replicas"] == 4
    study = (RS.new_studyjob("s"), PS.new_studyjob("s"))
    want = RS.StudyJobReconciler().generate_trial(study[0], 0, params)
    got = PS.StudyJobReconciler().generate_trial(study[1], 0, params)
    # the JAX trial runs its jaxrt image's entrypoint, the launcher; the
    # port's names the port's launcher as its command
    want["spec"]["template"]["spec"]["containers"][0]["command"] = list(
        JAX_COMMAND)
    assert got == gpu_view(want)
    assert got["spec"]["template"]["spec"]["containers"][0] == {
        "name": "jax", "image": PJT.DEFAULT_IMAGE,
        "command": list(PJT.DEFAULT_COMMAND)}


# -- sweeps through both packages ---------------------------------------------


class Sweep:
    """One package's StudyJob and JAXJob controllers and FakeKubelet on
    its own FakeCluster."""

    def __init__(self, side: str):
        jax = side == "jax"
        self.side = side
        self.cluster = (RCluster if jax else PCluster)()
        self.S, self.JT, self.ob = (RS, RJT, rob) if jax else (PS, PJT, pob)
        seed = r_seed if jax else p_seed
        self.ctls = [seed(self.S.build_controller(self.cluster)),
                     seed((r_jobs if jax else p_jobs)(self.cluster,
                                                      record_events=False))]
        self.kubelet = (RKubelet if jax else PKubelet)(self.cluster)

    def drain(self):
        """Four turns of both controllers, at most 20 reconciles each:
        a running study writes its status on every reconcile in both
        packages, and the write's own watch event queues the next."""
        for _ in range(4):
            for c in self.ctls:
                c.run_until_idle(max_rounds=20, advance_delayed=True)

    def study(self) -> dict:
        return self.cluster.get(self.S.API_VERSION, self.S.KIND, "sweep",
                                "default")

    def jobs(self) -> list[dict]:
        return sorted(self.cluster.list(self.JT.API_VERSION, self.JT.KIND,
                                        namespace="default"),
                      key=lambda j: j["metadata"]["name"])

    def report(self, objective) -> None:
        """Every Running trial gets `objective(params)` and its pod
        succeeds (the JAX test's run_all_trials, one pass)."""
        for job in self.jobs():
            if not self.ob.cond_is_true(job, self.JT.COND_RUNNING) or \
                    self.ob.cond_is_true(job, self.JT.COND_SUCCEEDED):
                continue
            params = json.loads(self.ob.annotations_of(job)[
                self.S.ANNO_PARAMETERS])
            self.ob.set_annotation(job, self.S.ANNO_OBJECTIVE,
                                   str(objective(params)))
            self.cluster.update(job)
            self.kubelet.succeed(worker_name(job["metadata"]["name"], 0))

    def view(self) -> dict:
        jax = self.side == "jax"
        pods = sorted(self.cluster.list("v1", "Pod", namespace="default"),
                      key=lambda p: p["metadata"]["name"])
        # each job's traceparent is minted at random
        return strip(json.loads(TRACE.sub("<traceparent>", json.dumps({
            "study": self.study().get("status"),
            "jobs": [job_view(j) if jax else j for j in self.jobs()],
            "pods": [gpu_view(pod_view(p)) if jax else p for p in pods]}))))


def run_pair(study_kw: dict, objective, algo_kw=None, rounds=30):
    """The same StudyJob through both packages, one script of kubelet
    steps and reports; the views equal after every step."""
    sweeps = (Sweep("jax"), Sweep("port"))
    for sw in sweeps:
        tmpl = JAX_TEMPLATE if sw.side == "jax" else \
            template_view(JAX_TEMPLATE)
        sj = sw.S.new_studyjob("sweep", trial_template=tmpl, **study_kw)
        sj["spec"]["algorithm"].update(algo_kw or {})
        sw.cluster.create(sj)
        sw.drain()
    steps = []
    for i in range(rounds):
        for sw in sweeps:
            sw.kubelet.step()
            sw.drain()
            sw.report(objective)
            sw.drain()
        want, got = sweeps[0].view(), sweeps[1].view()
        assert got == want, i
        steps.append(got)
        if sweeps[1].ob.cond_is_true(sweeps[1].study(), PS.COND_SUCCEEDED):
            break
    return sweeps[1], steps


def test_grid_sweep_finds_the_best_and_claims_gpus():
    port, steps = run_pair(dict(parameters=PARAMS, max_trials=4,
                                parallel_trials=2),
                           objective=lambda p: p["lr"])
    study = port.study()
    assert pob.cond_is_true(study, PS.COND_SUCCEEDED)
    assert study["status"]["trials"]["completed"] == 4
    assert study["status"]["bestTrial"]["objective"] == min(
        s["lr"] for s in PS.grid_suggestions(PARAMS, 4))
    # the parallelism cap held at every step, and the pods claimed GPUs
    assert max(s["study"]["trials"]["active"] for s in steps) == 2
    for pod in port.cluster.list("v1", "Pod"):
        c = pod["spec"]["containers"][0]
        assert c["resources"]["limits"] == {PJT.RESOURCE_GPU: 4}
        assert c["command"][:3] == list(PJT.DEFAULT_COMMAND)
        assert pod["spec"]["nodeSelector"] == {
            PJT.NODESELECTOR_ACCEL: "nvidia-h100-80gb",
            PJT.NODESELECTOR_POOL: "pool-2x2"}


def test_maximize_direction():
    port, _ = run_pair(dict(parameters=PARAMS, max_trials=3,
                            parallel_trials=3, goal="maximize"),
                       objective=lambda p: p["lr"])
    assert port.study()["status"]["bestTrial"]["objective"] == max(
        s["lr"] for s in PS.grid_suggestions(PARAMS, 3))


def test_bayes_sweep():
    port, _ = run_pair(dict(algorithm="bayesianoptimization",
                            parameters=PARAMS, max_trials=5,
                            parallel_trials=1),
                       objective=lambda p: (p["lr"] - 0.02) ** 2)
    assert port.study()["status"]["trials"]["completed"] == 5


def test_hyperband_sweep_promotes_and_substitutes_the_budget():
    tmpl_budget = {"algorithm": "hyperband", "parameters": BUDGET_PARAMS,
                   "max_trials": 4, "parallel_trials": 4}
    port, _ = run_pair(tmpl_budget, objective=lambda p: p["lr"] / p["budget"],
                       algo_kw={"minBudget": 5, "maxBudget": 20,
                                "reduction": 2})
    study = port.study()
    assert pob.cond_is_true(study, PS.COND_SUCCEEDED)
    assert study["status"]["bestTrial"]["parameters"]["budget"] == 20


@pytest.mark.parametrize("kw", [dict(algorithm="simulated-annealing"),
                                dict(parameters=PARAMS, max_trials=2,
                                     parallel_trials=2)])
def test_bad_algorithm_and_failed_trials(kw):
    """An unknown algorithm fails the study; trials whose pods fail make
    it Failed with AllTrialsFailed."""
    sweeps = (Sweep("jax"), Sweep("port"))
    never = copy.deepcopy(JAX_TEMPLATE)
    never["spec"]["restartPolicy"] = "Never"   # a failed pod fails its job
    for sw in sweeps:
        sw.cluster.create(sw.S.new_studyjob(
            "sweep", **({"parameters": PARAMS} | kw),
            trial_template=never if sw.side == "jax"
            else template_view(never)))
        sw.drain()
        for _ in range(3):
            sw.kubelet.step()
            for job in sw.jobs():
                name = worker_name(job["metadata"]["name"], 0)
                if sw.cluster.get_or_none("v1", "Pod", name, "default"):
                    sw.kubelet.fail(name, exit_code=1)
            sw.drain()
    assert sweeps[1].view() == sweeps[0].view()
    assert pob.cond_is_true(sweeps[1].study(), PS.COND_FAILED)


def test_study_delete_cascades_to_trials():
    sweeps = (Sweep("jax"), Sweep("port"))
    for sw in sweeps:
        sw.cluster.create(sw.S.new_studyjob(
            "sweep", parameters=PARAMS, max_trials=4, parallel_trials=2,
            trial_template=JAX_TEMPLATE if sw.side == "jax"
            else template_view(JAX_TEMPLATE)))
        sw.drain()
        assert len(sw.jobs()) == 2
        sw.cluster.delete(sw.S.API_VERSION, sw.S.KIND, "sweep", "default")
        assert sw.jobs() == []
        assert sw.cluster.list("v1", "Pod") == []


# -- a sweep whose trials train ------------------------------------------------

TRIAL_CFG = dict(model="transformer-test", task="lm", global_batch=4,
                 seq_len=16, vocab_size=256, learning_rate=0.05,
                 warmup_steps=0, total_steps=3, log_every=1,
                 model_kwargs={"dtype": "float32"})
SWEEP_TIMEOUT = 120


def final_loss(log: str) -> float | None:
    """`final.loss` of a launcher's last summary line."""
    lines = [ln for ln in log.splitlines() if ln.startswith('{"summary"')]
    if not lines:
        return None
    return json.loads(lines[-1])["summary"]["final"].get("loss")


def test_two_trial_grid_trains_through_the_port(tmp_path):
    """Two trials (adamw, sgdm) of one GPU each, gang-scheduled on one
    2-GPU node, each a port launcher on the CPU; the collector reads
    each trial pod's final.loss into the objective annotation; the study
    ends Succeeded with the lower loss its bestTrial."""
    cluster = PCluster()
    cluster.create(new_gpu_node("gpu-node-0", product="nvidia-h100-80gb",
                                node_pool="train", gpus=2))
    for opt in ("adamw", "sgdm"):
        (tmp_path / f"{opt}.json").write_text(
            json.dumps({**TRIAL_CFG, "optimizer": opt}))
    shim = tmp_path / "bin"
    shim.mkdir()
    (shim / "python").write_text(
        f"#!/bin/sh\nexec {' '.join(NICE)} {sys.executable} \"$@\"\n")
    (shim / "python").chmod(0o755)

    def env_hook(pod, env):
        env["PATH"] = f"{shim}{os.pathsep}{env.get('PATH', '')}"
        env.update(JAXRT_METRICS_PORT="0", OMP_NUM_THREADS="1")
        return env

    executor = LocalPodExecutor(cluster, env_hook=env_hook, cwd=str(ROOT),
                                log_dir=str(tmp_path))

    def collector(job: dict) -> float | None:
        pod = worker_name(job["metadata"]["name"], 0)
        logs = [e for e in executor.logs if e["name"] == pod]
        if not logs:
            return None
        with open(logs[-1]["path"], errors="replace") as f:
            loss = final_loss(f.read())
        if loss is not None and pob.annotations_of(job).get(
                PS.ANNO_OBJECTIVE) != str(loss):
            cluster.patch(PJT.API_VERSION, PJT.KIND, job["metadata"]["name"],
                          {"metadata": {"annotations": {
                              PS.ANNO_OBJECTIVE: str(loss)}}}, "default")
        return loss

    ctls = [p_seed(PS.build_controller(cluster, collector=collector)),
            p_seed(p_jobs(cluster, record_events=False)),
            p_seed(build_scheduler(cluster, record_events=False))]
    tmpl = {"spec": {
        "replicas": 1, "schedulerName": SCHEDULER_NAME,
        "gpu": {"product": "nvidia-h100-80gb", "nodePool": "train",
                "gpusPerWorker": 1},
        "template": {"spec": {"containers": [{
            "name": "jax", "image": PJT.DEFAULT_IMAGE,
            "command": list(PJT.DEFAULT_COMMAND) + [
                "--config", str(tmp_path / "${opt}.json"),
                "--device", "cpu"]}]}}}}
    cluster.create(PS.new_studyjob(
        "sweep", parameters=[{"name": "opt", "parameterType": "categorical",
                              "feasible": {"list": ["adamw", "sgdm"]}}],
        trial_template=tmpl, max_trials=2, parallel_trials=2))
    conds, gated = [], {}
    pods = cluster.watch("v1", "Pod")    # each pod as first created
    deadline = time.monotonic() + SWEEP_TIMEOUT
    try:
        while True:
            for c in ctls:
                c.run_until_idle(advance_delayed=True)
            while (ev := pods.poll()) is not None:
                gated.setdefault(ev.object["metadata"]["name"],
                                 ev.object["spec"].get("schedulingGates")
                                 == [{"name": GATE_GANG}])
            executor.poll_once()
            study = cluster.get(PS.API_VERSION, PS.KIND, "sweep", "default")
            now = [c["type"] for c in study.get("status", {}).get(
                "conditions", []) if c["status"] == "True"]
            if not conds or conds[-1] != now:
                conds.append(now)
            if pob.cond_is_true(study, PS.COND_SUCCEEDED) or \
                    pob.cond_is_true(study, PS.COND_FAILED):
                break
            assert time.monotonic() < deadline, [
                open(e["path"]).read()[-1500:] for e in executor.logs]
            time.sleep(0.1)
    finally:
        executor.shutdown()
        pods.stop()
    assert pob.cond_is_true(study, PS.COND_SUCCEEDED), [
        open(e["path"]).read()[-1500:] for e in executor.logs]
    assert conds[0] == ["Running"] and conds[-1] == ["Succeeded"], conds
    assert gated == {"sweep-trial-0-worker-0": True,
                     "sweep-trial-1-worker-0": True}
    losses = {}
    for e in executor.logs:
        assert e["rc"] == 0
        with open(e["path"]) as f:
            losses[e["name"].split("-worker")[0]] = final_loss(f.read())
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses.values())
    best = study["status"]["bestTrial"]
    assert best["objective"] == min(losses.values())
    assert losses[best["trial"]] == best["objective"]
    for name, loss in losses.items():
        job = cluster.get(PJT.API_VERSION, PJT.KIND, name, "default")
        assert pob.annotations_of(job)[PS.ANNO_OBJECTIVE] == str(loss)
