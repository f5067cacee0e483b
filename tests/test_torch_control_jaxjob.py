"""The port's JAXJob controller (kubeflow_tpu_torch/control/jaxjob/)
against the JAX package's, each on its own FakeCluster with its own
FakeKubelet.

The same specs go to both controllers: rigid, multislice (sliceCount 2),
elastic Resize, elastic slice Shrink, gang_schedule with a priority,
and a template with its own env, scheduling gates and a traceparent.
The services and pods they make must be equal after the GPU mapping
(`gpu_view`): google.com/tpu limits become nvidia.com/gpu, the TPU
accelerator and topology selectors become the GPU product and node-pool
selectors, the default command and image become the port's, and the
libtpu MEGASCALE_* env keys, which the port never sets, are dropped.
Then one FakeKubelet script — Running, one pod Failed, one pod exit 75,
the node tainted for impending termination — must give equal job
status after every step (conditions, restarts, preemptions, the epoch
and the world stamp), equal events and equal lifecycle counters.
validate() gives equal messages on every spec fault but the topology
rule, which the port replaces (`TOPOLOGY_RULE`).
"""

import copy
import json
import pathlib

import pytest

from kubeflow_tpu.control.jaxjob import controller as RC
from kubeflow_tpu.control.jaxjob import types as RT
from kubeflow_tpu.control.k8s.fake import FakeCluster as RCluster
from kubeflow_tpu.control.k8s.kubelet import FakeKubelet as RKubelet
from kubeflow_tpu.control.runtime import seed_controller as r_seed
from kubeflow_tpu.runtime.metrics import MetricsRegistry as RRegistry
from kubeflow_tpu_torch.control.jaxjob import controller as PC
from kubeflow_tpu_torch.control.jaxjob import types as PT
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster as PCluster
from kubeflow_tpu_torch.control.k8s.kubelet import FakeKubelet as PKubelet
from kubeflow_tpu_torch.control.runtime import seed_controller as p_seed
from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry as PRegistry

# The mapping of the accelerator surface: a TPU accelerator to a GPU
# product, a slice topology to the node pool that holds that slice
PRODUCT = {"tpu-v5-lite-podslice": "nvidia-h100-80gb",
           "tpu-v5p-slice": "nvidia-a100-80gb"}
JAX_COMMAND = ["python", "-m", "kubeflow_tpu.runtime.launcher"]
JAX_IMAGE = "kubeflow-tpu/jaxrt:latest"
ROOT = pathlib.Path(__file__).resolve().parents[1]
TRACEPARENT = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
# fields the apiserver or the clock fills, never a decision
VOLATILE = {"uid", "resourceVersion", "creationTimestamp",
            "lastTransitionTime", "lastUpdateTime", "startTime",
            "completionTime", "startedAt", "firstTimestamp",
            "lastTimestamp", "managedFields"}


def pool_of(topology: str) -> str:
    """The node pool a TPU topology's slice maps to ("2X4" and "2x4" are
    one pool on both sides: the JAX package canonicalises the topology,
    the port the pool name)."""
    return f"pool-{topology}".lower()


def new_job(side: str, name: str, accelerator=None, topology=None,
            chips: int = 4, **kw) -> dict:
    if side == "jax":
        return RT.new_jaxjob(name, accelerator=accelerator,
                             topology=topology, chips_per_worker=chips, **kw)
    return PT.new_jaxjob(
        name, product=PRODUCT[accelerator] if accelerator else None,
        node_pool=f"pool-{topology}" if topology else None,
        gpus_per_worker=chips, **kw)


def _own_template(job: dict) -> dict:
    """A template with its own env (one key the controller also sets:
    the template's value wins), a foreign scheduling gate (kept beside
    the gang gate), annotations, and a job traceparent to propagate."""
    tmpl = job["spec"]["template"]
    tmpl["metadata"]["annotations"] = {"example.com/team": "ml"}
    tmpl["metadata"]["labels"] = {"app": "train"}
    tmpl["spec"]["schedulingGates"] = [{"name": "example.com/quota"}]
    tmpl["spec"]["containers"][0]["env"] = [
        {"name": "FOO", "value": "1"},
        {"name": "JAXJOB_NAMESPACE", "value": "from-template"}]
    job["metadata"]["annotations"] = {
        "obs.kubeflow.org/traceparent": TRACEPARENT}
    return job


SPECS = {
    "rigid": (dict(replicas=2, accelerator="tpu-v5-lite-podslice",
                   topology="2x4"), None),
    "multislice": (dict(replicas=2, slice_count=2,
                        accelerator="tpu-v5-lite-podslice",
                        topology="2x4"), None),
    "elastic_resize": (dict(replicas=4, accelerator="tpu-v5-lite-podslice",
                            topology="4x4", elastic_min=2), None),
    "elastic_slice_shrink": (dict(replicas=2, slice_count=2,
                                  accelerator="tpu-v5p-slice",
                                  topology="2x4", slice_policy="Shrink",
                                  min_slices=1), None),
    "gang_priority": (dict(replicas=2, accelerator="tpu-v5-lite-podslice",
                           topology="2X4", priority=7,
                           gang_schedule=True), None),
    "own_template": (dict(replicas=2, accelerator="tpu-v5-lite-podslice",
                          topology="2x4", gang_schedule=True),
                     _own_template),
}


class World:
    """One package's controller, FakeCluster, FakeKubelet and registry,
    with the Ready node the kubelet binds to."""

    def __init__(self, side: str, spec: str):
        jax = side == "jax"
        self.side = side
        self.cluster = (RCluster if jax else PCluster)()
        self.registry = (RRegistry if jax else PRegistry)()
        build = RC.build_controller if jax else PC.build_controller
        self.ctl = (r_seed if jax else p_seed)(
            build(self.cluster, record_events=True, registry=self.registry))
        self.kubelet = (RKubelet if jax else PKubelet)(self.cluster)
        self.T = RT if jax else PT
        self.cluster.create({
            "apiVersion": "v1", "kind": "Node",
            "metadata": {"name": "fake-node"},
            "status": {"conditions": [{"type": "Ready", "status": "True"}]}})
        kw, mutate = SPECS[spec]
        job = new_job(side, "train", **kw)
        self.cluster.create(mutate(job) if mutate else job)

    def pump(self) -> None:
        for _ in range(4):
            self.ctl.run_until_idle(advance_delayed=True)
            self.kubelet.step()
        self.ctl.run_until_idle(advance_delayed=True)

    def job(self) -> dict:
        return self.cluster.get(self.T.API_VERSION, self.T.KIND, "train",
                                "default")

    def fail(self, index: int, exit_code: int) -> None:
        name = f"train-worker-{index}"
        if self.cluster.get_or_none("v1", "Pod", name, "default"):
            self.kubelet.fail(name, exit_code=exit_code)

    def taint(self) -> None:
        node = self.cluster.get("v1", "Node", "fake-node")
        node.setdefault("spec", {})["taints"] = [
            {"key": self.T.TAINT_IMPENDING_TERMINATION,
             "effect": "NoSchedule"}]
        self.cluster.update(node)


def _strip(x, trace: str | None):
    """`x` without VOLATILE keys, its minted traceparent replaced."""
    text = json.dumps(x, sort_keys=True)
    if trace:
        text = text.replace(trace, "<traceparent>")
    x = json.loads(text)

    def walk(v):
        if isinstance(v, dict):
            return {k: walk(w) for k, w in v.items() if k not in VOLATILE}
        if isinstance(v, list):
            return [walk(w) for w in v]
        return v

    return walk(x)


def gpu_view(pod: dict) -> dict:
    """The pod the port must make for the JAX package's `pod`."""
    pod = copy.deepcopy(pod)
    spec = pod["spec"]
    if "nodeSelector" in spec:
        sel = {}
        for k, v in spec["nodeSelector"].items():
            if k == RT.NODESELECTOR_ACCEL:
                sel[PT.NODESELECTOR_ACCEL] = PRODUCT[v]
            elif k == RT.NODESELECTOR_TOPOLOGY:
                sel[PT.NODESELECTOR_POOL] = pool_of(v)
            else:
                sel[k] = v
        spec["nodeSelector"] = sel
    for c in spec["containers"]:
        limits = (c.get("resources") or {}).get("limits") or {}
        if RT.RESOURCE_TPU in limits:
            limits[PT.RESOURCE_GPU] = limits.pop(RT.RESOURCE_TPU)
        if c.get("command") == JAX_COMMAND:
            c["command"] = list(PT.DEFAULT_COMMAND)
        if c.get("image") == JAX_IMAGE:
            c["image"] = PT.DEFAULT_IMAGE
        c["env"] = [e for e in c.get("env") or []
                    if not e["name"].startswith("MEGASCALE_")]
    return pod


def snapshot(w: World) -> dict:
    """Job status, pods, services, events and the lifecycle counters of
    one world, free of volatile fields; JAX pods through gpu_view."""
    job = w.job()
    trace = job["metadata"].get("annotations", {}).get(
        "obs.kubeflow.org/traceparent")
    if trace == TRACEPARENT:
        trace = None        # the template's own: equal on both sides
    pods = sorted(w.cluster.list("v1", "Pod", namespace="default"),
                  key=lambda p: p["metadata"]["name"])
    if w.side == "jax":
        pods = [gpu_view(p) for p in pods]
    events = sorted(
        (e["reason"], e["type"], e["message"], e["count"],
         e["involvedObject"]["kind"], e["involvedObject"]["name"])
        for e in w.cluster.list("v1", "Event", namespace="default"))
    counters = {name: sorted((sorted(lab.items()), v)
                             for lab, v in w.registry.series(name))
                for name in ("jaxjob_gang_restart_total",
                             "jaxjob_resizes_total",
                             "jaxjob_slice_resizes_total")}
    return _strip({
        "status": job.get("status") or {},
        "epoch": (RC if w.side == "jax" else PC).gang_epoch(job),
        "pods": pods,
        "services": w.cluster.list("v1", "Service", namespace="default"),
        "events": events,
        "counters": counters,
    }, trace)


SCRIPT = (
    ("running", lambda w: None),
    ("one pod failed", lambda w: w.fail(1, 1)),
    ("one pod exit 75", lambda w: w.fail(0, RT.EXIT_PREEMPTED)),
    ("node tainted", lambda w: w.taint()),
)


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_pods_and_status_equal_the_reference_through_a_phase_script(spec):
    ref, port = World("jax", spec), World("port", spec)
    for step, act in SCRIPT:
        for w in (ref, port):
            act(w)
            w.pump()
        want, got = snapshot(ref), snapshot(port)
        for key in want:
            assert got[key] == want[key], (spec, step, key)
    # the script moved the job: a restart or a resize, and a preemption
    status = port.job()["status"]
    assert status.get("restarts", 0) + status.get("resizes", 0) >= 1, status
    if spec not in ("gang_priority", "own_template"):
        # an ungated gang ran: the taint or exit 75 was a preemption
        assert status.get("preemptions", 0) + status.get("resizes", 0) >= 1


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_every_pod_claims_gpus_and_runs_the_port(spec):
    w = World("port", spec)
    w.pump()
    pods = w.cluster.list("v1", "Pod", namespace="default")
    assert pods
    for p in pods:
        c = p["spec"]["containers"][0]
        assert c["resources"]["limits"] == {"nvidia.com/gpu": 4}
        assert c["command"] == ["python", "-m",
                                "kubeflow_tpu_torch.runtime.launcher"]
        sel = p["spec"]["nodeSelector"]
        assert sel["cloud.google.com/gke-accelerator"].startswith("nvidia-")
        assert not any("tpu" in k or "tpu" in str(v)
                       for k, v in sel.items())
        names = {e["name"] for e in c["env"]}
        assert not any(n.startswith("MEGASCALE_") for n in names)
    if spec == "multislice":
        env = {e["name"]: e["value"]
               for e in pods[-1]["spec"]["containers"][0]["env"]}
        assert env["JAXJOB_NUM_SLICES"] == "2"
        assert env["JAXJOB_SLICE_ID"] in ("0", "1")


# Spec faults: each mutates a valid job the same way on both sides
FAULTS = {
    "replicas": lambda s: s.update(replicas=0),
    "slice_count": lambda s: s.update(sliceCount=0),
    "containers": lambda s: s["template"]["spec"].update(containers=[]),
    "restart_policy": lambda s: s.update(restartPolicy="Always"),
    "port": lambda s: s.update(coordinatorPort=70000),
    "priority": lambda s: s.update(priority=True),
    "elastic_type": lambda s: s.update(elastic=[1]),
    "elastic_min_max": lambda s: s.update(
        elastic={"minReplicas": 3, "maxReplicas": 2}),
    "elastic_max": lambda s: s.update(elastic={"maxReplicas": 5}),
    "elastic_policies": lambda s: s.update(elastic={
        "resizePolicy": "Grow", "batchPolicy": "Double", "maxResizes": 0,
        "slicePolicy": "Split", "minSlices": 3}),
    "multislice_resize": lambda s: s.update(
        sliceCount=2, elastic={"minReplicas": 2, "maxReplicas": 4}),
    "elastic_user_command": lambda s: (
        s.update(elastic={"minReplicas": 1}),
        s["template"]["spec"]["containers"][0].update(
            args=["--", "python", "train.py"])),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_validate_messages_equal_the_reference(fault):
    ref = new_job("jax", "j", "tpu-v5-lite-podslice", "2x2")
    port = new_job("port", "j", "tpu-v5-lite-podslice", "2x2")
    for job in (ref, port):
        FAULTS[fault](job["spec"])
    want = RT.validate(ref)
    assert want
    assert PT.validate(port) == want


# The rule the port replaces: the JAX package holds replicas x
# chipsPerWorker to the slice topology's chips; a node pool has no shape
# to tile, so the port holds gpusPerWorker to a positive int instead.
TOPOLOGY_RULE = ("spec.tpu.topology", "spec.gpu.gpusPerWorker")


def test_the_topology_rule_is_the_one_difference():
    # replicas 3 cannot tile a 2x4 slice of 4-chip workers
    ref = new_job("jax", "j", "tpu-v5-lite-podslice", "2x4", replicas=3)
    port = new_job("port", "j", "tpu-v5-lite-podslice", "2x4", replicas=3)
    assert [m.split()[0] for m in RT.validate(ref)] == [TOPOLOGY_RULE[0]]
    assert PT.validate(port) == []
    # a worker claiming no GPUs: the reference skips the geometry check
    # when chipsPerWorker is 0, the port refuses it
    ref = new_job("jax", "j", "tpu-v5-lite-podslice", "2x4", chips=0)
    port = new_job("port", "j", "tpu-v5-lite-podslice", "2x4", chips=0)
    assert RT.validate(ref) == []
    assert [m.split()[0] for m in PT.validate(port)] == [TOPOLOGY_RULE[1]]
    port["spec"]["gpu"].update(gpusPerWorker=2, nodePool="  ")
    assert PT.validate(port) == [
        "spec.gpu.nodePool '  ' is not a node-pool name"]
    # the same rule with a consistent request: both accept
    ok = [new_job(s, "j", "tpu-v5-lite-podslice", "2x4", replicas=2)
          for s in ("jax", "port")]
    assert RT.validate(ok[0]) == PT.validate(ok[1]) == []


def test_mains_raise_until_the_rest_client_is_ported():
    import subprocess
    import sys

    for mod in ("kubeflow_tpu_torch.control.jaxjob",
                "kubeflow_tpu_torch.control.scheduler"):
        out = subprocess.run([sys.executable, "-m", mod], cwd=ROOT,
                             capture_output=True, text=True, timeout=60)
        assert out.returncode != 0
        assert "NotImplementedError" in out.stderr
        assert "item 20b" in out.stderr
