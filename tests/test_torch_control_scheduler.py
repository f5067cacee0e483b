"""The port's gang scheduler (kubeflow_tpu_torch/control/scheduler/)
against the JAX package's: the same clusters, with each TPU pool's
(accelerator, topology) mapped to a GPU pool's (product, node pool) and
chips to GPUs, and the same gangs, driven through each package's JAXJob
controller, scheduler and a non-binding FakeKubelet on a fake clock.
After every step the bindings, the Pending set, the evicted pods
(preemption victims and node-death evictions), the jobs' status and the
scheduler's counters must be equal: all-or-nothing admission, a gang
left Pending behind a running one, priority preemption, partial elastic
admission and grow-back, spot-first placement, slice-per-pool multislice
placement, the pool key's single spelling and node death.
"""

import ast
import json
import pathlib

import pytest

from kubeflow_tpu.control.jaxjob import types as RT
from kubeflow_tpu.control.jaxjob.controller import (
    build_controller as r_controller,
)
from kubeflow_tpu.control.k8s.fake import FakeCluster as RCluster
from kubeflow_tpu.control.k8s.kubelet import FakeKubelet as RKubelet
from kubeflow_tpu.control.runtime import seed_controller as r_seed
from kubeflow_tpu.control.scheduler.nodes import new_tpu_node
from kubeflow_tpu.control.scheduler.scheduler import (
    build_scheduler as r_scheduler,
)
from kubeflow_tpu.runtime.metrics import MetricsRegistry as RRegistry
from kubeflow_tpu_torch.control.jaxjob import types as PT
from kubeflow_tpu_torch.control.jaxjob.controller import (
    build_controller as p_controller,
)
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster as PCluster
from kubeflow_tpu_torch.control.k8s.kubelet import FakeKubelet as PKubelet
from kubeflow_tpu_torch.control.runtime import seed_controller as p_seed
from kubeflow_tpu_torch.control.scheduler import nodes as PN
from kubeflow_tpu_torch.control.scheduler.nodes import new_gpu_node
from kubeflow_tpu_torch.control.scheduler.scheduler import (
    build_scheduler as p_scheduler,
)
from kubeflow_tpu_torch.control.scheduler.topology import normalize_pool
from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry as PRegistry

from test_torch_control_jaxjob import PRODUCT, VOLATILE, pool_of

PORT = pathlib.Path(__file__).resolve().parents[1] / "kubeflow_tpu_torch"
ACCEL = "tpu-v5-lite-podslice"
COUNTERS = ("scheduler_gangs_admitted_total", "scheduler_preemptions_total",
            "scheduler_spot_admissions_total",
            "scheduler_slice_admissions_total", "scheduler_requeues_total",
            "scheduler_node_evictions_total", "scheduler_queue_depth",
            "jaxjob_gang_restart_total")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


class World:
    """One package's JAXJob controller and gang scheduler on one
    FakeCluster; the kubelet runs only scheduler-bound pods."""

    def __init__(self, side: str):
        jax = side == "jax"
        self.side = side
        self.clock = FakeClock()
        self.cluster = (RCluster if jax else PCluster)()
        self.registry = (RRegistry if jax else PRegistry)()
        self.T = RT if jax else PT
        self.ctls = [
            (r_seed if jax else p_seed)((r_controller if jax else p_controller)(
                self.cluster, record_events=False)),
            (r_seed if jax else p_seed)((r_scheduler if jax else p_scheduler)(
                self.cluster, registry=self.registry, record_events=False,
                clock=self.clock))]
        self.kubelet = (RKubelet if jax else PKubelet)(self.cluster,
                                                        auto_bind=False)

    def node(self, name: str, topology: str = "2x4", chips: int = 4,
             **kw) -> None:
        if self.side == "jax":
            self.cluster.create(new_tpu_node(
                name, accelerator=ACCEL, topology=topology,
                chips_per_node=chips, **kw))
        else:
            self.cluster.create(new_gpu_node(
                name, product=PRODUCT[ACCEL], node_pool=pool_of(topology),
                gpus=chips, **kw))

    def gang(self, name: str, replicas: int = 2, topology: str = "2x4",
             chips: int = 4, namespace: str = "default", **kw) -> None:
        if self.side == "jax":
            job = RT.new_jaxjob(name, namespace, replicas=replicas,
                                accelerator=ACCEL, topology=topology,
                                chips_per_worker=chips, gang_schedule=True,
                                **kw)
        else:
            job = PT.new_jaxjob(name, namespace, replicas=replicas,
                                product=PRODUCT[ACCEL],
                                node_pool=f"pool-{topology}",
                                gpus_per_worker=chips, gang_schedule=True,
                                **kw)
        self.cluster.create(job)

    def not_ready(self, name: str) -> None:
        node = self.cluster.get("v1", "Node", name)
        node["status"]["conditions"] = [{"type": "Ready", "status": "False"}]
        self.cluster.update(node)

    def succeed(self, job: str) -> None:
        for p in self.cluster.list("v1", "Pod"):
            if p["metadata"]["labels"].get(self.T.LABEL_JOB_NAME) == job \
                    and (p.get("status") or {}).get("phase") == "Running":
                self.kubelet.succeed(p["metadata"]["name"],
                                     p["metadata"]["namespace"])

    def pump_controller(self) -> None:
        self.ctls[0].run_until_idle(advance_delayed=True)

    def pump_scheduler(self) -> None:
        self.ctls[1].run_until_idle(advance_delayed=True)

    def pump(self, rounds: int = 10) -> None:
        for _ in range(rounds):
            for c in self.ctls:
                c.run_until_idle(advance_delayed=True)
            self.kubelet.step()
            self.clock.t += 1.0

    def decisions(self) -> dict:
        pods = sorted(self.cluster.list("v1", "Pod"),
                      key=lambda p: (p["metadata"]["namespace"],
                                     p["metadata"]["name"]))
        key = [f"{p['metadata']['namespace']}/{p['metadata']['name']}"
               for p in pods]
        jobs = {j["metadata"]["name"]: _strip(j.get("status") or {})
                for j in self.cluster.list(self.T.API_VERSION, self.T.KIND)}
        return {
            "bindings": {k: p["spec"].get("nodeName")
                         for k, p in zip(key, pods)},
            "pending": sorted(k for k, p in zip(key, pods)
                              if p["spec"].get("schedulingGates")),
            "evicted": sorted(k for k, p in zip(key, pods)
                              if (p.get("status") or {}).get("reason")
                              == "Evicted"),
            "jobs": jobs,
            "counters": {n: sorted((sorted(lab.items()), v)
                                   for lab, v in self.registry.series(n))
                         for n in COUNTERS},
        }


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in VOLATILE}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


# Each scenario: steps of (method, args, kwargs) on World, a comparison
# after each "pump", and what the port must have decided at the end
SCENARIOS = {
    "all_or_nothing": [
        ("node", ("n0",), {}), ("gang", ("g",), {}), ("pump",),
        ("node", ("n1",), {}), ("pump",)],
    "third_gang_pending": [
        ("node", ("n0",), {}), ("node", ("n1",), {}),
        ("gang", ("a",), {}), ("pump",),
        ("gang", ("b",), {}), ("pump",),
        ("succeed", ("a",), {}), ("pump",)],
    "priority_preemption": [
        ("node", ("n0",), {}), ("node", ("n1",), {}),
        ("gang", ("low",), {}), ("pump",),
        ("gang", ("high",), dict(priority=10)), ("pump_controller",),
        ("pump_scheduler",), ("pump",)],
    "elastic_partial_then_grow": [
        ("node", ("n0",), dict(topology="4x4")),
        ("node", ("n1",), dict(topology="4x4")),
        ("gang", ("e",), dict(replicas=4, topology="4x4", elastic_min=2)),
        ("pump",), ("node", ("n2",), dict(topology="4x4")),
        ("node", ("n3",), dict(topology="4x4")), ("pump",)],
    "spot_first": [
        ("node", ("od0",), {}), ("node", ("od1",), {}),
        ("node", ("sp0",), dict(spot=True)),
        ("node", ("sp1",), dict(spot=True)),
        ("gang", ("el",), dict(elastic_min=1)), ("pump",),
        ("gang", ("rigid",), {}), ("pump",)],
    "slice_per_pool": [
        ("node", ("a0",), {}), ("node", ("a1",), {}),
        ("node", ("b0",), dict(topology="4x4")),
        ("node", ("b1",), dict(topology="4x4")),
        ("gang", ("ms",), dict(slice_count=2)), ("pump",)],
    "pool_spelling": [
        ("node", ("n0",), {}), ("node", ("n1",), {}),
        ("gang", ("g",), dict(topology="2X4")), ("pump",)],
    "node_death": [
        ("node", ("n0",), {}), ("node", ("n1",), {}), ("node", ("n2",), {}),
        ("gang", ("g",), {}), ("pump",), ("not_ready", ("n0",), {}),
        ("pump_scheduler",), ("pump",)],
    "tenants": [
        ("node", ("n0",), {}), ("node", ("nb",), dict(topology="2x2")),
        ("gang", ("big",), dict(priority=10)),
        ("gang", ("fit",), dict(replicas=1, topology="2x2",
                                namespace="tenant-b")), ("pump",)],
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_decisions_equal_the_reference(scenario):
    ref, port = World("jax"), World("port")
    victims = None
    for n, step in enumerate(SCENARIOS[scenario]):
        name, args, kwargs = (*step, (), {})[:3]
        for w in (ref, port):
            getattr(w, name)(*args, **kwargs)
        if name.startswith("pump"):
            want, got = ref.decisions(), port.decisions()
            for key in want:
                assert got[key] == want[key], (scenario, n, key)
        if name == "pump_scheduler":
            # the victims, before the JAXJob controller restarts them
            victims = port.decisions()["evicted"]
    got = port.decisions()
    b = got["bindings"]
    if scenario == "all_or_nothing":
        assert sorted(b.values()) == ["n0", "n1"]
    elif scenario == "third_gang_pending":
        assert sorted(v for k, v in b.items() if "/b-" in k) == ["n0", "n1"]
    elif scenario == "priority_preemption":
        assert sorted(v for k, v in b.items() if "/high-" in k) == \
            ["n0", "n1"]
        assert got["jobs"]["low"]["preemptions"] == 1
        assert victims == ["default/low-worker-0", "default/low-worker-1"]
    elif scenario == "elastic_partial_then_grow":
        assert sorted(v for v in b.values() if v) == ["n0", "n1", "n2", "n3"]
    elif scenario == "spot_first":
        assert sorted(v for k, v in b.items() if "/el-" in k) == \
            ["sp0", "sp1"]
        assert sorted(v for k, v in b.items() if "/rigid-" in k) == \
            ["od0", "od1"]
    elif scenario == "slice_per_pool":
        pools = [{b[f"default/ms-worker-{i}"][0] for i in s}
                 for s in ((0, 1), (2, 3))]
        assert all(len(p) == 1 for p in pools) and pools[0] != pools[1]
    elif scenario == "pool_spelling":
        assert sorted(b.values()) == ["n0", "n1"]
    elif scenario == "node_death":
        assert got["jobs"]["g"]["preemptions"] == 1
        assert victims == ["default/g-worker-0"]
        assert sorted(b.values()) == ["n1", "n2"]
    elif scenario == "tenants":
        assert b["tenant-b/fit-worker-0"] == "nb"


def test_third_gang_stays_pending_while_the_first_runs():
    """The all-or-nothing control phase 34 holds on the card: a 1-GPU
    gang submitted beside a running 2-worker gang on a 2-GPU node stays
    gated and unbound until the first gang's pods end."""
    w = World("port")
    w.cluster.create(new_gpu_node("gpu0", product="nvidia-h100-80gb",
                                  node_pool="card", gpus=2))
    for name, replicas in (("gang", 2), ("third", 1)):
        w.cluster.create(PT.new_jaxjob(
            name, replicas=replicas, product="nvidia-h100-80gb",
            node_pool="card", gpus_per_worker=1, gang_schedule=True))
        w.pump()
    d = w.decisions()
    assert d["bindings"]["default/gang-worker-0"] == "gpu0"
    assert d["bindings"]["default/gang-worker-1"] == "gpu0"
    assert d["pending"] == ["default/third-worker-0"]
    w.succeed("gang")
    w.pump()
    assert w.decisions()["bindings"]["default/third-worker-0"] == "gpu0"


def test_node_model_reads_nvidia_gpus():
    node = new_gpu_node("n", product="nvidia-h100-80gb", node_pool=" Pool-A ",
                        gpus=8)
    v = PN.node_view(node)
    assert v.allocatable_gpus == 8 and v.ready
    assert v.labels == {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb",
                        "cloud.google.com/gke-nodepool": "pool-a"}
    pod = {"spec": {"containers": [
        {"resources": {"limits": {"nvidia.com/gpu": 2}}},
        {"name": "sidecar"}]}}
    assert PN.pod_gpu_request(pod) == 2
    assert PN.pod_gpu_request({"spec": {"containers": [
        {"resources": {"limits": {"google.com/tpu": 4}}}]}}) == 0


@pytest.mark.parametrize("bad", ["", "   ", None])
def test_pool_key_normaliser(bad):
    assert normalize_pool(" GPU-Pool ") == "gpu-pool"
    with pytest.raises(ValueError):
        normalize_pool(bad)


def test_single_spelling_of_the_pool_key():
    """The one normaliser: no module of the port's control plane but
    scheduler/topology.py lower-cases or strips a string itself, and
    every module that reads the pool key imports the normaliser."""
    offenders = []
    for path in sorted((PORT / "control").rglob("*.py")):
        if path.relative_to(PORT).as_posix() == \
                "control/scheduler/topology.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("lower", "casefold") \
                    and not node.args:
                offenders.append(f"{path.name}:{node.lineno}")
    assert offenders == []
    for rel in ("control/jaxjob/types.py", "control/jaxjob/controller.py",
                "control/scheduler/nodes.py"):
        assert "control.scheduler.topology import normalize_pool" in \
            (PORT / rel).read_text(), rel


def test_no_tpu_names_in_the_port_control_plane():
    """google.com/tpu and the gke-tpu- labels appear in the port's
    control plane only in comments and docstrings that cite the JAX
    package."""
    for path in sorted((PORT / "control").rglob("*.py")):
        tree = ast.parse(path.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef))
                and n.body and isinstance(n.body[0], ast.Expr)
                and isinstance(n.body[0].value, ast.Constant)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and id(node) not in docs:
                assert "google.com/tpu" not in node.value, path
                assert "gke-tpu-" not in node.value, path


def test_metrics_render_without_prometheus_client():
    w = World("port")
    w.node("n0", topology="2x2")
    w.gang("g", replicas=1, topology="2x2")
    w.pump()
    text = w.registry.render()
    assert 'scheduler_gangs_admitted_total{namespace="default",' \
           'tenant="default"} 1.0' in text
    assert "jaxjob_gang_schedule_seconds_count 1" in text
    assert "scheduler_pass_seconds_count" in text
    json.dumps(w.decisions())
