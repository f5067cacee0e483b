"""The port's JAXService operator (kubeflow_tpu_torch/control/jaxservice/)
against the JAX package's, each on its own FakeCluster with its own
FakeKubelet, registry and manual clock.

The same specs go to both controllers — a min/max fleet, a
gang-scheduled fleet with a priority, a per-replica inflight cap, a
rollout with canary steps, and a template with its own env. The
services, pods, status and endpoints annotation must be equal after the
GPU mapping (`gpu_view`: nvidia.com/gpu for google.com/tpu, the product
and node-pool selectors for the accelerator and topology ones, the
port's server module and serving image) with each side's revision hash
and minted traceparent named, not compared (the hash covers ``gpu``
where the JAX package's covers ``tpu``). Then the closed loop under
``RegistrySignals``: a queue-driven scale-up, the cordon -> drained ->
deleted steps gated on the router's in-flight gauge, and a rollout's
promote and its rollback give equal status, annotations and
``jaxservice_*`` series after every step. validate() gives equal
messages on every spec fault but the topology rule (`TOPOLOGY_RULE`).
"""

import copy
import json

import pytest

from kubeflow_tpu.control.jaxjob import types as RJT
from kubeflow_tpu.control.jaxservice import controller as RC
from kubeflow_tpu.control.jaxservice import types as RT
from kubeflow_tpu.control.k8s.fake import FakeCluster as RCluster
from kubeflow_tpu.control.k8s.kubelet import FakeKubelet as RKubelet
from kubeflow_tpu.control.runtime import seed_controller as r_seed
from kubeflow_tpu.obs import trace as r_trace
from kubeflow_tpu.runtime.metrics import MetricsRegistry as RRegistry
from kubeflow_tpu.serving import router as RR
from kubeflow_tpu_torch.control.jaxjob import types as PJT
from kubeflow_tpu_torch.control.jaxservice import controller as PC
from kubeflow_tpu_torch.control.jaxservice import types as PT
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster as PCluster
from kubeflow_tpu_torch.control.k8s.kubelet import FakeKubelet as PKubelet
from kubeflow_tpu_torch.control.runtime import seed_controller as p_seed
from kubeflow_tpu_torch.obs import trace as p_trace
from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry as PRegistry
from kubeflow_tpu_torch.serving import router as PR

from test_torch_control_jaxjob import PRODUCT, VOLATILE, pool_of

JAX_SERVER = ["python", "-m", "kubeflow_tpu.serving"]
JAX_IMAGE = "kubeflow-tpu/platform:latest"
# The reference's rule this port replaces: a TPU slice topology must be
# NxM[xK]; the port checks the GPU request instead (jaxjob's rule)
TOPOLOGY_RULE = ("spec.tpu.topology", "spec.gpu.gpusPerWorker")
SERIES = ("jaxservice_replicas", "jaxservice_scale_total",
          "jaxservice_replica_restarts_total", "jaxservice_rollouts_total",
          "jaxservice_rollout_phase")


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def new_service(side: str, name: str = "chat", accelerator=None,
                topology=None, chips: int = 1, **kw) -> dict:
    kw.setdefault("model", "gpt-125m")
    if side == "jax":
        return RT.new_jaxservice(name, accelerator=accelerator,
                                 topology=topology,
                                 chips_per_replica=chips, **kw)
    return PT.new_jaxservice(
        name, product=PRODUCT[accelerator] if accelerator else None,
        node_pool=f"pool-{topology}" if topology else None,
        gpus_per_replica=chips, **kw)


def _max_inflight(svc):
    svc["spec"]["resilience"] = {"maxInflight": 8, "defaultBand": "critical"}
    return svc


def _canary(svc):
    svc["spec"]["rollout"] = {"maxSurge": 1, "maxUnavailable": 0,
                              "canarySteps": [0.25, 0.5, 1.0],
                              "analysisWindowSeconds": 10.0}
    return svc


def _own_template(svc):
    svc["spec"]["template"] = {
        "metadata": {"labels": {"app": "chat"},
                     "annotations": {"example.com/team": "ml"}},
        "spec": {"containers": [{
            "name": "serving", "image": "example.com/serving:v1",
            "env": [{"name": "FOO", "value": "1"},
                    {"name": "JAXSERVICE_REPLICA", "value": "own"}]}]}}
    return svc


SPECS = {
    "fleet": (dict(min_replicas=2, max_replicas=4,
                   accelerator="tpu-v5-lite-podslice", topology="2x2",
                   chips=4), None),
    "gang_priority": (dict(min_replicas=2, gang_schedule=True, priority=7,
                           accelerator="tpu-v5-lite-podslice",
                           topology="2X2", chips=1), None),
    "max_inflight": (dict(min_replicas=1, accelerator="tpu-v5p-slice",
                          topology="2x2", chips=2), _max_inflight),
    "rollout_canary": (dict(min_replicas=2, max_replicas=3), _canary),
    "own_template": (dict(min_replicas=1, gang_schedule=True,
                          accelerator="tpu-v5-lite-podslice",
                          topology="2x2"), _own_template),
}


class World:
    """One package's JAXService controller, FakeCluster, FakeKubelet,
    registry and clock; ``signals`` wires RegistrySignals over the
    registry and a TokenRouter sharing it."""

    def __init__(self, side: str, svc: dict | None = None,
                 signals: bool = False, analysis=None):
        jax = side == "jax"
        self.side = side
        self.T = RT if jax else PT
        self.cluster = (RCluster if jax else PCluster)(history_limit=8192)
        self.registry = (RRegistry if jax else PRegistry)()
        self.clock = Clock()
        router_mod = RR if jax else PR
        sig = router_mod.RegistrySignals(self.registry) if signals else None
        build = (RC if jax else PC).build_controller
        self.ctl = (r_seed if jax else p_seed)(build(
            self.cluster, record_events=True, registry=self.registry,
            signals=sig, clock=self.clock, rollout_analysis=analysis))
        self.kubelet = (RKubelet if jax else PKubelet)(self.cluster)
        extra = {"prom_sink": False} if jax else {}
        self.router = router_mod.TokenRouter(
            service="chat", namespace="default", clock=self.clock,
            registry=self.registry, replica_token_budget=64,
            tracer=(r_trace if jax else p_trace).Tracer(), **extra)
        if svc is not None:
            self.cluster.create(svc)

    def pump(self, rounds: int = 6) -> None:
        for _ in range(rounds):
            self.ctl.run_until_idle(advance_delayed=True)
            self.kubelet.step()

    def svc(self) -> dict:
        return self.cluster.get(self.T.API_VERSION, self.T.KIND, "chat",
                                "default")

    def sync(self):
        return self.router.sync_from_object(self.svc())


def gpu_view(pod: dict) -> dict:
    """The replica pod the port must make for the JAX package's `pod`."""
    pod = copy.deepcopy(pod)
    spec = pod["spec"]
    if "nodeSelector" in spec:
        sel = {}
        for k, v in spec["nodeSelector"].items():
            if k == RJT.NODESELECTOR_ACCEL:
                sel[PJT.NODESELECTOR_ACCEL] = PRODUCT[v]
            elif k == RJT.NODESELECTOR_TOPOLOGY:
                sel[PJT.NODESELECTOR_POOL] = pool_of(v)
            else:
                sel[k] = v
        spec["nodeSelector"] = sel
    for c in spec["containers"]:
        limits = (c.get("resources") or {}).get("limits") or {}
        if RJT.RESOURCE_TPU in limits:
            limits[PJT.RESOURCE_GPU] = limits.pop(RJT.RESOURCE_TPU)
        if c.get("command", [])[:3] == JAX_SERVER:
            c["command"] = ["python", "-m", "kubeflow_tpu_torch.serving",
                            *c["command"][3:]]
        if c.get("image") == JAX_IMAGE:
            c["image"] = PJT.SERVING_IMAGE
    return pod


def spec_view(spec: dict) -> dict:
    """The spec the port is given for the JAX package's `spec`."""
    spec = copy.deepcopy(spec)
    tpu = spec.pop("tpu", None)
    if tpu:
        spec["gpu"] = {"product": PRODUCT[tpu["accelerator"]],
                       "nodePool": f"pool-{tpu['topology']}",
                       "gpusPerWorker": tpu["chipsPerWorker"]}
    return spec


def snapshot(w: World) -> dict:
    """Status, annotations, pods, services and the jaxservice_* series
    of one world, free of volatile fields; each side's revision hashes
    and minted traceparent replaced by names."""
    svc = w.svc()
    pods = sorted(w.cluster.list("v1", "Pod", namespace="default"),
                  key=lambda p: p["metadata"]["name"])
    if w.side == "jax":
        pods = [gpu_view(p) for p in pods]
    series = {name: sorted((sorted(lab.items()), v)
                           for lab, v in w.registry.series(name))
              for name in SERIES}
    status = copy.deepcopy(svc.get("status") or {})
    if w.side == "jax":
        snaps = status.get("revisions", {}).get("snapshots", {})
        for rev in snaps:
            snaps[rev] = spec_view(snaps[rev])
    snap = {"status": status,
            "annotations": svc["metadata"].get("annotations") or {},
            "pods": pods,
            "services": w.cluster.list("v1", "Service",
                                       namespace="default"),
            "series": series}
    text = json.dumps(snap, sort_keys=True)
    revs = set((svc.get("status") or {}).get("revisions", {})
               .get("snapshots", {}))
    revs |= {p["metadata"].get("labels", {}).get(w.T.LABEL_REVISION)
             for p in pods}
    revs |= {json.loads(text).get("status", {}).get("revisions", {})
             .get(k) for k in ("current", "target", "previous", "aborted")}
    # name each revision by the first spec ref that minted it
    names = {}
    for rev, spec in ((svc.get("status") or {}).get("revisions", {})
                      .get("snapshots", {}).items()):
        names[rev] = f"<rev:{spec['model']['ref']}>"
    for rev in sorted(r for r in revs if r):
        text = text.replace(rev, names.get(rev, "<rev>"))
    trace = svc["metadata"].get("annotations", {}).get(
        "obs.kubeflow.org/traceparent")
    if trace:
        text = text.replace(trace, "<traceparent>")
    x = json.loads(text)

    def walk(v):
        if isinstance(v, dict):
            return {k: walk(u) for k, u in v.items() if k not in VOLATILE}
        if isinstance(v, list):
            return [walk(u) for u in v]
        return v

    return walk(x)


def assert_equal(ref: World, port: World, step: str) -> None:
    want, got = snapshot(ref), snapshot(port)
    for key in want:
        assert got[key] == want[key], (step, key)


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_pods_services_and_status_equal_the_reference(spec):
    kw, mutate = SPECS[spec]
    worlds = []
    for side in ("jax", "port"):
        svc = new_service(side, **kw)
        worlds.append(World(side, mutate(svc) if mutate else svc))
    for w in worlds:
        w.pump()
    assert_equal(*worlds, "provisioned")
    port = worlds[1]
    pods = port.cluster.list("v1", "Pod", namespace="default")
    # gang-scheduled replicas wait for the scheduler's gate to lift
    ready = 0 if kw.get("gang_schedule") else len(pods)
    assert pods and port.svc()["status"]["replicas"]["ready"] == ready
    for p in pods:
        c = p["spec"]["containers"][0]
        assert c["command"][:3] == ["python", "-m",
                                    "kubeflow_tpu_torch.serving"]
        if spec != "rollout_canary":     # the one spec without a GPU
            assert c["resources"]["limits"] == {
                PJT.RESOURCE_GPU: kw.get("chips", 1)}
            assert p["spec"]["nodeSelector"][PJT.NODESELECTOR_POOL] == \
                pool_of(kw["topology"])


def test_scale_up_and_the_drain_steps_equal_the_reference():
    worlds = [World(side, new_service(side, min_replicas=1, max_replicas=3,
                                      target_queue_depth=4,
                                      up_stabilization_s=1.0,
                                      down_stabilization_s=2.0),
                    signals=True) for side in ("jax", "port")]
    tickets = {}
    steps = (
        ("one replica", lambda w: None),
        ("queue pressure seen", lambda w: tickets.setdefault(
            w.side, [w.router.submit(32) for _ in range(20)])),
        ("scaled up", lambda w: setattr(w.clock, "t", w.clock.t + 1.5)),
        ("members synced", lambda w: w.sync()),
        # the queue drains: every ticket completes, the routed ones first
        ("demand gone", lambda w: [w.router.complete(t)
                                   for t in tickets[w.side]
                                   if t.member is not None
                                   and t.member.name != "chat-replica-2"]),
        ("scale-down pending", lambda w: setattr(w.clock, "t",
                                                 w.clock.t + 3.0)),
        ("cordoned, draining", lambda w: w.sync()),
        ("drained", lambda w: [w.router.complete(t) for t in
                               list(tickets[w.side]) if t.member is not None
                               and not t.resolved]),
        ("deleted", lambda w: w.sync()),
    )
    seen = []
    for step, act in steps:
        for w in worlds:
            act(w)
            w.pump()
        assert_equal(*worlds, step)
        st = worlds[1].svc()["status"]
        seen.append((st["targetReplicas"], st["replicas"]["cordoned"]))
    # the path the loop took: up to 3, one cordoned, then 2 and none
    assert (3, 0) in seen and any(c == 1 for _, c in seen)
    assert seen[-1] == (2, 0), seen


@pytest.mark.parametrize("healthy", [True, False],
                         ids=["promote", "rollback"])
def test_rollout_promote_and_rollback_equal_the_reference(healthy):
    worlds = []
    for side in ("jax", "port"):
        svc = _canary(new_service(side, min_replicas=2))
        svc["spec"]["rollout"]["canarySteps"] = [0.5, 1.0]
        worlds.append(World(side, svc, signals=True,
                            analysis=None if healthy else
                            (lambda *a: False)))
    for w in worlds:
        w.pump()
    for w in worlds:
        s = w.svc()
        s["spec"]["model"]["ref"] = "gpt-125m-v2"
        w.cluster.update(s)
    for step in range(14):
        for w in worlds:
            w.pump(rounds=2)
            w.clock.t += 6.0
        assert_equal(*worlds, f"rollout step {step}")
    rev = PT.revisions_status(worlds[1].svc())
    outcome = {lab["outcome"]: v for lab, v in
               worlds[1].registry.series("jaxservice_rollouts_total")}
    assert rev["phase"] == PT.PHASE_IDLE
    if healthy:
        assert outcome == {"promoted": 1.0, "rolled_back": 0.0,
                           "aborted": 0.0}
    else:
        assert rev["aborted"] and outcome == {
            "promoted": 0.0, "rolled_back": 1.0, "aborted": 1.0}


BAD = (
    ("no ref", lambda s: s["model"].update(ref="")),
    ("min > max", lambda s: s.update(replicas={"min": 3, "max": 2})),
    ("port", lambda s: s.update(port=70000)),
    ("band", lambda s: s.update(resilience={"defaultBand": "gold"})),
    ("steps", lambda s: s.update(rollout={"canarySteps": [0.5, 0.2]})),
    ("queue", lambda s: s["autoscaling"].update(targetQueueDepth=0)),
    ("drain", lambda s: s.update(drainSeconds=-1)),
)


@pytest.mark.parametrize("fault", [name for name, _ in BAD])
def test_validate_messages_equal_the_reference(fault):
    mutate = dict(BAD)[fault]
    ref = new_service("jax", accelerator="tpu-v5-lite-podslice",
                      topology="2x2")
    port = new_service("port", accelerator="tpu-v5-lite-podslice",
                       topology="2x2")
    mutate(ref["spec"])
    mutate(port["spec"])
    assert PT.validate(port) == RT.validate(ref) != []


def test_the_topology_rule_is_the_one_difference():
    ref = new_service("jax", accelerator="tpu-v5-lite-podslice",
                      topology="2by2")
    port = new_service("port", accelerator="tpu-v5-lite-podslice",
                       topology="2x2", chips=0)
    assert [m.split()[0] for m in RT.validate(ref)] == [TOPOLOGY_RULE[0]]
    assert [m.split()[0] for m in PT.validate(port)] == [TOPOLOGY_RULE[1]]
    port["spec"]["gpu"].update(gpusPerWorker=1, nodePool="  ")
    assert PT.validate(port) == [
        "spec.gpu.nodePool '  ' is not a node-pool name"]
