"""The port's alert-driven remediation (kubeflow_tpu_torch/obs/
remediate.py) against the JAX package's.

Seeded streams of alert transitions through both engines, with label
matchers, silences, per-action cooldowns, the global rate limit, dry
runs, declining and failing actions, and a small audit ring: the
decisions, the audit, ``obs_remediations_total`` in each registry and
the Events all equal. The three shipped actions act alike on each
package's cluster: the JAXService scale-up nudge (which the port's
JAXService controller then consumes), the cache relist, and cordon and
drain, on the port's GPU node (`new_gpu_node`) where the JAX package
has its TPU node.
"""

import numpy as np
import pytest

from kubeflow_tpu.control.cache import ClusterCache as RCache
from kubeflow_tpu.control.jaxservice import types as RST
from kubeflow_tpu.control.k8s.fake import FakeCluster as RCluster
from kubeflow_tpu.control.scheduler import SCHEDULER_NAME as R_SCHED
from kubeflow_tpu.control.scheduler.nodes import new_tpu_node
from kubeflow_tpu.obs import remediate as RM
from kubeflow_tpu.obs.events import EventRecorder as REvents
from kubeflow_tpu.runtime.metrics import MetricsRegistry as RRegistry
from kubeflow_tpu_torch.control.cache import ClusterCache as PCache
from kubeflow_tpu_torch.control.jaxservice import types as PST
from kubeflow_tpu_torch.control.jaxservice.controller import build_controller
from kubeflow_tpu_torch.control.k8s import objects as pob
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster as PCluster
from kubeflow_tpu_torch.control.runtime import seed_controller
from kubeflow_tpu_torch.control.scheduler import SCHEDULER_NAME as P_SCHED
from kubeflow_tpu_torch.control.scheduler.nodes import new_gpu_node
from kubeflow_tpu_torch.obs import remediate as PM
from kubeflow_tpu_torch.obs.events import EventRecorder as PEvents
from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry as PRegistry
from test_torch_control_profile import event_row
from test_torch_obs_tsdb import Clock

ALERTS = ("KVPagesExhausted", "NodeSLOBurn", "SchedulerPassSlow",
          "CheckpointFailures")


def action_for(M, name, log):
    """A scripted action: records its call, declines without a
    ``service`` label on one alert, fails on a ``boom`` label."""

    def act(tr):
        labels = tr.get("labels") or {}
        log.append((name, tr["alert"], tr.get("at")))
        if labels.get("boom"):
            raise RuntimeError(f"{name} failed on {labels['boom']}")
        if tr["alert"] == "KVPagesExhausted" and not labels.get("service"):
            raise M.SkipAction("transition has no service label")
        return f"{name} acted"

    return act


def bindings(M, log):
    return [
        M.Remediation("scale", "KVPagesExhausted",
                      action_for(M, "scale", log), cooldown_s=120.0),
        M.Remediation("scale-prod", "KVPagesExhausted",
                      action_for(M, "scale-prod", log), cooldown_s=60.0,
                      matchers={"namespace": "prod"}),
        M.Remediation("drain", "NodeSLOBurn", action_for(M, "drain", log),
                      cooldown_s=600.0),
        M.Remediation("relist", "SchedulerPassSlow",
                      action_for(M, "relist", log), cooldown_s=30.0),
    ]


def transitions(rng, at: float) -> list[dict]:
    out = []
    for _ in range(int(rng.integers(0, 5))):
        labels = {}
        if rng.random() < 0.8:
            labels["service"] = ("chat", "code")[int(rng.integers(2))]
        labels["namespace"] = ("default", "prod", "team-b")[
            int(rng.integers(3))]
        if rng.random() < 0.3:
            labels["node"] = f"gpu-node-{int(rng.integers(3))}"
        if rng.random() < 0.1:
            labels["boom"] = "yes"
        if rng.random() < 0.2:
            labels["tenant"] = "team-z"
        out.append({"alert": ALERTS[int(rng.integers(len(ALERTS)))],
                    "to": ("firing", "firing", "pending", "resolved")[
                        int(rng.integers(4))],
                    "labels": labels, "value": 0.0, "at": at})
    return out


def silenced(alert, labels, at):
    return labels.get("namespace") == "team-b" and 300 <= at < 900


@pytest.mark.parametrize("dry_run", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_engine_decisions_equal(seed, dry_run):
    rng = np.random.default_rng(seed)
    clock = Clock(0.0)
    logs = [], []
    clusters = PCluster(), RCluster()
    regs = PRegistry(), RRegistry()
    engines = [M.RemediationEngine(
        bindings(M, log), recorder=E(cluster, component="obs"), registry=reg,
        clock=clock, dry_run=dry_run, max_actions=3, rate_window_s=300.0,
        silenced=silenced, audit_limit=16)
        for M, log, E, cluster, reg in zip((PM, RM), logs, (PEvents, REvents),
                                           clusters, regs)]
    results = set()
    for _ in range(80):
        clock.t += float(rng.choice([5.0, 15.0, 45.0]))
        trs = transitions(rng, clock.t)
        at = None if rng.random() < 0.5 else clock.t
        got = engines[0].observe(trs, at=at)
        assert got == engines[1].observe(trs, at=at)
        results.update(d["result"] for d in got)
    assert logs[0] == logs[1]
    assert engines[0].audit() == engines[1].audit()
    assert len(engines[0].audit()) == 16
    assert regs[0].render() == regs[1].render()
    assert sorted(map(event_row, clusters[0].list("v1", "Event")), key=repr) \
        == sorted(map(event_row, clusters[1].list("v1", "Event")), key=repr)
    assert {PM.COOLDOWN, PM.RATE_LIMITED, PM.SILENCED,
            PM.DRY_RUN if dry_run else PM.EXECUTED} <= results, results


def test_scripted_decisions_reach_every_result():
    """One script through both engines that reaches each result: a
    live run, a cooldown, a silence, a declined action, a failed one,
    the rate limit, and after a window, a run again."""
    script = [
        (0.0, "KVPagesExhausted", {"service": "chat", "namespace": "prod"}),
        (10.0, "KVPagesExhausted", {"service": "chat"}),
        (300.0, "NodeSLOBurn", {"namespace": "team-b", "node": "n"}),
        (400.0, "NodeSLOBurn", {"node": "n", "boom": "yes"}),
        (500.0, "KVPagesExhausted", {"namespace": "x"}),
        (510.0, "SchedulerPassSlow", {}),
        (700.0, "SchedulerPassSlow", {}),
        (1500.0, "SchedulerPassSlow", {}),
    ]
    out = []
    for M, Reg in ((PM, PRegistry), (RM, RRegistry)):
        eng = M.RemediationEngine(bindings(M, []), registry=Reg(),
                                  max_actions=4, rate_window_s=900.0,
                                  silenced=silenced)
        out.append([d for at, alert, labels in script
                    for d in eng.observe([{"alert": alert, "to": "firing",
                                           "labels": labels}], at=at)])
    assert out[0] == out[1]
    assert [d["result"] for d in out[0]] == [
        "executed", "executed", "cooldown", "silenced", "error", "skipped",
        "rate_limited", "rate_limited", "executed"]


def test_register_and_default_remediations():
    for kw in ({}, {"client": object()}, {"cache": object()},
               {"client": object(), "cache": object(), "namespace": "x"}):
        got = [(r.name, r.alert, r.cooldown_s, r.matchers)
               for r in PM.default_remediations(**kw)]
        assert got == [(r.name, r.alert, r.cooldown_s, r.matchers)
                       for r in RM.default_remediations(**kw)]
    assert P_SCHED == R_SCHED
    for M in (PM, RM):
        eng = M.RemediationEngine(registry=PRegistry() if M is PM
                                  else RRegistry())
        eng.register(M.Remediation("a", "X", lambda tr: "ok"))
        assert eng.observe([{"alert": "X", "to": "firing", "labels": {}}],
                           at=1.0)[0]["result"] == M.EXECUTED


def _services():
    pc, rc = PCluster(), RCluster()
    pc.create(PST.new_jaxservice("chat", "default", min_replicas=1,
                                 max_replicas=3))
    rc.create(RST.new_jaxservice("chat", "default", min_replicas=1,
                                 max_replicas=3))
    for c, T in ((pc, PST), (rc, RST)):
        svc = c.get(T.API_VERSION, T.KIND, "chat", "default")
        svc["status"] = {"targetReplicas": 1}
        c.update_status(svc)
    return pc, rc


def test_scale_up_nudge_and_the_controller_consumes_it():
    pc, rc = _services()
    firing = {"alert": "KVPagesExhausted", "to": "firing", "at": 0.0,
              "labels": {"service": "chat", "namespace": "default",
                         "instance": "default/chat-replica-0"}}
    got = PM.scale_up_nudge_action(pc)(firing)
    assert got == RM.scale_up_nudge_action(rc)(firing) == \
        "nudged default/chat floor to 2 replicas"
    for c, T in ((pc, PST), (rc, RST)):
        svc = c.get(T.API_VERSION, T.KIND, "chat", "default")
        assert pob.annotations_of(svc)[T.ANNOTATION_SCALE_NUDGE] == "2"
    for M, c in ((PM, pc), (RM, rc)):
        with pytest.raises(M.SkipAction):
            M.scale_up_nudge_action(c)({"alert": "KVPagesExhausted",
                                        "to": "firing", "labels": {}})
    ctl = seed_controller(build_controller(pc, registry=PRegistry()))
    ctl.run_until_idle()
    svc = pc.get(PST.API_VERSION, PST.KIND, "chat", "default")
    assert svc["status"]["targetReplicas"] == 2
    assert PST.ANNOTATION_SCALE_NUDGE not in pob.annotations_of(svc)
    assert sorted(p["metadata"]["name"] for p in pc.list("v1", "Pod")) == [
        "chat-replica-0", "chat-replica-1"]


def test_cache_relist_action_equal():
    pc, rc = _services()
    caches = (PCache(pc, kinds=(("v1", "Pod"), (PST.API_VERSION, PST.KIND)))
              .connect(),
              RCache(rc, kinds=(("v1", "Pod"), (RST.API_VERSION, RST.KIND)))
              .connect())
    tr = {"alert": "SchedulerPassSlow", "to": "firing", "labels": {}}
    assert PM.cache_relist_action(caches[0])(tr) == \
        RM.cache_relist_action(caches[1])(tr) == "relisted 2 cached kind(s)"
    one = (("v1", "Pod"),)
    assert PM.cache_relist_action(caches[0], kinds=one)(tr) == \
        RM.cache_relist_action(caches[1], kinds=one)(tr) == \
        "relisted 1 cached kind(s)"
    assert len(caches[0].objects(PST.API_VERSION, PST.KIND)) == 1


def _pod(name, node, sched, phase):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"nodeName": node, "schedulerName": sched,
                     "containers": [{"name": "w", "image": "x"}]},
            "status": {"phase": phase}}


def test_cordon_drain_on_the_gpu_node():
    pc, rc = PCluster(), RCluster()
    pc.create(new_gpu_node("gpu-node-0", gpus=8))
    pc.create(new_gpu_node("gpu-node-1", gpus=8))
    rc.create(new_tpu_node("gpu-node-0"))
    rc.create(new_tpu_node("gpu-node-1"))
    pods = [("w0", "gpu-node-0", P_SCHED, "Running"),
            ("w1", "gpu-node-0", P_SCHED, "Pending"),
            ("w2", "gpu-node-0", P_SCHED, "Succeeded"),
            ("w3", "gpu-node-0", "default-scheduler", "Running"),
            ("w4", "gpu-node-1", P_SCHED, "Running")]
    for c in (pc, rc):
        for p in pods:
            c.create(_pod(*p))
    tr = {"alert": "NodeSLOBurn", "to": "firing",
          "labels": {"node": "gpu-node-0"}}
    got = PM.cordon_drain_action(pc)(tr)
    assert got == RM.cordon_drain_action(rc)(tr) == \
        "cordoned gpu-node-0, evicted 2 pod(s)"
    for c in (pc, rc):
        assert c.get("v1", "Node", "gpu-node-0")["spec"]["unschedulable"]
        assert not (c.get("v1", "Node", "gpu-node-1").get("spec") or {}) \
            .get("unschedulable")
    status = lambda c: {p["metadata"]["name"]: p["status"]  # noqa: E731
                        for p in c.list("v1", "Pod")}
    assert status(pc) == status(rc)
    assert status(pc)["w0"]["reason"] == "Evicted"
    assert status(pc)["w3"] == {"phase": "Running"}
    assert pc.get("v1", "Node", "gpu-node-0")["status"]["allocatable"] == \
        {"nvidia.com/gpu": 8}
    for M, c in ((PM, pc), (RM, rc)):
        with pytest.raises(M.SkipAction):
            M.cordon_drain_action(c)({"alert": "NodeSLOBurn",
                                      "to": "firing", "labels": {}})
    assert PM.cordon_drain_action(pc, scheduler_name="other")(tr) == \
        RM.cordon_drain_action(rc, scheduler_name="other")(tr) == \
        "cordoned gpu-node-0, evicted 0 pod(s)"
