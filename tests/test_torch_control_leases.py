"""The port's LeaderElector (kubeflow_tpu_torch/control/leases.py) and
ChaosClient (control/k8s/chaos.py) against the JAX package's.

One election script — acquire, stand-by, renew, takeover after expiry,
release and an immediate hand-off — on a manual clock gives the JAX
electors' answers and Lease objects on the JAX FakeCluster, and the
port's electors the same on the port's FakeCluster and over HTTP (the
port's RestClient to the port's ApiServer). One seeded chaos policy over
one call sequence gives the JAX ChaosClient's fault log, the same
exceptions and the same store afterwards.
"""

import pytest

from kubeflow_tpu.control import leases as RL
from kubeflow_tpu.control.k8s import chaos as RCh
from kubeflow_tpu.control.k8s import objects as RO
from kubeflow_tpu.control.k8s.fake import FakeCluster as RCluster
from kubeflow_tpu_torch.control import leases as PL
from kubeflow_tpu_torch.control.k8s import apiserver as PA
from kubeflow_tpu_torch.control.k8s import chaos as PCh
from kubeflow_tpu_torch.control.k8s import objects as PO
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster as PCluster

from test_torch_control_jaxjob import _strip


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def election(leases, client) -> list:
    """Each step's (a, b) answers, then the Lease as it stands."""
    clock = Clock()
    a, b = (leases.LeaderElector(client, "jaxservice-controller",
                                 identity=f"pod-{i}", lease_seconds=15.0,
                                 clock=clock) for i in "ab")
    out = []

    def step(name, *calls):
        out.append((name, [c() for c in calls],
                    _strip(client.get(leases.API_VERSION, leases.KIND,
                                      "jaxservice-controller", "kubeflow")
                           ["spec"], None)))

    step("acquire", a.try_acquire, b.try_acquire)
    clock.t += 10
    a._last_renew = -1e9        # force a real renew, not the cached flag
    step("renew", a.try_acquire, b.try_acquire)
    clock.t += 16               # past leaseDurationSeconds
    step("takeover", b.try_acquire, a.try_acquire)
    b.release()
    step("release", lambda: b.is_leader, a.try_acquire)
    return out


@pytest.mark.parametrize("backend", ["fake", "rest"])
def test_election_equals_the_jax_elector(backend):
    want = election(RL, RCluster())
    if backend == "fake":
        got = election(PL, PCluster())
    else:
        server = PA.ApiServer().serve_background()
        try:
            got = election(PL, PA.client_for(server))
        finally:
            server.shutdown()
    assert got == want
    assert [answers for _, answers, _ in got] == [
        [True, False], [True, False], [True, False], [False, True]]
    # MicroTime strings on the wire, the hand-off counted
    spec = got[-1][2]
    assert spec["holderIdentity"] == "pod-a"
    assert spec["leaseTransitions"] == 2
    assert isinstance(spec["renewTime"], str)


def chaos_run(chaos, ob, cluster) -> tuple:
    """A seeded policy over a fixed call sequence: the fault log, what
    each call raised, and the store's ConfigMaps afterwards."""
    policy = chaos.ChaosPolicy(seed=11, rate=0.4, latency=0.001)
    slept = []
    c = chaos.ChaosClient(cluster, policy, sleeper=slept.append)
    raised = []
    for i in range(40):
        name = f"cm{i % 7}"
        obj = ob.new_object("v1", "ConfigMap", name, "default")
        calls = (lambda: c.create(obj),
                 lambda: c.get_or_none("v1", "ConfigMap", name, "default"),
                 lambda: c.patch("v1", "ConfigMap", name,
                                 {"data": {"i": str(i)}}, "default"),
                 lambda: c.list("v1", "ConfigMap", "default"),
                 lambda: c.delete("v1", "ConfigMap", name, "default"))
        try:
            calls[i % len(calls)]()
            raised.append(None)
        except ob.ApiError as e:
            raised.append((type(e).__name__, getattr(e, "code", None),
                           getattr(e, "retry_after", None)))
    faults = [(f.call, f.verb, f.kind, f.fault) for f in c.fault_log()]
    store = sorted((o["metadata"]["name"], o.get("data"))
                   for o in cluster.list("v1", "ConfigMap", "default"))
    return faults, raised, store, slept


def test_chaos_fault_log_equals_the_jax_one_for_one_seed():
    want = chaos_run(RCh, RO, RCluster())
    got = chaos_run(PCh, PO, PCluster())
    assert got == want
    faults = got[0]
    assert {f[3].split(":")[0] for f in faults} == {
        "error", "conflict", "latency"}, faults
