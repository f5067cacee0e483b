"""The port's Tensorboard controller (kubeflow_tpu_torch/control/
tensorboard/) against the JAX package's.

The same Tensorboard CRs, their log paths drawn from a seed with numpy
(cloud paths, local paths, none), go through both packages' generators
and through each reconciler on its own FakeCluster: the Deployment,
Service and VirtualService are equal except the image, which is the
port's TENSORBOARD_IMAGE for the JAX package's DEFAULT_IMAGE; the CRD
manifests are equal. The cases mirror the Tensorboard half of
tests/test_profile_tensorboard.py.
"""

import numpy as np
import pytest

from kubeflow_tpu.control.k8s.fake import FakeCluster as RCluster
from kubeflow_tpu.control.runtime import Request as RRequest
from kubeflow_tpu.control.runtime import seed_controller as r_seed
from kubeflow_tpu.control.tensorboard import controller as RTB
from kubeflow_tpu_torch.control.jaxjob.types import TENSORBOARD_IMAGE
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster as PCluster
from kubeflow_tpu_torch.control.runtime import Request as PRequest
from kubeflow_tpu_torch.control.runtime import seed_controller as p_seed
from kubeflow_tpu_torch.control.tensorboard import controller as PTB
from test_torch_control_profile import strip

PATHS = ("gs://bucket/runs", "s3://b/r", "/cns/x/logs", "/data/logs",
         "/mnt/nfs/team/profile", "")


def as_port(x):
    """The JAX package's object as the port must make it: its default
    image becomes the port's."""
    if isinstance(x, dict):
        return {k: as_port(v) for k, v in x.items()}
    if isinstance(x, list):
        return [as_port(v) for v in x]
    return TENSORBOARD_IMAGE if x == RTB.DEFAULT_IMAGE else x


def seeded_tensorboard(seed: int) -> tuple[str, str, str]:
    rng = np.random.default_rng(seed)
    return (f"tb{int(rng.integers(100))}",
            str(rng.choice(["default", "team-ml", "kubeflow-user"])),
            str(rng.choice(PATHS)))


@pytest.mark.parametrize("seed", range(8))
def test_generators_equal_but_the_image(seed, monkeypatch):
    monkeypatch.setenv("ISTIO_GATEWAY", "kubeflow/gpu-gateway")
    name, ns, logspath = seeded_tensorboard(seed)
    r = RTB.new_tensorboard(name, ns, logspath)
    p = PTB.new_tensorboard(name, ns, logspath)
    assert p == r
    rr, pr = RTB.TensorboardReconciler(), PTB.TensorboardReconciler()
    want = rr.generate_deployment(r)
    got = pr.generate_deployment(p)
    assert got["spec"]["template"]["spec"]["containers"][0]["image"] == \
        TENSORBOARD_IMAGE
    assert got == as_port(want)
    assert pr.generate_service(p) == rr.generate_service(r)
    assert pr.generate_virtual_service(p) == rr.generate_virtual_service(r)
    assert PTB.is_cloud_path(logspath) == RTB.is_cloud_path(logspath)


def test_an_image_in_the_spec_wins_in_both():
    r = RTB.new_tensorboard("tb", "default", "gs://b/r")
    r["spec"]["image"] = "example/tensorboard:2.16"
    got = PTB.TensorboardReconciler().generate_deployment(r)
    assert got == RTB.TensorboardReconciler().generate_deployment(r)


def test_crd_manifest_equal():
    assert PTB.crd_manifest() == RTB.crd_manifest()


def _objects(cluster) -> dict:
    return {(o["kind"], o["metadata"]["name"]): strip(o)
            for o in cluster.dump()}


@pytest.mark.parametrize("istio", ["false", "True"])
def test_reconcile_equal_on_both_clusters(istio, monkeypatch):
    """Each reconciler on its own cluster: the children (owner references
    included, their uids aside) and the Ready condition as the Deployment's
    readyReplicas moves, equal after the image mapping."""
    monkeypatch.setenv("USE_ISTIO", istio)
    views = []
    for tb, cluster_cls, seed, req in ((RTB, RCluster, r_seed, RRequest),
                                       (PTB, PCluster, p_seed, PRequest)):
        cluster = cluster_cls()
        ctl = seed(tb.build_controller(cluster))
        cluster.create(tb.new_tensorboard("tb1", logspath="/data/logs"))
        ctl.run_until_idle(advance_delayed=True)
        first = _objects(cluster)
        dep = cluster.get("apps/v1", "Deployment", "tb1", "default")
        dep["status"] = {"readyReplicas": 1}
        cluster.update_status(dep)
        tb.TensorboardReconciler().reconcile(cluster, req("default", "tb1"))
        views.append((first, _objects(cluster)))
    (r_first, r_ready), (p_first, p_ready) = views

    for want, got in ((r_first, p_first), (r_ready, p_ready)):
        assert sorted(got) == sorted(want)
        assert got == as_port(want)
    assert ("VirtualService", "tensorboard-default-tb1") in p_first \
        if istio == "True" else \
        ("VirtualService", "tensorboard-default-tb1") not in p_first
    conds = {c["type"]: c["status"]
             for c in p_ready[("Tensorboard", "tb1")]["status"]["conditions"]}
    assert conds == {"Ready": "True"}
