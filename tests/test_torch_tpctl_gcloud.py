"""The port's GkeGpuPlatform (kubeflow_tpu_torch/tpctl/apply.py) against an
offline gcloud double, through the real subprocess path.

The double is a copy of tests/test_gcloud_double.py's: a real executable
first on PATH, stateful in a JSON file, logging every argv. This copy
also reads `--accelerator=type=...,count=...` and reports it in
`describe` under `config.accelerators`, as gcloud does for a GPU pool,
which is what the port's drift check reads. The cases mirror that file:
create, the idempotent re-apply, drift, delete and the double delete,
the coordinator end to end, auth errors that never read as "gone",
gcloud's stderr in the raised error. Run through the same double, the
JAX package's GkeTpuPlatform and the port's call gcloud with the same
verbs in the same order.
"""

import json
import os
import stat

import pytest

from kubeflow_tpu.tpctl.apply import GkeTpuPlatform
from kubeflow_tpu.tpctl.tpudef import TpuDef as RDef
from kubeflow_tpu_torch.control.jaxjob.types import (
    NODESELECTOR_ACCEL,
    NODESELECTOR_POOL,
)
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster
from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry
from kubeflow_tpu_torch.tpctl.apply import Coordinator, GkeGpuPlatform
from kubeflow_tpu_torch.tpctl.tpudef import TpuDef

FAKE_GCLOUD = r'''#!/usr/bin/env python3
"""Stateful gcloud double: container node-pools {describe,create,delete}.

State: $GCLOUD_STATE json {"pools": {name: {...flags}}}. Also appends
every argv to $GCLOUD_STATE.log for contract assertions.
"""
import json, os, sys

state_path = os.environ["GCLOUD_STATE"]
with open(state_path + ".log", "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\n")
try:
    with open(state_path) as f:
        state = json.load(f)
except FileNotFoundError:
    state = {"pools": {}}
args = sys.argv[1:]
if args[:2] != ["container", "node-pools"] or len(args) < 4:
    print("unsupported gcloud surface: " + " ".join(args), file=sys.stderr)
    sys.exit(2)
verb, name = args[2], args[3]
flags = {a.split("=", 1)[0]: (a.split("=", 1)[1] if "=" in a else True)
         for a in args[4:]}
for req in ("--project", "--zone", "--cluster"):
    if req not in flags:
        print(f"missing required flag {req}", file=sys.stderr)
        sys.exit(2)
if verb == "describe":
    if os.environ.get("GCLOUD_FAIL_AUTH"):
        print("ERROR: (gcloud.container.node-pools.describe) "
              "invalid authentication credentials", file=sys.stderr)
        sys.exit(1)
    if name in state["pools"]:
        flags = state["pools"][name]
        labels = dict(kv.split("=", 1) for kv in
                      flags.get("--node-labels", "").split(",") if kv)
        config = {"machineType": flags.get("--machine-type"),
                  "labels": labels}
        if "--accelerator" in flags:
            acc = dict(kv.split("=", 1)
                       for kv in flags["--accelerator"].split(","))
            config["accelerators"] = [{
                "acceleratorType": acc["type"],
                "acceleratorCount": acc["count"]}]
        print(json.dumps({"name": name, "config": config,
                          "initialNodeCount": int(flags.get("--num-nodes",
                                                            "1"))}))
        sys.exit(0)
    print(f"Not found: projects/x/zones/y/clusters/z/nodePools/{name}",
          file=sys.stderr)
    sys.exit(1)
if verb == "create":
    if name in state["pools"]:
        print(f"Already exists: {name}", file=sys.stderr)
        sys.exit(1)
    if "--machine-type" not in flags or "--num-nodes" not in flags:
        print("create requires --machine-type and --num-nodes",
              file=sys.stderr)
        sys.exit(2)
    state["pools"][name] = flags
elif verb == "delete":
    if "--quiet" not in flags:
        print("delete prompts without --quiet", file=sys.stderr)
        sys.exit(2)
    if name not in state["pools"]:
        print(f"Not found: {name}", file=sys.stderr)
        sys.exit(1)
    del state["pools"][name]
else:
    print(f"unsupported verb {verb}", file=sys.stderr)
    sys.exit(2)
with open(state_path, "w") as f:
    json.dump(state, f)
'''


@pytest.fixture()
def gcloud_env(tmp_path, monkeypatch):
    binpath = tmp_path / "bin"
    binpath.mkdir()
    exe = binpath / "gcloud"
    exe.write_text(FAKE_GCLOUD)
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    state = tmp_path / "state.json"
    monkeypatch.setenv("PATH", f"{binpath}:{os.environ['PATH']}")
    monkeypatch.setenv("GCLOUD_STATE", str(state))
    monkeypatch.delenv("GCLOUD_FAIL_AUTH", raising=False)
    return state


def _pools(state):
    return json.loads(state.read_text())["pools"] if state.exists() else {}


def _calls(state):
    logp = state.with_suffix(".json.log")
    if not logp.exists():
        return []
    return [json.loads(ln) for ln in logp.read_text().splitlines()]


CFG = dict(name="KF", platform="gke-gpu", project="proj-1",
           zone="us-central1-a", accelerator="nvidia-h100-80gb", gpus=8)


def test_create_through_the_real_subprocess(gcloud_env):
    GkeGpuPlatform().apply(TpuDef(**CFG))
    pools = _pools(gcloud_env)
    assert list(pools) == ["kf-gpu"]     # normalize_pool("KF-gpu")
    flags = pools["kf-gpu"]
    assert flags["--machine-type"] == "a3-highgpu-8g"
    assert flags["--accelerator"] == "type=nvidia-h100-80gb,count=8"
    assert flags["--num-nodes"] == "1"
    assert "--placement-type" not in flags       # one node
    assert dict(kv.split("=", 1) for kv in
                flags["--node-labels"].split(",")) == {
        NODESELECTOR_ACCEL: "nvidia-h100-80gb", NODESELECTOR_POOL: "kf-gpu"}
    assert (flags["--project"], flags["--zone"], flags["--cluster"]) == (
        "proj-1", "us-central1-a", "KF")


def test_multi_node_pool_is_placed_compactly(gcloud_env):
    GkeGpuPlatform().apply(TpuDef(**{**CFG, "gpus": 32}))
    flags = _pools(gcloud_env)["kf-gpu"]
    assert flags["--num-nodes"] == "4"
    assert flags["--placement-type"] == "COMPACT"
    # a pool smaller than one machine still gets one whole node
    assert GkeGpuPlatform()._machine(TpuDef(**{**CFG, "gpus": 1})) == (
        "a3-highgpu-8g", 8, 1)


def test_re_apply_is_idempotent_via_describe(gcloud_env):
    p = GkeGpuPlatform()
    p.apply(TpuDef(**CFG))
    p.apply(TpuDef(**CFG))
    assert [c[2] for c in _calls(gcloud_env)] == [
        "describe", "create", "describe"]


@pytest.mark.parametrize("change,what", [
    ({"gpus": 16}, "nodes 1 != 2"),
    ({"accelerator": "nvidia-h200-141gb"},
     "accelerator nvidia-h100-80gb != nvidia-h200-141gb"),
])
def test_drift_fails_instead_of_a_fake_success(gcloud_env, change, what):
    p = GkeGpuPlatform()
    p.apply(TpuDef(**CFG))
    with pytest.raises(RuntimeError, match="different shape") as e:
        p.apply(TpuDef(**{**CFG, **change}))
    assert what in str(e.value)
    p.apply(TpuDef(**CFG))       # the unchanged spec is still idempotent


def test_delete_and_double_delete(gcloud_env):
    p = GkeGpuPlatform()
    p.apply(TpuDef(**CFG))
    p.delete(TpuDef(**CFG))
    assert _pools(gcloud_env) == {}
    p.delete(TpuDef(**CFG))
    assert [c[2] for c in _calls(gcloud_env)].count("delete") == 1


def test_auth_failure_never_reads_as_pool_gone(gcloud_env, monkeypatch):
    p = GkeGpuPlatform()
    p.apply(TpuDef(**CFG))
    monkeypatch.setenv("GCLOUD_FAIL_AUTH", "1")
    with pytest.raises(RuntimeError, match="describe failed"):
        p.delete(TpuDef(**CFG))
    monkeypatch.delenv("GCLOUD_FAIL_AUTH")
    assert "kf-gpu" in _pools(gcloud_env)


def test_unknown_product_is_loud(gcloud_env):
    with pytest.raises(ValueError, match="unknown GPU product"):
        GkeGpuPlatform().apply(TpuDef(**{**CFG,
                                         "accelerator": "nvidia-h100"}))
    assert _pools(gcloud_env) == {}


def test_create_failure_surfaces_gcloud_stderr(gcloud_env, monkeypatch):
    monkeypatch.setattr(
        GkeGpuPlatform, "commands",
        lambda self, c: [["gcloud", "container", "node-pools", "create",
                          "kf-gpu", "--project=p", "--zone=z",
                          "--cluster=c"]])
    with pytest.raises(RuntimeError, match="machine-type"):
        GkeGpuPlatform().apply(TpuDef(**CFG))


def test_coordinator_end_to_end(gcloud_env):
    """tpctl apply: the pool through the double, the manifests into the
    FakeCluster, Available; then the teardown takes the pool."""
    cluster = FakeCluster()
    coord = Coordinator(cluster, registry=MetricsRegistry())
    cfg = TpuDef(**{**CFG, "applications": ("crds", "namespace")})
    out = coord.apply(cfg)
    assert any(c["type"] == "TpuDefAvailable" and c["status"] == "True"
               for c in out["status"]["conditions"])
    assert "kf-gpu" in _pools(gcloud_env)
    assert cluster.get("v1", "Namespace", "kubeflow")
    coord.delete(cfg)
    assert _pools(gcloud_env) == {}
    assert coord.status("KF") is None


def test_the_same_gcloud_verbs_as_the_reference(gcloud_env):
    """Apply, re-apply, delete and delete again with each package's
    provider on the same double: the same verbs in the same order, and
    the same scope flags on every call."""
    seqs = []
    for provider, cfg in (
            (GkeTpuPlatform(), RDef(name="kf", platform="gke-tpu",
                                    project="proj-1", zone="us-central1-a",
                                    accelerator="tpu-v5-lite-podslice",
                                    topology="2x4")),
            (GkeGpuPlatform(), TpuDef(**{**CFG, "name": "kf"}))):
        gcloud_env.with_suffix(".json.log").unlink(missing_ok=True)
        provider.apply(cfg)
        provider.apply(cfg)
        provider.delete(cfg)
        provider.delete(cfg)
        seqs.append([(c[2], sorted(a for a in c if a.startswith(
            ("--project", "--zone", "--cluster")))) for c in
            _calls(gcloud_env)])
    assert seqs[1] == seqs[0]
    assert [v for v, _ in seqs[1]] == ["describe", "create", "describe",
                                       "describe", "delete", "describe"]
