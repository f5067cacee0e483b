"""The port's PodDefault webhook (kubeflow_tpu_torch/control/poddefault/)
against the JAX package's.

The same pods and PodDefaults, drawn from a seed with numpy, go through
both packages' `filter_poddefaults`, `safe_to_apply` (conflicts
included), `apply_poddefaults` and the AdmissionReview `review` (its
JSONPatch decoded); the outputs must be equal. The CRD manifests are
equal too, and the port's mutator runs as a FakeCluster admission hook
and over HTTP as the JAX tests run the reference's
(tests/test_poddefault_webhook.py).
"""

import base64
import copy
import json
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from kubeflow_tpu.control.k8s import objects as rob
from kubeflow_tpu.control.k8s.fake import FakeCluster as RCluster
from kubeflow_tpu.control.poddefault import webhook as RW
from kubeflow_tpu_torch.control.k8s import objects as pob
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster as PCluster
from kubeflow_tpu_torch.control.poddefault import webhook as PW

ROOT = Path(__file__).resolve().parents[1]

ENV_NAMES = ("KFTPU_TRACE_FILE", "NCCL_DEBUG", "CUDA_DEVICE_MAX_CONNECTIONS",
             "HF_HOME")
MOUNTS = ("/data", "/cache", "/logs")


def seeded_case(seed: int) -> tuple[dict, list[dict]]:
    """A pod and four PodDefaults from the seed: selectors that match
    the pod's labels or not, env vars and mounts that may collide with
    the pod's own or each other's, tolerations, labels, annotations."""
    rng = np.random.default_rng(seed)
    labels = {k: "true" for k in ("inject-gpu", "team-ml", "trace")
              if rng.random() < 0.7}
    env = [{"name": n, "value": str(int(rng.integers(3)))}
           for n in ENV_NAMES if rng.random() < 0.3]
    pod = rob.new_object("v1", "Pod", f"p{seed}", "default", labels=labels,
                         spec={"containers": [{"name": "main",
                                               "env": env}]})
    if rng.random() < 0.1:
        rob.set_annotation(pod, f"{RW.ANNOTATION_PREFIX}/exclude", "true")
    pds = []
    for i in range(4):
        key = str(rng.choice(["inject-gpu", "team-ml", "trace", "absent"]))
        kw = {"selector": {"matchLabels": {key: "true"}}}
        if rng.random() < 0.7:
            kw["env"] = [{"name": str(n), "value": str(int(rng.integers(3)))}
                         for n in rng.choice(ENV_NAMES, 2, replace=False)]
        if rng.random() < 0.5:
            path = str(rng.choice(MOUNTS))
            kw["volumes"] = [{"name": f"v{i}", "emptyDir": {}}]
            kw["volume_mounts"] = [{"name": f"v{i}", "mountPath": path}]
        if rng.random() < 0.4:
            kw["tolerations"] = [{"key": "nvidia.com/gpu",
                                  "operator": "Exists"}]
        if rng.random() < 0.4:
            kw["labels"] = {"team": str(rng.choice(["ml", "infra"]))}
            kw["annotations"] = {"note": f"pd{i}"}
        if rng.random() < 0.3:
            kw["env_from"] = [{"secretRef": {"name": f"s{i}"}}]
        pd = RW.new_poddefault(f"pd{i}", **kw)
        pd["metadata"]["resourceVersion"] = str(10 + i)
        pds.append(pd)
    return pod, pds


def port_poddefault(pd: dict) -> dict:
    """The same PodDefault made by the port's constructor."""
    spec = pd["spec"]
    out = PW.new_poddefault(
        pd["metadata"]["name"], pd["metadata"]["namespace"],
        selector=spec["selector"], desc=spec["desc"], env=spec.get("env"),
        env_from=spec.get("envFrom"), volumes=spec.get("volumes"),
        volume_mounts=spec.get("volumeMounts"),
        tolerations=spec.get("tolerations"), labels=spec.get("labels"),
        annotations=spec.get("annotations"))
    out["metadata"]["resourceVersion"] = pd["metadata"]["resourceVersion"]
    return out


SEEDS = list(range(24))


@pytest.mark.parametrize("seed", SEEDS)
def test_merge_functions_equal(seed):
    pod, pds = seeded_case(seed)
    ppds = [port_poddefault(pd) for pd in pds]
    assert ppds == pds
    want = RW.filter_poddefaults(pod, pds)
    got = PW.filter_poddefaults(copy.deepcopy(pod), ppds)
    assert got == want
    assert PW.safe_to_apply(pod, got) == RW.safe_to_apply(pod, want)
    if RW.safe_to_apply(pod, want) is None:
        assert PW.apply_poddefaults(copy.deepcopy(pod), got) == \
            RW.apply_poddefaults(copy.deepcopy(pod), want)
    else:
        with pytest.raises(ValueError) as e_port:
            PW.apply_poddefaults(copy.deepcopy(pod), got)
        with pytest.raises(ValueError) as e_ref:
            RW.apply_poddefaults(copy.deepcopy(pod), want)
        assert str(e_port.value) == str(e_ref.value)


def test_the_seeds_reach_every_branch():
    """Among the seeds: a conflict, a clean merge with a patch, a pod no
    default selects and an excluded pod."""
    seen = set()
    for seed in SEEDS:
        pod, pds = seeded_case(seed)
        matched = RW.filter_poddefaults(pod, pds)
        if not matched:
            seen.add("excluded" if rob.annotations_of(pod) else "none")
        elif RW.safe_to_apply(pod, matched):
            seen.add("conflict")
        else:
            seen.add("merged")
    assert seen == {"excluded", "none", "conflict", "merged"}


def _review(mutator, pod: dict, uid: str) -> dict:
    return mutator.review({"request": {"uid": uid, "namespace": "default",
                                       "object": copy.deepcopy(pod)}})


@pytest.mark.parametrize("seed", SEEDS[:12])
def test_review_patch_equal(seed):
    pod, pds = seeded_case(seed)
    rc, pc = RCluster(), PCluster()
    for pd in pds:
        rc.create(pd)
        pc.create(port_poddefault(pd))
    want = _review(RW.PodDefaultMutator(rc), pod, f"u{seed}")
    got = _review(PW.PodDefaultMutator(pc), pod, f"u{seed}")
    assert got["response"].keys() == want["response"].keys()
    for key in ("uid", "allowed", "patchType"):
        assert got["response"].get(key) == want["response"].get(key)
    if "patch" in want["response"]:
        # the annotation value is the PodDefault's resourceVersion, which
        # each cluster stamps itself
        def decoded(resp, stamps):
            ops = json.loads(base64.b64decode(resp["patch"]))
            text = json.dumps(ops)
            for rv, name in stamps:
                text = text.replace(
                    f'"{RW.ANNOTATION_PREFIX}/poddefault-{name}": "{rv}"',
                    f'"{RW.ANNOTATION_PREFIX}/poddefault-{name}": "<rv>"')
            return json.loads(text)

        def stamps(cluster):
            return [(o["metadata"]["resourceVersion"], o["metadata"]["name"])
                    for o in cluster.list(RW.API_VERSION, RW.KIND,
                                          namespace="default")]

        assert decoded(got["response"], stamps(pc)) == \
            decoded(want["response"], stamps(rc))
        patched = pob.json_patch(copy.deepcopy(pod), json.loads(
            base64.b64decode(got["response"]["patch"])))
        assert patched == PW.PodDefaultMutator(pc).mutate(copy.deepcopy(pod))


def test_crd_manifest_equal():
    assert PW.crd_manifest() == RW.crd_manifest()


TRACE_DEFAULT = dict(
    selector={"matchLabels": {"trace": "true"}},
    env=[{"name": "KFTPU_TRACE_FILE", "value": "/logs/run/trace.jsonl"}],
    volumes=[{"name": "logs", "persistentVolumeClaim": {"claimName": "l"}}],
    volume_mounts=[{"name": "logs", "mountPath": "/logs"}],
)


def _pod(labels=None, env=None):
    return pob.new_object("v1", "Pod", "p", "default", labels=labels or {},
                          spec={"containers": [{"name": "main",
                                                "env": env or []}]})


def test_admission_hook_injects_and_conflict_admits_unmodified():
    cluster = PCluster()
    cluster.create(PW.new_poddefault("trace", **TRACE_DEFAULT))
    cluster.add_admission_hook(PW.PodDefaultMutator(cluster).admission_hook)
    pod = cluster.create(_pod(labels={"trace": "true"}))
    env = {e["name"]: e["value"] for e in pod["spec"]["containers"][0]["env"]}
    assert env["KFTPU_TRACE_FILE"] == "/logs/run/trace.jsonl"
    assert f"{PW.ANNOTATION_PREFIX}/poddefault-trace" in \
        pob.annotations_of(pod)
    clash = _pod(labels={"trace": "true"},
                 env=[{"name": "KFTPU_TRACE_FILE", "value": "/elsewhere"}])
    clash["metadata"]["name"] = "p2"
    pod2 = cluster.create(clash)
    assert pod2["spec"]["containers"][0]["env"] == [
        {"name": "KFTPU_TRACE_FILE", "value": "/elsewhere"}]


def test_admission_review_over_http():
    cluster = PCluster()
    cluster.create(PW.new_poddefault("trace", **TRACE_DEFAULT))
    svc = PW.PodDefaultMutator(cluster).serve(host="127.0.0.1") \
        .serve_background()
    try:
        assert not svc.tls
        pod = _pod(labels={"trace": "true"})
        req = urllib.request.Request(
            f"http://127.0.0.1:{svc.port}/apply-poddefault", method="POST",
            data=json.dumps({"apiVersion": "admission.k8s.io/v1",
                             "kind": "AdmissionReview",
                             "request": {"uid": "u1", "namespace": "default",
                                         "object": pod}}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            resp = json.loads(r.read())["response"]
        assert resp["allowed"] and resp["uid"] == "u1"
        patched = pob.json_patch(pod, json.loads(base64.b64decode(
            resp["patch"])))
        env = {e["name"]: e["value"]
               for e in patched["spec"]["containers"][0]["env"]}
        assert env["KFTPU_TRACE_FILE"] == "/logs/run/trace.jsonl"
    finally:
        svc.shutdown()


def test_main_serves_http_and_exits_zero_on_sigterm():
    """`python -m kubeflow_tpu_torch.control.poddefault` without a certs
    directory serves plain HTTP; SIGTERM ends it with exit 0."""
    from kubeflow_tpu_torch.control.k8s.apiserver import ApiServer

    api = ApiServer(PCluster()).serve_background()
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.control.poddefault",
         "--port", "0", "--apiserver", api.url, "--certs-dir", ""],
        cwd=ROOT, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline().strip()
        assert "(http)" in line, line
        port = int(line.split(":")[-1].split(" ")[0])
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            assert r.status == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(20) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        api.shutdown()
