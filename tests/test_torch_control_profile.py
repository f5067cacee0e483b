"""The port's Profile controller and its plugins
(kubeflow_tpu_torch/control/profile/) against the JAX package's, each on
its own FakeCluster.

The same profiles, made from a seed with numpy, go to both controllers;
every object each cluster then holds must be equal after the GPU mapping
(`gpu_view`), which renames exactly one key here: the quota's
``requests.google.com/tpu`` becomes ``requests.nvidia.com/gpu``. The
cases mirror the profile half of tests/test_profile_tensorboard.py
(provisioning, service-account role bindings, the ownership conflict,
WorkloadIdentity, the finalizer) and tests/test_profile_irsa.py (the
trust-policy surgery, function by function, and the plugin through the
controller).

`gpu_view` and `cluster_view` are shared with the notebook, JWA and
StudyJob parity files.
"""

import copy
import json
import urllib.parse

import numpy as np
import pytest

from kubeflow_tpu.control.k8s import objects as rob
from kubeflow_tpu.control.k8s.fake import FakeCluster as RCluster
from kubeflow_tpu.control.profile import controller as RC
from kubeflow_tpu.control.profile import plugin_irsa as RI
from kubeflow_tpu.control.profile import types as RT
from kubeflow_tpu.control.runtime import Request as RRequest
from kubeflow_tpu.control.runtime import seed_controller as r_seed
from kubeflow_tpu_torch.control.jaxjob import types as JT
from kubeflow_tpu_torch.control.k8s import objects as pob
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster as PCluster
from kubeflow_tpu_torch.control.profile import controller as PC
from kubeflow_tpu_torch.control.profile import plugin_irsa as PI
from kubeflow_tpu_torch.control.profile import types as PT
from kubeflow_tpu_torch.control.runtime import Request as PRequest
from kubeflow_tpu_torch.control.runtime import seed_controller as p_seed

# -- the GPU mapping, shared with the other parity files -----------------------

# a TPU accelerator to a GPU product, a slice topology to its node pool
PRODUCT = {"tpu-v5-lite-podslice": "nvidia-h100-80gb",
           "tpu-v4-podslice": "nvidia-a100-80gb"}
JAX_RESOURCE = "google.com/tpu"
JAX_ACCEL = "cloud.google.com/gke-tpu-accelerator"
JAX_TOPOLOGY = "cloud.google.com/gke-tpu-topology"
JAX_COMMAND = ["python", "-m", "kubeflow_tpu.runtime.launcher"]
# each JAX image and the port's image that takes its place
IMAGES = {"kubeflow-tpu/jaxrt:latest": JT.DEFAULT_IMAGE,
          "kubeflow-tpu/jax-notebook:latest": JT.NOTEBOOK_IMAGE,
          "kubeflow-tpu/jax-notebook-tpu:latest": JT.NOTEBOOK_IMAGE}
# fields the apiserver or the clock fills, never a decision
VOLATILE = {"uid", "resourceVersion", "creationTimestamp",
            "lastTransitionTime", "lastUpdateTime", "startTime",
            "completionTime", "startedAt", "firstTimestamp",
            "lastTimestamp", "managedFields", "deletionTimestamp"}


def pool_of(topology: str) -> str:
    """The node pool a TPU topology's slice maps to."""
    return f"pool-{topology}".lower()


def gpu_view(x):
    """`x` as the port must produce it for the JAX package's `x`: each
    mapped key or value renamed, everything else as it was.
    - ``google.com/tpu`` (a limit) -> ``nvidia.com/gpu``;
    - ``requests.google.com/tpu`` (a quota) -> ``requests.nvidia.com/gpu``;
    - the TPU accelerator selector -> the GPU product selector, its value
      through PRODUCT;
    - the TPU topology selector -> the node-pool selector (`pool_of`);
    - a JAX image -> the port's (IMAGES), the JAX launcher's command ->
      the port launcher's."""
    if isinstance(x, list):
        if x[:3] == JAX_COMMAND:
            return list(JT.DEFAULT_COMMAND) + [gpu_view(v) for v in x[3:]]
        return [gpu_view(v) for v in x]
    if isinstance(x, str):
        return IMAGES.get(x, x)
    if not isinstance(x, dict):
        return x
    out = {}
    for k, v in x.items():
        if k == JAX_RESOURCE:
            out[JT.RESOURCE_GPU] = v
        elif k == f"requests.{JAX_RESOURCE}":
            out[PT.QUOTA_GPU] = v
        elif k == JAX_ACCEL:
            out[JT.NODESELECTOR_ACCEL] = PRODUCT[v]
        elif k == JAX_TOPOLOGY:
            out[JT.NODESELECTOR_POOL] = pool_of(v)
        else:
            out[k] = gpu_view(v)
    return out


# annotations whose value the clock writes: kept, their value masked
STAMPED = {"kubeflow-resource-stopped"}


def strip(x):
    """`x` without VOLATILE keys, STAMPED values masked."""
    if isinstance(x, dict):
        return {k: "<stamp>" if k in STAMPED else strip(v)
                for k, v in x.items() if k not in VOLATILE}
    if isinstance(x, list):
        return [strip(v) for v in x]
    return x


def event_row(e: dict) -> tuple:
    """An Event by what it says: its object name carries a random
    suffix, and so does a marker naming another event."""
    inv = e.get("involvedObject") or {}
    comp = (e.get("source") or {}).get("component", "")
    return (e["reason"], e.get("type"), e.get("message"), e.get("count"),
            inv.get("kind"), inv.get("name"),
            comp.split(".")[0] if comp.startswith("nb-fwd-") else comp)


def cluster_view(cluster, jax: bool) -> dict:
    """Every object the cluster holds, by (apiVersion, kind, namespace,
    name), free of volatile fields, the JAX side through gpu_view; the
    Events as sorted rows."""
    objs, events = {}, []
    for o in cluster.dump():
        if o["kind"] == "Event":
            events.append(event_row(o))
            continue
        m = o["metadata"]
        objs[json.dumps([o["apiVersion"], o["kind"], m.get("namespace"),
                         m["name"]])] = strip(gpu_view(o) if jax else o)
    return {"objects": objs, "events": sorted(events, key=repr)}


def assert_views_equal(ref_cluster, port_cluster, what: str = "") -> dict:
    want = cluster_view(ref_cluster, jax=True)
    got = cluster_view(port_cluster, jax=False)
    assert sorted(got["objects"]) == sorted(want["objects"]), what
    for key in want["objects"]:
        assert got["objects"][key] == want["objects"][key], (what, key)
    assert got["events"] == want["events"], what
    return got


def drain(ctl):
    """Four drains of at most 20 reconciles each. Both packages'
    Profile and Notebook controllers write their status on every
    reconcile, and the write's own watch event queues the next one, so
    a drain never empties; their objects settle within the first few."""
    for _ in range(4):
        ctl.run_until_idle(max_rounds=20, advance_delayed=True)


# -- the profile controller ---------------------------------------------------


class FakeIAM:
    """The WorkloadIdentity plugin's IAM backend."""

    def __init__(self):
        self.bindings = set()

    def bind(self, gsa, ksa):
        self.bindings.add((gsa, ksa))

    def unbind(self, gsa, ksa):
        self.bindings.discard((gsa, ksa))


def seeded_profile(seed: int) -> dict:
    """new_profile's arguments drawn from the seed (the quota counts and
    sizes and the owner), the same on both sides."""
    rng = np.random.default_rng(seed)
    return {"owner": f"user{int(rng.integers(1000))}@example.com",
            "quota": int(rng.integers(1, 65)),
            "cpu_quota": str(int(rng.integers(1, 257))),
            "memory_quota": f"{int(rng.integers(1, 513))}Gi"}


def new_profile(side: str, name: str, owner: str, quota=None, **kw) -> dict:
    if side == "jax":
        return RT.new_profile(name, owner, tpu_chip_quota=quota, **kw)
    return PT.new_profile(name, owner, gpu_quota=quota, **kw)


class World:
    """One package's Profile controller with the WorkloadIdentity and
    IRSA plugins on its own FakeCluster."""

    def __init__(self, side: str, iam_policy: str | None = None):
        jax = side == "jax"
        self.side, self.jax = side, jax
        self.cluster = (RCluster if jax else PCluster)()
        self.iam = FakeIAM()
        self.aws = FakeIamBackend({"s3-reader": iam_policy or policy()})
        C, I = (RC, RI) if jax else (PC, PI)
        self.ctl = (r_seed if jax else p_seed)(C.build_controller(
            self.cluster, plugins={
                "WorkloadIdentity": C.WorkloadIdentityPlugin(
                    iam_backend=self.iam),
                I.KIND: I.IrsaPlugin(iam_backend=self.aws)}))
        self.T = RT if jax else PT
        self.ob = rob if jax else pob

    def create(self, obj: dict) -> None:
        self.cluster.create(obj)
        drain(self.ctl)


def pair(iam_policy: str | None = None) -> tuple[World, World]:
    return World("jax", iam_policy), World("port", iam_policy)


@pytest.mark.parametrize("seed", [0, 1])
def test_full_namespace_provisioning(seed):
    """Namespace, service accounts, role bindings, the GPU quota, the
    authorization policy and Ready, as the JAX package makes them."""
    args = seeded_profile(seed)
    ref, port = pair()
    for w in (ref, port):
        w.create(new_profile(w.side, "team-a", args["owner"], args["quota"],
                             cpu_quota=args["cpu_quota"],
                             memory_quota=args["memory_quota"]))
    assert_views_equal(ref.cluster, port.cluster)
    quota = port.cluster.get("v1", "ResourceQuota", PT.QUOTA_NAME, "team-a")
    hard = quota["spec"]["hard"]
    assert hard["requests.nvidia.com/gpu"] == args["quota"]
    assert not any("tpu" in k for k in hard), hard
    assert pob.cond_is_true(port.cluster.get(PT.API_VERSION, PT.KIND,
                                             "team-a"), "Ready")


def test_profile_without_quota_makes_none():
    ref, port = pair()
    for w in (ref, port):
        w.create(new_profile(w.side, "team-b", "bob@example.com"))
    assert_views_equal(ref.cluster, port.cluster)
    assert port.cluster.get_or_none("v1", "ResourceQuota", PT.QUOTA_NAME,
                                    "team-b") is None


def test_ownership_conflict_rejected():
    """profile_controller.go:168-186: a namespace another user owns
    blocks the profile; nothing is provisioned into it."""
    ref, port = pair()
    for w in (ref, port):
        w.cluster.create(w.ob.new_object(
            "v1", "Namespace", "taken",
            annotations={"owner": "bob@example.com"}))
        w.create(new_profile(w.side, "taken", "alice@example.com"))
    got = assert_views_equal(ref.cluster, port.cluster)
    prof = port.cluster.get(PT.API_VERSION, PT.KIND, "taken")
    c = pob.cond_get(prof, "Ready")
    assert (c["status"], c["reason"]) == ("False",
                                          "NamespaceOwnershipConflict")
    assert not any('"ServiceAccount"' in k for k in got["objects"])


def test_workload_identity_and_finalizer_revoke():
    """The GSA annotation and IAM binding, then the deletion: the plugin
    revokes, the finalizer goes, the namespace cascades."""
    gsa = "gsa@proj.iam.gserviceaccount.com"
    ref, port = pair()
    for w in (ref, port):
        w.create(new_profile(w.side, "team-a", "alice@example.com", 8,
                             plugins=[{"kind": "WorkloadIdentity",
                                       "spec": {"gcpServiceAccount": gsa}}]))
    assert_views_equal(ref.cluster, port.cluster, "applied")
    assert port.iam.bindings == ref.iam.bindings == {(gsa,
                                                      "team-a/default-editor")}
    sa = port.cluster.get("v1", "ServiceAccount", PT.SA_EDITOR, "team-a")
    assert pob.annotations_of(sa)[PC.WorkloadIdentityPlugin.ANNOTATION] == gsa
    for w in (ref, port):
        w.cluster.delete(w.T.API_VERSION, w.T.KIND, "team-a")
        drain(w.ctl)
    assert_views_equal(ref.cluster, port.cluster, "deleted")
    assert port.iam.bindings == ref.iam.bindings == set()
    assert port.cluster.get_or_none("v1", "Namespace", "team-a") is None
    assert port.cluster.get_or_none(PT.API_VERSION, PT.KIND, "team-a") is None


def test_unknown_plugin_kind_is_skipped():
    ref, port = pair()
    for w in (ref, port):
        w.create(new_profile(w.side, "team-c", "carol@example.com",
                             plugins=[{"kind": "NoSuchPlugin", "spec": {}}]))
    assert_views_equal(ref.cluster, port.cluster)


# -- the IRSA plugin: trust-policy surgery (plugin_iam_test.go) ---------------

OIDC_HOST = ("oidc.beta.us-west-2.wesley.amazonaws.com/id/"
          "50D94CFC65139194EDC21891B611EF72")
PROVIDER_ARN = f"arn:aws:iam::34892524:oidc-provider/{OIDC_HOST}"
ROLE_ARN = "arn:aws:iam::34892524:role/s3-reader"


def policy(subjects=None) -> str:
    """A trust policy like plugin_iam_test.go's fixtures."""
    equals = {f"{OIDC_HOST}:aud": [RI.DEFAULT_AUDIENCE]}
    if subjects is not None:
        equals[f"{OIDC_HOST}:sub"] = subjects
    return json.dumps({
        "Version": "2012-10-17",
        "Statement": [{
            "Effect": "Allow",
            "Principal": {"Federated": PROVIDER_ARN},
            "Action": "sts:AssumeRoleWithWebIdentity",
            "Condition": {"StringEquals": equals},
        }],
    })


def _siblings() -> str:
    """Sibling statements, a StringLike operator and a custom audience,
    which the surgery must carry through untouched."""
    doc = json.loads(policy())
    doc["Statement"][0]["Condition"]["StringLike"] = {
        f"{OIDC_HOST}:sub": ["system:serviceaccount:kube-*:*"]}
    doc["Statement"][0]["Condition"]["StringEquals"][f"{OIDC_HOST}:aud"] = \
        ["custom-audience"]
    doc["Statement"].append({"Effect": "Allow",
                             "Principal": {"Service": "ec2.amazonaws.com"},
                             "Action": "sts:AssumeRole"})
    return json.dumps(doc)


SA0, SA1 = "system:serviceaccount:ns0:sa0", "system:serviceaccount:ns1:sa1"
SURGERY = {
    "add_first_subject": ("add", policy()),
    "add_keeps_existing": ("add", policy([SA0])),
    "add_duplicate": ("add", policy([SA1])),
    "add_subject_as_string": ("add", policy(SA0)),
    "remove_subject": ("remove", policy([SA0, SA1])),
    "remove_last_subject": ("remove", policy([SA1])),
    "remove_absent": ("remove", policy([SA0])),
    "siblings_add": ("add", _siblings()),
    "no_statements": ("add", json.dumps({"Version": "2012-10-17",
                                         "Statement": []})),
}


def _surgery(mod, verb: str, doc: str):
    fn = (mod.add_service_account_in_assume_role_policy if verb == "add"
          else mod.remove_service_account_in_assume_role_policy)
    try:
        return "ok", json.loads(fn(doc, "ns1", "sa1"))
    except mod.ConditionExistsError as e:
        return "ConditionExistsError", str(e)
    except ValueError as e:
        return "ValueError", str(e)


@pytest.mark.parametrize("case", sorted(SURGERY))
def test_trust_policy_surgery_equals_the_reference(case):
    verb, doc = SURGERY[case]
    got, want = _surgery(PI, verb, doc), _surgery(RI, verb, doc)
    assert got == want
    if case == "remove_last_subject":
        # plugin_iam.go:213-227: the emptied :sub key is dropped
        cond = got[1]["Statement"][0]["Condition"]["StringEquals"]
        assert f"{OIDC_HOST}:sub" not in cond


def test_arn_parsing_and_document_builders():
    for fn in ("issuer_url_from_provider_arn", "role_name_from_arn"):
        for arn in (PROVIDER_ARN, ROLE_ARN, "no-slash"):
            assert getattr(PI, fn)(arn) == getattr(RI, fn)(arn)
    assert PI.issuer_url_from_provider_arn(PROVIDER_ARN) == OIDC_HOST
    stmt = PI.make_assume_role_with_web_identity_policy_document(
        PROVIDER_ARN, {"StringEquals": {}})
    assert stmt == RI.make_assume_role_with_web_identity_policy_document(
        PROVIDER_ARN, {"StringEquals": {}})
    assert PI.make_policy_document(stmt) == RI.make_policy_document(stmt)
    assert (PI.KIND, PI.ANNOTATION, PI.DEFAULT_AUDIENCE) == \
        (RI.KIND, RI.ANNOTATION, RI.DEFAULT_AUDIENCE)


# -- the IRSA plugin through the controller -----------------------------------


class FakeIamBackend:
    """Stores trust policies URL-quoted, as the AWS API returns them
    (plugin_iam.go:85)."""

    def __init__(self, roles: dict[str, str]):
        self.roles = {n: urllib.parse.quote(p) for n, p in roles.items()}
        self.updates: list[tuple[str, str]] = []

    def get_assume_role_policy(self, role_name: str) -> str:
        return self.roles[role_name]

    def update_assume_role_policy(self, role_name: str, policy_json: str):
        self.roles[role_name] = urllib.parse.quote(policy_json)
        self.updates.append((role_name, policy_json))

    def decoded(self, role_name: str) -> str:
        return urllib.parse.unquote(self.roles[role_name])


def irsa_profile(side: str, name="team-aws", owner="alice@example.com"):
    return new_profile(side, name, owner, 4, plugins=[
        {"kind": RI.KIND, "spec": {"awsIamRole": ROLE_ARN}}])


@pytest.mark.parametrize("initial", [None, ["system:serviceaccount:other:"
                                            "default-editor"]])
def test_irsa_apply_reapply_and_revoke(initial):
    """apply annotates default-editor and adds its subject; a second
    reconcile makes no AWS write; revoke takes both away and leaves other
    namespaces' subjects. Cluster, policy and AWS writes equal the
    reference's after each step."""
    ref, port = pair(policy(initial))
    for w in (ref, port):
        w.create(irsa_profile(w.side))

    def same(what):
        assert_views_equal(ref.cluster, port.cluster, what)
        assert port.aws.updates == ref.aws.updates, what
        assert port.aws.decoded("s3-reader") == ref.aws.decoded("s3-reader")

    same("applied")
    sa = port.cluster.get("v1", "ServiceAccount", PT.SA_EDITOR, "team-aws")
    assert pob.annotations_of(sa)[PI.ANNOTATION] == ROLE_ARN
    n = len(port.aws.updates)
    ref.ctl.enqueue(RRequest(name="team-aws", namespace=None))
    port.ctl.enqueue(PRequest(name="team-aws", namespace=None))
    drain(ref.ctl)
    drain(port.ctl)
    same("reapplied")
    assert len(port.aws.updates) == n
    for w in (ref, port):
        w.cluster.delete(w.T.API_VERSION, w.T.KIND, "team-aws")
        drain(w.ctl)
    same("revoked")
    subjects = json.loads(port.aws.decoded("s3-reader"))["Statement"][0][
        "Condition"]["StringEquals"].get(f"{OIDC_HOST}:sub")
    assert subjects == initial


def test_profile_without_irsa_never_touches_iam():
    ref, port = pair()
    for w in (ref, port):
        w.create(new_profile(w.side, "plain", "bob@example.com"))
    assert port.aws.updates == ref.aws.updates == []


def test_irsa_without_backend_only_annotates():
    """No IAM backend: the annotation is written, the trust policy is
    left alone (the reference logs a warning)."""
    worlds = []
    for side, C, I, seed, Cl in (("jax", RC, RI, r_seed, RCluster),
                                 ("port", PC, PI, p_seed, PCluster)):
        cluster = Cl()
        ctl = seed(C.build_controller(cluster,
                                      plugins={I.KIND: I.IrsaPlugin()}))
        cluster.create(irsa_profile(side))
        drain(ctl)
        worlds.append(cluster)
    assert_views_equal(*worlds)


def test_gpu_view_names_the_quota_key_alone():
    """The mapping renames the quota's key and nothing else of a
    profile."""
    jax = RT.new_profile("p", "o", tpu_chip_quota=3, cpu_quota="2")
    want = copy.deepcopy(jax)
    hard = want["spec"]["resourceQuotaSpec"]["hard"]
    hard["requests.nvidia.com/gpu"] = hard.pop("requests.google.com/tpu")
    assert gpu_view(jax) == want
    assert strip(PT.new_profile("p", "o", gpu_quota=3, cpu_quota="2")) == \
        strip(want)
