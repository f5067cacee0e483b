"""The port's Jupyter web app (kubeflow_tpu_torch/webapps/) against the
JAX package's, each on its own FakeCluster.

One script of requests goes to both apps' routers; each response and
every object each cluster then holds must be equal after the GPU mapping
(tests/test_torch_control_profile.py `gpu_view`). The form's
``tpu: {count, accelerator, topology}`` goes to the port as ``gpu:
{count, product, nodePool}`` (the accelerator through PRODUCT, the
topology through `pool_of`); the notebook's ``google.com/tpu`` limit
comes back as ``nvidia.com/gpu``, the TPU accelerator and topology
selectors as GKE's product and node-pool ones, and the JAX notebook
images as the port's. The spawner config's ``tpu`` entry is the port's
``gpu`` (`config_view`), with the same counts [0, 1, 4, 8]. The cases
mirror tests/test_webapps.py's TestJwa, TestJwaFlavors, TestJwaUiDom,
test_jwa_serves_spawner_ui and test_jwa_spawner_config_from_yaml; the
crud backend's authorization is held against the JAX one on one profile
and its role bindings; and the port's app answers over HTTP against the
port's apiserver through its REST client, as chip_smoke.py phase 36
drives it.
"""

import base64
import copy
import json
import urllib.request

import numpy as np
import pytest
import yaml

from kubeflow_tpu.control.k8s import objects as rob
from kubeflow_tpu.control.k8s.fake import FakeCluster as RCluster
from kubeflow_tpu.control.poddefault import new_poddefault
from kubeflow_tpu.control.profile import types as RPT
from kubeflow_tpu.utils.httpd import HttpReq as RReq
from kubeflow_tpu.webapps import crud_backend as RCB
from kubeflow_tpu.webapps import jwa as RJ
from kubeflow_tpu.webapps import jwa_flavors as RF
from kubeflow_tpu_torch.control.jaxjob import types as JT
from kubeflow_tpu_torch.control.k8s import objects as pob
from kubeflow_tpu_torch.control.k8s.apiserver import ApiServer
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster as PCluster
from kubeflow_tpu_torch.control.k8s.rest import RestClient
from kubeflow_tpu_torch.control.notebook import types as NT
from kubeflow_tpu_torch.control.profile import types as PPT
from kubeflow_tpu_torch.utils.httpd import HttpReq as PReq
from kubeflow_tpu_torch.webapps import crud_backend as PCB
from kubeflow_tpu_torch.webapps import jwa as PJ
from kubeflow_tpu_torch.webapps import jwa_flavors as PF
from test_torch_control_profile import (
    PRODUCT,
    assert_views_equal,
    gpu_view,
    pool_of,
    strip,
)

USER = "alice@example.com"
NB_PATH = "/api/namespaces/team-a/notebooks"


def config_view(cfg: dict) -> dict:
    """The port's spawner config for the JAX package's: ``tpu`` (counts
    and TPU accelerators) becomes ``gpu`` (the same counts and the GPU
    products), the images the port's (one image serves GPUs and CPUs)."""
    cfg = copy.deepcopy(cfg)
    tpu = cfg.pop("tpu")
    cfg["gpu"] = {"value": tpu["value"], "options": tpu["options"],
                  "products": [PRODUCT[a] for a in tpu["accelerators"]]}
    cfg["image"]["value"] = gpu_view(cfg["image"]["value"])
    cfg["image"]["options"] = sorted(set(gpu_view(cfg["image"]["options"])))
    return cfg


def form_view(form: dict) -> dict:
    """The port's form for the JAX package's: ``tpu`` -> ``gpu``."""
    form = copy.deepcopy(form)
    tpu = form.pop("tpu", None)
    if isinstance(tpu, dict):
        gpu = {"count": tpu.get("count", 0)}
        if tpu.get("accelerator"):
            gpu["product"] = PRODUCT[tpu["accelerator"]]
        if tpu.get("topology"):
            gpu["nodePool"] = pool_of(tpu["topology"])
        form["gpu"] = gpu
    elif tpu is not None:
        form["gpu"] = tpu
    if "image" in form:
        form["image"] = gpu_view(form["image"])
    return form


class Pair:
    """The JAX app and the port's, each on its own FakeCluster holding
    namespace team-a."""

    def __init__(self, flavor: str | None = None, config=None):
        self.ref_cluster, self.port_cluster = RCluster(), PCluster()
        self.ref_cluster.create(rob.new_object("v1", "Namespace", "team-a"))
        self.port_cluster.create(pob.new_object("v1", "Namespace", "team-a"))
        self.ref = RJ.JupyterWebApp(self.ref_cluster, flavor=flavor,
                                    config=config).router()
        self.port = PJ.JupyterWebApp(self.port_cluster, flavor=flavor,
                                     config=config and config_view(config)
                                     ).router()

    def call(self, method: str, path: str, body=None, user=USER,
             port_body=None):
        """One request to both apps: (status, JSON body) of each, the
        port's body `form_view` of the JAX one's unless given."""
        out = []
        for router, Req, b in (
                (self.ref, RReq, body),
                (self.port, PReq, port_body if port_body is not None
                 else (form_view(body) if isinstance(body, dict) else body))):
            resp = router.dispatch(Req(
                method=method, path=path, params={}, query={},
                headers={"kubeflow-userid": user} if user else {},
                body=json.dumps(b).encode() if b is not None else b""))
            out.append((resp.status, json.loads(resp.body)
                        if resp.content_type == "application/json" and
                        resp.body else resp.body))
        return out

    def same(self, method: str, path: str, body=None, **kw):
        (rs, rb), (ps, pb) = self.call(method, path, body, **kw)
        assert ps == rs, (method, path, pb, rb)
        assert pb == gpu_view(rb), (method, path)
        assert_views_equal(self.ref_cluster, self.port_cluster,
                           f"{method} {path}")
        return ps, pb


def seeded_form(seed: int) -> dict:
    """A spawner form drawn from the seed: the chip count, the TPU
    accelerator and topology, the sizes and a workspace volume."""
    rng = np.random.default_rng(seed)
    return {"name": f"nb{int(rng.integers(100))}",
            "image": "kubeflow-tpu/jax-notebook-tpu:latest",
            "cpu": str(int(rng.integers(1, 9))),
            "memory": f"{int(rng.integers(1, 33))}Gi",
            "tpu": {"count": int(rng.choice([1, 4, 8])),
                    "accelerator": str(rng.choice(sorted(PRODUCT))),
                    "topology": str(rng.choice(["2x2", "2x4", "4x4"]))},
            "workspaceVolume": {"name": "ws", "mountPath": "/home/jovyan"}}


def test_config_and_namespaces():
    p = Pair()
    (_, ref), (_, port) = p.call("GET", "/api/config")
    assert port["config"] == config_view(ref["config"])
    assert port["config"]["gpu"]["options"] == [0, 1, 4, 8]
    assert "tpu" not in port["config"]
    p.same("GET", "/api/namespaces")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_create_notebook_with_the_gpu_form(seed):
    form = seeded_form(seed)
    p = Pair()
    p.same("POST", NB_PATH, form)
    nb = p.port_cluster.get(NT.API_VERSION, NT.KIND, form["name"], "team-a")
    spec = nb["spec"]["template"]["spec"]
    c0 = spec["containers"][0]
    assert c0["resources"]["limits"] == {JT.RESOURCE_GPU:
                                         form["tpu"]["count"]}
    assert spec["nodeSelector"] == {
        JT.NODESELECTOR_ACCEL: PRODUCT[form["tpu"]["accelerator"]],
        JT.NODESELECTOR_POOL: pool_of(form["tpu"]["topology"])}
    assert c0["image"] == JT.NOTEBOOK_IMAGE
    assert c0["volumeMounts"][0]["mountPath"] == "/home/jovyan"
    # the same name again: 409 from both
    assert [s for s, _ in p.call("POST", NB_PATH, form)] == [409, 409]


@pytest.mark.parametrize("form", [
    {"name": "cpu-nb"}, {"name": "int-nb", "tpu": 4},
    {"name": "zero-nb", "tpu": {"count": 0,
                                "accelerator": "tpu-v4-podslice"}},
    {"name": "product-nb", "tpu": {"count": 1,
                                   "accelerator": "tpu-v4-podslice"}},
    {"name": "labelled", "labels": {"team-libs": "true"}}])
def test_other_forms(form):
    """CPU only, a bare count, a zero count, a product without a node
    pool, configuration labels on the CR and the pod template."""
    p = Pair()
    p.same("POST", NB_PATH, form)
    nb = p.port_cluster.get(NT.API_VERSION, NT.KIND, form["name"], "team-a")
    limits = nb["spec"]["template"]["spec"]["containers"][0][
        "resources"].get("limits", {})
    assert list(limits) in ([], [JT.RESOURCE_GPU])
    if "labels" in form:
        assert nb["spec"]["template"]["metadata"]["labels"] == form["labels"]


@pytest.mark.parametrize("form", [{"name": "Invalid Name!"}, {},
                                  {"name": "x" * 64}])
def test_invalid_names_are_400(form):
    p = Pair()
    p.same("POST", NB_PATH, form)
    assert not p.port_cluster.list(NT.API_VERSION, NT.KIND)


def test_list_stop_start_and_delete():
    p = Pair()
    p.same("POST", NB_PATH, {"name": "nb1"})
    _, rows = p.same("GET", NB_PATH)
    assert rows["notebooks"][0]["status"]["phase"] == "waiting"
    for cluster in (p.ref_cluster, p.port_cluster):
        nb = cluster.get(NT.API_VERSION, NT.KIND, "nb1", "team-a")
        nb["status"] = {"readyReplicas": 1}
        cluster.update_status(nb)
    _, rows = p.same("GET", NB_PATH)
    assert rows["notebooks"][0]["status"]["phase"] == "ready"
    p.same("PATCH", f"{NB_PATH}/nb1", {"stopped": True})
    nb = p.port_cluster.get(NT.API_VERSION, NT.KIND, "nb1", "team-a")
    assert NT.STOP_ANNOTATION in pob.annotations_of(nb)
    _, rows = p.same("GET", NB_PATH)
    assert rows["notebooks"][0]["status"]["phase"] == "stopped"
    p.same("PATCH", f"{NB_PATH}/nb1", {"stopped": False})
    p.same("GET", f"{NB_PATH}/nb1/events")
    p.same("GET", f"{NB_PATH}/missing/events")
    p.same("PATCH", f"{NB_PATH}/missing", {"stopped": True})
    p.same("DELETE", f"{NB_PATH}/nb1")
    p.same("DELETE", f"{NB_PATH}/nb1")


def test_pvcs_poddefaults_and_storageclasses():
    p = Pair()
    p.same("POST", "/api/namespaces/team-a/pvcs",
           {"name": "data", "size": "20Gi", "class": "fast"})
    p.same("POST", "/api/namespaces/team-a/pvcs", {"name": "data"})
    _, out = p.same("GET", "/api/namespaces/team-a/pvcs")
    assert out["pvcs"] == [{"name": "data", "size": "20Gi",
                            "mode": "ReadWriteOnce"}]
    for cluster in (p.ref_cluster, p.port_cluster):
        cluster.create(new_poddefault(
            "add-secret", "team-a",
            selector={"matchLabels": {"use-secret": "true"}},
            desc="Mount the team secret"))
        cluster.create({"apiVersion": "storage.k8s.io/v1",
                        "kind": "StorageClass",
                        "metadata": {"name": "fast"}})
    _, out = p.same("GET", "/api/namespaces/team-a/poddefaults")
    assert out["poddefaults"][0]["matchLabels"] == {"use-secret": "true"}
    p.same("GET", "/api/storageclasses")


def test_spawner_page_offers_gpus():
    p = Pair()
    for path in ("/", "/spawner"):
        (rs, ref), (ps, page) = p.call("GET", path)
        assert ps == rs == 200
        # relative paths: the spawner is served behind a prefix rewrite
        assert b"'api/config'" in page and b"GPUs" in page
        assert b"TPU" not in page and b"config.gpu?.options" in page
        assert page.replace(b"GPUs", b"TPU chips").replace(
            b"gpu", b"tpu") == ref.replace(b"gpu", b"tpu")
        for frag in (b'id="vol-mode"', b'id="pvcs"', b'id="vol-size"',
                     b'id="vol-mount"', b'id="poddefaults"',
                     b"matchLabels", b"PATCH", b"stopped", b"'delete'"):
            assert frag in page, frag
    p.same("GET", "/healthz")


def test_spawner_config_from_yaml(tmp_path, monkeypatch):
    """spawner_ui_config.yaml: admin YAML deep-merges over the defaults
    and drives both /api/config and the form's fallbacks."""
    for side, cfg in (("jax", {"image": {"value": "corp/jax:2.0"},
                               "memory": {"value": "8Gi"},
                               "tpu": {"options": [0, 4]}}),
                      ("port", {"image": {"value": "corp/torch:2.0"},
                                "memory": {"value": "8Gi"},
                                "gpu": {"options": [0, 4]}})):
        (tmp_path / f"{side}.yaml").write_text(yaml.safe_dump(
            {"spawnerFormDefaults": cfg}))
    got = []
    for side, mod in (("jax", RJ), ("port", PJ)):
        monkeypatch.setenv("JWA_CONFIG", str(tmp_path / f"{side}.yaml"))
        got.append(mod.load_spawner_config())
    want = config_view(got[0])
    want["image"]["value"] = "corp/torch:2.0"
    assert got[1] == want
    assert got[1]["gpu"]["products"] == PJ.DEFAULT_CONFIG["gpu"]["products"]
    cluster = PCluster()
    r = PJ.JupyterWebApp(cluster).router()
    r.dispatch(PReq(method="POST", path=NB_PATH, params={}, query={},
                    headers={}, body=json.dumps({"name": "nb1"}).encode()))
    nb = cluster.get(NT.API_VERSION, NT.KIND, "nb1", "team-a")
    assert nb["spec"]["template"]["spec"]["containers"][0]["image"] == \
        "corp/torch:2.0"
    monkeypatch.delenv("JWA_CONFIG")
    assert PJ.load_spawner_config()["image"]["value"] == JT.NOTEBOOK_IMAGE


# -- flavors ------------------------------------------------------------------


def test_unknown_flavor_fails_loudly():
    for env in ({"UI": "nope"}, {}, {"UI": "snapshot"}, {"UI": "default"}):
        try:
            want = RF.select_flavor(env)
        except ValueError as e:
            with pytest.raises(ValueError, match="unknown UI flavor"):
                PF.select_flavor(env)
            assert str(e)
            continue
        assert PF.select_flavor(env) == want
    with pytest.raises(ValueError):
        PJ.JupyterWebApp(PCluster(), flavor="rok")


@pytest.mark.parametrize("url", ["gs://bkt/ws/alice/", "s3://b/x",
                                 "http://evil", 7])
def test_snapshot_flavor_post(url):
    p = Pair(flavor="snapshot")
    p.same("POST", NB_PATH, {"name": "snap-nb", "snapshotUrl": url})


def test_snapshot_token_endpoint():
    p = Pair(flavor="snapshot")
    path = "/api/snapshot/namespaces/team-a/token"
    p.same("GET", path)
    for cluster, ob in ((p.ref_cluster, rob), (p.port_cluster, pob)):
        sec = ob.new_object("v1", "Secret", "snapshot-access", "team-a")
        sec["data"] = {"token": base64.b64encode(b"s3cret").decode()}
        cluster.create(sec)
    _, out = p.same("GET", path)
    assert out["token"]["value"] == "s3cret"


def test_default_flavor_has_no_snapshot_surface():
    p = Pair(flavor="default")
    p.same("GET", "/api/snapshot/namespaces/team-a/token")
    p.same("POST", NB_PATH, {"name": "plain", "snapshotUrl": "gs://x/"})


# -- the crud backend's authorization -----------------------------------------


@pytest.mark.parametrize("user, verb", [
    (USER, "delete"), ("bob@example.com", "list"),
    ("bob@example.com", "create"), ("carol@example.com", "create"),
    ("mallory@example.com", "get"), ("root@example.com", "delete")])
def test_authorizer_equals_the_reference(user, verb):
    """Owner, a viewer, an editor, a stranger and the cluster admin,
    against one GPU-quota profile and its role bindings."""
    got = []
    for side, cluster, ob, PT, CB in (
            ("jax", RCluster(), rob, RPT, RCB),
            ("port", PCluster(), pob, PPT, PCB)):
        prof = (RPT.new_profile("team-a", USER, tpu_chip_quota=4)
                if side == "jax"
                else PPT.new_profile("team-a", USER, gpu_quota=4))
        cluster.create(prof)
        for who, role in (("bob@example.com", "view"),
                          ("carol@example.com", "edit")):
            cluster.create(ob.new_object(
                "rbac.authorization.k8s.io/v1", "RoleBinding",
                f"user-{role}", "team-a",
                annotations={PT.ANNO_USER: who, PT.ANNO_ROLE: role}))
        authz = CB.Authorizer(cluster, cluster_admin="root@example.com")
        try:
            authz.check(user, verb, "team-a")
            got.append("allowed")
        except Exception as e:
            got.append((type(e).__name__, e.status, e.message))
    assert got[1] == got[0]


def test_crud_routes_equal_the_reference():
    outs = []
    for side, cluster, ob, CB, Req, PT in (
            ("jax", RCluster(), rob, RCB, RReq, RPT),
            ("port", PCluster(), pob, PCB, PReq, PPT)):
        cluster.create(ob.new_object("v1", "Namespace", "team-a"))
        cluster.create((RPT.new_profile("team-a", USER, tpu_chip_quota=2)
                        if side == "jax"
                        else PPT.new_profile("team-a", USER, gpu_quota=2)))
        r = CB.CrudBackend(cluster, CB.Authorizer(cluster)).router()
        rows = []
        for method, path, user, body in (
                ("GET", "/api/namespaces", USER, None),
                ("GET", "/api/namespaces", None, None),
                ("POST", "/api/namespaces/team-a/pvcs", USER,
                 {"metadata": {"name": "d"}, "spec": {}}),
                ("GET", "/api/namespaces/team-a/secrets", USER, None),
                ("GET", "/api/namespaces/team-a/pvcs", "bob@example.com",
                 None),
                ("DELETE", "/api/namespaces/team-a/pvcs/d", USER, None),
                ("DELETE", "/api/namespaces/team-a/pvcs/d", USER, None),
                ("GET", "/api/storageclasses", USER, None)):
            resp = r.dispatch(Req(
                method=method, path=path, params={}, query={},
                headers={"kubeflow-userid": user} if user else {},
                body=json.dumps(body).encode() if body else b""))
            rows.append([resp.status, json.loads(resp.body)])
        outs.append(rows)
    # the created pvc's volatile fields aside
    assert strip(outs[1]) == strip(gpu_view(outs[0]))
    assert [s for s, _ in outs[1]] == [200, 401, 200, 200, 403, 200, 404,
                                       200]


# -- over HTTP, against the port's apiserver ----------------------------------


def test_the_app_over_http_on_the_rest_client():
    """The port's JWA served over HTTP on the port's RestClient against
    its ApiServer: a GPU form as user kubeflow-userid makes the
    Notebook; the list shows it."""
    cluster = PCluster()
    cluster.create(pob.new_object("v1", "Namespace", "team-a"))
    api = ApiServer(cluster).serve_background()
    svc = PJ.JupyterWebApp(RestClient(base_url=api.url)).serve(
        host="127.0.0.1", port=0).serve_background()
    try:
        base = f"http://127.0.0.1:{svc.port}"
        req = urllib.request.Request(
            base + NB_PATH, method="POST",
            data=json.dumps({"name": "gpu-nb", "gpu": {
                "count": 1, "product": "nvidia-h100-80gb"}}).encode(),
            headers={"kubeflow-userid": USER,
                     "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert json.loads(resp.read()) == {"status": "ok",
                                               "name": "gpu-nb"}
        with urllib.request.urlopen(base + NB_PATH, timeout=30) as resp:
            rows = json.loads(resp.read())["notebooks"]
        assert [r["name"] for r in rows] == ["gpu-nb"]
        spec = cluster.get(NT.API_VERSION, NT.KIND, "gpu-nb", "team-a")[
            "spec"]["template"]["spec"]
        assert spec["containers"][0]["resources"]["limits"] == {
            JT.RESOURCE_GPU: 1}
        assert spec["nodeSelector"] == {
            JT.NODESELECTOR_ACCEL: "nvidia-h100-80gb"}
    finally:
        svc.shutdown()
        api.shutdown()
