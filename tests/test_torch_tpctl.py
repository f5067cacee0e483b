"""The port's tpctl deployment engine (kubeflow_tpu_torch/tpctl/) against
the JAX package's: the TpuDef, the manifest renderer and the
coordinator, each package on its own FakeCluster.

`port_view` maps a JAX-package object to what the port must render for
it: a module under `kubeflow_tpu.` is launched as its namesake under
`kubeflow_tpu_torch.`, and an image under the `kubeflow-tpu/` prefix is
the same image under the port's `kubeflow-tpu-torch/`; nothing else
changes (the CRDs are equal as they are). The TpuDef itself differs only
in its platform: a GPU pool (`accelerator`, `gpus`) for a TPU slice.
The cases mirror tests/test_tpctl.py: the example round trip, overlays,
subsets, HA leader election, Available/Degraded, the second apply, the
delete, the doctor and the CLI. The last test holds ROADMAP.md to the
renderer: the modules it names but the port does not have yet are the
ones ROADMAP Queue 1 lists as still to port.
"""

import copy
import importlib.util
import json
import re
from pathlib import Path

import pytest
import yaml

from kubeflow_tpu.control.k8s.fake import FakeCluster as RCluster
from kubeflow_tpu.tpctl import cli as RCli
from kubeflow_tpu.tpctl import manifests as RM
from kubeflow_tpu.tpctl.apply import Coordinator as RCoordinator
from kubeflow_tpu.tpctl.tpudef import TpuDef as RDef
from kubeflow_tpu_torch.control.k8s import objects as pob
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster as PCluster
from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry
from kubeflow_tpu_torch.tpctl import cli as PCli
from kubeflow_tpu_torch.tpctl import manifests as PM
from kubeflow_tpu_torch.tpctl import tpudef as PD
from kubeflow_tpu_torch.tpctl.apply import Coordinator as PCoordinator
from kubeflow_tpu_torch.tpctl.tpudef import TpuDef as PDef
from kubeflow_tpu_torch.utils import yaml_lite
from test_torch_control_profile import strip

ROOT = Path(__file__).resolve().parents[1]


def port_view(x):
    if isinstance(x, dict):
        return {k: port_view(v) for k, v in x.items()}
    if isinstance(x, list):
        return [port_view(v) for v in x]
    if isinstance(x, str):
        if x.startswith("kubeflow_tpu."):
            return "kubeflow_tpu_torch." + x[len("kubeflow_tpu."):]
        if x.startswith("kubeflow-tpu/"):
            return "kubeflow-tpu-torch/" + x[len("kubeflow-tpu/"):]
    return x


# the shared (non-platform) spec fields each case sets on both TpuDefs
CASES = {
    "all": {},
    "no-istio": {"use_istio": False},
    "ha": {"ha_controllers": True},
    "subset": {"applications": ("crds", "namespace", "jaxjob-controller",
                                "poddefault-webhook", "jupyter-web-app")},
    "overlay": {"namespace": "kf-gpu", "overlays": [
        {"target": {"kind": "Deployment", "name": "jaxjob-controller"},
         "patch": {"spec": {"replicas": 3}}},
        {"target": {"kind": "Service"},
         "patch": {"metadata": {"labels": {"tier": "edge"}}}}]},
}


def pair(case: str) -> tuple[RDef, PDef]:
    kw = copy.deepcopy(CASES[case])
    return RDef(**kw), PDef(**kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_equals_the_reference_under_the_port_mapping(case):
    r, p = pair(case)
    want, got = RM.render(r), PM.render(p)
    key = lambda o: (o["kind"], o["metadata"]["name"],  # noqa: E731
                     o["metadata"].get("namespace"))
    assert [key(o) for o in got] == [key(o) for o in want]
    assert got == [port_view(o) for o in want]


def test_crds_are_the_port_kinds_and_equal_the_reference():
    crds = [o for o in PM.render(PDef()) if o["kind"] ==
            "CustomResourceDefinition"]
    assert [c["spec"]["names"]["kind"] for c in crds] == [
        "JAXJob", "JAXService", "Notebook", "Profile", "PodDefault",
        "Tensorboard", "StudyJob"]
    assert crds == [o for o in RM.render(RDef())
                    if o["kind"] == "CustomResourceDefinition"]


def test_ha_controllers_render_leader_election():
    p = PDef(ha_controllers=True)
    ctl = next(o for o in PM.render(p) if o["kind"] == "Deployment"
               and o["metadata"]["name"] == "tensorboard-controller")
    env = {e["name"]: e["value"]
           for e in ctl["spec"]["template"]["spec"]["containers"][0]["env"]}
    assert ctl["spec"]["replicas"] == 2
    assert env["ENABLE_LEADER_ELECTION"] == "true"
    assert ctl["spec"]["template"]["spec"]["containers"][0]["args"] == [
        "python", "-m", "kubeflow_tpu_torch.control.tensorboard"]


def test_tpudef_round_trip_and_the_gpu_platform():
    cfg = PDef.from_dict(yaml_lite.loads(PD.example_yaml()))
    assert (cfg.name, cfg.platform, cfg.accelerator, cfg.gpus) == (
        "kubeflow-tpu", "existing", "nvidia-h100-80gb", 8)
    assert cfg.pool_gpus() == 8
    again = PDef.from_dict(yaml_lite.loads(cfg.dump()))
    assert again.to_object()["spec"] == cfg.to_object()["spec"]
    assert again.to_object()["spec"]["platform"] == {
        "kind": "existing", "project": "", "zone": "",
        "accelerator": "nvidia-h100-80gb", "gpus": 8}
    # the same kind and group as the reference; the spec apart from the
    # platform equal to the reference's for the same fields
    ref = RDef.from_dict(yaml.safe_load(RDef().dump())).to_object()
    got = cfg.to_object()
    assert (got["apiVersion"], got["kind"]) == (ref["apiVersion"],
                                                 ref["kind"])
    ours = ("platform", "imagePrefix")
    assert {k: v for k, v in got["spec"].items() if k not in ours} == \
        {k: v for k, v in ref["spec"].items() if k not in ours}
    assert got["spec"]["imagePrefix"] == "kubeflow-tpu-torch"
    for bad in (0, -8, "8", 2.5, True):
        with pytest.raises(ValueError, match="positive integer"):
            PDef(gpus=bad).pool_gpus()


def test_load_from_a_file_and_refusals(tmp_path):
    f = tmp_path / "tpudef.yaml"
    f.write_text(PD.example_yaml())
    assert PDef.load(str(f)).to_object() == PDef.load(
        f.open()).to_object()
    f.write_text("kind: KfDef\n")
    with pytest.raises(ValueError, match="expected kind TpuDef"):
        PDef.load(str(f))
    with pytest.raises(ValueError, match="unknown applications"):
        PDef.from_dict({"spec": {"applications": ["nope"]}})


def _cluster_view(cluster, jax: bool) -> dict:
    """Every object but the TpuDef, free of volatile fields, the JAX
    side through port_view."""
    out = {}
    for o in cluster.dump():
        if o["kind"] == "TpuDef":
            continue
        o = port_view(o) if jax else o
        m = o["metadata"]
        out[json.dumps([o["apiVersion"], o["kind"], m.get("namespace"),
                        m["name"]])] = strip(o)
    return out


def _conds(obj: dict) -> dict:
    return {c["type"]: (c["status"], c.get("reason"))
            for c in (obj.get("status") or {}).get("conditions") or []}


@pytest.mark.parametrize("case", ["all", "ha", "overlay"])
def test_apply_second_apply_and_delete_equal_the_reference(case):
    r, p = pair(case)
    rc, pc = RCluster(), PCluster()
    rco, pco = RCoordinator(rc), PCoordinator(pc, registry=MetricsRegistry())
    want, got = rco.apply(r), pco.apply(p)
    assert _conds(got) == _conds(want) == {
        "TpuDefAvailable": ("True", "ApplySucceeded"),
        "TpuDefDegraded": ("False", "ApplySucceeded")}
    assert _cluster_view(pc, jax=False) == _cluster_view(rc, jax=True)
    # the second apply writes nothing (kfctl_second_apply.py)
    rvs = {(o["kind"], o["metadata"]["name"]):
           o["metadata"]["resourceVersion"] for o in pc.dump()
           if o["kind"] != "TpuDef"}
    pco.apply(p)
    assert rvs == {(o["kind"], o["metadata"]["name"]):
                   o["metadata"]["resourceVersion"] for o in pc.dump()
                   if o["kind"] != "TpuDef"}
    rco.delete(r)
    pco.delete(p)
    assert pco.status(p.name) is None and rco.status(r.name) is None
    assert _cluster_view(pc, jax=False) == _cluster_view(rc, jax=True)


def test_apply_failure_sets_degraded_and_counts():
    reg = MetricsRegistry()

    class Boom(Exception):
        pass

    class FailingPlatform:
        def apply(self, cfg):
            raise Boom("insufficient quota for nvidia-h100-80gb")

    coord = PCoordinator(PCluster(), provider=FailingPlatform(), registry=reg)
    with pytest.raises(Boom):
        coord.apply(PDef())
    obj = coord.status("kubeflow-tpu")
    assert pob.cond_is_true(obj, "TpuDefDegraded")
    assert "insufficient quota" in pob.cond_get(obj, "TpuDefDegraded")[
        "message"]
    assert not pob.cond_is_true(obj, "TpuDefAvailable")
    PCoordinator(PCluster(), registry=reg).apply(PDef())
    text = reg.render()
    assert "tpctl_deploy_requests_total 2.0" in text
    assert "tpctl_deployments_failure_total 1.0" in text
    assert "tpctl_dep_duration_seconds_count 1" in text
    with pytest.raises(ValueError, match="unknown platform"):
        PCoordinator(PCluster(), registry=reg).apply(PDef(platform="gke-tpu"))


def test_doctor_reports_equal_the_reference():
    r, p = pair("all")
    rc, pc = RCluster(), PCluster()
    assert PCli.doctor_report(pc, p) == RCli.doctor_report(rc, r)
    RCoordinator(rc).apply(r)
    PCoordinator(pc, registry=MetricsRegistry()).apply(p)
    rows, healthy = PCli.doctor_report(pc, p)
    assert (rows, healthy) == RCli.doctor_report(rc, r)
    assert not healthy and {row["status"] for row in rows} == {
        "ok", "not-ready"}
    for row in rows:
        if row["status"] == "not-ready":
            d = pc.get("apps/v1", "Deployment", row["name"], p.namespace)
            d.setdefault("status", {})["readyReplicas"] = \
                d["spec"].get("replicas", 1)
            pc.update_status(d)
    assert PCli.doctor_report(pc, p)[1] is True


def test_cli_generate_dry_run_example_and_doctor(capsys, tmp_path):
    assert PCli.main(["generate"]) == 0
    docs = list(yaml.safe_load_all(capsys.readouterr().out))
    assert docs == PM.render(PDef.from_dict(yaml_lite.loads(
        PD.example_yaml())))
    assert PCli.main(["apply", "--dry-run"]) == 0
    assert "'TpuDefAvailable': 'True'" in capsys.readouterr().out
    assert PCli.main(["example"]) == 0
    assert capsys.readouterr().out == PD.example_yaml()
    f = tmp_path / "tpudef.yaml"
    f.write_text(PDef(applications=("crds", "jaxjob-controller")).dump())
    assert PCli.main(["doctor", "-f", str(f), "--dry-run"]) == 1
    assert "platform NOT healthy" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        PCli.main(["status", "--url", "http://127.0.0.1:1"])


def test_yaml_lite_multi_document_dump_equals_pyyaml():
    objs = PM.render(PDef())
    assert yaml_lite.dump_all(objs) == yaml.safe_dump_all(objs,
                                                          sort_keys=False)
    assert list(yaml.safe_load_all(yaml_lite.dump_all(objs))) == objs


def _roadmap_queue1_item_4() -> str:
    text = (ROOT / "ROADMAP.md").read_text()
    queue = text[text.index("### Queue 1"):text.index("### Queue 2")]
    return queue[queue.index("\n4. **"):queue.index("\n5. **")]


def test_unresolved_launched_modules_are_roadmap_queue1():
    """Every rendered `python -m kubeflow_tpu_torch....` that names no
    module of the port is one that ROADMAP Queue 1 item 4 still lists
    to port (items 2-3, KFAM, the gatekeeper and the metric collector,
    are ported and resolve), and every such module it names is
    rendered; the rest resolve."""
    launched = PM.launched_modules(PM.render(PDef()))
    assert launched == [PM.MODULES[n] for n in PDef().applications
                        if n in PM.MODULES]
    missing = {m for m in launched if importlib.util.find_spec(m) is None}
    listed = set(re.findall(r"`(kubeflow_tpu_torch(?:\.\w+)+)`",
                            _roadmap_queue1_item_4()))
    assert missing == listed
    assert missing == {PM.MODULES[n] for n in PM.UNPORTED}
    assert missing == {"kubeflow_tpu_torch.webapps.dashboard_main",
                       "kubeflow_tpu_torch.webapps.tensorboards_main"}
    for name in ("kfam", "gatekeeper", "metric-collector"):
        assert importlib.util.find_spec(PM.MODULES[name]) is not None
