"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, imports without CUDA or triton, and never falls back to the CPU
unasked."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "kubeflow_tpu_torch"
# prometheus_client and requests are absent on the card's machine: the
# port renders its metrics from its own registry (runtime/metrics.py) and
# speaks HTTP through the standard library (control/k8s/rest.py)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "kubeflow_tpu",
             "prometheus_client", "requests")


def _modules():
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PKG.rglob("*.py"))


def test_import_pulls_in_no_jax_or_triton():
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    new = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in new if m.split(".")[0] in (*FORBIDDEN, "triton")]
    assert not bad, bad
    assert "kubeflow_tpu_torch.runtime.trainer" in new
    # the distributed runtime and the mesh are scanned like the rest
    for mod in ("parallel.dist", "parallel.backends", "parallel.mesh",
                "parallel.shardings", "runtime.elastic", "ops.moe",
                "ops.ring_attention", "ops.ulysses", "parallel.pipeline"):
        assert f"kubeflow_tpu_torch.{mod}" in new, mod


def test_the_services_path_imports_without_cuda_or_the_jax_package():
    """The control plane's services path imports with no CUDA device
    visible and pulls in no torch, no JAX-package module, no
    prometheus_client and no requests."""
    mods = ["kubeflow_tpu_torch.control.mains",
            "kubeflow_tpu_torch.control.k8s.rest",
            "kubeflow_tpu_torch.control.jaxservice.controller",
            "kubeflow_tpu_torch.obs.goodput"]
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True, env={**os.environ,
                                          "CUDA_VISIBLE_DEVICES": ""})
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(mods) <= set(loaded)
    bad = [m for m in loaded
           if m.split(".")[0] in (*FORBIDDEN, "torch", "triton")]
    assert not bad, bad


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_forbidden_imports(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_entry_points_raise_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda default is valid here")
    from kubeflow_tpu_torch import resolve_device
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.runtime import launcher

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model("transformer-test")
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"model": "transformer-test", "task": "lm",
                               "global_batch": 2, "seq_len": 16,
                               "vocab_size": 256, "total_steps": 1}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--config", str(cfg)])
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_smoke_script_refuses_to_run_without_gpu(tmp_path):
    """Run without a GPU, or away from the package, chip_smoke exits non-zero
    and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_kernel_build_is_lazy():
    from kubeflow_tpu_torch.ops import _build

    assert _build._libs == {}
    # every file of csrc is a source the build compiles or a header its
    # hash covers
    assert [p.name for p in sorted((PKG / "ops" / "csrc").iterdir())] == [
        "flash_bwd.cu", "flash_bwd_dkv.cu", "flash_bwd_dkv_split.cu",
        "flash_fwd.cu", "flash_simple.cu", "flash_sm90.cuh"]
    assert sorted(_build.SOURCES + _build.HEADERS) == [
        "flash_bwd.cu", "flash_bwd_dkv.cu", "flash_bwd_dkv_split.cu",
        "flash_fwd.cu", "flash_simple.cu", "flash_sm90.cuh"]


def test_serving_runtime_and_utils_modules_are_scanned():
    """The AST scan above covers every module of the decode and serving
    slice, and none of them imports prometheus_client (absent on the
    card's machine)."""
    scanned = {p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")}
    for path in ("serving/server.py", "serving/continuous.py",
                 "serving/quant.py", "serving/router.py",
                 "serving/__main__.py", "runtime/generate.py",
                 "runtime/kvcache.py", "runtime/metrics.py",
                 "utils/httpd.py", "ops/quantize.py", "serve_bench.py"):
        assert f"kubeflow_tpu_torch/{path}" in scanned, path
    for path in sorted(scanned):
        tree = ast.parse((ROOT / path).read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            assert not any(n.split(".")[0] == "prometheus_client"
                           for n in names), path


def test_imports_and_serves_with_jax_triton_and_prometheus_blocked():
    """Every module imports, and the CPU server answers a predict over
    HTTP, with jax, triton and prometheus_client unimportable."""
    code = (
        "import importlib, importlib.abc, json, sys, urllib.request\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'triton',\n"
        "                                  'prometheus_client'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "from kubeflow_tpu_torch.serving.server import (ModelServer,\n"
        "                                                serve_lm_generator)\n"
        "served = serve_lm_generator('x', 'transformer-test', device='cpu',\n"
        "    prompt_len=8, max_new_tokens=4, continuous_batching=True,\n"
        "    decode_slots=2, param_dtype='int8')\n"
        "server = ModelServer(); server.register(served)\n"
        "svc = server.serve(host='127.0.0.1', port=0).serve_background()\n"
        "req = urllib.request.Request(\n"
        "    f'http://127.0.0.1:{svc.port}/v1/models/x:predict',\n"
        "    data=json.dumps({'instances': [{'tokens': [1, 2]}]}).encode(),\n"
        "    method='POST')\n"
        "preds = json.loads(urllib.request.urlopen(req).read())['predictions']\n"
        "svc.shutdown(); server.close()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'triton', 'prometheus_client', 'kubeflow_tpu')]\n"
        "print(json.dumps({'preds': preds, 'bad': bad}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert len(got["preds"]) == 1 and len(got["preds"][0]) == 4


def test_classification_modules_are_scanned_and_build_without_jax():
    """The classification slice's modules are in the scans above, and
    every classifier builds under the reference's registry name with
    jax, flax and triton unimportable."""
    scanned = {p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")}
    for path in ("models/resnet.py", "models/vit.py", "models/bert.py",
                 "models/encoder.py", "runtime/data.py", "runtime/records.py",
                 "runtime/trainer.py", "serving/server.py", "convert.py",
                 "bench.py"):
        assert f"kubeflow_tpu_torch/{path}" in scanned, path
    code = (
        "import importlib.abc, json, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',\n"
        "                                  'triton', 'kubeflow_tpu'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "from kubeflow_tpu_torch.models.registry import get_model\n"
        "names = ['resnet18', 'resnet50', 'resnet101', 'vit-test',\n"
        "         'vit-s16', 'vit-b16', 'bert-test', 'bert-base']\n"
        "sizes = {n: sum(p.numel() for p in\n"
        "                get_model(n, device='meta').parameters())\n"
        "         for n in names}\n"
        "print(json.dumps(sizes))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    sizes = json.loads(out.stdout.strip().splitlines()[-1])
    # the published sizes: ResNet-50 25.6M, ViT-B/16 ~86M, BERT-base ~110M
    assert 25.5e6 < sizes["resnet50"] < 25.6e6
    assert 85e6 < sizes["vit-b16"] < 88e6
    assert 100e6 < sizes["bert-base"] < 112e6


def test_control_plane_imports_without_torch_jax_or_prometheus():
    """The job path's control plane (the JAXJob controller, the gang
    scheduler, the sidecar and what they import) imports with jax,
    triton, prometheus_client and the JAX package unimportable, and
    pulls in no torch at all, so no CUDA; the sidecar's gate on a root
    without the NVIDIA files answers without torch too."""
    scanned = {p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")}
    for path in ("control/k8s/objects.py", "control/k8s/fake.py",
                 "control/k8s/kubelet.py", "control/runtime.py",
                 "control/reconcilehelper.py", "control/scheduler/__init__.py",
                 "control/scheduler/topology.py", "control/scheduler/nodes.py",
                 "control/scheduler/capacity.py", "control/scheduler/queue.py",
                 "control/cache.py", "control/jaxjob/types.py",
                 "control/jaxjob/controller.py",
                 "control/scheduler/scheduler.py", "sidecar/controller.py"):
        assert f"kubeflow_tpu_torch/{path}" in scanned, path
    code = (
        "import importlib.abc, json, sys, tempfile\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'triton',\n"
        "                                  'prometheus_client',\n"
        "                                  'kubeflow_tpu'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "from kubeflow_tpu_torch.control.jaxjob import controller\n"
        "from kubeflow_tpu_torch.control.scheduler import scheduler\n"
        "from kubeflow_tpu_torch.sidecar import controller as sidecar\n"
        "gate = sidecar.gpu_devices_present(tempfile.mkdtemp())\n"
        "print(json.dumps({'gate': gate, 'torch': sorted(\n"
        "    m for m in sys.modules if m.split('.')[0] == 'torch')}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"gate": False, "torch": []}


def test_access_and_observability_modules_import_without_torch():
    """KFAM, the gatekeeper, the observability plane and the prober are
    in the scans above, and import with jax, triton, prometheus_client,
    requests and the JAX package unimportable, pulling in no torch."""
    mods = ["kubeflow_tpu_torch.control.kfam",
            "kubeflow_tpu_torch.control.kfam.service",
            "kubeflow_tpu_torch.control.kfam.__main__",
            "kubeflow_tpu_torch.control.gatekeeper",
            "kubeflow_tpu_torch.control.gatekeeper.auth",
            "kubeflow_tpu_torch.control.gatekeeper.__main__",
            "kubeflow_tpu_torch.obs", "kubeflow_tpu_torch.obs.tsdb",
            "kubeflow_tpu_torch.obs.rules", "kubeflow_tpu_torch.obs.persist",
            "kubeflow_tpu_torch.obs.remediate",
            "kubeflow_tpu_torch.obs.plane", "kubeflow_tpu_torch.obs.goodput",
            "kubeflow_tpu_torch.metric_collector",
            "kubeflow_tpu_torch.metric_collector.prober",
            "kubeflow_tpu_torch.metric_collector.__main__"]
    scanned = set(_modules())
    assert set(mods) <= scanned, sorted(set(mods) - scanned)
    code = (
        "import importlib, importlib.abc, json, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'triton',\n"
        "                                  'prometheus_client', 'requests',\n"
        "                                  'kubeflow_tpu', 'torch'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from kubeflow_tpu_torch.obs.goodput import ServingSLO\n"
        "print(json.dumps(hasattr(ServingSLO, 'from_store')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) is True
