"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, imports without CUDA or triton, and never falls back to the CPU
unasked."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "kubeflow_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "kubeflow_tpu")


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
        "flash_bwd.cu", "flash_bwd_dkv.cu", "flash_fwd.cu", "flash_sm90.cuh"]
    assert sorted(_build.SOURCES + _build.HEADERS) == [
        "flash_bwd.cu", "flash_bwd_dkv.cu", "flash_fwd.cu", "flash_sm90.cuh"]


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
