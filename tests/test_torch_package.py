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
