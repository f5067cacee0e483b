"""The port's job sidecar (kubeflow_tpu_torch/sidecar/controller.py)
against the JAX package's: the GPU readiness gate against a temporary
root, with and without the NVIDIA kernel module's version file and the
device files, and the SIGCONT/SIGTERM handshake, whose files (names,
directory, order) must equal the JAX sidecar's through a whole
lifecycle."""

import threading
import time

import pytest

from kubeflow_tpu.control.k8s.fake import FakeCluster as RCluster
from kubeflow_tpu.sidecar import controller as RS
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster as PCluster
from kubeflow_tpu_torch.sidecar import controller as PS


def test_gate_reads_the_nvidia_version_file(tmp_path):
    assert not PS.gpu_devices_present(str(tmp_path))
    version = tmp_path / PS.NVIDIA_VERSION_FILE
    version.parent.mkdir(parents=True)
    version.write_text("NVRM version: NVIDIA UNIX x86_64 Kernel Module\n")
    assert PS.gpu_devices_present(str(tmp_path))


def test_gate_reads_the_device_files(tmp_path):
    dev = tmp_path / "dev"
    dev.mkdir()
    # the control device alone is not a GPU
    (dev / "nvidiactl").touch()
    (dev / "nvidia-uvm").touch()
    assert not PS.gpu_devices_present(str(tmp_path))
    (dev / "nvidia0").touch()
    assert PS.gpu_devices_present(str(tmp_path))


def test_gate_on_the_real_root_asks_torch_last(monkeypatch, tmp_path):
    """On "/" with neither file, torch's device count decides (here, with
    no GPU, False); another root never asks torch."""
    import torch

    monkeypatch.setattr(PS, "NVIDIA_VERSION_FILE",
                        str(tmp_path / "none" / "version"))
    monkeypatch.setattr(PS, "NVIDIA_DEV_GLOB", str(tmp_path / "nvidia[0-9]*"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert PS.gpu_devices_present("/")
    assert not PS.gpu_devices_present(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert not PS.gpu_devices_present("/")


def _lifecycle(mod, cluster_cls, shared, gate) -> tuple:
    """One sidecar run: the gate opens after a few polls, the master pod
    goes Running -> Succeeded; returns the signal files seen before the
    gate opened, after SIGCONT, and at exit, with the copier's calls and
    the final phase."""
    cluster = cluster_cls()
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": "job-worker-0", "namespace": "default"},
           "spec": {"containers": [{"name": "jax"}]},
           "status": {"phase": "Running"}}
    cluster.create(pod)
    copies, seen = [], {}
    polls = {"n": 0}

    def device_check():
        polls["n"] += 1
        seen.setdefault("gated", sorted(p.name for p in (
            shared / mod.SIGNAL_DIR).iterdir()))
        return gate(polls["n"])

    def finish():
        time.sleep(0.1)
        cur = cluster.get("v1", "Pod", "job-worker-0", "default")
        cur["status"]["phase"] = mod.PHASE_SUCCEEDED
        cluster.update_status(cur)

    ctl = mod.SidecarController(
        str(shared), master_pod="job-worker-0", client=cluster,
        download=("file://src", "file://dst"),
        upload=("file://out", "file://bucket"),
        copier=lambda s, d: copies.append((s, d)),
        device_check=device_check, timeout_s=5, poll_s=0.01)
    threading.Thread(target=finish).start()
    with ctl:
        ctl.wait_ready()
        seen["ready"] = sorted(p.name for p in (shared / mod.SIGNAL_DIR)
                               .iterdir())
        phase = ctl.wait_done()
    seen["exit"] = sorted(p.relative_to(shared).as_posix()
                          for p in shared.rglob("*"))
    return seen, copies, phase, polls["n"] >= 3


def test_handshake_files_equal_the_reference(tmp_path):
    got = _lifecycle(PS, PCluster, tmp_path / "port", lambda n: n >= 3)
    want = _lifecycle(RS, RCluster, tmp_path / "jax", lambda n: n >= 3)
    assert got == want
    seen, copies, phase, polled = got
    assert seen["gated"] == [] and seen["ready"] == ["SIGCONT"]
    assert seen["exit"] == [".kubeflow-tpu-sidecar",
                            ".kubeflow-tpu-sidecar/SIGCONT",
                            ".kubeflow-tpu-sidecar/SIGTERM"]
    assert copies == [("file://src", "file://dst"),
                      ("file://out", "file://bucket")]
    assert phase == "Succeeded" and polled
    assert (PS.SIGNAL_DIR, PS.SIGCONT_FILE, PS.SIGTERM_FILE) == \
        (RS.SIGNAL_DIR, RS.SIGCONT_FILE, RS.SIGTERM_FILE)


@pytest.mark.parametrize("mod", [RS, PS], ids=["jax", "port"])
def test_gate_timeout_still_signals_termination(tmp_path, mod):
    ctl = mod.SidecarController(str(tmp_path), master_pod="m",
                                device_check=lambda: False, timeout_s=0.05,
                                poll_s=0.01)
    with pytest.raises(TimeoutError):
        with ctl:
            ctl.wait_ready()
    assert not ctl.is_ready() and ctl.should_terminate()


def test_the_gate_is_the_default_and_main_waits_for_the_rest_client(capsys):
    """main no longer waits for the REST client: it watches the master
    pod through it (tests/test_torch_control_mains.py drives it against
    an apiserver); here, its flags."""
    ctl = PS.SidecarController("/tmp", master_pod="m")
    assert ctl.device_check is PS.gpu_devices_present
    with pytest.raises(SystemExit) as e:
        PS.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--master-pod" in out and "--apiserver" in out
