"""Job lifecycle sidecar: readiness gate + master watch + artifact copy.

Port of `kubeflow_tpu/sidecar/controller.py`, back on GPUs, which is
where openmpi-controller/controller/controller.py began:

- file-based handshake over a shared emptyDir (:9-11): touch SIGCONT when
  the environment is ready (main container blocks on it), SIGTERM when
  the job should exit — the same directory and file names as the JAX
  package's sidecar;
- readiness gate: as the reference does (:14, :73-90), wait for the
  NVIDIA kernel module's /proc/driver/nvidia/version, or the
  /dev/nvidia<N> device files, and when neither shows, for torch to
  count a CUDA device — gated behind a timeout;
- data staging: download before SIGCONT, upload artifacts after the job
  finishes (:104-116) through a pluggable object-store copier (gs://
  via gsutil, s3:// via awscli, file:// for tests);
- master-phase watch (:92-102): poll the master pod's phase through the
  K8s API until Succeeded/Failed (workers use this to exit when rank 0
  is done). ``main``, the container entry, needs the REST client of a
  later slice and raises NotImplementedError until then.
"""

from __future__ import annotations

import logging
import os
import pathlib
import shutil
import subprocess
import time

log = logging.getLogger("kubeflow_tpu_torch.sidecar")

SIGNAL_DIR = ".kubeflow-tpu-sidecar"   # the shared-volume dir (:9)
SIGCONT_FILE = "SIGCONT"
SIGTERM_FILE = "SIGTERM"
PHASE_SUCCEEDED = "Succeeded"          # :12-13
PHASE_FAILED = "Failed"
# The GPU gate's paths (:14), relative to the filesystem root that
# gpu_devices_present is given
NVIDIA_VERSION_FILE = "proc/driver/nvidia/version"
NVIDIA_DEV_GLOB = "dev/nvidia[0-9]*"


def default_copier(src: str, dst: str) -> None:
    """Object-store copy: gs:// (gsutil), s3:// (aws cli), file://|path."""
    def is_remote(p):
        return p.startswith(("gs://", "s3://"))

    if src.startswith("gs://") or dst.startswith("gs://"):
        subprocess.run(["gsutil", "-m", "cp", "-r", src, dst], check=True)
    elif src.startswith("s3://") or dst.startswith("s3://"):
        subprocess.run(["aws", "s3", "cp", "--recursive", src, dst], check=True)
    else:
        src_p = pathlib.Path(src.removeprefix("file://"))
        dst_p = pathlib.Path(dst.removeprefix("file://"))
        if src_p.is_dir():
            shutil.copytree(src_p, dst_p, dirs_exist_ok=True)
        else:
            dst_p.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy2(src_p, dst_p)


def gpu_devices_present(root: str = "/") -> bool:
    """The reference's gate (:73-90): the NVIDIA kernel module's
    version file or a GPU device file under ``root``. On the real root, when neither
    is there, a torch that imports and counts a CUDA device passes too
    (a container that sees the GPU without the module's /proc entry);
    another root (a test's temporary directory) is judged by its files
    alone."""
    import glob

    if os.path.exists(os.path.join(root, NVIDIA_VERSION_FILE)):
        return True
    if glob.glob(os.path.join(root, NVIDIA_DEV_GLOB)):
        return True
    if os.path.abspath(root) != "/":
        return False
    try:
        import torch

        return torch.cuda.device_count() > 0
    except Exception:
        return False


class SidecarController:
    def __init__(
        self,
        shared_dir: str,
        *,
        master_pod: str | None = None,
        namespace: str = "default",
        client=None,
        download: tuple[str, str] | None = None,   # (src, dst)
        upload: tuple[str, str] | None = None,
        copier=default_copier,
        device_check=gpu_devices_present,
        timeout_s: float = 600.0,
        poll_s: float = 1.0,
    ):
        self.dir = pathlib.Path(shared_dir) / SIGNAL_DIR
        self.master_pod = master_pod
        self.namespace = namespace
        self.client = client
        self.download = download
        self.upload = upload
        self.copier = copier
        self.device_check = device_check
        self.timeout_s = timeout_s
        self.poll_s = poll_s

    # -- signal files (:39-57) ----------------------------------------------

    def __enter__(self) -> "SidecarController":
        self.dir.mkdir(parents=True, exist_ok=True)
        return self

    def __exit__(self, *exc) -> None:
        (self.dir / SIGTERM_FILE).touch()  # :51

    def signal_ready(self) -> None:
        (self.dir / SIGCONT_FILE).touch()  # :57

    def is_ready(self) -> bool:
        return (self.dir / SIGCONT_FILE).exists()

    def should_terminate(self) -> bool:
        return (self.dir / SIGTERM_FILE).exists()

    # -- phases -------------------------------------------------------------

    def wait_ready(self) -> None:
        """Device gate + data download, then SIGCONT (:53-57)."""
        deadline = time.monotonic() + self.timeout_s
        while not self.device_check():
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"GPU devices not visible within {self.timeout_s}s")
            log.info("waiting for GPU devices...")
            time.sleep(self.poll_s)
        if self.download:
            self.copier(*self.download)
        self.signal_ready()

    def poll_master_phase(self) -> str:
        pod = self.client.get_or_none("v1", "Pod", self.master_pod, self.namespace)
        if pod is None:
            return PHASE_FAILED  # master gone = job dead
        return (pod.get("status") or {}).get("phase", "Pending")

    def wait_done(self) -> str:
        """Poll master pod phase to terminal (:59, :92-102), then upload."""
        deadline = time.monotonic() + self.timeout_s
        while True:
            phase = self.poll_master_phase()
            if phase in (PHASE_SUCCEEDED, PHASE_FAILED):
                break
            if time.monotonic() > deadline:
                raise TimeoutError("master pod never reached a terminal phase")
            time.sleep(self.poll_s)
        if self.upload:
            self.copier(*self.upload)
        return phase

    def run(self) -> str:
        """Full lifecycle (main.py:7-33)."""
        with self:
            self.wait_ready()
            return self.wait_done()


def main(argv: list[str] | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser("kubeflow-tpu-sidecar")
    p.add_argument("--shared-dir", default="/kubeflow-tpu")
    p.add_argument("--master-pod", required=True)
    p.add_argument("--namespace", default=os.environ.get("POD_NAMESPACE", "default"))
    p.add_argument("--download", nargs=2, metavar=("SRC", "DST"))
    p.add_argument("--upload", nargs=2, metavar=("SRC", "DST"))
    p.add_argument("--timeout-secs", type=float, default=600.0)
    p.parse_args(argv)
    # the --master-pod watch reads the pod through the apiserver
    raise NotImplementedError(
        "the sidecar's --master-pod watch needs the REST client "
        "(control/k8s/rest.py), which is not ported yet (ROADMAP Queue 1, "
        "item 20b)")


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
