"""GPU job lifecycle sidecar (reference: components/openmpi-controller;
port of `kubeflow_tpu/sidecar/`)."""

from kubeflow_tpu_torch.sidecar.controller import SidecarController  # noqa: F401
