"""PyTorch/CUDA port of kubeflow_tpu for NVIDIA Hopper (H100).

The JAX package `kubeflow_tpu` is the reference this port is held
against; the port imports nothing of it. Its entry points run on
`cuda` unless the caller asks for `device="cpu"`, and raise when no GPU
is present and the CPU was not asked for. The CUDA kernels build from
`ops/csrc/` on first use on a CUDA device, never at import. The
re-export below is lazy: the control plane (`control/`, `sidecar/`)
imports without torch.
"""

__all__ = ["resolve_device"]


def __getattr__(name: str):
    if name == "resolve_device":
        from kubeflow_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
