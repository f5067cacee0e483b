"""Notebook operator — managed Jupyter servers with idle culling (port
of `kubeflow_tpu/control/notebook/`).

Reference: components/notebook-controller (SURVEY.md §2.2). A Notebook CR
becomes a StatefulSet (1 replica) + Service (80 -> 8888) + optional Istio
VirtualService; status is derived from the pod's container state; idle
servers are culled (scaled to zero) via the Jupyter /api/status probe.
Notebook images are the port's (PyTorch on CUDA), and GPUs are requested
through the same `nvidia.com/gpu` limit and selectors a JAXJob uses.
"""

from kubeflow_tpu_torch.control.notebook.types import API_VERSION, KIND, new_notebook  # noqa: F401
from kubeflow_tpu_torch.control.notebook.controller import (  # noqa: F401
    NotebookReconciler,
    build_controller,
)
