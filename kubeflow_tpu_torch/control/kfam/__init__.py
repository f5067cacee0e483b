"""KFAM — Kubeflow Access Management REST service (port of
`kubeflow_tpu/control/kfam/`).

Reference: components/access-management (SURVEY.md §2.2): profile +
contributor (RoleBinding) management consumed by the central dashboard.
"""

from kubeflow_tpu_torch.control.kfam.service import KfamService  # noqa: F401
