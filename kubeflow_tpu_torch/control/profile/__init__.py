"""Profile operator — multi-tenancy: one namespace per user or team
(port of `kubeflow_tpu/control/profile/`).

Reference: components/profile-controller (SURVEY.md §2.2): Profile CR ->
Namespace (istio-injection labeled) + default-editor/default-viewer
ServiceAccounts + owner RoleBinding + ResourceQuota + cloud-credential
plugins, with a finalizer for cleanup. The quota counts
``nvidia.com/gpu`` alongside cpu and memory.
"""

from kubeflow_tpu_torch.control.profile.types import API_VERSION, KIND, new_profile  # noqa: F401
from kubeflow_tpu_torch.control.profile.controller import (  # noqa: F401
    ProfileReconciler,
    build_controller,
)
