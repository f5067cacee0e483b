"""Gatekeeper — basic-auth authservice for mesh ext-authz (port of
`kubeflow_tpu/control/gatekeeper/`).

Reference: components/gatekeeper (SURVEY.md §2.2).
"""

from kubeflow_tpu_torch.control.gatekeeper.auth import AuthServer, pwhash  # noqa: F401
