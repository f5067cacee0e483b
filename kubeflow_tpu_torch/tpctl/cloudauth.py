"""Cloud credential plumbing for the tpctl plane.

Port of `kubeflow_tpu/tpctl/cloudauth.py`.

The reference's deployment engine carries three pieces of GCP auth
machinery that the tpctl plane was missing:

- ``RefreshableTokenSource`` (bootstrap/cmd/bootstrap/app/tokenSource.go:35-75):
  a shared token holder whose ``refresh`` validates that the *new* token
  still grants access to the project before swapping it in, so in-flight
  users of the source never see a downgrade.
- ``check_project_access`` (gcpUtils.go:128-180): TestIamPermissions for
  ``resourcemanager.projects.setIamPolicy`` with exponential backoff —
  the validity gate used both by token refresh and request admission
  (kfctlServer.go:545).
- ``update_policy`` + ``prepare_account`` (gcpUtils.go:60-119): IAM
  policy merge — role->member set semantics with placeholder
  substitution and add/remove actions.
- ``bind_role`` (initHandler.go:33 + ksServer.BindRole): grants the
  deployment-manager service account the admin role under a per-project
  lock.

All cloud calls go through an injectable ``CrmBackend`` (the reference
holds live cloudresourcemanager clients, untestable offline); the policy
math is pure Python.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Protocol

SET_IAM_POLICY_PERMISSION = "resourcemanager.projects.setIamPolicy"
IAM_ADMIN_ROLE = "roles/owner"  # ksServer IAM_ADMIN_ROLE analogue


def is_auth_rejection(e: Exception) -> bool:
    """True when a backend error is a definitive credentials verdict
    (HTTP 401/403 — e.g. urllib.error.HTTPError.code), not an outage."""
    return getattr(e, "code", None) in (401, 403)


class CrmBackend(Protocol):
    """The cloudresourcemanager slice the tpctl plane needs."""

    def test_iam_permissions(self, project: str, token: str,
                             permissions: list[str]) -> list[str]:
        """Returns the subset of `permissions` the token holds."""
        ...

    def get_iam_policy(self, project: str, token: str) -> dict: ...

    def set_iam_policy(self, project: str, token: str, policy: dict) -> None: ...


def check_project_access(
    project: str,
    token: str,
    backend: CrmBackend,
    *,
    max_elapsed: float = 60.0,
    initial_interval: float = 2.0,
    max_interval: float = 5.0,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
) -> bool:
    """True when the token holds setIamPolicy on the project.

    Retries transient backend errors with exponential backoff
    (gcpUtils.go:150-155: 2s initial, 5s cap, 1min budget). A clean
    "permission not granted" answer — including a definitive HTTP
    401/403 from the backend — returns False immediately; an exhausted
    retry budget re-raises the last backend error, because a CRM outage
    is not a credentials verdict (the reference's CheckProjectAccess
    likewise returns (false, err), and callers branch on err). The
    budget is wall-clock (backend call time counts), so callers' thread
    -pinning bounds hold even when the backend hangs to its timeout.
    """
    start = clock()
    interval = initial_interval
    while True:
        try:
            granted = backend.test_iam_permissions(
                project, token, [SET_IAM_POLICY_PERMISSION])
            return SET_IAM_POLICY_PERMISSION in granted
        except Exception as e:
            if is_auth_rejection(e):
                return False  # 401/403 IS the verdict, not an outage
            if clock() - start + interval > max_elapsed:
                raise
            sleep(interval)
            interval = min(interval * 2, max_interval)


class RefreshableTokenSource:
    """Shared, thread-safe OAuth token with validated refresh
    (tokenSource.go:35-75)."""

    def __init__(self, project: str, backend: CrmBackend,
                 checker: Callable[..., bool] = check_project_access):
        if not project:
            raise ValueError("project is required")
        self.project = project
        self.backend = backend
        self.checker = checker
        self._mu = threading.Lock()
        self._token: str | None = None

    def refresh(self, new_token: str) -> None:
        """Swap in a new token after verifying it still grants project
        access (tokenSource.go:52-71). Raises on empty/invalid tokens;
        the current token is left untouched on failure."""
        if not new_token:
            raise ValueError("no access token specified")
        if not self.checker(self.project, new_token, self.backend):
            raise PermissionError(
                "could not refresh the token source: token does not provide "
                "sufficient privileges")
        with self._mu:
            self._token = new_token

    def token(self) -> str | None:
        with self._mu:
            return self._token


def prepare_account(account: str) -> str:
    """Prefix an identity for IAM bindings (gcpUtils.go:60-68)."""
    if "iam.gserviceaccount.com" in account:
        return "serviceAccount:" + account
    if "google-kubeflow-support" in account:
        return "group:" + account
    return "user:" + account


def update_policy(current_policy: dict, iam_bindings: list[dict],
                  *, cluster: str, project: str, email: str,
                  action: str = "add") -> dict:
    """Merge declarative bindings into an IAM policy (gcpUtils.go:70-119).

    ``iam_bindings``: [{"members": [...], "roles": [...]}] where members
    may be the reference's set-kubeflow-* placeholders. Returns a new
    policy dict; role->member sets are deduplicated, and ``action="remove"``
    deletes the named members from the named roles.
    """
    policy_map: dict[str, dict[str, bool]] = {}
    for binding in current_policy.get("bindings") or []:
        members = policy_map.setdefault(binding.get("role", ""), {})
        for m in binding.get("members") or []:
            members[m] = True

    sa_mapping = {
        "set-kubeflow-admin-service-account": prepare_account(
            f"{cluster}-admin@{project}.iam.gserviceaccount.com"),
        "set-kubeflow-user-service-account": prepare_account(
            f"{cluster}-user@{project}.iam.gserviceaccount.com"),
        "set-kubeflow-vm-service-account": prepare_account(
            f"{cluster}-vm@{project}.iam.gserviceaccount.com"),
        "set-kubeflow-iap-account": prepare_account(email),
    }
    for binding in iam_bindings:
        for member in binding.get("members") or []:
            actual = sa_mapping.get(member, member)
            for role in binding.get("roles") or []:
                members = policy_map.setdefault(role, {})
                members[actual] = action == "add"

    new_bindings = []
    for role, members in policy_map.items():
        kept = [m for m, present in members.items() if present]
        if kept:
            new_bindings.append({"role": role, "members": kept})
    out = dict(current_policy)
    out["bindings"] = new_bindings
    return out


class HttpCrmBackend:
    """cloudresourcemanager REST backend (stdlib urllib, no SDK).

    The production CrmBackend: POSTs testIamPermissions /
    getIamPolicy / setIamPolicy with the caller's bearer token. The
    endpoint is overridable for hermetic tests and private-access VPCs.
    """

    DEFAULT_ENDPOINT = "https://cloudresourcemanager.googleapis.com/v1"

    def __init__(self, endpoint: str = DEFAULT_ENDPOINT, timeout: float = 15.0):
        self.endpoint = endpoint.rstrip("/")
        self.timeout = timeout

    def _post(self, path: str, token: str, payload: dict) -> dict:
        import json
        import urllib.request

        req = urllib.request.Request(
            f"{self.endpoint}/{path}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json",
                     "Authorization": f"Bearer {token}"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read() or b"{}")

    def test_iam_permissions(self, project: str, token: str,
                             permissions: list[str]) -> list[str]:
        out = self._post(f"projects/{project}:testIamPermissions", token,
                         {"permissions": permissions})
        return out.get("permissions", [])

    def get_iam_policy(self, project: str, token: str) -> dict:
        return self._post(f"projects/{project}:getIamPolicy", token, {})

    def set_iam_policy(self, project: str, token: str, policy: dict) -> None:
        self._post(f"projects/{project}:setIamPolicy", token,
                   {"policy": policy})


class ProjectLocks:
    """Per-project mutex map (ksServer.go:166-174 GetProjectLock)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._locks: dict[str, threading.Lock] = {}

    def get(self, project: str) -> threading.Lock:
        with self._mu:
            return self._locks.setdefault(project, threading.Lock())


_project_locks = ProjectLocks()


def bind_role(project: str, token: str, service_account: str,
              backend: CrmBackend, *, role: str = IAM_ADMIN_ROLE,
              locks: ProjectLocks | None = None) -> None:
    """Grant `role` to the service account on the project
    (initHandler.go:33 -> ksServer.BindRole). Get-modify-set under a
    per-project lock; idempotent when the binding already exists."""
    locks = locks or _project_locks
    with locks.get(project):
        policy = backend.get_iam_policy(project, token)
        member = "serviceAccount:" + service_account
        for b in policy.get("bindings") or []:
            if b.get("role") == role and member in (b.get("members") or []):
                return
        policy.setdefault("bindings", []).append(
            {"role": role, "members": [member]})
        backend.set_iam_policy(project, token, policy)
