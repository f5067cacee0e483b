"""Declarative IAM binding patches — scripts/gke/iam_patch.py rebuilt.

Port of `kubeflow_tpu/tpctl/iam_patch.py` (its YAML through the port's
`utils/yaml_lite`).

The reference script shells out to `gcloud projects get-iam-policy`,
merges a declarative bindings YAML into it with retry-on-conflict, and
`set-iam-policy`s the result (iam_patch.py:12-17 usage header). Here the
merge is cloudauth.update_policy (gcpUtils.go:70 semantics, shared with
the tpctl plane) and the cloud calls go through a CrmBackend — the
stdlib HttpCrmBackend in production, injectable for tests.

Usage:
  python -m kubeflow_tpu_torch.tpctl.iam_patch --action=add --project=p \
      --bindings-file=bindings.yaml --token-file=token.txt
bindings.yaml:
  bindings:
    - members: [set-kubeflow-iap-account, user:x@y.com]
      roles: [roles/iap.httpsResourceAccessor]
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import Callable

from kubeflow_tpu_torch.tpctl import cloudauth
from kubeflow_tpu_torch.utils import yaml_lite

log = logging.getLogger("kubeflow_tpu_torch.iam_patch")


def load_bindings(path: str) -> list[dict]:
    doc = yaml_lite.load(path)
    bindings = (doc or {}).get("bindings")
    if not isinstance(bindings, list):
        raise ValueError(f"{path}: expected top-level 'bindings' list")
    return bindings


def patch_iam_policy(
    project: str,
    token: str,
    bindings: list[dict],
    backend: cloudauth.CrmBackend,
    *,
    action: str = "add",
    cluster: str = "",
    email: str = "",
    retries: int = 5,
    sleep: Callable[[float], None] = time.sleep,
) -> dict:
    """Get-merge-set with retry (the reference retries the whole cycle on
    set conflicts, iam_patch.py's loop). Returns the final policy."""
    if action not in ("add", "remove"):
        raise ValueError(f"action must be add|remove, got {action!r}")
    if retries < 1:
        raise ValueError(f"retries must be >= 1, got {retries}")
    last_err: Exception | None = None
    for attempt in range(retries):
        policy = backend.get_iam_policy(project, token)
        updated = cloudauth.update_policy(
            policy, bindings, cluster=cluster, project=project, email=email,
            action=action)
        try:
            backend.set_iam_policy(project, token, updated)
            return updated
        except Exception as e:  # concurrent editor: re-read and re-merge
            if cloudauth.is_auth_rejection(e):
                raise  # permission denied is not a merge conflict
            last_err = e
            log.warning("set-iam-policy attempt %d failed: %s", attempt + 1, e)
            sleep(min(2.0 * (attempt + 1), 10.0))
    raise last_err  # type: ignore[misc]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--action", default="add", choices=["add", "remove"])
    p.add_argument("--project", required=True)
    p.add_argument("--bindings-file", required=True)
    p.add_argument("--token-file", required=True,
                   help="file containing the OAuth bearer token")
    p.add_argument("--cluster", default="")
    p.add_argument("--email", default="")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    token = open(args.token_file).read().strip()
    bindings = load_bindings(args.bindings_file)
    backend = cloudauth.HttpCrmBackend()
    policy = patch_iam_policy(args.project, token, bindings, backend,
                              action=args.action, cluster=args.cluster,
                              email=args.email)
    log.info("policy now has %d bindings", len(policy.get("bindings", [])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
