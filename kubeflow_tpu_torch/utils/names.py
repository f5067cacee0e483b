"""Kubernetes object-name validation shared by every CR-creating endpoint.

Port of `kubeflow_tpu/utils/names.py`. Browser-side checks (the spawner
form) are advisory; a real apiserver rejects a non-RFC1123
metadata.name with an opaque 422, so the backends validate up front and
answer a clean 400.
"""

from __future__ import annotations

import re

from kubeflow_tpu_torch.utils.httpd import ApiHttpError

_DNS1123 = re.compile(r"[a-z0-9]([-a-z0-9]*[a-z0-9])?")


def is_dns1123(name: object) -> bool:
    return (isinstance(name, str) and 0 < len(name) <= 63
            and _DNS1123.fullmatch(name) is not None)


def require_dns1123(name: object, what: str = "name") -> str:
    if not is_dns1123(name):
        raise ApiHttpError(
            400, f"invalid {what} {name!r}: must be lowercase RFC-1123 "
                 "(letters, digits, '-'; max 63 chars)")
    return name  # type: ignore[return-value]


def sanitize_dns1123(raw: str, fallback: str = "user") -> str:
    """Best-effort conversion of free-form text (e.g. an email localpart)
    into a valid name — for server-derived defaults, never user input."""
    s = re.sub(r"[^a-z0-9-]", "-", raw.lower()).strip("-")[:63].strip("-")
    return s if is_dns1123(s) else fallback
