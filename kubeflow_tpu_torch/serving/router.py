"""What the server needs of the serving plane's router (port of the
jax-free constants and helpers of kubeflow_tpu/serving/router.py): the
deadline header, the 504 exception and the Retry-After header of a 429.

The multi-replica `TokenRouter` / `RouterFrontend` (routing, retries,
hedging, breakers) is not ported yet; it waits for its own slice
(ROADMAP Queue 1, slice 2).
"""

from __future__ import annotations

import math

# the request's REMAINING deadline budget in seconds
HEADER_DEADLINE = "x-request-deadline-s"


class DeadlineExceeded(Exception):
    """The request's deadline elapsed before it could be served: the
    HTTP shell's 504. Raised for dead-on-arrival requests and when the
    continuous batcher cancels an expired slot."""


def _retry_after_headers(retry_after: float | None) -> dict | None:
    if retry_after is None:
        return None
    return {"Retry-After": str(int(math.ceil(retry_after)))}
