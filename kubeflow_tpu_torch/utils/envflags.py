"""Boolean env knobs, read as the JAX package reads them.

A knob such as USE_ISTIO or ENABLE_CULLING is on when its value, in any
case, is "true" (``os.environ.get(name, default).lower() == "true"`` at
every site of `kubeflow_tpu/control/`). The port's control plane
lower-cases no string itself (only `control/scheduler/topology.py`
normalises, and only pool keys), so its knobs are read here.
"""

from __future__ import annotations

import os


def env_flag(name: str, default: str = "false") -> bool:
    """True when ``$name`` (else ``default``) is "true" in any case."""
    return os.environ.get(name, default).lower() == "true"
