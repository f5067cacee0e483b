"""Idle culling: scale notebooks to zero when Jupyter reports no activity.

Port of `kubeflow_tpu/control/notebook/culler.py`. Reference:
notebook-controller/pkg/culler/culler.go —
- env knobs (:24-27): ENABLE_CULLING (default off), CULL_IDLE_TIME
  (1440 min), IDLENESS_CHECK_PERIOD (1 min);
- probe (:138): GET http://<nb>.<ns>.svc/notebook/<ns>/<nb>/api/status,
  parse Jupyter's last_activity;
- idle decision (:171-191) and the stop annotation write (:91), which the
  next reconcile turns into replicas=0 (notebook_controller.go:284-286).

The probe speaks HTTP through the standard library (`urllib.request`):
the card's machine has no `requests`. As the JAX package's, it answers
None on any failure and gives up after 5 s. The probe is injectable so
controller tests drive idleness without a live Jupyter.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import urllib.request
from typing import Callable

from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.control.notebook import types as T
from kubeflow_tpu_torch.utils.envflags import env_flag

log = logging.getLogger("kubeflow_tpu_torch.culler")

TIME_FMT = "%Y-%m-%dT%H:%M:%SZ"
PROBE_TIMEOUT_S = 5.0


def enabled() -> bool:
    return env_flag("ENABLE_CULLING", "false")


def idle_time_minutes() -> float:
    return float(os.environ.get("CULL_IDLE_TIME", "1440"))


def check_period_minutes() -> float:
    return float(os.environ.get("IDLENESS_CHECK_PERIOD", "1"))


def requeue_seconds() -> float:
    """GetRequeueTime analogue (culler.go:61)."""
    return check_period_minutes() * 60.0


def status_url(notebook: dict) -> str:
    """The Jupyter status API behind the notebook's in-cluster Service
    (getNotebookApiStatus, culler.go:138-169)."""
    m = ob.meta(notebook)
    return (f"http://{m['name']}.{m['namespace']}.svc.cluster.local"
            f"/notebook/{m['namespace']}/{m['name']}/api/status")


def probe_status(url: str, timeout: float = PROBE_TIMEOUT_S) -> str | None:
    """GET a Jupyter status API; its last_activity, or None when the
    server is unreachable, answers other than 200, or sends no JSON."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            if resp.status != 200:
                return None
            return json.loads(resp.read()).get("last_activity")
    except Exception as e:
        log.debug("status probe of %s failed: %s", url, e)
        return None


def default_probe(notebook: dict) -> str | None:
    """GET the notebook's Jupyter status API; returns last_activity or
    None."""
    return probe_status(status_url(notebook))


def is_idle(last_activity: str | None, now: datetime.datetime | None = None) -> bool:
    """notebookIsIdle (culler.go:171-189)."""
    if not last_activity:
        return False
    try:
        last = datetime.datetime.strptime(
            last_activity.split(".")[0].rstrip("Z") + "Z", TIME_FMT
        ).replace(tzinfo=datetime.timezone.utc)
    except ValueError:
        return False
    now = now or datetime.datetime.now(datetime.timezone.utc)
    return (now - last).total_seconds() > idle_time_minutes() * 60.0


def is_stopped(notebook: dict) -> bool:
    return T.STOP_ANNOTATION in ob.annotations_of(notebook)


def set_stop_annotation(notebook: dict) -> None:
    """SetStopAnnotation (culler.go:91)."""
    ob.set_annotation(notebook, T.STOP_ANNOTATION, ob.now_iso())


def needs_culling(
    notebook: dict,
    probe: Callable[[dict], str | None] = default_probe,
    now: datetime.datetime | None = None,
) -> bool:
    """NotebookNeedsCulling (culler.go:191-206)."""
    if not enabled():
        return False
    if is_stopped(notebook):
        return False
    return is_idle(probe(notebook), now=now)
