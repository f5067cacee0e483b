"""JAXService CRD: API types, defaults, validation.

The serving analogue of JAXJob (ROADMAP #2): where a JAXJob is one gang
that runs to completion, a JAXService is N interchangeable model-server
replicas that run forever behind the token-aware router
(``serving/router.py``), scaled between ``replicas.min`` and
``replicas.max`` on router queue depth and tokens/sec. Each replica is
its own gang of ONE for the gang scheduler — replicas admit
independently (a serving fleet wants every replica it can get, not
all-or-nothing), but still get slice-topology placement, spot-pool
preference and priority from the same scheduler the training plane
uses.

Status contract: ``status.targetReplicas`` is the autoscaler's durable
decision (level-triggered provisioning reconciles toward it across
controller restarts); per-replica phases land in
``status.replicaStatuses``; the READY endpoint set is published on the
``ANNOTATION_ENDPOINTS`` metadata annotation — the downward-style feed
the router consumes (docs/serving.md).

Port of `kubeflow_tpu/control/jaxservice/types.py` on GPUs, mapped as
the JAXJob's types map it: ``spec.gpu = {product, nodePool,
gpusPerWorker}`` takes the place of ``spec.tpu = {accelerator,
topology, chipsPerWorker}``, ``validate`` applies the JAXJob's GPU rule
(``gpusPerWorker`` a positive int, ``nodePool`` a node-pool name) where
the JAX package checks the slice topology, and ``revision_hash`` hashes
``gpu`` where it hashes ``tpu``. The group, kind, labels, annotations,
env names and every other default and rule are the JAX package's.
"""

from __future__ import annotations

import hashlib
import json

from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.control.scheduler import SCHEDULER_NAME
from kubeflow_tpu_torch.control.jaxjob.types import validate_gpu

# The ONE spelling of the controller -> router endpoints wire contract
# lives with its consumer (serving/router.py, the dist.py pattern);
# re-exported here for the control plane.
from kubeflow_tpu_torch.serving.router import (  # noqa: F401
    ANNOTATION_ENDPOINTS,
    BAND_DEFAULT,
    BAND_RANK,
    STATE_ACTIVE,
    STATE_CORDONED,
)

GROUP = "kubeflow.org"
VERSION = "v1alpha1"
API_VERSION = f"{GROUP}/{VERSION}"
KIND = "JAXService"

# Condition types (the JAXJob Created/Running/Failed shape, serving
# vocabulary: a service is Ready, never Succeeded)
COND_CREATED = "Created"
COND_READY = "Ready"
COND_DEGRADED = "Degraded"

# Pod labels (the jaxjob.kubeflow.org/job-name analogue)
LABEL_SERVICE_NAME = "jaxservice.kubeflow.org/service-name"
LABEL_REPLICA_INDEX = "jaxservice.kubeflow.org/replica-index"

# Revision identity on replica PODS: the content-addressed hash of the
# pod-shaping spec fields (``revision_hash``). The rollout state machine
# keys every decision off this label — which replicas are old, which are
# the surge canary — and the router stamps it on request metrics so
# canary-vs-baseline burn is measurable (docs/serving.md, "Safe
# rollouts").
LABEL_REVISION = "jaxservice.kubeflow.org/revision"

# Scale-down drain marker on replica PODS: a cordoned replica is
# published to the router as state=cordoned (no new work), the
# controller deletes it only once the router reports zero in-flight
# tokens for it — the drain state machine in docs/serving.md.
ANNOTATION_CORDON = "jaxservice.kubeflow.org/cordon"

# Durable drain deadline on cordoned replica PODS: the absolute
# controller-clock time after which a signal-less drain may delete the
# pod. Persisted so a controller restart RESUMES the countdown instead
# of restarting it (the in-memory timer of PR 8 only ever drained
# longer; this makes the grace exact across restarts).
ANNOTATION_DRAIN_DEADLINE = "jaxservice.kubeflow.org/drain-deadline"

# One-shot replica floor on the JAXSERVICE, written by the alert-driven
# remediation engine (obs/remediate.py, KVPagesExhausted -> scale up).
# The autoscaler consumes and CLEARS it inside its normal reconcile, so
# the move flows through the record-first durable target write and the
# max-replica clamp like any other scale decision.
ANNOTATION_SCALE_NUDGE = "jaxservice.kubeflow.org/scale-nudge"

# Env injected into replica containers
ENV_SERVICE = "JAXSERVICE_NAME"
ENV_REPLICA = "JAXSERVICE_REPLICA"
ENV_NAMESPACE = "JAXSERVICE_NAMESPACE"

DEFAULT_PORT = 8500

# Autoscaling defaults: targets are PER-REPLICA capacities; the
# stabilization windows are the hysteresis (a demand spike shorter than
# the up window scales nothing, a lull shorter than the down window
# keeps every replica — docs/serving.md).
DEFAULT_TARGET_QUEUE_DEPTH = 8
DEFAULT_TARGET_TOKENS_PER_SEC = 2000.0
DEFAULT_UP_STABILIZATION_S = 5.0
DEFAULT_DOWN_STABILIZATION_S = 30.0

# Scale-down drain grace when NO signal plane is wired to the
# controller (the production default): a Running cordoned replica may
# still hold multi-minute decodes the controller cannot observe, so it
# is held this long after cordon before deletion. With signals wired,
# the router's per-replica in-flight gauge gates the delete instead.
DEFAULT_DRAIN_SECONDS = 60.0

# Rollout defaults: one surge replica at a time, never dip below the
# target (maxUnavailable=0), a 10% -> 50% -> 100% canary ladder, and a
# 60 s analysis window per step with automatic rollback armed.
DEFAULT_MAX_SURGE = 1
DEFAULT_MAX_UNAVAILABLE = 0
DEFAULT_CANARY_STEPS = (0.1, 0.5, 1.0)
DEFAULT_ANALYSIS_WINDOW_S = 60.0

# Rollout phases recorded in status.revisions.phase — the rollout state
# machine (docs/serving.md, "Safe rollouts"). Idle means current ==
# target (no rollout in flight).
PHASE_IDLE = "Idle"
PHASE_SURGE = "Surge"
PHASE_ANALYZE = "Analyze"
PHASE_PROMOTE = "Promote"
PHASE_ROLLBACK = "Rollback"
ROLLOUT_PHASES = (PHASE_IDLE, PHASE_SURGE, PHASE_ANALYZE,
                  PHASE_PROMOTE, PHASE_ROLLBACK)

# jaxservice_rollouts_total outcomes, pre-registered at 0 on first
# sight (the first-failure tripwire discipline): rate()/increase() must
# see a zero sample before the first aborted rollout.
ROLLOUT_OUTCOMES = ("promoted", "rolled_back", "aborted")


def drain_seconds(spec: dict) -> float:
    return spec.get("drainSeconds", DEFAULT_DRAIN_SECONDS)


def replica_name(service_name: str, index: int) -> str:
    return f"{service_name}-replica-{index}"


def replica_index(pod_name: str) -> int:
    """Replica slot from a pod name; unparseable names sort AFTER every
    real replica (the jaxjob worker_index discipline — a malformed
    leftover must never alias slot 0)."""
    import sys

    try:
        return int(pod_name.rsplit("-", 1)[1])
    except (IndexError, ValueError):
        return sys.maxsize


def replicas_spec(spec: dict) -> dict:
    """spec.replicas with defaults: {min, max}."""
    r = spec.get("replicas")
    if isinstance(r, int):  # shorthand: fixed size, autoscaler clamped
        return {"min": r, "max": r}
    r = r if isinstance(r, dict) else {}
    mn = r.get("min", 1)
    return {"min": mn, "max": r.get("max", mn)}


def autoscaling_spec(spec: dict) -> dict:
    a = spec.get("autoscaling")
    a = a if isinstance(a, dict) else {}
    return {
        "targetQueueDepth": a.get("targetQueueDepth",
                                  DEFAULT_TARGET_QUEUE_DEPTH),
        "targetTokensPerSec": a.get("targetTokensPerSec",
                                    DEFAULT_TARGET_TOKENS_PER_SEC),
        "scaleUpStabilizationSeconds": a.get(
            "scaleUpStabilizationSeconds", DEFAULT_UP_STABILIZATION_S),
        "scaleDownStabilizationSeconds": a.get(
            "scaleDownStabilizationSeconds", DEFAULT_DOWN_STABILIZATION_S),
    }


def resilience_spec(spec: dict) -> dict:
    """spec.resilience with defaults — the namespace-level request
    resilience knobs the router frontend adopts through the endpoints
    watch (``RouterFrontend.apply_spec``):

    - ``defaultBand``: criticality band for requests without an
      x-request-band header (the ROADMAP #3 multi-tenancy bridge —
      a tenant's JAXService declares how sheddable its traffic is);
    - ``deadlineSeconds``: deadline for requests without an
      x-request-deadline-s header (0 = no default deadline);
    - ``hedge``: whether the frontend may race a second replica leg;
    - ``maxInflight``: per-REPLICA concurrent-request admission cap
      (0 = unbounded), threaded into the model-server command line so
      an overloaded replica 429s with Retry-After instead of queueing
      unboundedly.
    """
    r = spec.get("resilience")
    r = r if isinstance(r, dict) else {}
    return {
        "defaultBand": r.get("defaultBand", BAND_DEFAULT),
        "deadlineSeconds": r.get("deadlineSeconds", 0.0),
        "hedge": bool(r.get("hedge", True)),
        "maxInflight": r.get("maxInflight", 0),
    }


def rollout_spec(spec: dict) -> dict:
    """spec.rollout with defaults — the staged-replacement knobs:

    - ``maxSurge``: extra replicas (above target) the rollout may run
      while old and new revisions coexist;
    - ``maxUnavailable``: how far below target the fleet may dip while
      old replicas drain (0 = surge-only, capacity never drops);
    - ``canarySteps``: the canary weight ladder — the fraction of
      traffic the router sends to the NEW revision at each step,
      strictly increasing, ending at full weight;
    - ``analysisWindowSeconds``: how long each step must look healthy
      (canary error rate and latency quantile vs baseline) before the
      rollout advances;
    - ``autoRollback``: whether a failed analysis rolls the fleet back
      to the previous revision automatically.
    """
    r = spec.get("rollout")
    r = r if isinstance(r, dict) else {}
    steps = r.get("canarySteps")
    if not isinstance(steps, (list, tuple)) or not steps:
        steps = list(DEFAULT_CANARY_STEPS)
    return {
        "maxSurge": r.get("maxSurge", DEFAULT_MAX_SURGE),
        "maxUnavailable": r.get("maxUnavailable", DEFAULT_MAX_UNAVAILABLE),
        "canarySteps": list(steps),
        "analysisWindowSeconds": r.get("analysisWindowSeconds",
                                       DEFAULT_ANALYSIS_WINDOW_S),
        "autoRollback": bool(r.get("autoRollback", True)),
    }


def revision_hash(spec: dict) -> str:
    """Content-addressed revision of the POD-SHAPING spec fields.

    Two specs that generate byte-identical replica pods hash the same
    (editing ``spec.replicas`` or the autoscaling windows is NOT a
    rollout); any change that alters the pod — model flags, port, GPU
    request, scheduler opt-in, the inflight cap threaded into the server
    command line, a custom template — mints a new revision. The hash is
    a valid k8s label value (``v`` + 10 hex chars).
    """
    shaping = {
        "model": model_spec(spec),
        "image": spec.get("image", ""),
        "port": spec.get("port", DEFAULT_PORT),
        "gpu": spec.get("gpu") or {},
        "priority": spec.get("priority", 0),
        "schedulerName": spec.get("schedulerName", ""),
        "maxInflight": resilience_spec(spec)["maxInflight"],
        "template": spec.get("template") or {},
    }
    blob = json.dumps(shaping, sort_keys=True, separators=(",", ":"))
    return "v" + hashlib.sha256(blob.encode("utf-8")).hexdigest()[:10]


def revisions_status(svc: dict) -> dict:
    """status.revisions with defaults: the durable rollout record.

    ``current`` is the revision the stable fleet runs, ``target`` the
    revision a rollout is moving toward (== current when idle),
    ``previous`` the rollback destination, ``phase`` the state-machine
    position, ``step`` the canary-ladder index, and ``stepStartedAt``
    the controller-clock time the step's analysis window opened. The
    record lands in status BEFORE any pod is touched (record-FIRST), so
    an interrupted rollout re-enters idempotently.

    ``snapshots`` maps revision -> the spec that minted it, so rollback
    can regenerate previous-revision pods after the live spec has moved
    on. ``aborted`` pins the revision a failed analysis rolled back
    from: the controller will not re-attempt it until the spec changes
    again (sticky abort). ``held`` marks a failed analysis frozen in
    place because ``autoRollback`` is off.
    """
    rev = (svc.get("status") or {}).get("revisions")
    rev = rev if isinstance(rev, dict) else {}
    snaps = rev.get("snapshots")
    return {
        "current": rev.get("current", ""),
        "target": rev.get("target", ""),
        "previous": rev.get("previous", ""),
        "phase": rev.get("phase", PHASE_IDLE),
        "step": rev.get("step", 0),
        "stepStartedAt": rev.get("stepStartedAt", 0.0),
        "snapshots": snaps if isinstance(snaps, dict) else {},
        "aborted": rev.get("aborted", ""),
        "held": bool(rev.get("held", False)),
    }


def model_spec(spec: dict) -> dict:
    m = spec.get("model")
    m = m if isinstance(m, dict) else {}
    return {
        "name": m.get("name", "model"),
        "ref": m.get("ref", ""),           # zoo model[@checkpoint_dir]
        "promptLen": m.get("promptLen", 128),
        "maxNewTokens": m.get("maxNewTokens", 32),
        "decodeSlots": m.get("decodeSlots", 8),
        "continuousBatching": bool(m.get("continuousBatching", True)),
        "paramDtype": m.get("paramDtype", ""),
    }


def new_jaxservice(
    name: str,
    namespace: str = "default",
    *,
    model: str = "gpt-125m",
    model_name: str = "chat",
    min_replicas: int = 1,
    max_replicas: int | None = None,
    port: int = DEFAULT_PORT,
    product: str | None = None,
    node_pool: str | None = None,
    gpus_per_replica: int = 1,
    priority: int = 0,
    gang_schedule: bool = False,
    target_queue_depth: int = DEFAULT_TARGET_QUEUE_DEPTH,
    target_tokens_per_sec: float = DEFAULT_TARGET_TOKENS_PER_SEC,
    up_stabilization_s: float = DEFAULT_UP_STABILIZATION_S,
    down_stabilization_s: float = DEFAULT_DOWN_STABILIZATION_S,
) -> dict:
    """Convenience constructor (the new_jaxjob analogue). ``product``
    (GKE's GPU label value, e.g. ``nvidia-h100-80gb``) asks for replicas
    of ``gpus_per_replica`` GPUs each (default 1: the port's model server
    runs on one card), ``node_pool`` pins them to one GKE node pool."""
    spec: dict = {
        "model": {"name": model_name, "ref": model},
        "replicas": {"min": min_replicas,
                     "max": max_replicas if max_replicas is not None
                     else min_replicas},
        "port": port,
        "autoscaling": {
            "targetQueueDepth": target_queue_depth,
            "targetTokensPerSec": target_tokens_per_sec,
            "scaleUpStabilizationSeconds": up_stabilization_s,
            "scaleDownStabilizationSeconds": down_stabilization_s,
        },
    }
    if priority:
        spec["priority"] = priority
    if gang_schedule:
        spec["schedulerName"] = SCHEDULER_NAME
    if product:
        spec["gpu"] = {
            "product": product,
            "nodePool": node_pool or "",
            "gpusPerWorker": gpus_per_replica,
        }
    return ob.new_object(API_VERSION, KIND, name, namespace, spec=spec)


def _posint(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool) and v >= 1


def _posnum(v) -> bool:
    return (isinstance(v, (int, float)) and not isinstance(v, bool)
            and v > 0)


def validate(svc: dict) -> list[str]:
    """Spec validation; problems become Degraded-condition reasons."""
    errs: list[str] = []
    spec = svc.get("spec") or {}
    model = model_spec(spec)
    if not model["ref"] or not isinstance(model["ref"], str):
        errs.append("spec.model.ref must name a zoo model "
                    "(e.g. 'gpt-125m' or 'gpt-125m@/ckpt/dir')")
    for k in ("promptLen", "maxNewTokens", "decodeSlots"):
        if not _posint(model[k]):
            errs.append(f"spec.model.{k} must be a positive int, "
                        f"got {model[k]!r}")
    reps = replicas_spec(spec)
    mn, mx = reps["min"], reps["max"]
    if not _posint(mn):
        errs.append(f"spec.replicas.min must be a positive int, got {mn!r}")
    if not _posint(mx):
        errs.append(f"spec.replicas.max must be a positive int, got {mx!r}")
    if _posint(mn) and _posint(mx) and mn > mx:
        errs.append(f"spec.replicas.min {mn} > max {mx}")
    port = spec.get("port", DEFAULT_PORT)
    if not isinstance(port, int) or not (0 < port < 65536):
        errs.append(f"spec.port invalid: {port!r}")
    prio = spec.get("priority", 0)
    if not isinstance(prio, int) or isinstance(prio, bool):
        errs.append(f"spec.priority must be an int, got {prio!r}")
    auto = autoscaling_spec(spec)
    if not _posint(auto["targetQueueDepth"]):
        errs.append("spec.autoscaling.targetQueueDepth must be a "
                    f"positive int, got {auto['targetQueueDepth']!r}")
    if not _posnum(auto["targetTokensPerSec"]):
        errs.append("spec.autoscaling.targetTokensPerSec must be a "
                    f"positive number, got {auto['targetTokensPerSec']!r}")
    for k in ("scaleUpStabilizationSeconds",
              "scaleDownStabilizationSeconds"):
        v = auto[k]
        if not (isinstance(v, (int, float)) and not isinstance(v, bool)
                and v >= 0):
            errs.append(f"spec.autoscaling.{k} must be a non-negative "
                        f"number, got {v!r}")
    drain = drain_seconds(spec)
    if not (isinstance(drain, (int, float)) and not isinstance(drain, bool)
            and drain >= 0):
        errs.append("spec.drainSeconds must be a non-negative number, "
                    f"got {drain!r}")
    res = resilience_spec(spec)
    if res["defaultBand"] not in BAND_RANK:
        errs.append("spec.resilience.defaultBand must be one of "
                    f"{sorted(BAND_RANK)}, got {res['defaultBand']!r}")
    dl = res["deadlineSeconds"]
    if not (isinstance(dl, (int, float)) and not isinstance(dl, bool)
            and dl >= 0):
        errs.append("spec.resilience.deadlineSeconds must be a "
                    f"non-negative number, got {dl!r}")
    mi = res["maxInflight"]
    if not (isinstance(mi, int) and not isinstance(mi, bool) and mi >= 0):
        errs.append("spec.resilience.maxInflight must be a non-negative "
                    f"int, got {mi!r}")
    roll = rollout_spec(spec)
    if not _posint(roll["maxSurge"]):
        errs.append("spec.rollout.maxSurge must be a positive int, "
                    f"got {roll['maxSurge']!r}")
    mu = roll["maxUnavailable"]
    if not (isinstance(mu, int) and not isinstance(mu, bool) and mu >= 0):
        errs.append("spec.rollout.maxUnavailable must be a non-negative "
                    f"int, got {mu!r}")
    steps = roll["canarySteps"]
    bad_step = any(
        not (isinstance(s, (int, float)) and not isinstance(s, bool)
             and 0 < s <= 1)
        for s in steps)
    if bad_step:
        errs.append("spec.rollout.canarySteps must be fractions in "
                    f"(0, 1], got {steps!r}")
    elif list(steps) != sorted(set(steps)):
        errs.append("spec.rollout.canarySteps must be strictly "
                    f"increasing, got {steps!r}")
    elif steps[-1] != 1:
        errs.append("spec.rollout.canarySteps must end at 1.0 (full "
                    f"weight), got {steps!r}")
    if not _posnum(roll["analysisWindowSeconds"]):
        errs.append("spec.rollout.analysisWindowSeconds must be a "
                    "positive number, got "
                    f"{roll['analysisWindowSeconds']!r}")
    # the JAXJob's GPU rule, where the JAX package checks spec.tpu's
    # topology
    errs += validate_gpu(spec)
    return errs


def crd_manifest() -> dict:
    """The CustomResourceDefinition applied by tpctl."""
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"jaxservices.{GROUP}"},
        "spec": {
            "group": GROUP,
            "names": {
                "kind": KIND,
                "listKind": "JAXServiceList",
                "plural": "jaxservices",
                "singular": "jaxservice",
                "shortNames": ["jsvc"],
            },
            "scope": "Namespaced",
            "versions": [
                {
                    "name": VERSION,
                    "served": True,
                    "storage": True,
                    "subresources": {"status": {}},
                    "schema": {
                        "openAPIV3Schema": {
                            "type": "object",
                            "x-kubernetes-preserve-unknown-fields": True,
                        }
                    },
                }
            ],
        },
    }
