"""JAXJob CRD: API types, defaults, validation — on GPUs.

Port of `kubeflow_tpu/control/jaxjob/types.py`. The CRD keeps its
group, kind and version (`kubeflow.org/v1alpha1`, `JAXJob`), its
labels, annotations and the `JAXJOB_*` env contract; what changes is
what names the accelerator. The reference platform's TFJob spec shape
(replicaSpecs with per-replica pod templates —
tf-controller-examples/tf-cnn/create_job_specs.py:125-191) collapses to
one homogeneous worker set: the gradient all-reduce replaces the
parameter servers, and MASTER/WORKER reduces to process_id 0. Each
worker pod claims ``nvidia.com/gpu`` (create_job_specs.py:168 set the
same limit on TFJob pods) and runs the port's launcher, which starts one
process per GPU of its pod (`--nproc-per-node`, default the CUDA device
count), so ``JAXJOB_NUM_PROCESSES`` stays the pod count.

Condition types follow the Katib/TFJob contract that E2E tests poll
(testing/katib_studyjob_test.py:128-194 waits on
status.conditions[].type == Running): Created, Running, Restarting,
Succeeded, Failed.
"""

from __future__ import annotations

from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.control.scheduler import SCHEDULER_NAME
from kubeflow_tpu_torch.control.scheduler.topology import normalize_pool

GROUP = "kubeflow.org"
VERSION = "v1alpha1"
API_VERSION = f"{GROUP}/{VERSION}"
KIND = "JAXJob"

# Condition types (katib/tf-operator contract)
COND_CREATED = "Created"
COND_RUNNING = "Running"
COND_RESTARTING = "Restarting"
COND_SUCCEEDED = "Succeeded"
COND_FAILED = "Failed"
# Elastic addition (not part of the katib polling contract, which only
# reads the five above): True while the gang runs below its full size —
# set on shrink, cleared when grow-back restores every worker.
COND_RESIZING = "Resizing"

# Pod labels (the `notebook-name` analogue, notebook_controller.go:541-563)
LABEL_JOB_NAME = "jaxjob.kubeflow.org/job-name"
LABEL_REPLICA_INDEX = "jaxjob.kubeflow.org/replica-index"
LABEL_SLICE_INDEX = "jaxjob.kubeflow.org/slice-index"

# Pod incarnation marker: the gang epoch (status.restarts +
# status.preemptions at creation time). A pod whose epoch is older than
# the job's current epoch belongs to a TORN-DOWN incarnation — the
# controller condemns it (deletes, excludes from status derivation)
# instead of re-reading its phase as a fresh failure. This is what
# makes gang restart resumable across transient apiserver errors
# without double-counting the restart budget.
ANNOTATION_EPOCH = "jaxjob.kubeflow.org/epoch"

# Elastic world stamp: the serialized parallel.dist.WorldSpec naming the
# CURRENT world's ordered members (rank = position, coordinator =
# members[0]). The controller re-stamps every live pod on a resize; the
# downward API projects the annotation into the pod (generate_pod mounts
# it at WORLD_FILE_PATH) so the worker-side elastic coordinator
# (runtime/elastic.py) sees shrink/grow without a kube client.
ANNOTATION_WORLD = "jaxjob.kubeflow.org/world"
WORLD_FILE_PATH = "/etc/jaxjob/world"

# Elastic resize policies (spec.elastic.resizePolicy)
RESIZE_RESIZE = "Resize"
RESIZE_RESTART = "Restart"
# Slice-failure policies (spec.elastic.slicePolicy, multislice jobs):
# worker-granular Resize cannot shrink a sliceCount > 1 gang (the dcn
# mesh axis moves in whole slices), so slice elasticity is its own
# knob. Shrink: losing any worker of a slice condemns exactly that
# slice's pods and the world shrinks to the surviving slices (gen bump,
# dcn axis shrinks, batchPolicy applies); below minSlices the normal
# restart path takes over. Restart (default): any loss restarts the
# whole gang — the pre-slice semantics.
SLICE_SHRINK = "Shrink"
SLICE_RESTART = "Restart"
# Global-batch policies across a resize (spec.elastic.batchPolicy):
# Preserve keeps the global batch (the loss curve is continuous);
# Scale shrinks/grows the global batch with the world. Values are the
# ENV_BATCH_POLICY wire contract, re-exported below from dist (the ONE
# spelling the worker-side coordinator compares against).
# Resizes never burn maxRestarts/maxPreemptions, but a generous ceiling
# bounds a pathological shrink/grow flap the way maxPreemptions bounds
# an always-75 loop; beyond it the controller falls back to the normal
# preemption-restart path (whose own budget then applies).
DEFAULT_MAX_RESIZES = 100

# Env contract consumed by kubeflow_tpu_torch.parallel.dist
# .initialize_from_env. Re-exported from dist (ONE authoritative
# spelling of the wire contract); the import is torch-free —
# parallel/__init__ is lazy so the control plane can import dist.
from kubeflow_tpu_torch.parallel.dist import (  # noqa: E402
    BATCH_PRESERVE,
    BATCH_SCALE,
    ENV_BATCH_POLICY,
    ENV_COORD,
    ENV_NAME,
    ENV_NAMESPACE,
    ENV_NPROC,
    ENV_NUM_SLICES,
    ENV_PID,
    ENV_SLICE_ID,
    ENV_WORLD_FILE,
)

# GKE GPU scheduling surface (create_job_specs.py:165-170 sets
# resources.limits["nvidia.com/gpu"]). The JAX package's counterparts
# are its TPU resource, accelerator and topology keys; here the product
# label (GKE's spelling, e.g. "nvidia-h100-80gb") and the node pool,
# whose nodes share one fabric, name where a gang's slice runs.
RESOURCE_GPU = "nvidia.com/gpu"
NODESELECTOR_ACCEL = "cloud.google.com/gke-accelerator"
NODESELECTOR_POOL = "cloud.google.com/gke-nodepool"
# The port's worker image and command (README.md, "The control plane")
DEFAULT_IMAGE = "kubeflow-tpu-torch/torchrt:latest"
DEFAULT_COMMAND = ("python", "-m", "kubeflow_tpu_torch.runtime.launcher")
# The JAXService replicas' default image (the JAX package's
# kubeflow-tpu/platform:latest); their command is the port's server
SERVING_IMAGE = "kubeflow-tpu-torch/platform:latest"
# The Notebook servers' default image (the JAX package's
# kubeflow-tpu/jax-notebook images): Jupyter over the port and CUDA
NOTEBOOK_IMAGE = "kubeflow-tpu-torch/torch-notebook:latest"

DEFAULT_COORDINATOR_PORT = 8476
RESTART_GANG = "GangOnFailure"
RESTART_NEVER = "Never"

# The launcher's graceful-preemption exit status (runtime/preemption.py
# EX_TEMPFAIL): the worker checkpointed and asked for a gang restart.
# Preemptions are counted in status.preemptions and do NOT consume the
# maxRestarts crash budget — node maintenance can evict a gang many
# times without the job being at fault.
EXIT_PREEMPTED = 75
# GKE taints nodes (GPU nodes too) ahead of maintenance/preemption;
# treat as unhealthy
TAINT_IMPENDING_TERMINATION = "cloud.google.com/impending-node-termination"


def gang_size(spec: dict) -> int:
    """Total worker pods = replicas-per-slice x sliceCount. The whole
    multislice set is ONE gang and ONE torch.distributed world; the
    mesh's `dcn` axis spans the slice boundary (parallel/mesh.py)."""
    return spec.get("replicas", 1) * spec.get("sliceCount", 1)


def elastic_spec(spec: dict) -> dict | None:
    """spec.elastic with defaults applied, or None when absent."""
    el = spec.get("elastic")
    if not isinstance(el, dict):
        return None
    return {
        "minReplicas": el.get("minReplicas", 1),
        "maxReplicas": el.get("maxReplicas", gang_size(spec)),
        "resizePolicy": el.get("resizePolicy", RESIZE_RESIZE),
        "batchPolicy": el.get("batchPolicy", BATCH_PRESERVE),
        "maxResizes": el.get("maxResizes", DEFAULT_MAX_RESIZES),
        "slicePolicy": el.get("slicePolicy", SLICE_RESTART),
        "minSlices": el.get("minSlices", 1),
    }


def is_slice_elastic(spec: dict) -> bool:
    """True when slice loss shrinks the world instead of restarting the
    gang: a multislice job with spec.elastic.slicePolicy Shrink."""
    el = elastic_spec(spec)
    return bool(el and spec.get("sliceCount", 1) > 1
                and el["slicePolicy"] == SLICE_SHRINK)


def is_elastic(spec: dict) -> bool:
    """True when the controller should resize instead of restart.
    Single-slice jobs: spec.elastic with resizePolicy Resize (Restart
    keeps restart semantics while still opting into spot-pool
    scheduling). Multislice jobs resize at SLICE granularity only —
    slicePolicy Shrink (worker-granular Resize cannot move the dcn
    axis)."""
    el = elastic_spec(spec)
    if not el:
        return False
    if spec.get("sliceCount", 1) > 1:
        return el["slicePolicy"] == SLICE_SHRINK
    return el["resizePolicy"] == RESIZE_RESIZE


def elastic_floor(spec: dict) -> int:
    """The smallest world (in WORKERS) a shrink may reach: minReplicas
    for worker-granular elasticity, minSlices x replicas for
    slice-granular (slices shrink whole)."""
    el = elastic_spec(spec)
    if el is None:
        return gang_size(spec)
    if is_slice_elastic(spec):
        return el["minSlices"] * spec.get("replicas", 1)
    return el["minReplicas"]


def new_jaxjob(
    name: str,
    namespace: str = "default",
    *,
    replicas: int = 1,
    slice_count: int = 1,
    image: str = DEFAULT_IMAGE,
    command: list[str] | None = None,
    product: str | None = None,
    node_pool: str | None = None,
    gpus_per_worker: int = 8,
    restart_policy: str = RESTART_GANG,
    max_restarts: int = 3,
    priority: int = 0,
    gang_schedule: bool = False,
    elastic_min: int | None = None,
    resize_policy: str = RESIZE_RESIZE,
    batch_policy: str = BATCH_PRESERVE,
    slice_policy: str | None = None,
    min_slices: int | None = None,
) -> dict:
    """Convenience constructor (the create_job_specs.py analogue).

    ``replicas`` is the worker count PER SLICE; ``slice_count`` > 1 asks
    for a multislice deployment (the reference's closest analogue is the
    multi-replica TFJob topology, create_job_specs.py:125-191 — but DCN
    replaces the PS/gRPC fabric).

    ``product`` (GKE's GPU label value, e.g. ``nvidia-h100-80gb``) asks
    for GPU workers of ``gpus_per_worker`` GPUs each (default 8: one
    worker pod per 8-GPU node, which the launcher runs as 8 ranks);
    ``node_pool`` pins the gang to one GKE node pool.

    ``gang_schedule=True`` opts the job into the GPU gang scheduler
    (control/scheduler): generated pods get spec.schedulerName plus a
    scheduling gate, and are only run once the whole gang is bound
    all-or-nothing. ``priority`` orders admission; a higher-priority
    gang may preempt a running lower-priority one.

    ``elastic_min`` makes the job ELASTIC (docs/elastic.md): on node
    loss/preemption the gang shrinks to the survivors (down to this
    floor) instead of restarting, and grows back when capacity returns;
    with gang_schedule, the scheduler may also admit the gang partially
    (>= elastic_min) and prefers spot-pool nodes for its workers."""
    spec: dict = {
        "replicas": replicas,
        "template": {
            "metadata": {"labels": {}},
            "spec": {
                "containers": [
                    {
                        "name": "jax",
                        "image": image,
                        "command": command or list(DEFAULT_COMMAND),
                    }
                ],
                "restartPolicy": "Never",
            },
        },
        "coordinatorPort": DEFAULT_COORDINATOR_PORT,
        "restartPolicy": restart_policy,
        "maxRestarts": max_restarts,
    }
    if slice_count > 1:
        spec["sliceCount"] = slice_count
    if priority:
        spec["priority"] = priority
    if elastic_min is not None or slice_policy is not None:
        el: dict = {}
        if elastic_min is not None:
            el["minReplicas"] = elastic_min
            el["resizePolicy"] = resize_policy
        el["batchPolicy"] = batch_policy
        if slice_policy is not None:
            el["slicePolicy"] = slice_policy
        if min_slices is not None:
            el["minSlices"] = min_slices
        spec["elastic"] = el
    if gang_schedule:
        spec["schedulerName"] = SCHEDULER_NAME
    if product:
        spec["gpu"] = {
            "product": product,
            "nodePool": node_pool or "",
            "gpusPerWorker": gpus_per_worker,
        }
    return ob.new_object(API_VERSION, KIND, name, namespace, spec=spec)


def validate(job: dict) -> list[str]:
    """Spec validation; returned problems become Failed-condition reasons."""
    errs = []
    spec = job.get("spec") or {}
    replicas = spec.get("replicas", 1)
    if not isinstance(replicas, int) or replicas < 1:
        errs.append(f"spec.replicas must be a positive int, got {replicas!r}")
    slices = spec.get("sliceCount", 1)
    if not isinstance(slices, int) or slices < 1:
        errs.append(f"spec.sliceCount must be a positive int, got {slices!r}")
    tmpl = spec.get("template") or {}
    containers = (tmpl.get("spec") or {}).get("containers") or []
    if not containers:
        errs.append("spec.template.spec.containers must have at least one container")
    rp = spec.get("restartPolicy", RESTART_GANG)
    if rp not in (RESTART_GANG, RESTART_NEVER):
        errs.append(f"spec.restartPolicy must be {RESTART_GANG} or {RESTART_NEVER}")
    port = spec.get("coordinatorPort", DEFAULT_COORDINATOR_PORT)
    if not isinstance(port, int) or not (0 < port < 65536):
        errs.append(f"spec.coordinatorPort invalid: {port!r}")
    prio = spec.get("priority", 0)
    if not isinstance(prio, int) or isinstance(prio, bool):
        errs.append(f"spec.priority must be an int, got {prio!r}")
    errs += _validate_elastic(spec)
    errs += validate_gpu(spec)
    return errs


def _validate_elastic(spec: dict) -> list[str]:
    raw = spec.get("elastic")
    if raw is None:
        return []
    if not isinstance(raw, dict):
        return [f"spec.elastic must be an object, got {raw!r}"]
    errs = []
    el = elastic_spec(spec)
    total = gang_size(spec)
    mn, mx = el["minReplicas"], el["maxReplicas"]

    def _posint(v) -> bool:
        return isinstance(v, int) and not isinstance(v, bool) and v >= 1

    if not _posint(mn):
        errs.append(f"spec.elastic.minReplicas must be a positive int, "
                    f"got {mn!r}")
    if not _posint(mx):
        errs.append(f"spec.elastic.maxReplicas must be a positive int, "
                    f"got {mx!r}")
    if _posint(mn) and _posint(mx):
        if mn > mx:
            errs.append(f"spec.elastic.minReplicas {mn} > maxReplicas {mx}")
        if mx != total:
            # the controller provisions the full gang and shrinks within
            # it; a maxReplicas above the pod set could never be reached
            # and one below it would strand provisioned workers
            errs.append(
                f"spec.elastic.maxReplicas {mx} must equal replicas x "
                f"sliceCount = {total} (the provisioned gang)")
    if el["resizePolicy"] not in (RESIZE_RESIZE, RESIZE_RESTART):
        errs.append(f"spec.elastic.resizePolicy must be {RESIZE_RESIZE} "
                    f"or {RESIZE_RESTART}")
    if el["batchPolicy"] not in (BATCH_PRESERVE, BATCH_SCALE):
        errs.append(f"spec.elastic.batchPolicy must be {BATCH_PRESERVE} "
                    f"or {BATCH_SCALE}")
    if not _posint(el["maxResizes"]):
        errs.append(f"spec.elastic.maxResizes must be a positive int, "
                    f"got {el['maxResizes']!r}")
    multislice = spec.get("sliceCount", 1) > 1
    if el["slicePolicy"] not in (SLICE_SHRINK, SLICE_RESTART):
        errs.append(f"spec.elastic.slicePolicy must be {SLICE_SHRINK} "
                    f"or {SLICE_RESTART}")
    if not _posint(el["minSlices"]):
        errs.append(f"spec.elastic.minSlices must be a positive int, "
                    f"got {el['minSlices']!r}")
    elif el["minSlices"] > spec.get("sliceCount", 1):
        errs.append(f"spec.elastic.minSlices {el['minSlices']} > "
                    f"sliceCount {spec.get('sliceCount', 1)}")
    if (multislice and el["resizePolicy"] == RESIZE_RESIZE
            and "slicePolicy" not in raw):
        # the pre-slicePolicy shape: worker-granular Resize cannot
        # shrink a multislice gang (the dcn axis moves in whole
        # slices). Point at the migration instead of silently changing
        # what the old spelling meant.
        errs.append(
            "spec.elastic on a multislice job resizes at SLICE "
            f"granularity: add elastic.slicePolicy: {SLICE_SHRINK} to "
            "shrink to surviving slices on slice loss (or "
            f"{SLICE_RESTART} to keep whole-gang restarts); "
            "worker-granular resizePolicy Resize alone is not "
            "supported with sliceCount > 1")
    if is_elastic(spec):
        argv = _worker_argv(spec)
        if "--" in argv and "--config" not in argv:
            # only the launcher's built-in-trainer path wires the
            # ElasticCoordinator; a user payload after "--" would never
            # see a resize — its world file updates unread while the
            # controller shrinks the gang around it
            errs.append(
                "spec.elastic with in-place resize (resizePolicy "
                f"{RESIZE_RESIZE} / slicePolicy {SLICE_SHRINK}) "
                "requires the built-in trainer (launcher --config): a "
                "user command after '--' cannot follow a resize (use "
                f"{RESIZE_RESTART} for spot tolerance without in-place "
                "resize)")
    return errs


def _worker_argv(spec: dict) -> list:
    """The worker container's effective argv (command + args)."""
    tmpl_spec = (spec.get("template") or {}).get("spec") or {}
    c = (tmpl_spec.get("containers") or [{}])[0]
    if not isinstance(c, dict):
        return []
    return list(c.get("command") or []) + list(c.get("args") or [])


def validate_gpu(spec: dict) -> list[str]:
    """The GPU request: gpusPerWorker must be a positive int. This is
    where the JAX package checks that replicas x chipsPerWorker tile the
    slice topology; a GPU node pool has no shape to tile (its nodes
    share one fabric, whatever their count), so only the per-worker
    claim and the pool's name are checked."""
    gpu = spec.get("gpu")
    if gpu is None:
        return []
    if not isinstance(gpu, dict):
        return [f"spec.gpu must be an object, got {gpu!r}"]
    errs = []
    n = gpu.get("gpusPerWorker")
    if not isinstance(n, int) or isinstance(n, bool) or n < 1:
        errs.append(f"spec.gpu.gpusPerWorker must be a positive int, "
                    f"got {n!r}")
    pool = gpu.get("nodePool")
    if pool:
        try:
            # the ONE normaliser of the pool key (scheduler/topology.py)
            normalize_pool(pool)
        except (ValueError, AttributeError):
            errs.append(f"spec.gpu.nodePool {pool!r} is not a node-pool "
                        f"name")
    return errs


def crd_manifest() -> dict:
    """The CustomResourceDefinition applied by tpctl."""
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"jaxjobs.{GROUP}"},
        "spec": {
            "group": GROUP,
            "names": {
                "kind": KIND,
                "listKind": "JAXJobList",
                "plural": "jaxjobs",
                "singular": "jaxjob",
                "shortNames": ["jj"],
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
