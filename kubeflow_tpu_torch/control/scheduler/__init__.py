"""kubeflow_tpu_torch.control.scheduler — the GPU gang scheduler.

Port of `kubeflow_tpu/control/scheduler/`. The reference platform
delegates placement to kube-scheduler; its only topology notion is "N
pods each asking for nvidia.com/gpu: 1"
(tf-controller-examples/tf-cnn/create_job_specs.py:165-170), which
places a gang piecemeal: a torch.distributed world missing one worker
never forms. This package admits a gang all-or-nothing onto GPU node
pools:

- ``topology``  — the ONE normaliser of the pool key (a GKE node-pool
  name), shared by JAXJob rendering and the node model.
- ``nodes``     — the node model: GPU product + node-pool labels,
  ``nvidia.com/gpu`` allocatable, taints, readiness.
- ``capacity``  — per-(product, node pool) sorted free-GPU buckets.
- ``queue``     — per-namespace gang queue: priority + FIFO order,
  exponential requeue backoff, injectable clock.
- ``scheduler`` — the Reconciler: all-or-nothing gang admission
  (reserve -> bind every pod via spec.nodeName, or release and requeue)
  and priority preemption (evict a lower-priority gang as
  Failed/Evicted so the JAXJob controller's gang-restart path fires).

A JAXJob opts in by setting ``spec.schedulerName`` (see
``jaxjob.types.new_jaxjob(gang_schedule=True)``); its generated pods
carry a scheduling gate that only admission lifts, so no kubelet runs a
partially placed gang. The names below are the JAX package's: the
contract between controller, scheduler and pods is unchanged.
"""

from __future__ import annotations

# Pod-facing contract, consumed by the JAXJob controller when a job opts
# into gang scheduling. Constants live here (import-light) so jaxjob can
# import them without pulling the scheduler runtime in.
SCHEDULER_NAME = "kubeflow-tpu-scheduler"
GATE_GANG = "scheduler.kubeflow.org/gang"
ANNOTATION_GANG_SIZE = "scheduler.kubeflow.org/gang-size"
ANNOTATION_PRIORITY = "scheduler.kubeflow.org/priority"
# Elastic floor: present on a gang's pods => the gang may be admitted
# PARTIALLY, down to this many workers (rigid gangs — no annotation —
# keep the all-or-nothing law). Stamped by the JAXJob controller from
# spec.elastic.minReplicas.
ANNOTATION_ELASTIC_MIN = "scheduler.kubeflow.org/elastic-min"
# Spot/preemptible pool surface (the GKE spot label, on GPU nodes as on
# TPU ones): spot nodes carry this label plus a matching NoSchedule
# taint, so only workloads that explicitly tolerate reclaim — elastic
# gangs — may land there. The scheduler PREFERS spot nodes for elastic
# workers but falls back to on-demand when the spot pool is full.
LABEL_SPOT = "cloud.google.com/gke-spot"


def __getattr__(name):
    # lazy: the runtime imports jaxjob types/controller, which import the
    # constants above — eager re-export here would be a cycle
    if name in ("build_scheduler", "GangScheduler"):
        from kubeflow_tpu_torch.control.scheduler import scheduler as _s

        return getattr(_s, name)
    raise AttributeError(name)
