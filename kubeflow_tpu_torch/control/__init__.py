"""kubeflow_tpu_torch.control — the port's control plane: the job path.

Port of `kubeflow_tpu/control/` for the pieces that run a training job
on GPUs (the reference platform's TFJob-on-GPU flow): submit a JAXJob,
place it on GPU nodes with the gang scheduler, make pods that claim
``nvidia.com/gpu`` and run the port's launcher, restart or resize the
gang. None of it needs torch.

- ``control.k8s``            — unstructured objects, the in-memory
  ``FakeCluster`` apiserver, and the fake kubelets (``FakeKubelet``,
  ``LocalPodExecutor``, which runs pod commands as local processes).
- ``control.runtime``        — the controller engine (workqueue +
  watches + requeue; controller-runtime's Manager/Controller analogue).
- ``control.reconcilehelper``— create-or-update diff/copy semantics
  (components/common/reconcilehelper/util.go).
- ``control.cache``          — the indexed cluster cache the controller
  and the scheduler read by default.
- ``control.jaxjob``         — the training-job operator: gang GPU pod
  sets + the ``JAXJOB_*`` env the port's dist reads.
- ``control.scheduler``      — the GPU gang scheduler: per-(product,
  node pool) pools, per-namespace gang queue, all-or-nothing admission,
  priority preemption.

The REST client, leases, the controller mains and the services
operator come in a later slice (ROADMAP Queue 1, item 20b).
"""
