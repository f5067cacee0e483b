"""kubeflow_tpu_torch.control — the port's control plane on GPUs.

Port of `kubeflow_tpu/control/` for the pieces that run a training job
and a serving fleet on GPUs: submit a JAXJob or a JAXService, place its
pods on GPU nodes with the gang scheduler, make pods that claim
``nvidia.com/gpu`` and run the port's launcher or server, restart,
resize, drain and roll them out. None of it needs torch.

- ``control.k8s``            — unstructured objects, the in-memory
  ``FakeCluster`` apiserver, its HTTP front (``apiserver``), the REST
  client for a live apiserver (``rest``, standard library only), the
  seeded fault injector (``chaos``), and the fake kubelets
  (``FakeKubelet``, ``LocalPodExecutor``, which runs pod commands as
  local processes).
- ``control.runtime``        — the controller engine (workqueue +
  watches + requeue; controller-runtime's Manager/Controller analogue).
- ``control.reconcilehelper``— create-or-update diff/copy semantics
  (components/common/reconcilehelper/util.go).
- ``control.cache``          — the indexed cluster cache the controllers
  and the scheduler read by default.
- ``control.leases``         — Lease-based leader election.
- ``control.mains``          — the shared controller main (REST client,
  /metrics, goodput export, leader election, SIGTERM to exit 0).
- ``control.jaxjob``         — the training-job operator: gang GPU pod
  sets + the ``JAXJOB_*`` env the port's dist reads.
- ``control.jaxservice``     — the serving operator: replica pods of the
  port's server, the endpoints annotation the router watches
  (``watch_endpoints``), autoscaling, drain, rollouts.
- ``control.scheduler``      — the GPU gang scheduler: per-(product,
  node pool) pools, per-namespace gang queue, all-or-nothing admission,
  priority preemption.
"""
