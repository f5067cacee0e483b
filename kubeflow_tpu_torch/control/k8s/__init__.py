"""In-tree Kubernetes API machinery (port of `kubeflow_tpu/control/k8s/`).

- ``objects`` — unstructured dict objects + metadata/condition/selector
  helpers (client-go's unstructured + apimachinery analogue).
- ``fake``    — ``FakeCluster``: an in-memory apiserver with resource
  versions, optimistic concurrency, label selectors, finalizers,
  deletionTimestamps, ownerReference garbage collection and watch
  streams.
- ``kubelet`` — ``FakeKubelet`` and ``LocalPodExecutor``.
- ``rest``    — ``RestClient``: the same Client interface over HTTP(S)
  to a real apiserver (in-cluster config: serviceaccount token + CA),
  on the standard library.
- ``apiserver`` — ``ApiServer``: a FakeCluster served over the
  Kubernetes REST wire format, for hermetic runs of the REST path.
- ``chaos``   — ``ChaosClient``: seeded fault injection around any
  Client.
"""

from kubeflow_tpu_torch.control.k8s.objects import (  # noqa: F401
    ApiError,
    Conflict,
    NotFound,
    cond_get,
    cond_set,
    gvk,
    match_labels,
    meta,
    new_object,
    owner_ref,
    set_owner,
)
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster  # noqa: F401
