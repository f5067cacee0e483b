"""In-tree Kubernetes API machinery (port of `kubeflow_tpu/control/k8s/`).

- ``objects`` — unstructured dict objects + metadata/condition/selector
  helpers (client-go's unstructured + apimachinery analogue).
- ``fake``    — ``FakeCluster``: an in-memory apiserver with resource
  versions, optimistic concurrency, label selectors, finalizers,
  deletionTimestamps, ownerReference garbage collection and watch
  streams.
- ``kubelet`` — ``FakeKubelet`` and ``LocalPodExecutor``.

The REST client for a live apiserver (``rest``) is not ported yet
(ROADMAP Queue 1, item 20b).
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
