"""PodDefault mutating admission webhook.

Port of `kubeflow_tpu/control/poddefault/`. Reference:
components/admission-webhook: label-matched injection of env, envFrom,
volumes, volumeMounts, tolerations, labels and annotations into pods at
admission time, which is how notebooks and jobs get secrets, tokens and
volumes. The port keeps the mechanism (JSONPatch reply, conflict-safe
merge) and uses it for GPU pods: a PodDefault can point the launcher's
span dump (KFTPU_TRACE_FILE) at a Tensorboard's log directory.
"""

from kubeflow_tpu_torch.control.poddefault.webhook import (  # noqa: F401
    API_VERSION,
    KIND,
    PodDefaultMutator,
    new_poddefault,
)
