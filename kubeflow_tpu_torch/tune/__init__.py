"""Hyperparameter sweeps — the Katib StudyJob capability (port of
`kubeflow_tpu/tune/`).

The reference's CI drives a StudyJob CRD and polls its conditions
(testing/katib_studyjob_test.py:128-194); the operator itself lived
outside the tree. Here the sweep controller is in-tree: each trial is one of
the port's JAXJobs (a gang of GPU pods running the port's launcher), so
one StudyJob fans out over GPU node pools.
"""

from kubeflow_tpu_torch.tune.studyjob import (  # noqa: F401
    API_VERSION,
    KIND,
    StudyJobReconciler,
    build_controller,
    new_studyjob,
)
