"""Tensorboard operator (port of `kubeflow_tpu/control/tensorboard/`;
reference: components/tensorboard-controller)."""

from kubeflow_tpu_torch.control.tensorboard.controller import (  # noqa: F401
    API_VERSION,
    KIND,
    TensorboardReconciler,
    build_controller,
    new_tensorboard,
)
