"""JAXJob — the gang-scheduled GPU training-job operator (port of
`kubeflow_tpu/control/jaxjob/`).

Where the reference platform wired GPU pods together with `TF_CONFIG`
parameter-server gRPC (tf-controller-examples/tf-cnn/launcher.py:68-80)
or MPI/NCCL (components/openmpi-controller), a JAXJob boots its workers
into one `torch.distributed` world through the port's launcher.
"""

from kubeflow_tpu_torch.control.jaxjob.types import (  # noqa: F401
    API_VERSION,
    KIND,
    new_jaxjob,
)
from kubeflow_tpu_torch.control.jaxjob.controller import JAXJobReconciler, build_controller  # noqa: F401
