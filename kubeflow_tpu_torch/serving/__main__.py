"""python -m kubeflow_tpu_torch.serving: the server's CLI
(serving/server.py main)."""

import sys

from kubeflow_tpu_torch.serving.server import main

if __name__ == "__main__":
    sys.exit(main())
