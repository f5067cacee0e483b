"""`python -m kubeflow_tpu_torch.control.tensorboard`: the Tensorboard
controller manager on the shared controller main (`control/mains.py`)
against the apiserver of its in-cluster config or of `--apiserver`."""

from kubeflow_tpu_torch.control.mains import run_controller
from kubeflow_tpu_torch.control.tensorboard.controller import build_controller


def main(argv: list[str] | None = None) -> None:
    run_controller("tensorboard-controller",
                   lambda client, args: build_controller(client), argv=argv)


if __name__ == "__main__":
    main()
