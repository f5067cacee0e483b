"""`python -m kubeflow_tpu_torch.control.jaxservice`: the JAXService
controller manager, on the shared controller main (`control/mains.py`)
against the apiserver of its in-cluster config or of `--apiserver`."""

from kubeflow_tpu_torch.control.jaxservice.controller import build_controller
from kubeflow_tpu_torch.control.mains import run_controller


def main(argv: list[str] | None = None) -> None:
    run_controller("jaxservice",
                   lambda client, args: build_controller(client), argv=argv)


if __name__ == "__main__":
    main()
