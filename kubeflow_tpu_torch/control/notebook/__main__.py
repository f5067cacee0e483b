"""`python -m kubeflow_tpu_torch.control.notebook`: the Notebook
controller manager, on the shared controller main (`control/mains.py`)
against the apiserver of its in-cluster config or of `--apiserver`. Its
/metrics serves the live `notebook_running` gauge, read from the
current StatefulSets at each scrape (metrics.go:95-116)."""

from kubeflow_tpu_torch.control.mains import run_controller
from kubeflow_tpu_torch.control.notebook.controller import (
    RunningNotebooksCollector,
    build_controller,
)


def _build(client, args):
    RunningNotebooksCollector(client).register()
    return build_controller(client)


def main(argv: list[str] | None = None) -> None:
    run_controller("notebook-controller", _build, argv=argv)


if __name__ == "__main__":
    main()
