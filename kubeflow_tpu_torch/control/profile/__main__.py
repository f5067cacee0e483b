"""`python -m kubeflow_tpu_torch.control.profile`: the Profile controller
manager with the WorkloadIdentity and IRSA plugins, on the shared
controller main (`control/mains.py`) against the apiserver of its
in-cluster config or of `--apiserver`."""

from kubeflow_tpu_torch.control.mains import run_controller
from kubeflow_tpu_torch.control.profile.controller import (
    WorkloadIdentityPlugin,
    build_controller,
)
from kubeflow_tpu_torch.control.profile.plugin_irsa import IrsaPlugin


def main(argv: list[str] | None = None) -> None:
    run_controller(
        "profile-controller",
        lambda client, args: build_controller(
            client,
            plugins={
                "WorkloadIdentity": WorkloadIdentityPlugin(),
                IrsaPlugin.KIND: IrsaPlugin(),
            },
        ),
        argv=argv,
    )


if __name__ == "__main__":
    main()
