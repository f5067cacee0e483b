"""`python -m kubeflow_tpu_torch.control.scheduler`: the GPU gang
scheduler, on the shared controller main (`control/mains.py`) against
the apiserver of its in-cluster config or of `--apiserver`."""

from kubeflow_tpu_torch.control.mains import run_controller
from kubeflow_tpu_torch.control.scheduler.scheduler import build_scheduler


def main(argv: list[str] | None = None) -> None:
    # 10% requeue-backoff jitter in production: after a node comes back,
    # same-shaped gangs must not retry admission in lockstep
    run_controller("gang-scheduler",
                   lambda client, args: build_scheduler(client, jitter=0.1),
                   argv=argv)


if __name__ == "__main__":
    main()
