"""`python -m kubeflow_tpu_torch.control.kfam [--port 8081] [--apiserver
URL]`: the KFAM service against the apiserver of its in-cluster config
or of `--apiserver`, until SIGTERM or SIGINT (then exit 0)."""

import argparse

from kubeflow_tpu_torch.control.k8s.rest import RestClient
from kubeflow_tpu_torch.control.kfam.service import KfamService
from kubeflow_tpu_torch.utils.httpd import serve_until_signalled


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser("kfam")
    p.add_argument("--port", type=int, default=8081)
    p.add_argument("--apiserver", default="")
    args = p.parse_args(argv)
    svc = KfamService(RestClient(base_url=args.apiserver or None)).serve(
        port=args.port).serve_background()
    return serve_until_signalled(svc, f"kfam on :{svc.port}")


if __name__ == "__main__":
    raise SystemExit(main())
