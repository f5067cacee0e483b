"""`python -m kubeflow_tpu_torch.webapps.jwa_main [--port 5000]
[--apiserver URL]`: the Jupyter web app against the apiserver of its
in-cluster config or of `--apiserver`."""

import argparse

from kubeflow_tpu_torch.control.k8s.rest import RestClient
from kubeflow_tpu_torch.webapps.jwa import JupyterWebApp


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser("jwa")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--apiserver", default="")
    args = p.parse_args(argv)
    svc = JupyterWebApp(RestClient(base_url=args.apiserver or None)).serve(
        port=args.port)
    print(f"jwa on :{svc.port}", flush=True)
    svc.serve_forever()


if __name__ == "__main__":
    main()
