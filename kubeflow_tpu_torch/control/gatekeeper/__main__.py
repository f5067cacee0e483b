"""`python -m kubeflow_tpu_torch.control.gatekeeper [--port 8085]`: the
basic-auth check endpoint (its user, password hash and salt from
GATEKEEPER_USERNAME, GATEKEEPER_PASSHASH and GATEKEEPER_SALT), until
SIGTERM or SIGINT (then exit 0)."""

import argparse

from kubeflow_tpu_torch.control.gatekeeper.auth import AuthServer
from kubeflow_tpu_torch.utils.httpd import serve_until_signalled


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser("gatekeeper")
    p.add_argument("--port", type=int, default=8085)
    args = p.parse_args(argv)
    svc = AuthServer().serve(port=args.port).serve_background()
    return serve_until_signalled(svc, f"gatekeeper on :{svc.port}")


if __name__ == "__main__":
    raise SystemExit(main())
