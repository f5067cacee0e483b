"""Webhook server entry: python -m kubeflow_tpu_torch.control.poddefault.

Port of `kubeflow_tpu/control/poddefault/__main__.py`. Serves HTTPS when
--certs-dir (or WEBHOOK_CERTS_DIR) is set: the kube apiserver refuses
plain-HTTP webhook callees, so the manifests `tpctl` renders always set
it, and the server then publishes its CA into the live
MutatingWebhookConfiguration on a thread. Plain HTTP is for local
debugging only. Reference flags: admission-webhook/main.go:541-542.

As `control/mains.py`'s controllers do, it runs until SIGTERM or SIGINT,
then stops the publishing thread and the server and exits 0.
"""
import argparse
import os
import signal
import threading

from kubeflow_tpu_torch.control.k8s.rest import RestClient
from kubeflow_tpu_torch.control.poddefault import PodDefaultMutator


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser("poddefault-webhook")
    p.add_argument("--port", type=int, default=4443)
    p.add_argument("--apiserver", default="")
    p.add_argument("--certs-dir",
                   default=os.environ.get("WEBHOOK_CERTS_DIR", ""),
                   help="serve HTTPS with a bootstrapped CA and cert from "
                        "this directory")
    args = p.parse_args(argv)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    mutator = PodDefaultMutator(RestClient(base_url=args.apiserver or None))
    svc = mutator.serve(port=args.port, certs_dir=args.certs_dir or None)
    svc.serve_background()
    print(f"poddefault webhook on :{svc.port} "
          f"({'https' if svc.tls else 'http'})", flush=True)
    publisher = None
    if svc.tls:
        # announce the CA to the apiserver (the registration may be
        # applied after this pod starts: serving must not wait on it)
        publisher = threading.Thread(
            target=mutator.publish_ca_bundle, kwargs={"stop": stop},
            name="ca-bundle-publish")
        publisher.start()
    try:
        while not stop.wait(1.0):
            pass
    finally:
        stop.set()
        if publisher is not None:
            publisher.join()
        svc.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
