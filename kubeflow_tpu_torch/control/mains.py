"""Shared container entrypoint for controller managers.

Port of `kubeflow_tpu/control/mains.py`. Each operator image runs
`python -m kubeflow_tpu_torch.control.<name>`; the `__main__` modules
call into here. Mirrors the kubebuilder main.go shape: build the client
(in-cluster, or ``--apiserver``), build the controller, serve /metrics
and /healthz (the port's registry through ``serve_metrics``: the card's
machine has no prometheus_client), publish goodput, and run until
SIGTERM or SIGINT. Then it stops the controller (waiting for its
threads), the goodput exporter and the metrics server, releases the
lease, and returns, so the process exits 0 within seconds of the signal.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading

log = logging.getLogger("kubeflow_tpu_torch.mains")


def run_controller(name: str, build, *, extra_args=None,
                   argv: list[str] | None = None) -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    p = argparse.ArgumentParser(f"kubeflow-tpu-torch-{name}")
    p.add_argument("--metrics-port", type=int, default=8080,
                   help="/metrics and /healthz (0 = any free port)")
    p.add_argument("--apiserver", default="", help="override in-cluster config")
    p.add_argument(
        "--enable-leader-election", action="store_true",
        default=os.environ.get("ENABLE_LEADER_ELECTION", "false") in (
            "true", "True", "TRUE"),
        help="Enable leader election for controller manager. Enabling this "
             "will ensure there is only one active controller manager.")
    if extra_args:
        extra_args(p)
    args = p.parse_args(argv)
    # installed before anything starts: a SIGTERM that lands while the
    # controller starts still ends the process through the orderly path
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())

    from kubeflow_tpu_torch.control.k8s.rest import RestClient

    client = RestClient(base_url=args.apiserver or None)

    # staging chaos drills: TPU_CHAOS_RATE>0 wraps the client in the
    # seeded fault injector (TPU_CHAOS_SEED picks the schedule) so a
    # whole controller deployment can be soak-tested against apiserver
    # faults without touching the cluster. 0/unset: no wrapper at all.
    from kubeflow_tpu_torch.control.k8s import chaos

    if float(os.environ.get(chaos.ENV_RATE, "0") or 0) > 0:
        client = chaos.ChaosClient(client)
        logging.getLogger("kubeflow_tpu_torch.chaos").warning(
            "chaos fault injection ENABLED for %s (TPU_CHAOS_RATE=%s, "
            "TPU_CHAOS_SEED=%s)", name,
            os.environ.get(chaos.ENV_RATE),
            os.environ.get(chaos.ENV_SEED, "0"))

    ctl = build(client, args)

    # --enable-leader-election parity (notebook-controller main.go:51-62):
    # HA replicas elect one active manager through a coordination Lease
    elector = None
    if args.enable_leader_election:
        from kubeflow_tpu_torch.control.leases import LeaderElector

        elector = LeaderElector(
            client, f"{name}-controller",
            namespace=os.environ.get("POD_NAMESPACE", "kubeflow"))
        ctl.with_leader_election(elector)

    from kubeflow_tpu_torch.runtime.metrics import serve_metrics

    metrics = serve_metrics(args.metrics_port)
    log.info("%s: metrics on :%d", name, metrics.port)

    # goodput_* export: every controller manager publishes its
    # span-stream accounting into the registry its /metrics endpoint
    # serves. TPU_GOODPUT_CHIPS sizes the lost GPU-seconds; 0 disables.
    from kubeflow_tpu_torch.obs.goodput import ENV_GOODPUT_CHIPS, GoodputExporter

    goodput_chips = int(os.environ.get(ENV_GOODPUT_CHIPS, "1") or 0)
    goodput_exporter = None
    if goodput_chips > 0:
        goodput_exporter = GoodputExporter(chips=goodput_chips).start()

    try:
        ctl.run(workers=2)
        # process lifetime park, released only by SIGTERM/SIGINT
        while not stop.wait(1.0):
            pass
        log.info("%s: signalled, stopping", name)
    finally:
        ctl.stop()
        if goodput_exporter is not None:
            goodput_exporter.stop()
        metrics.shutdown()
        if elector is not None:
            elector.release()  # immediate hand-off on clean shutdown
