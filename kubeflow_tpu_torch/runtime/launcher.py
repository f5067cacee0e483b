"""In-pod launcher of the port (port of kubeflow_tpu/runtime/launcher.py).

- runs the built-in trainer (`--config` JSON/YAML -> TrainConfig) on one
  device, or a user command given after `--`;
- serves the metrics registry at $JAXRT_METRICS_PORT (default 9100);
- attaches the job's trace context ($TRACEPARENT) and runs the trainer
  inside a `worker` span; $KFTPU_TRACE_FILE receives the span dump at
  exit (tools/trace2perfetto.py reads it);
- installs a SIGTERM PreemptionNotice as the trainer's stop flag: a
  preempted run saves its step and exits EX_TEMPFAIL (75), which the
  JAXJob controller reads as "gang-restart me and resume";
- exits 0 on success, 1 on failure; prints `{"summary": ...}` as the
  last line of a built-in run.

The device is cuda unless `--device cpu` is given; with no GPU and no
`--device cpu` it fails rather than train on the CPU. `--wait-devices`
waits until torch sees a CUDA device. Multi-process world formation
from the JAXJOB_* env and the elastic world file wait for the port's
parallel/dist.py (ROADMAP Queue 1 items 15b, 16).

Usage:
    python -m kubeflow_tpu_torch.runtime.launcher --config cfg.yaml [--device cpu]
    python -m kubeflow_tpu_torch.runtime.launcher -- python my_train.py --flag
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import time

from kubeflow_tpu_torch.obs import trace as obs_trace

log = logging.getLogger("kubeflow_tpu_torch.launcher")

# the gang env the JAXJob controller stamps (the reference's parallel/dist.py)
ENV_NPROC = "JAXJOB_NUM_PROCESSES"
ENV_PID = "JAXJOB_PROCESS_ID"
ENV_NAME = "JAXJOB_NAME"
ENV_WORLD_FILE = "JAXJOB_WORLD_FILE"
ENV_METRICS_PORT = "JAXRT_METRICS_PORT"
ENV_TRACE_FILE = "KFTPU_TRACE_FILE"


def wait_for_devices(timeout_s: float = 300.0) -> int:
    """Block until torch sees a CUDA device; returns the count."""
    import torch

    deadline = time.monotonic() + timeout_s
    while True:
        n = torch.cuda.device_count()
        if n > 0:
            log.info("devices ready: %d x %s", n, torch.cuda.get_device_name(0))
            return n
        if time.monotonic() > deadline:
            raise TimeoutError(f"no CUDA devices after {timeout_s}s")
        time.sleep(2.0)


def load_config(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        from kubeflow_tpu_torch.utils import yaml_lite

        return yaml_lite.loads(text)


def run_builtin_trainer(cfg_dict: dict, device: str = "cuda") -> int:
    from kubeflow_tpu_torch.runtime import metrics as rt_metrics
    from kubeflow_tpu_torch.runtime.preemption import EX_TEMPFAIL, PreemptionNotice
    from kubeflow_tpu_torch.runtime.trainer import TrainConfig, Trainer

    metrics_port = int(os.environ.get(ENV_METRICS_PORT, "9100"))
    server = None
    try:
        server = rt_metrics.serve_metrics(metrics_port)
        log.info("metrics on :%d/metrics", server.port)
    except OSError:
        log.warning("metrics port %d busy; metrics endpoint disabled",
                    metrics_port)
    notice = PreemptionNotice()
    try:
        # the worker span: a child of the job's root span (TRACEPARENT,
        # attached in main), with train.fit and its steps inside
        with obs_trace.TRACER.span("worker",
                                   process=os.environ.get(ENV_PID, ""),
                                   job=os.environ.get(ENV_NAME, "")):
            cfg = TrainConfig.from_dict(cfg_dict)
            # SIGTERM (pod eviction, node maintenance) => save and exit
            # EX_TEMPFAIL, so the controller gang-restarts and resumes
            notice.install()
            summary = Trainer(cfg, device=device).fit(stop=notice)
    finally:
        notice.uninstall()
        _dump_trace()
        if server is not None:
            server.shutdown()
    fa = sys.modules.get("kubeflow_tpu_torch.ops.flash_attention")
    if fa is not None:
        log.info("flash kernel launches: %s", json.dumps(fa.LAUNCHES))
    print(json.dumps({"summary": summary}), flush=True)
    return EX_TEMPFAIL if summary.get("preempted") else 0


def _dump_trace() -> None:
    """Persist this process's spans ($KFTPU_TRACE_FILE, JSONL)."""
    path = os.environ.get(ENV_TRACE_FILE)
    if not path:
        return
    try:
        obs_trace.write_jsonl(path, obs_trace.COLLECTOR.spans())
    except OSError as e:
        log.warning("could not write trace dump %s: %s", path, e)


def run_user_command(argv: list[str]) -> int:
    """Run the user payload, streaming its output; its exit code is the
    launcher's."""
    log.info("exec: %s", " ".join(argv))
    proc = subprocess.Popen(argv, stdout=sys.stdout, stderr=sys.stderr)
    return proc.wait()


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    user_cmd: list[str] = []
    if "--" in argv:
        i = argv.index("--")
        argv, user_cmd = argv[:i], argv[i + 1:]

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config",
                   help="TrainConfig JSON/YAML for the built-in trainer")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--wait-devices", action="store_true",
                   help="block until a CUDA device is visible before starting")
    p.add_argument("--device-timeout", type=float, default=300.0)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    nproc = int(os.environ.get(ENV_NPROC) or 1)
    if nproc > 1:
        raise NotImplementedError(
            f"{ENV_NPROC}={nproc}: multi-process training waits for the "
            "port's parallel/dist.py (ROADMAP Queue 1 item 16)")
    if os.environ.get(ENV_WORLD_FILE):
        log.warning("%s is set: elastic resize waits for the port's "
                    "parallel/dist.py (ROADMAP Queue 1 items 15b, 16); "
                    "running as one process", ENV_WORLD_FILE)

    # adopt the job's trace context before any span opens
    ctx = obs_trace.context_from_env()
    if ctx is not None:
        obs_trace.TRACER.attach(ctx)

    if args.wait_devices and args.device != "cpu":
        wait_for_devices(args.device_timeout)
    if args.config:
        return run_builtin_trainer(load_config(args.config), args.device)
    if user_cmd:
        return run_user_command(user_cmd)
    p.error("need --config or a user command after --")
    return 2


if __name__ == "__main__":
    sys.exit(main())
