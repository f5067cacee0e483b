"""In-pod launcher of the port (port of kubeflow_tpu/runtime/launcher.py).

- forms the world the JAXJOB_* env describes (parallel/dist.py,
  through the collectives backend $JAXJOB_COLLECTIVES_BACKEND) and runs
  the built-in trainer (`--config` JSON/YAML -> TrainConfig) on this
  process's device, or a user command given after `--` (which gets the
  env and forms its own world);
- one process per GPU: with `--nproc-per-node` N > 1 (default: the
  CUDA device count; 1 on the CPU) it starts N local workers, local rank
  r on cuda:r, global rank JAXJOB_PROCESS_ID x N + r in a world of
  JAXJOB_NUM_PROCESSES x N, forwards SIGTERM to them and exits with
  their code (75 when one was preempted and none failed); a user
  command runs once per local rank when `--nproc-per-node` is given (a
  serving mesh: `-- python -m kubeflow_tpu_torch.serving --mesh model=2`);
- with $JAXJOB_WORLD_FILE and `--config` the elastic coordinator forms
  and re-forms the world from the stamp in that file instead
  (runtime/elastic.py): shrink or grow in place, resuming from the
  checkpoint;
- serves the metrics registry at $JAXRT_METRICS_PORT (default 9100);
- with $JAXRT_PROFILER_PORT set, serves on-demand profiler captures of
  the built-in trainer's next steps there (runtime/profiler.py; a user
  command gets no server, as in the reference);
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
waits until torch sees a CUDA device.

Usage:
    python -m kubeflow_tpu_torch.runtime.launcher --config cfg.yaml [--device cpu]
    JAXJOB_COORDINATOR_ADDRESS=host:8476 JAXJOB_NUM_PROCESSES=2 \
        JAXJOB_PROCESS_ID=0 python -m kubeflow_tpu_torch.runtime.launcher \
        --config cfg.yaml --nproc-per-node 8
    python -m kubeflow_tpu_torch.runtime.launcher -- python my_train.py --flag
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import subprocess
import sys
import time

from kubeflow_tpu_torch.obs import trace as obs_trace
from kubeflow_tpu_torch.parallel import dist as D
from kubeflow_tpu_torch.runtime.profiler import (
    ENV_PROFILER_PORT,
    start_server_from_env,
)

log = logging.getLogger("kubeflow_tpu_torch.launcher")

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
                                   process=os.environ.get(D.ENV_PID, ""),
                                   job=os.environ.get(D.ENV_NAME, "")):
            cfg = TrainConfig.from_dict(cfg_dict)
            # SIGTERM (pod eviction, node maintenance) => save and exit
            # EX_TEMPFAIL, so the controller gang-restarts and resumes
            notice.install()
            world_file = os.environ.get(D.ENV_WORLD_FILE)
            if world_file:
                import socket

                from kubeflow_tpu_torch.runtime.elastic import (
                    ElasticCoordinator,
                    file_world_source,
                )

                coord = ElasticCoordinator(
                    file_world_source(world_file),
                    my_name=os.environ.get("HOSTNAME")
                    or socket.gethostname(),
                    notice=notice, device=device,
                    batch_policy=os.environ.get(D.ENV_BATCH_POLICY,
                                                D.BATCH_PRESERVE))
                summary = coord.run(cfg, full_world=int(
                    os.environ.get(D.ENV_NPROC, "1")))
            else:
                trainer = Trainer(cfg, device=device)
                summary = trainer.fit(stop=notice)
            if device.startswith("cuda"):
                import torch

                log.info("peak device memory: %.3f GB",
                         torch.cuda.max_memory_allocated(device) / 1e9)
    finally:
        notice.uninstall()
        _dump_trace()
        if server is not None:
            server.shutdown()
    fa = sys.modules.get("kubeflow_tpu_torch.ops.flash_attention")
    if fa is not None:
        log.info("flash kernel launches: %s; by instantiation: %s",
                 json.dumps(fa.LAUNCHES),
                 json.dumps(dict(fa.INSTANCE_LAUNCHES)))
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
    p.add_argument("--nproc-per-node", type=int, default=None,
                   help="local worker processes, one per device (default: "
                   "the CUDA device count; 1 with --device cpu)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.device not in ("cuda", "cpu"):
        p.error(f"--device {args.device}: cuda or cpu")
    if args.config is None and not user_cmd:
        p.error("need --config or a user command after --")

    if args.wait_devices and args.device != "cpu":
        wait_for_devices(args.device_timeout)

    # adopt the job's trace context before any span opens
    ctx = obs_trace.context_from_env()
    if ctx is not None:
        obs_trace.TRACER.attach(ctx)

    if not args.config:
        # an explicit --nproc-per-node runs the command once per local
        # rank, each with its rank's env (a serving mesh's ranks)
        if (args.nproc_per_node or 1) > 1 and \
                D.ENV_LOCAL_RANK not in os.environ:
            return run_local_workers([*argv, "--", *user_cmd],
                                     args.nproc_per_node)
        return run_user_command(user_cmd)
    import torch

    from kubeflow_tpu_torch.device import resolve_device
    from kubeflow_tpu_torch.parallel import backends as B

    nproc = args.nproc_per_node
    if nproc is None:
        nproc = 1 if args.device == "cpu" else max(1, torch.cuda.device_count())
    if nproc > 1 and D.ENV_LOCAL_RANK not in os.environ:
        return run_local_workers(argv, nproc)
    local_rank = int(os.environ.get(D.ENV_LOCAL_RANK) or 0)
    device = "cpu" if args.device == "cpu" else f"cuda:{local_rank}"
    if device != "cpu":
        torch.cuda.set_device(resolve_device(device))

    log.info("collectives backend: %s", B.get_backend().name)
    if os.environ.get(D.ENV_WORLD_FILE):
        # the env describes the full gang, the stamp the live members:
        # the elastic coordinator forms the world from the stamp
        log.info("elastic world file %s set: deferring world formation "
                 "to the elastic coordinator",
                 os.environ[D.ENV_WORLD_FILE])
    else:
        cfg = D.initialize_from_env(device=device)
        log.info("process %d/%d (job=%s) on %s", cfg.process_id,
                 cfg.num_processes, cfg.job_name or "-", device)
    try:
        capture = start_server_from_env()
    except OSError as e:
        capture = None
        log.warning("profiler capture port %s busy (%s); on-demand capture "
                    "disabled", os.environ.get(ENV_PROFILER_PORT), e)
    try:
        return run_builtin_trainer(load_config(args.config), device)
    finally:
        if capture is not None:
            capture.shutdown()
        D.shutdown()


def run_local_workers(argv: list[str], nproc: int,
                      module: str = "kubeflow_tpu_torch.runtime.launcher",
                      base_env: dict[str, str] | None = None) -> int:
    """Start `nproc` copies of `python -m module argv` (this launcher by
    default), local rank r with the env of global rank JAXJOB_PROCESS_ID
    x nproc + r (from `base_env`, default this process's); forward
    SIGTERM; return the first failing code, else 75 when one was
    preempted, else 0."""
    from kubeflow_tpu_torch.runtime.preemption import EX_TEMPFAIL

    if "--nproc-per-node" in argv:
        i = argv.index("--nproc-per-node")
        argv = argv[:i] + argv[i + 2:]
    argv = [a for a in argv if not a.startswith("--nproc-per-node=")]
    procs = []
    for r in range(nproc):
        env = D.expand_local(dict(os.environ if base_env is None
                                  else base_env), nproc, r)
        # one span dump, one metrics port and one capture port per worker
        if env.get(ENV_TRACE_FILE):
            env[ENV_TRACE_FILE] = f"{env[ENV_TRACE_FILE]}.local{r}"
        port = int(env.get(ENV_METRICS_PORT, "9100"))
        env[ENV_METRICS_PORT] = str(port + r if port else 0)
        if env.get(ENV_PROFILER_PORT):
            port = int(env[ENV_PROFILER_PORT])
            env[ENV_PROFILER_PORT] = str(port + r if port else 0)
        procs.append(subprocess.Popen([sys.executable, "-m", module, *argv],
                                      env=env))
    log.info("started %d local workers", nproc)

    def forward(signum, _frame):
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signum)

    old = signal.signal(signal.SIGTERM, forward)
    try:
        codes = [proc.wait() for proc in procs]
    finally:
        signal.signal(signal.SIGTERM, old)
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    failed = [c for c in codes if c not in (0, EX_TEMPFAIL)]
    if failed:
        return failed[0]
    return EX_TEMPFAIL if EX_TEMPFAIL in codes else 0


if __name__ == "__main__":
    sys.exit(main())
