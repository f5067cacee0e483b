"""The port's on-demand profiler capture (kubeflow_tpu_torch/runtime/
profiler.py: JAXRT_PROFILER_PORT, the reference's variable, starts an
HTTP trigger where the reference starts xprof's collection server).

A transformer-test Trainer.fit on a thread, and the launcher's `--config`
run as a subprocess, each answer `GET /capture?steps=2` with a Chrome
trace of their next two steps: exactly two optimizer updates in it, and
the `X-Capture-Steps` header naming two consecutive global steps. A
request while a window is open or armed (by another request or by
profile_dir) gets 409, one that no step hook answers within its timeout
504 (and arms nothing after), a bad query 400; without the variable
there is no server, and a user command gets none, as in the reference;
with `--nproc-per-node` local worker r listens on the port + r, as
JAXRT_METRICS_PORT does.
"""

import json
import os
import pathlib
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from kubeflow_tpu_torch.runtime import launcher as L
from kubeflow_tpu_torch.runtime import profiler as P
from kubeflow_tpu_torch.runtime.trainer import TrainConfig, Trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(model="transformer-test", task="lm", global_batch=4, seq_len=16,
           vocab_size=256, optimizer="adamw", learning_rate=1e-3,
           warmup_steps=0, log_every=1, model_kwargs={"dtype": "float32"})
UPDATE = "Optimizer.step#AdamW.step"


def _get(url: str, timeout: float = 120):
    """(status, headers, body) of a GET, error statuses included."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _updates(body: bytes) -> int:
    events = json.loads(body)["traceEvents"]
    return sum(1 for e in events if e.get("name") == UPDATE)


def _consecutive(header: str, n: int) -> bool:
    first, last = map(int, header.split("-"))
    return last - first == n - 1


def test_a_capture_over_http_traces_the_next_steps_of_fit():
    broker = P.CaptureBroker()
    server = P.start_server_from_env({P.ENV_PROFILER_PORT: "0"}, broker)
    trainer = Trainer(TrainConfig.from_dict(dict(CFG, total_steps=10**6)),
                      device="cpu")
    stepped, stop = threading.Event(), threading.Event()
    fit = threading.Thread(target=trainer.fit, kwargs=dict(
        callback=lambda i, m: stepped.set(), stop=stop.is_set))
    # fit's hook is the module's broker: this test's server asks its own
    orig = P.CAPTURES
    P.CAPTURES = broker
    try:
        fit.start()
        assert stepped.wait(120)
        status, headers, body = _get(
            f"http://127.0.0.1:{server.port}/capture?steps=2")
    finally:
        stop.set()
        fit.join(120)
        P.CAPTURES = orig
        server.shutdown()
    assert status == 200, body[:500]
    assert _consecutive(headers["X-Capture-Steps"], 2)
    assert _updates(body) == 2
    assert headers["X-Trace-Path"] == ""      # a temporary trace, gone
    assert not fit.is_alive()


def _request_in_thread(broker, steps=1, timeout_s=60.0):
    out = {}

    def go():
        try:
            out["cap"] = broker.request(steps, timeout_s)
        except P.CaptureError as e:
            out["err"] = e

    t = threading.Thread(target=go)
    t.start()
    return t, out


def _wait_armed(broker):
    deadline = time.monotonic() + 30
    while broker._armed is None:
        assert time.monotonic() < deadline
        time.sleep(0.01)


def test_conflict_while_a_window_is_open_or_armed(tmp_path):
    broker = P.CaptureBroker()
    idle = P.TraceWindow(None)
    broker.begin(None)
    t, out = _request_in_thread(broker, steps=2)
    _wait_armed(broker)
    with pytest.raises(P.CaptureError) as err:      # armed by a request
        broker.request(1, 5.0)
    assert err.value.status == 409
    broker.before_step(7, idle)                      # opens it
    with pytest.raises(P.CaptureError) as err:      # open
        broker.request(1, 5.0)
    assert err.value.status == 409
    broker.before_step(8, idle)
    broker.before_step(9, idle)                      # closes it after 8
    t.join(30)
    cap = out["cap"]
    assert (cap.first, cap.last) == (7, 8) and os.path.exists(cap.window.path)
    cap.discard()
    # a profile_dir window open: 409, and over HTTP too
    configured = P.TraceWindow(str(tmp_path / "prof"), start_step=10,
                               num_steps=2)
    broker.before_step(10, configured)
    assert configured.active
    server = P.start_server_from_env({P.ENV_PROFILER_PORT: "0"}, broker)
    try:
        status, _, body = _get(f"http://127.0.0.1:{server.port}/capture")
        assert status == 409 and b"cannot nest" in body
        status, _, _ = _get(f"http://127.0.0.1:{server.port}/capture?steps=0")
        assert status == 400
    finally:
        server.shutdown()
    broker.before_step(12, configured)
    assert configured.captured and not configured.active
    broker.end()


def test_a_request_armed_before_the_profile_dir_window_opens_gets_409(
        tmp_path):
    broker = P.CaptureBroker()
    configured = P.TraceWindow(str(tmp_path / "prof"), start_step=3,
                               num_steps=1)
    t, out = _request_in_thread(broker)
    _wait_armed(broker)
    broker.before_step(3, configured)
    t.join(30)
    assert out["err"].status == 409 and configured.active
    broker.end()
    configured.stop()


def test_timeout_when_fit_is_not_stepping_and_503_when_it_ends():
    broker = P.CaptureBroker()
    server = P.start_server_from_env({P.ENV_PROFILER_PORT: "0"}, broker)
    try:
        t0 = time.monotonic()
        status, _, body = _get(
            f"http://127.0.0.1:{server.port}/capture?steps=2&timeout=0.5")
        assert status == 504 and b"no training step began" in body
        assert time.monotonic() - t0 < 30
    finally:
        server.shutdown()
    assert broker._armed is None                     # nothing left armed
    t, out = _request_in_thread(broker)
    _wait_armed(broker)
    broker.end()                                     # fit ended first
    t.join(30)
    assert out["err"].status == 503


def test_no_server_without_the_variable_nor_for_a_user_command(monkeypatch):
    assert P.start_server_from_env({}) is None
    assert P.start_server_from_env({P.ENV_PROFILER_PORT: ""}) is None
    started = []
    monkeypatch.setattr(L, "start_server_from_env",
                        lambda *a, **k: started.append(1))
    monkeypatch.setenv(P.ENV_PROFILER_PORT, "0")
    assert L.main(["--", sys.executable, "-c", "pass"]) == 0
    assert started == []


def test_each_local_worker_takes_the_port_plus_its_rank(tmp_path):
    (tmp_path / "envdump.py").write_text(
        "import os\n"
        "r = os.environ['JAXJOB_LOCAL_RANK']\n"
        "open(os.path.join(os.environ['DUMP'], r), 'w').write(\n"
        "    os.environ.get('JAXRT_PROFILER_PORT', '-'))\n")
    for port, want in (("7100", ["7100", "7101"]), ("0", ["0", "0"]),
                       (None, ["-", "-"])):
        env = {k: v for k, v in os.environ.items()
               if k != P.ENV_PROFILER_PORT}
        env.update(PYTHONPATH=str(tmp_path), DUMP=str(tmp_path))
        if port is not None:
            env[P.ENV_PROFILER_PORT] = port
        assert L.run_local_workers([], 2, module="envdump", base_env=env) == 0
        assert [(tmp_path / str(r)).read_text() for r in range(2)] == want


def test_the_launcher_answers_a_capture_of_its_next_steps(tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(dict(CFG, total_steps=10**6)))
    env = {**os.environ, P.ENV_PROFILER_PORT: "0", "JAXRT_METRICS_PORT": "0",
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.runtime.launcher",
         "--config", str(cfg), "--device", "cpu"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, port = [], None
    try:
        for line in proc.stdout:
            lines.append(line)
            m = re.search(r"profiler capture server on :(\d+)", line)
            port = int(m.group(1)) if m else port
            if port and re.search(r"\bstep 2 loss=", line):
                break
        assert port, "".join(lines)[-3000:]
        status, headers, body = _get(
            f"http://127.0.0.1:{port}/capture?steps=2")
        assert status == 200, body[:500]
        assert _consecutive(headers["X-Capture-Steps"], 2)
        assert _updates(body) == 2
    finally:
        proc.kill()
        proc.communicate(timeout=60)
