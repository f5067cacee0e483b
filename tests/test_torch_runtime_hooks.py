"""The port's runtime hooks: PreemptionNotice, TraceWindow over
torch.profiler, eval (against the JAX eval_step), StepMeter spans, the
Prefetcher, /metrics, the launcher as a real subprocess (SIGTERM -> exit
75 -> resume, the TRACEPARENT span tree, live gauges), and serving from
a port checkpoint. All on the CPU at transformer-test size."""

import json
import math
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.runtime import preemption as jpreemption
from kubeflow_tpu.runtime import trainer as jtrainer
from kubeflow_tpu_torch.convert import flax_to_state_dict
from kubeflow_tpu_torch.obs import trace as obs_trace
from kubeflow_tpu_torch.runtime import checkpoint as ckpt
from kubeflow_tpu_torch.runtime import launcher
from kubeflow_tpu_torch.runtime import metrics as rt_metrics
from kubeflow_tpu_torch.runtime import records
from kubeflow_tpu_torch.runtime import trainer as ttrainer
from kubeflow_tpu_torch.runtime.data import Prefetcher, per_process_slice
from kubeflow_tpu_torch.runtime.preemption import EX_TEMPFAIL, PreemptionNotice
from kubeflow_tpu_torch.runtime.profiler import TraceWindow
from kubeflow_tpu_torch.serving import server as S

REPO = Path(__file__).resolve().parents[1]
BASE = dict(model="transformer-test", task="lm", global_batch=8, seq_len=32,
            vocab_size=256, learning_rate=1e-2, weight_decay=1e-4,
            warmup_steps=1, total_steps=4, log_every=1,
            model_kwargs={"dtype": "float32"})
TRACE_ID, PARENT_ID = "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"


def port(**kw) -> ttrainer.Trainer:
    return ttrainer.Trainer(ttrainer.TrainConfig.from_dict({**BASE, **kw}),
                            device="cpu")


def packed_shard(path: Path, seed: int, rows: int = 24) -> None:
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 256, int(n), dtype=np.int32)
            for n in rng.integers(4, 60, 3 * rows)]
    tok, seg = records.pack_documents(docs, BASE["seq_len"])
    records.write_packed_token_shard(str(path), tok[:rows], seg[:rows])


# -- PreemptionNotice --------------------------------------------------------

def test_preemption_notice_matches_the_reference():
    assert EX_TEMPFAIL == jpreemption.EX_TEMPFAIL == 75
    now = [100.0]
    for mod in (jpreemption, sys.modules[PreemptionNotice.__module__]):
        n = mod.PreemptionNotice(grace_s=30.0, clock=lambda: now[0])
        assert not n() and n.deadline is None and n.remaining_grace() is None
        n.trigger()
        now[0] += 10.0
        n.trigger()               # the first trigger keeps the deadline
        assert n() and n.deadline == 130.0
        assert n.remaining_grace() == 20.0
        now[0] += 100.0
        assert n.remaining_grace() == 0.0
        now[0] = 100.0


def test_preemption_notice_signal_install_and_uninstall(monkeypatch):
    monkeypatch.setenv("JAXJOB_TERMINATION_GRACE_S", "7")
    seen = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
    try:
        n = PreemptionNotice()
        assert n.grace_s == 7.0
        n.install(signal.SIGUSR1)
        assert n.install(signal.SIGUSR1) is n and n.installed
        with pytest.raises(ValueError, match="already installed"):
            n.install(signal.SIGUSR2)
        os.kill(os.getpid(), signal.SIGUSR1)
        for _ in range(100):
            if n():
                break
            time.sleep(0.01)
        assert n() and seen == [signal.SIGUSR1]      # chained, once
        n.uninstall()
        assert not n.installed and n()
        os.kill(os.getpid(), signal.SIGUSR1)
        time.sleep(0.05)
        assert seen == [signal.SIGUSR1] * 2           # the old handler back
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_stop_flag_saves_and_resumes(tmp_path):
    notice = PreemptionNotice()

    def cb(i, m):
        if i == 2:
            notice.trigger()

    d = str(tmp_path / "ckpt")
    t = port(total_steps=50, checkpoint_dir=d, checkpoint_every=1000)
    summary = t.fit(callback=cb, stop=notice)
    assert summary["preempted"] is True and t.step == 3
    assert ckpt.list_steps(d) == [3]
    t2 = port(total_steps=50, checkpoint_dir=d)
    s2 = t2.fit(steps=5)
    assert s2["start_step"] == 3 and "preempted" not in s2 and t2.step == 5


def test_preempt_before_the_first_step_gives_valid_json(tmp_path):
    notice = PreemptionNotice()
    notice.trigger()
    summary = port(checkpoint_dir=str(tmp_path)).fit(stop=notice)
    assert summary["preempted"] is True
    parsed = json.loads(json.dumps({"summary": summary}, allow_nan=False))
    assert parsed["summary"]["step_time_s"] is None
    assert ckpt.list_steps(str(tmp_path)) == [0]


def test_resume_then_preempt_keeps_the_checkpoint(tmp_path):
    d = str(tmp_path)
    port(checkpoint_dir=d).fit(steps=2)
    before = os.stat(os.path.join(d, "2", ckpt.PARAMS_FILE))
    notice = PreemptionNotice()
    notice.trigger()
    t = port(checkpoint_dir=d)
    assert t.fit(stop=notice)["preempted"] and t.step == 2
    after = os.stat(os.path.join(d, "2", ckpt.PARAMS_FILE))
    assert (after.st_ino, after.st_mtime_ns) == (before.st_ino,
                                                 before.st_mtime_ns)


# -- TraceWindow ---------------------------------------------------------------

def test_trace_window_state_machine(tmp_path):
    w = TraceWindow(str(tmp_path / "t"), start_step=2, num_steps=2)
    w.step(0)
    assert not w.active
    w.step(2)
    assert w.active
    w.step(3)
    assert w.active
    w.step(4)
    assert not w.active and w.captured and os.path.exists(w.path)
    w.step(2)                                  # armed once
    assert not w.active
    w.stop()                                   # safe twice
    off = TraceWindow(None)
    off.step(2)
    assert not off.active and not off.captured


def test_fit_writes_a_chrome_trace(tmp_path):
    d = tmp_path / "prof"
    summary = port(total_steps=5, profile_dir=str(d), profile_start_step=1,
                   profile_steps=2).fit()
    assert math.isfinite(summary["final"]["loss"])
    traces = list(d.glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


# -- eval ----------------------------------------------------------------------

def test_eval_matches_the_jax_eval_step(tmp_path):
    packed_shard(tmp_path / "eval.kfr", seed=1)
    cfg = dict(eval_data_path=str(tmp_path / "eval.kfr"), packed_data=True,
               eval_steps=2)
    jt = jtrainer.Trainer(jtrainer.TrainConfig.from_dict({**BASE, **cfg}))
    state = jt.init_state()
    t = port(**cfg)
    t.model.load_state_dict(flax_to_state_dict(jax.device_get(state.params)))
    it_j, it_t = jt.eval_data_iter(), t.eval_data_iter()
    want, got = [], []
    for _ in range(2):
        bj, bt = next(it_j), next(it_t)
        assert "segment_ids" in bt and bt.keys() == bj.keys()
        want.append({k: float(v) for k, v in jt.eval_step(state, bj).items()})
        got.append({k: float(v) for k, v in
                    t.eval_step(t._to_device(bt)).items()})
    it_j.close()
    it_t.close()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["accuracy"], w["accuracy"], atol=1e-6)
    assert t.model.training                      # eval left train mode on


def test_fit_eval_summary_and_gauges(tmp_path):
    packed_shard(tmp_path / "train.kfr", seed=2)
    packed_shard(tmp_path / "eval.kfr", seed=3)
    t = port(data_path=str(tmp_path / "train.kfr"), packed_data=True,
             eval_every=2, eval_steps=2,
             eval_data_path=str(tmp_path / "eval.kfr"))
    summary = t.fit(steps=2)
    ev = summary["eval"]
    want = [t.eval_step(t._to_device(b)) for b, _ in
            zip(t.eval_data_iter(), range(2))]
    np.testing.assert_allclose(
        ev["loss"], sum(float(m["loss"]) for m in want) / 2, rtol=1e-6)
    assert ev["perplexity"] == pytest.approx(math.exp(ev["loss"]))
    assert ev["smoke"] == 0.0
    for key in ("loss", "accuracy", "perplexity", "smoke"):
        [(_, value)] = rt_metrics.REGISTRY.series(f"jaxrt_eval_{key}")
        assert value == pytest.approx(ev[key])
    # without eval_data_path: the training source at seed + 1, a smoke eval
    s2 = port(data_path=str(tmp_path / "train.kfr"), packed_data=True,
              eval_every=1, eval_steps=1).fit(steps=1)
    assert s2["eval"]["smoke"] == 1.0


# -- StepMeter spans and the fit tree -------------------------------------------

def test_step_meter_spans():
    tracer = obs_trace.Tracer()
    meter = rt_metrics.StepMeter(1e9, "", tracer=tracer, step_base=5)
    for _ in range(2):
        meter.start()
        meter.stop()
    meter.start()                   # this step raises before stop()
    meter.close()
    meter.close()                   # idempotent
    meter.start()
    meter.start()                   # an unfinished start: exported as ERROR
    meter.stop()
    spans = tracer.collector.spans()
    assert [s.attrs["step"] for s in spans] == [5, 6, 7, 7, 7]
    assert [s.status for s in spans] == ["OK", "OK", "ERROR", "ERROR", "OK"]
    assert all(s.name == "train.step" for s in spans)
    with pytest.raises(RuntimeError, match="without start"):
        rt_metrics.StepMeter(1.0).stop()


def test_fit_spans_nest_under_the_ambient_parent(tmp_path):
    obs_trace.COLLECTOR.clear()
    ctx = obs_trace.parse_traceparent(f"00-{TRACE_ID}-{PARENT_ID}-01")
    token = obs_trace.TRACER.attach(ctx)
    try:
        port(checkpoint_dir=str(tmp_path), checkpoint_every=2).fit(steps=3)
    finally:
        obs_trace.TRACER.detach(token)
    spans = [s for s in obs_trace.COLLECTOR.spans() if s.trace_id == TRACE_ID]
    fit = [s for s in spans if s.name == "train.fit"]
    assert len(fit) == 1 and fit[0].parent_id == PARENT_ID
    steps = [s for s in spans if s.name == "train.step"]
    assert [s.attrs["step"] for s in steps] == [0, 1, 2]
    assert steps[0].attrs.get("compile") is True
    saves = [s for s in spans if s.name == "train.checkpoint"]
    assert [s.attrs["step"] for s in saves] == [2, 3]
    assert all(s.parent_id == fit[0].span_id for s in steps + saves)
    assert all(s.span_id in obs_trace.reachable(spans, PARENT_ID)
               for s in spans)


# -- Prefetcher -----------------------------------------------------------------

def test_prefetcher_order_values_and_end():
    batches = [{"tokens": np.full((2, 3), i, np.int32)} for i in range(5)]
    pf = Prefetcher(iter(batches), "cpu")
    got = [int(b["tokens"][0, 0]) for b in pf]
    assert got == list(range(5))
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()


def test_prefetcher_surfaces_errors_and_close_stops_the_source():
    closed = threading.Event()

    def source():
        try:
            i = 0
            while True:
                yield {"x": np.array([i])}
                i += 1
        finally:
            closed.set()

    pf = Prefetcher(source(), "cpu", depth=2)
    assert int(next(pf)["x"][0]) == 0
    pf.close()
    assert closed.is_set() and not pf._thread.is_alive()

    def bad():
        yield {"x": np.array([1])}
        raise ValueError("shard gone")

    pf = Prefetcher(bad(), "cpu")
    next(pf)
    with pytest.raises(ValueError, match="shard gone"):
        next(pf)
    pf.close()


def test_per_process_slice():
    b = {"tokens": np.arange(8).reshape(8, 1)}
    assert per_process_slice(b, 4, 1)["tokens"].ravel().tolist() == [2, 3]
    with pytest.raises(ValueError, match="divisible"):
        per_process_slice(b, 3, 0)


def test_serve_metrics_endpoints():
    rt_metrics.REGISTRY.gauge("jaxrt_test_gauge", 1.5, "a test gauge")
    svc = rt_metrics.serve_metrics(0, host="127.0.0.1")
    try:
        base = f"http://127.0.0.1:{svc.port}"
        text = urllib.request.urlopen(base + "/metrics", timeout=10).read()
        assert b"jaxrt_test_gauge 1.5" in text
        assert urllib.request.urlopen(base + "/healthz", timeout=10).status == 200
    finally:
        svc.shutdown()


# -- the launcher ----------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp_path, cfg: dict, env_extra: dict):
    path = tmp_path / f"cfg{len(list(tmp_path.glob('cfg*')))}.json"
    path.write_text(json.dumps(cfg))
    env = {**os.environ, **env_extra,
           "PYTHONPATH": os.pathsep.join(
               [str(REPO), os.environ.get("PYTHONPATH", "")])}
    return subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.runtime.launcher",
         "--config", str(path), "--device", "cpu"],
        cwd=str(REPO), env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)


def _lines(proc) -> "queue.Queue[str | None]":
    q: queue.Queue = queue.Queue()

    def pump():
        for line in proc.stdout:
            q.put(line)
        q.put(None)

    threading.Thread(target=pump, daemon=True).start()
    return q


def test_launcher_sigterm_exits_tempfail_and_resumes(tmp_path):
    d = tmp_path / "ckpt"
    trace_file = tmp_path / "trace.jsonl"
    metrics_port = _free_port()
    cfg = {**BASE, "total_steps": 100000, "checkpoint_dir": str(d),
           "checkpoint_every": 100000, "model_kwargs": {"dtype": "float32"}}
    proc = _launch(tmp_path, cfg, {
        "TRACEPARENT": f"00-{TRACE_ID}-{PARENT_ID}-01",
        "KFTPU_TRACE_FILE": str(trace_file),
        "JAXRT_METRICS_PORT": str(metrics_port)})
    lines, out = _lines(proc), []
    try:
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            line = lines.get(timeout=240)
            assert line is not None, "".join(out)
            out.append(line)
            if " step 3 loss=" in line:
                break
        metrics = urllib.request.urlopen(
            f"http://127.0.0.1:{metrics_port}/metrics", timeout=30).read()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    while (line := lines.get(timeout=30)) is not None:
        out.append(line)
    text = "".join(out)
    for gauge in (b"jaxrt_step_seconds", b"jaxrt_examples_per_sec",
                  b"jaxrt_loss"):
        assert gauge in metrics
    assert rc == EX_TEMPFAIL, text[-3000:]
    summary = json.loads(out[-1], parse_constant=lambda c: pytest.fail(c))[
        "summary"]
    assert summary["preempted"] is True
    step = ckpt.list_steps(str(d))[-1]
    assert f"preempted at step {step}" in text and step >= 3
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["latest_step"] == step

    spans = obs_trace.read_jsonl(str(trace_file))
    worker = [s for s in spans if s.name == "worker"]
    fit = [s for s in spans if s.name == "train.fit"]
    assert len(worker) == 1 and worker[0].parent_id == PARENT_ID
    assert worker[0].trace_id == TRACE_ID
    assert len(fit) == 1 and fit[0].parent_id == worker[0].span_id
    assert fit[0].attrs["preempted"] is True
    inside = [s for s in spans if s.name in ("train.step", "train.checkpoint")]
    assert {s.name for s in inside} == {"train.step", "train.checkpoint"}
    assert all(s.parent_id == fit[0].span_id for s in inside)
    assert len(obs_trace.reachable(spans, PARENT_ID)) == len(spans) + 1
    # the reference's converter reads the port's dump unchanged
    conv = subprocess.run(
        [sys.executable, str(REPO / "tools" / "trace2perfetto.py"),
         str(trace_file), "-o", str(tmp_path / "t.json")],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path))
    assert conv.returncode == 0, conv.stderr
    names = {e["name"] for e in json.loads(
        (tmp_path / "t.json").read_text())["traceEvents"]}
    assert {"worker", "train.fit", "train.step"} <= names

    # the gang restart: the same config to step + 2 resumes from the save
    proc = _launch(tmp_path, {**cfg, "total_steps": step + 2}, {})
    text, _ = proc.communicate(timeout=240)
    assert proc.returncode == 0, text[-3000:]
    s2 = json.loads(text.strip().splitlines()[-1])["summary"]
    assert s2["start_step"] == step and s2["steps"] == step + 2
    assert f"resumed from checkpoint at step {step}" in text


def test_launcher_user_command_and_refusals(monkeypatch):
    assert launcher.main(["--", sys.executable, "-c",
                          "import sys; sys.exit(3)"]) == 3
    with pytest.raises(SystemExit):
        launcher.main([])
    monkeypatch.setenv("JAXJOB_NUM_PROCESSES", "2")
    with pytest.raises(NotImplementedError, match="item 16"):
        launcher.main(["--", sys.executable, "-c", "pass"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(TimeoutError, match="no CUDA devices"):
        launcher.wait_for_devices(timeout_s=0.0)


# -- serving from a checkpoint -------------------------------------------------------

SERVE = dict(prompt_len=8, max_new_tokens=6, device="cpu", dtype="float32")
INSTANCES = [{"tokens": [9, 8, 7, 6, 5]}, {"tokens": [1, 2, 3]},
             {"tokens": list(range(1, 12))}]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("served") / "ckpt"
    # another seed than serving's random weights (seed 0)
    t = port(checkpoint_dir=str(d), seed=5)
    t.fit(steps=3)
    return d, {k: v.detach().clone() for k, v in t.model.state_dict().items()}


@pytest.mark.parametrize("continuous", [False, True])
def test_served_checkpoint_equals_in_memory_params(trained, continuous):
    d, state = trained
    kw = dict(SERVE, continuous_batching=continuous, decode_slots=2)
    from_ckpt = S.serve_lm_generator("a", "transformer-test",
                                     checkpoint_dir=str(d), **kw)
    in_memory = S.serve_lm_generator("b", "transformer-test",
                                     state_dict=state, **kw)
    random_w = S.serve_lm_generator("c", "transformer-test", **kw)
    try:
        got = [list(map(int, r)) for r in from_ckpt.predict(INSTANCES)]
        want = [list(map(int, r)) for r in in_memory.predict(INSTANCES)]
        other = [list(map(int, r)) for r in random_w.predict(INSTANCES)]
    finally:
        for m in (from_ckpt, in_memory, random_w):
            m.close()
    assert got == want and got != other


def test_served_draft_from_checkpoint(trained):
    """The target's own checkpoint as the draft: the tokens equal plain
    greedy decode and the draft's proposals are accepted (but for the
    last round's overshoot), where a random draft's almost never are."""
    d, _ = trained

    def acceptance(name):
        def total(metric):
            return sum(v for lab, v in rt_metrics.REGISTRY.series(metric)
                       if lab.get("model") == name)

        return (total("serving_speculative_accepted_total")
                / total("serving_speculative_drafted_total"))

    plain = S.serve_lm_generator("p", "transformer-test",
                                 checkpoint_dir=str(d), **SERVE)
    outs = {}
    try:
        want = [list(map(int, r)) for r in plain.predict(INSTANCES)]
        for name, extra in (("self", {"draft_checkpoint_dir": str(d)}),
                            ("rand", {})):
            served = S.serve_lm_generator(
                name, "transformer-test", checkpoint_dir=str(d),
                draft_model="transformer-test", draft_k=3, **extra, **SERVE)
            try:
                outs[name] = [list(map(int, r))
                              for r in served.predict(INSTANCES)]
            finally:
                served.close()
    finally:
        plain.close()
    assert outs["self"] == outs["rand"] == want
    assert acceptance("self") > 0.8 > 0.2 > acceptance("rand")


def test_empty_checkpoint_dir_fails_registration(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        S.serve_lm_generator("x", "transformer-test",
                             checkpoint_dir=str(tmp_path / "empty"), **SERVE)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        S.main(["--lm", f"chat=transformer-test@{tmp_path / 'empty'}",
                "--device", "cpu", "--port", "0"])
