"""The port launcher as a gang of gloo processes on the CPU
(`python -m kubeflow_tpu_torch.runtime.launcher --device cpu`, one
process per JAXJOB_PROCESS_ID): a SIGTERM to one rank stops both at the
same step (the stop flag is all-reduced every step), both save that step
together and exit 75; a checkpoint saved by a world of 2 resumes in a
world of 1 and one saved by a world of 1 resumes in a world of 2, each
ending equal to a straight run (params within 1e-6, loss within 1e-5,
f32), and so does one saved by a world of 2 to a `file://` URI (the
fsspec path, a step committed by its marker); a save or write that fails on rank 0 fails every rank promptly,
with no rank left waiting in another collective.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from kubeflow_tpu_torch.obs.trace import read_jsonl
from kubeflow_tpu_torch.runtime.checkpoint import restore_params
from test_torch_dist import NICE, ROOT, free_port, run_world

CFG = dict(model="transformer-test", task="lm", global_batch=4, seq_len=16,
           vocab_size=256, optimizer="sgdm", learning_rate=0.05,
           warmup_steps=0, log_every=1, model_kwargs={"dtype": "float32"})
TIMEOUT = 180


def _start(tmp_path, tag: str, cfg: dict, world: int) -> list:
    """`world` launcher processes on `cfg`; their output goes to files."""
    path = tmp_path / f"{tag}.json"
    path.write_text(json.dumps(cfg))
    port = free_port()
    procs = []
    for rank in range(world):
        out = open(tmp_path / f"{tag}.rank{rank}.log", "w")
        env = {**os.environ, "JAXJOB_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "JAXJOB_NUM_PROCESSES": str(world),
               "JAXJOB_PROCESS_ID": str(rank), "JAXRT_METRICS_PORT": "0",
               "OMP_NUM_THREADS": "1"}
        procs.append((subprocess.Popen(
            [*NICE, sys.executable, "-m",
             "kubeflow_tpu_torch.runtime.launcher", "--config", str(path),
             "--device", "cpu"],
            cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT), out))
    return procs


def _finish(procs, tmp_path, tag: str) -> list[tuple[int, str, dict]]:
    """(exit code, output, summary) of each rank."""
    res = []
    try:
        for rank, (p, out) in enumerate(procs):
            rc = p.wait(timeout=TIMEOUT)
            out.close()
            text = (tmp_path / f"{tag}.rank{rank}.log").read_text()
            lines = [ln for ln in text.splitlines()
                     if ln.startswith('{"summary"')]
            assert lines, f"{tag} rank {rank} exit {rc}:\n{text[-3000:]}"
            res.append((rc, text, json.loads(lines[-1])["summary"]))
    finally:
        for p, out in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
    return res


def _run(tmp_path, tag, cfg, world):
    res = _finish(_start(tmp_path, tag, cfg, world), tmp_path, tag)
    for rc, text, _ in res:
        assert rc == 0, text[-3000:]
    return res


def test_sigterm_on_one_rank_stops_the_gang_at_one_step(tmp_path):
    ckpt = tmp_path / "ckpt"
    cfg = dict(CFG, total_steps=100_000, checkpoint_dir=str(ckpt))
    procs = _start(tmp_path, "gang", cfg, 2)
    log1 = tmp_path / "gang.rank1.log"
    deadline = time.monotonic() + TIMEOUT
    while "step 3 loss=" not in log1.read_text():
        assert time.monotonic() < deadline and procs[1][0].poll() is None, \
            log1.read_text()[-3000:]
        time.sleep(0.05)
    procs[1][0].send_signal(signal.SIGTERM)
    res = _finish(procs, tmp_path, "gang")
    assert [rc for rc, _, _ in res] == [75, 75], [t[-2000:] for _, t, _ in res]
    assert all(s["preempted"] for _, _, s in res)
    stopped = [int(t.split("preempted at step ")[1].split(":")[0])
               for _, t, _ in res]
    assert stopped[0] == stopped[1] >= 3
    manifest = json.loads((ckpt / "manifest.json").read_text())
    assert manifest["latest_step"] == stopped[0]
    assert manifest["world_sizes"] == {str(stopped[0]): 2}


@pytest.mark.parametrize("first,second", [(2, 1), (1, 2)])
def test_checkpoint_moves_between_world_sizes(tmp_path, first, second):
    moved, straight = tmp_path / "moved", tmp_path / "straight"
    procs = _start(tmp_path, "straight", dict(
        CFG, total_steps=6, checkpoint_dir=str(straight)), 1)
    # the first world trains to 6 saving every 3 steps; its step 6 goes,
    # so the second world resumes from step 3 on the same schedule
    _run(tmp_path, "first", dict(CFG, total_steps=6, checkpoint_every=3,
                                 checkpoint_dir=str(moved)), first)
    shutil.rmtree(moved / "6")
    res = _run(tmp_path, "second", dict(CFG, total_steps=6,
                                        checkpoint_dir=str(moved)), second)
    assert all(s["start_step"] == 3 for _, _, s in res)
    assert all("resumed from checkpoint at step 3" in t for _, t, _ in res)
    want = _finish(procs, tmp_path, "straight")[0]
    assert want[0] == 0
    np.testing.assert_allclose(res[0][2]["final"]["loss"],
                               want[2]["final"]["loss"], atol=1e-5)
    got, step = restore_params(str(moved))
    ref, ref_step = restore_params(str(straight))
    assert step == ref_step == 6
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-6,
                                   err_msg=k)
    manifest = json.loads((moved / "manifest.json").read_text())
    assert manifest["world_sizes"]["6"] == second


def test_gang_resumes_through_a_file_uri(tmp_path):
    """A world of 2 checkpoints to a `file://` URI (the fsspec path: each
    step committed by its marker), loses its last step, and a world of 1
    resumes from the URI; it ends equal to a straight run in this
    process (params within 1e-6, loss within 1e-5)."""
    from kubeflow_tpu_torch.runtime.checkpoint import COMMIT_FILE, list_steps
    from kubeflow_tpu_torch.runtime.trainer import TrainConfig, Trainer

    uri = f"file://{tmp_path / 'moved'}"
    _run(tmp_path, "first", dict(CFG, total_steps=6, checkpoint_every=3,
                                 checkpoint_dir=uri), 2)
    assert list_steps(uri) == [3, 6]
    # step 6 loses its marker (a write cut short): never a step
    os.remove(tmp_path / "moved" / "6" / COMMIT_FILE)
    res = _run(tmp_path, "second", dict(CFG, total_steps=6,
                                        checkpoint_dir=uri), 1)
    assert res[0][2]["start_step"] == 3
    assert "resumed from checkpoint at step 3" in res[0][1]
    straight = Trainer(TrainConfig.from_dict(dict(CFG, total_steps=6)),
                       device="cpu")
    want = straight.fit()
    np.testing.assert_allclose(res[0][2]["final"]["loss"],
                               want["final"]["loss"], atol=1e-5)
    got, step = restore_params(uri)
    assert step == 6
    for k, v in straight.model.state_dict().items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-6,
                                   err_msg=k)


def test_nproc_per_node_starts_one_worker_per_device(tmp_path):
    """One launcher with --nproc-per-node 2 (a pod of JAXJOB_PROCESS_ID 0
    in a world of 1 pod) runs two workers, global ranks 0 and 1 of a
    world of 2, each with its own span dump; the gang trains as one."""
    path = tmp_path / "c.json"
    path.write_text(json.dumps(dict(CFG, total_steps=2, mesh={"data": 2})))
    env = {**os.environ, "JAXJOB_COORDINATOR_ADDRESS":
           f"127.0.0.1:{free_port()}", "JAXJOB_NUM_PROCESSES": "1",
           "JAXJOB_PROCESS_ID": "0", "JAXRT_METRICS_PORT": "0",
           "KFTPU_TRACE_FILE": str(tmp_path / "trace.jsonl"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [*NICE, sys.executable, "-m", "kubeflow_tpu_torch.runtime.launcher",
         "--config", str(path), "--device", "cpu", "--nproc-per-node", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    text = out.stdout + out.stderr
    assert "process 0/2" in text and "process 1/2" in text
    assert "Mesh(data=2) on 2x cpu" in text
    assert text.count('{"summary"') == 2
    for r in range(2):
        spans = read_jsonl(str(tmp_path / f"trace.jsonl.local{r}"))
        steps = {s.span_id for s in spans if s.name == "train.step"}
        reduces = [s for s in spans if s.name == "train.grad_reduce"]
        # one reduce a step, closed at the step loop's sync, in its step
        assert len(reduces) == len(steps) == 2
        assert all(s.parent_id in steps and s.duration > 0 for s in reduces)


def failing_save_worker(rank, n, out_dir):
    """Two gloo ranks fit transformer-test while rank 0's checkpoint fails
    in three ways, one fit each, in one world: its background write
    (surfacing at the next save), the device -> host copy inside save,
    and the write of the final save (surfacing at close). Each rank
    records the error fit raised and how long it took. Collectives time
    out after 30 s here: a rank left waiting in another collective than
    rank 0's would show as a timeout, not as the errors the test
    expects."""
    import time

    from kubeflow_tpu_torch.parallel import dist as D
    from kubeflow_tpu_torch.runtime import checkpoint as C
    from kubeflow_tpu_torch.runtime.trainer import TrainConfig, Trainer

    D.FORMATION_TIMEOUT_S = 30.0
    D.initialize_from_env(device="cpu")

    def bad_write(self, step, host):
        self._write_error = OSError("disk full")

    def bad_copy(state):
        raise RuntimeError("copy failed")

    out = {}
    for case, every, patch in (("write", 1, (C.Checkpointer, "_write",
                                             bad_write)),
                               ("copy", 1, (C, "_to_host", bad_copy)),
                               ("final", 0, (C.Checkpointer, "_write",
                                             bad_write))):
        cfg = TrainConfig.from_dict(dict(
            CFG, total_steps=3, checkpoint_every=every,
            checkpoint_dir=os.path.join(out_dir, case)))
        trainer = Trainer(cfg, device="cpu")
        obj, name, fn = patch
        old = getattr(obj, name)
        if rank == 0:
            setattr(obj, name, fn)
        t0 = time.monotonic()
        try:
            trainer.fit()
            out[case] = ["none", time.monotonic() - t0]
        except Exception as e:
            out[case] = [type(e).__name__, time.monotonic() - t0]
        finally:
            setattr(obj, name, old)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    D.shutdown()


def test_a_failed_save_on_rank_0_fails_every_rank_promptly(tmp_path):
    run_world(2, "test_torch_gang:failing_save_worker", tmp_path, timeout=150)
    got = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(2)]
    assert {c: e for c, (e, _) in got[0].items()} == {
        "write": "OSError", "copy": "RuntimeError", "final": "OSError"}
    assert {c: e for c, (e, _) in got[1].items()} == {
        "write": "CheckpointError", "copy": "CheckpointError",
        "final": "CheckpointError"}
    assert max(dt for r in got for _, dt in r.values()) < 20.0, got
