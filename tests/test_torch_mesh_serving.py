"""The port's LM served over a device mesh (serving/mesh.py) on the CPU:
a gloo world of 4 processes, rank 0 holding the ModelServer, the others
following, against one port process and against the reference's meshed
`serve_lm_generator` on the 8 virtual CPU devices, f32, transformer-test
(4 q / 2 kv heads) at weights converted from the reference's flax tree.

- `{"fsdp": 2, "model": 2}` and the replicated-kv `{"model": 4}` (2 kv
  heads over 4 ranks: each rank's cache holds the heads its q heads
  use): greedy tokens of the generate path and of the slot decoder, with
  and without the rolling cache, equal one process's and the
  reference's; logits of the meshed model within the reference's 1e-4;
  sampled tokens (temperature > 0) equal one process's (rank 0 samples
  and shares them); a port checkpoint written by a one-process Trainer
  served over the mesh; an HTTP round trip to rank 0 and
  `signature_def["mesh"]`.
- the CLI: `--mesh model=2` with no world in the env starts its two
  ranks itself and stops them in order on SIGTERM (exit 0); under the
  launcher's `--nproc-per-node 2` the same command runs two ranks, and a
  follower killed under it turns rank 0 unready and fails its process.
- registration: a missing checkpoint, the power-of-two rule of the data
  axes, and the reference's refusals under a mesh (paged cache, a draft,
  int8 weights), with its exception types.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import torch

from test_torch_dist import NICE, ROOT, free_port, run_world

P, N, VOCAB = 8, 4, 64
INSTANCES = [{"tokens": [1, 2, 3]}, {"tokens": list(range(1, 12))},
             {"tokens": [9]}, {"tokens": [5, 4, 3, 2, 1]}]
ROLLING = dict(attention_window=4, rolling_kv_cache=True)
FSDP_MODEL = {"fsdp": 2, "model": 2}
MODEL4 = {"model": 4}
# name -> (mesh, serve_lm_generator kwargs)
CASES = {
    "fsdp_model_generate": (FSDP_MODEL, {}),
    "fsdp_model_slots_rolling": (FSDP_MODEL, dict(
        ROLLING, continuous_batching=True, decode_slots=2)),
    "model4_slots": (MODEL4, dict(continuous_batching=True, decode_slots=4)),
    "model4_generate_rolling": (MODEL4, ROLLING),
    "model4_sampled": (MODEL4, dict(temperature=0.8, top_k=8)),
}
LOGITS_TOL = 1e-4       # the reference's, sharded vs unsharded


def serve(mesh=None, state_dict=None, name="lm", **kw):
    from kubeflow_tpu_torch.serving import server as S

    return S.serve_lm_generator(
        name, "transformer-test", device="cpu", dtype="float32",
        prompt_len=P, max_new_tokens=N, vocab_size=VOCAB, mesh=mesh,
        state_dict=state_dict, **kw)


def mesh_worker(rank, n, out_dir):
    """Every case's model on this rank; rank 0 predicts, the others
    follow until rank 0's ModelServer closes."""
    from kubeflow_tpu_torch.parallel import dist as D
    from kubeflow_tpu_torch.serving import mesh as serving_mesh
    from kubeflow_tpu_torch.serving import server as S

    D.initialize_from_env(device="cpu")
    weights = torch.load(os.path.join(out_dir, "init.pt"), weights_only=True)
    server = S.ModelServer()
    served = {}
    for name, (mesh, kw) in CASES.items():
        served[name] = serve(mesh, weights, name=name, **kw)
        server.register(served[name])
    served["checkpoint"] = serve(
        FSDP_MODEL, name="checkpoint", continuous_batching=True,
        decode_slots=2, checkpoint_dir=os.path.join(out_dir, "ckpt"))
    server.register(served["checkpoint"])
    # the logits of the meshed model itself: an op of its own
    sm = serving_mesh.ServingMesh(MODEL4, device="cpu")
    from kubeflow_tpu_torch.models.registry import get_model

    model = get_model("transformer-test", device="cpu", dtype="float32",
                      vocab_size=VOCAB, max_seq_len=P + N)
    model.load_state_dict(weights)
    sm.place(model)
    logits_id = sm.register(lambda op, words, tensors: model(tensors[0]))
    if rank > 0:
        serving_mesh.follow()
        D.shutdown()
        return
    out = {name: m.predict(INSTANCES) for name, m in served.items()}
    out["logits"] = sm.call(logits_id, 0, (), [torch.tensor(
        [[3, 1, 4, 1, 5, 9, 2, 6]])])
    out["kv_heads"] = model.cache_kv_heads()
    svc = server.serve(host="127.0.0.1", port=0)
    svc.serve_background()
    base = f"http://127.0.0.1:{svc.port}"
    req = urllib.request.Request(
        f"{base}/v1/models/fsdp_model_generate:predict",
        data=json.dumps({"instances": INSTANCES}).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        out["http"] = json.loads(resp.read())["predictions"]
    with urllib.request.urlopen(
            f"{base}/v1/models/fsdp_model_generate/metadata",
                                timeout=60) as resp:
        out["metadata"] = json.loads(resp.read())
    with urllib.request.urlopen(f"{base}/readyz", timeout=60) as resp:
        out["readyz"] = resp.status
    svc.shutdown()
    server.close()         # the followers stop
    torch.save(out, os.path.join(out_dir, "rank0.pt"))
    D.shutdown()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's f32 transformer-test weights (PRNGKey(0)) as a
    port state dict, a port checkpoint after one one-process training
    step, and the reference's meshed greedy tokens."""
    import jax
    import jax.numpy as jnp
    from flax.core import meta

    from kubeflow_tpu.models.registry import get_model as jax_get_model
    from kubeflow_tpu.serving.server import serve_lm_generator as jax_serve
    from kubeflow_tpu_torch.convert import flax_to_state_dict
    from kubeflow_tpu_torch.runtime.trainer import TrainConfig, Trainer

    root = tmp_path_factory.mktemp("mesh_lm")
    jm = jax_get_model("transformer-test", vocab_size=VOCAB,
                       max_seq_len=P + N, dtype=jnp.float32)
    params = meta.unbox(jm.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 1), jnp.int32),
                                train=False)["params"])
    weights = flax_to_state_dict(jax.device_get(params))
    torch.save(weights, root / "init.pt")
    trainer = Trainer(TrainConfig.from_dict(dict(
        model="transformer-test", task="lm", global_batch=4, seq_len=P,
        vocab_size=VOCAB, total_steps=1, warmup_steps=0, log_every=10**9,
        checkpoint_dir=str(root / "ckpt"), checkpoint_every=1,
        model_kwargs={"dtype": "float32", "max_seq_len": P + N})),
        device="cpu")
    trainer.fit()
    ref = {}
    for name, mesh, kw in (("fsdp_model", FSDP_MODEL, {}),
                           ("model4_slots", MODEL4,
                            dict(continuous_batching=True, decode_slots=4))):
        served = jax_serve("x", "transformer-test", dtype=jnp.float32,
                           prompt_len=P, max_new_tokens=N, vocab_size=VOCAB,
                           mesh=mesh, **kw)
        try:
            ref[name] = served.predict(INSTANCES)
        finally:
            served.close()
    return root, weights, ref


@pytest.fixture(scope="module")
def world(reference):
    root, _, _ = reference
    run_world(4, "test_torch_mesh_serving:mesh_worker", root, timeout=300)
    return torch.load(root / "rank0.pt", weights_only=False)


def _single(weights, **kw):
    served = serve(None, weights, **kw)
    try:
        return served.predict(INSTANCES)
    finally:
        served.close()


@pytest.mark.parametrize("name", sorted(CASES))
def test_meshed_tokens_equal_one_process(name, world, reference):
    _, weights, _ = reference
    _, kw = CASES[name]
    got = [list(map(int, r)) for r in world[name]]
    assert got == [list(map(int, r)) for r in _single(weights, **kw)]


def test_meshed_tokens_equal_the_reference_mesh(world, reference):
    """Greedy, dense cache: the port's meshed generate path and slot
    decoder, its one process, and the reference's meshed server agree."""
    _, _, ref = reference
    want = [list(map(int, r)) for r in ref["fsdp_model"]]
    assert [list(map(int, r))
            for r in ref["model4_slots"]] == want
    for name in ("fsdp_model_generate", "model4_slots"):
        assert [list(map(int, r)) for r in world[name]] == want


def test_meshed_logits_and_local_kv_heads(world, reference):
    from kubeflow_tpu_torch.models.registry import get_model

    _, weights, _ = reference
    model = get_model("transformer-test", device="cpu", dtype="float32",
                      vocab_size=VOCAB, max_seq_len=P + N)
    model.load_state_dict(weights)
    with torch.no_grad():
        want = model(torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6]]))
    assert float((world["logits"] - want).abs().max()) <= LOGITS_TOL
    # 2 kv heads, 4 q heads over model 4: rank 0's q head uses kv head 0
    assert world["kv_heads"] == 1 and model.cache_kv_heads() == 2


def test_checkpoint_http_and_signature(world, reference, tmp_path):
    from kubeflow_tpu_torch.serving import server as S

    root, weights, _ = reference
    single = S.serve_lm_generator(
        "lm", "transformer-test", device="cpu", dtype="float32",
        prompt_len=P, max_new_tokens=N, vocab_size=VOCAB,
        checkpoint_dir=str(root / "ckpt"))
    try:
        want = single.predict(INSTANCES)
    finally:
        single.close()
    assert [list(map(int, r)) for r in world["checkpoint"]] == \
        [list(map(int, r)) for r in want]
    assert world["http"] == [list(map(int, r))
                             for r in world["fsdp_model_generate"]]
    sig = world["metadata"]["metadata"]["signature_def"]
    assert sig["mesh"] == FSDP_MODEL and sig["method_name"] == "generate"
    assert world["readyz"] == 200


def test_registration_refusals(tmp_path, monkeypatch):
    """What the reference refuses under a mesh, the port refuses at
    registration with the same exception types, before any world forms."""
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        serve({"model": 2}, checkpoint_dir=str(tmp_path / "empty"))
    for kw, match in ((dict(continuous_batching=True, kv_pages=8,
                            kv_page_size=4), "paged KV cache"),
                      (dict(draft_model="transformer-test"),
                       "speculative decoding"),
                      (dict(param_dtype="int8"), "single-chip")):
        with pytest.raises(ValueError, match=match):
            serve({"model": 2}, **kw)
    monkeypatch.setenv("JAXJOB_NUM_PROCESSES", "3")
    with pytest.raises(ValueError, match="power of two"):
        serve({"data": 3})
    monkeypatch.setenv("JAXJOB_NUM_PROCESSES", "1")
    with pytest.raises(ValueError, match="device count 1"):
        serve({"model": 2})


def test_a_mesh_of_one_rank_serves_in_this_process(reference):
    """A mesh whose axes are all 1 needs no world: the one-process path
    serves it, under the mesh's refusals, its signature names the mesh,
    and the tokens are one process's."""
    _, weights, _ = reference
    one = {"data": 1, "model": 1}
    for kw, match in ((dict(continuous_batching=True, kv_pages=8,
                            kv_page_size=4), "paged KV cache"),
                      (dict(draft_model="transformer-test"),
                       "speculative decoding"),
                      (dict(param_dtype="int8"), "single-chip")):
        with pytest.raises(ValueError, match=match):
            serve(one, weights, **kw)
    served = serve(one, weights, continuous_batching=True, decode_slots=2)
    try:
        got = served.predict(INSTANCES)
        assert served.signature["mesh"] == {"data": 1, "model": 1}
    finally:
        served.close()
    assert [list(map(int, r)) for r in got] == \
        [list(map(int, r)) for r in _single(weights)]


# -- the CLI -------------------------------------------------------------------


def _get(url: str, body=None, timeout=60):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _wait_ready(base: str, proc, timeout: float = 120.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.communicate()[0][-3000:]
        try:
            if _get(f"{base}/readyz", timeout=5)[0] == 200:
                return
        except OSError:
            pass
        time.sleep(0.3)
    raise AssertionError("the meshed server never became ready")


def _ranks(parent: int) -> dict[int, int]:
    """{JAXJOB_PROCESS_ID: pid} of the `python -m kubeflow_tpu_torch.serving`
    processes among `parent`'s descendants."""
    procs = {}
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0")
                           if b"=" in kv)
        except (OSError, ValueError, IndexError):
            continue
        procs[int(pid)] = (ppid, argv, env)
    mine, grew = {parent}, True
    while grew:
        kids = {p for p, (pp, _, _) in procs.items() if pp in mine} - mine
        mine |= kids
        grew = bool(kids)
    return {int(env[b"JAXJOB_PROCESS_ID"]): pid
            for pid, (_, argv, env) in procs.items()
            if pid in mine and pid != parent
            and argv[1:3] == [b"-m", b"kubeflow_tpu_torch.serving"]}


def _kill_tree(proc) -> None:
    """SIGKILL `proc` and its serving ranks (a killed starter leaves
    them running)."""
    for pid in _ranks(proc.pid).values():
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


CLI = ["--mesh", "model=2", "--device", "cpu", "--lm", "lm=transformer-test",
       "--prompt-len", str(P), "--max-new-tokens", str(N), "--dtype",
       "float32", "--continuous-batching", "--decode-slots", "2"]


def _env(**kw) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("JAXJOB_")}
    return {**env, "OMP_NUM_THREADS": "1", **kw}


def _want_cli_tokens():
    from kubeflow_tpu_torch.serving import server as S

    served = S.serve_lm_generator(
        "lm", "transformer-test", device="cpu", dtype="float32",
        prompt_len=P, max_new_tokens=N, continuous_batching=True,
        decode_slots=2)
    try:
        return [list(map(int, r)) for r in served.predict(INSTANCES)]
    finally:
        served.close()


def test_cli_starts_its_world_and_stops_it_in_order():
    port = free_port()
    proc = subprocess.Popen(
        [*NICE, sys.executable, "-m", "kubeflow_tpu_torch.serving", *CLI,
         "--port", str(port)], cwd=ROOT, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        base = f"http://127.0.0.1:{port}"
        _wait_ready(base, proc)
        assert len(_ranks(proc.pid)) == 2
        status, body = _get(f"{base}/v1/models/lm:predict",
                            {"instances": INSTANCES})
        assert status == 200 and body["predictions"] == _want_cli_tokens()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out[-3000:]
        lines = [json.loads(ln) for ln in out.splitlines()
                 if ln.startswith('{"serving_rank"')]
        assert sorted(ln["serving_rank"] for ln in lines) == [0, 1]
        # each rank counts the launches of every flash kernel while it
        # served: decode attends by bmm over the cache
        from kubeflow_tpu_torch.ops import flash_attention as fa

        assert all(ln["launches"] == dict.fromkeys(fa.LAUNCHES, 0)
                   for ln in lines)
    finally:
        _kill_tree(proc)


def test_launcher_ranks_and_a_lost_follower():
    port = free_port()
    coord = free_port()
    proc = subprocess.Popen(
        [*NICE, sys.executable, "-m", "kubeflow_tpu_torch.runtime.launcher",
         "--device", "cpu", "--nproc-per-node", "2", "--",
         sys.executable, "-m", "kubeflow_tpu_torch.serving", *CLI,
         "--port", str(port)], cwd=ROOT,
        env=_env(JAXJOB_COORDINATOR_ADDRESS=f"127.0.0.1:{coord}",
                 JAXJOB_NUM_PROCESSES="1", JAXJOB_PROCESS_ID="0"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        base = f"http://127.0.0.1:{port}"
        _wait_ready(base, proc)
        status, body = _get(f"{base}/v1/models/lm:predict",
                            {"instances": INSTANCES[:1]})
        assert status == 200 and len(body["predictions"][0]) == N
        ranks = _ranks(proc.pid)
        assert sorted(ranks) == [0, 1]
        os.kill(ranks[1], signal.SIGKILL)
        # rank 0 notices within a heartbeat: unready, then gone
        deadline = time.monotonic() + 60
        seen = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                seen = _get(f"{base}/readyz", timeout=5)[0]
            except OSError:
                pass
            if seen == 503:
                break
            time.sleep(0.2)
        out, _ = proc.communicate(timeout=60)
        assert seen == 503, out[-3000:]
        assert proc.returncode != 0
        assert "serving mesh lost" in out
    finally:
        _kill_tree(proc)
