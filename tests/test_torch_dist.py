"""The port's distributed bootstrap (kubeflow_tpu_torch/parallel/dist.py)
against the reference's parallel/dist.py: the JAXJOB_* env contract and
the elastic world stamp parse the same, `initialize_from_env` keeps the
reference's re-entrancy (the same world is a no-op, a changed world
tears down first, a failed teardown raises WorldTeardownError), and a
2-rank gloo world forms from the env in two processes.

`run_world` (used by the other multi-process test files) runs a
function of a test module in n processes, each with its rank's JAXJOB_*
env, and fails on a non-zero exit or a timeout; the tests at the end
hold that a failed rank stops its world at once and names every rank's
output, that a timeout does too, and that a world whose coordinator port
was taken before rank 0 bound it runs again on another.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

import pytest
import torch

from kubeflow_tpu_torch.parallel import backends as B
from kubeflow_tpu_torch.parallel import dist as D

ROOT = pathlib.Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"


# coordinator ports for the worlds the tests start (below the ephemeral
# range: a bind(0) port could be taken before rank 0's store binds it)
free_port = D.free_port


# spawned ranks yield the CPU to the test processes beside them: timing
# tests in other workers share the machine
NICE = ["nice", "-n", "10"]
# what rank 0's store raises when its port was taken before it bound it
_BIND_FAILED = ("EADDRINUSE", "address already in use")
WORLD_ATTEMPTS = 3


def _tails(outs: list[str], codes: list) -> str:
    return "\n".join(f"--- rank {r}: exit {c}\n{o[-3000:]}"
                     for r, (o, c) in enumerate(zip(outs, codes)))


def _run_world_once(n, code, out_dir, args, env, timeout):
    """One attempt: (exit codes, outputs); a rank that fails stops the
    rest of the world at once, and so does the timeout (its codes are
    then None for the ranks it stopped, and `timed_out` is set)."""
    port = free_port()
    procs, logs = [], []
    try:
        for rank in range(n):
            e = {**os.environ, **(env or {}),
                 D.ENV_COORD: f"127.0.0.1:{port}", D.ENV_NPROC: str(n),
                 D.ENV_PID: str(rank), "OMP_NUM_THREADS": "1"}
            logs.append(tempfile.TemporaryFile("w+"))
            procs.append(subprocess.Popen(
                [*NICE, sys.executable, "-c", code,
                 json.dumps([rank, n, str(out_dir), *args])],
                cwd=ROOT, env=e, stdout=logs[-1], stderr=subprocess.STDOUT,
                text=True))
        deadline = time.monotonic() + timeout
        timed_out = False
        while True:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes) or any(c for c in codes):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    return codes, outs, timed_out


def run_world(n: int, target: str, out_dir, *args, env: dict | None = None,
              timeout: float = 240.0) -> list[str]:
    """Run `module.function(rank, n, out_dir, *args)` (`target` is
    "module:function", a module under tests/) in n processes with the
    JAXJOB_* env of rank 0..n-1 around one coordinator, one thread each,
    at a lower priority. Returns each rank's output.

    When a rank exits non-zero the rest of the world is stopped at once
    and the call raises with every rank's exit code and the tail of its
    output; so does a world that outlives `timeout`. A world whose rank
    0 could not bind its coordinator port (taken between the choice and
    the bind) is run again on another port, up to WORLD_ATTEMPTS times;
    no other failure is retried."""
    mod, fn = target.split(":")
    # each rank dies with the test process that started it (PR_SET_PDEATHSIG):
    # an xdist worker killed mid-test leaves no rank waiting on its
    # coordinator
    code = ("import ctypes, json, signal, sys\n"
            "try:\n    ctypes.CDLL(None).prctl(1, signal.SIGKILL)\n"
            "except (OSError, AttributeError):\n    pass\n"
            "a = json.loads(sys.argv[1])\n"
            "print(f'run_world: rank {a[0]} of {a[1]} started', flush=True)\n"
            f"sys.path[:0] = [{str(ROOT)!r}, {str(TESTS)!r}]\n"
            f"import {mod}\n{mod}.{fn}(*a)\n")
    for attempt in range(1, WORLD_ATTEMPTS + 1):
        codes, outs, timed_out = _run_world_once(n, code, out_dir, args, env,
                                                 timeout)
        if timed_out:
            raise AssertionError(
                f"world of {n} ({target}) outlived {timeout} s, stopped:\n"
                + _tails(outs, codes))
        if all(c == 0 for c in codes):
            return outs
        if (codes[0] and any(m in outs[0] for m in _BIND_FAILED)
                and attempt < WORLD_ATTEMPTS):
            continue
        bad = [(r, c) for r, c in enumerate(codes) if c]
        raise AssertionError(f"world of {n} ({target}): ranks {bad} failed, "
                             "the rest stopped:\n" + _tails(outs, codes))
    raise AssertionError("unreachable")


@pytest.fixture(autouse=True)
def clean_world(monkeypatch):
    monkeypatch.delenv(B.ENV_BACKEND, raising=False)
    yield
    D.shutdown()


# -- the env contract, against the reference ---------------------------------------


ENVS = [
    {},
    {"JAXJOB_COORDINATOR_ADDRESS": "w0:1234", "JAXJOB_NUM_PROCESSES": "4",
     "JAXJOB_PROCESS_ID": "3", "JAXJOB_NAME": "j", "JAXJOB_NAMESPACE": "ns"},
    {"JAXJOB_COORDINATOR_ADDRESS": "w0", "JAXJOB_NUM_PROCESSES": "2",
     "JAXJOB_PROCESS_ID": "1"},
    {"JAXJOB_COORDINATOR_ADDRESS": "10.0.0.1:9000",
     "JAXJOB_NUM_PROCESSES": "8", "JAXJOB_PROCESS_ID": "5",
     "JAXJOB_NUM_SLICES": "2", "JAXJOB_SLICE_ID": "1"},
]


@pytest.mark.parametrize("env", ENVS, ids=["empty", "named", "bare-host",
                                           "multislice"])
def test_dist_config_matches_reference(env):
    from kubeflow_tpu.parallel import dist as RD

    got, want = D.DistConfig.from_env(env), RD.DistConfig.from_env(env)
    assert got.__dict__ == want.__dict__
    assert (got.distributed, got.multislice) == (want.distributed,
                                                 want.multislice)
    # the port sets no libtpu MEGASCALE_* key; the JAXJOB_* block is equal
    ref_env = {k: v for k, v in want.to_env().items()
               if not k.startswith("MEGASCALE_")}
    assert got.to_env() == ref_env
    assert D.DistConfig.from_env(got.to_env()) == got
    assert D.DEFAULT_COORD_PORT == RD.DEFAULT_COORD_PORT == 8476


WORLDS = [
    '{"gen": 0, "size": 2, "members": ["w0", "w1"]}',
    '{"gen": 3, "size": 1, "members": ["w1"], "coordinator": "w1:8476"}',
    '{"gen": 1, "size": 2, "members": ["a", "b"], "slices": [1, 1]}',
    "", None, "{", "[]", '{"gen": 0}', '{"gen": -1, "size": 0, "members": []}',
    '{"gen": 0, "size": 3, "members": ["a"]}',
    '{"gen": "x", "size": 1, "members": ["a"]}',
    '{"gen": 0, "size": 2, "members": ["a", "b"], "slices": [0]}',
    '{"gen": 0, "size": 1, "members": ["a"], "slices": ["z"]}',
]


@pytest.mark.parametrize("text", WORLDS)
def test_world_spec_matches_reference(text):
    from kubeflow_tpu.parallel import dist as RD

    got, want = D.WorldSpec.from_json(text), RD.WorldSpec.from_json(text)
    assert (got is None) == (want is None)
    if got is None:
        return
    assert got.__dict__ == want.__dict__
    assert got.to_json() == want.to_json()
    assert D.WorldSpec.from_json(got.to_json()) == got
    for name in (*got.members, "nobody"):
        assert got.rank_of(name) == want.rank_of(name)
        assert got.slice_of(name) == want.slice_of(name)
    assert got.num_slices == want.num_slices


def test_expand_local_gives_global_ranks():
    env = {D.ENV_COORD: "h:1", D.ENV_NPROC: "2", D.ENV_PID: "1"}
    got = [D.DistConfig.from_env(D.expand_local(env, 4, r)) for r in range(4)]
    assert [c.process_id for c in got] == [4, 5, 6, 7]
    assert {c.num_processes for c in got} == {8}
    assert D.expand_local(env, 4, 2)[D.ENV_LOCAL_RANK] == "2"


def test_free_port_is_below_the_ephemeral_range_and_free():
    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        low = int(f.read().split()[0])
    for _ in range(20):
        port = D.free_port()
        assert 1024 <= port < low
        with socket.socket() as s:
            s.bind(("127.0.0.1", port))


def test_wait_for_coordinator():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        D.wait_for_coordinator(f"127.0.0.1:{s.getsockname()[1]}", timeout_s=5)
    with pytest.raises(TimeoutError):
        D.wait_for_coordinator(f"127.0.0.1:{free_port()}", timeout_s=0.3)


def test_torch_backend_choice():
    assert D.torch_backend(torch.device("cpu")) == "gloo"
    assert D.torch_backend(torch.device("cuda")) == "nccl"


# -- re-entrancy --------------------------------------------------------------------


def _env(n, pid, port=1):
    return {D.ENV_COORD: f"127.0.0.1:{port}", D.ENV_NPROC: str(n),
            D.ENV_PID: str(pid)}


@pytest.fixture
def fake_formation(monkeypatch):
    """Formation and teardown recorded instead of done."""
    calls = []
    monkeypatch.setattr(D, "_torch_initialize",
                        lambda cfg, dev, be, addr=None, prefix="": calls.append(
                            ("init", cfg.num_processes, cfg.process_id, be)))
    monkeypatch.setattr(D, "_torch_shutdown",
                        lambda: calls.append(("shutdown",)))
    return calls


def test_single_process_is_a_no_op(fake_formation):
    cfg = D.initialize_from_env({})
    assert not cfg.distributed and fake_formation == []
    assert D.active_world() == cfg and D.active_backend() is None
    with pytest.raises(ValueError, match="COORDINATOR"):
        D.initialize_from_env({D.ENV_NPROC: "2"})
    assert D.active_world() == cfg        # a bad env tears nothing down


def test_reentry_same_world_noop_changed_world_tears_down(fake_formation):
    D.initialize_from_env(_env(2, 0), device="cpu")
    assert fake_formation == [("init", 2, 0, "gloo")]
    # the same world (metadata aside): a no-op that refreshes the name
    cfg = D.initialize_from_env({**_env(2, 0), D.ENV_NAME: "renamed"},
                                device="cpu")
    assert cfg.job_name == "renamed" and D.active_world().job_name == "renamed"
    assert len(fake_formation) == 1
    assert D.active_device() == torch.device("cpu")
    # a changed world: teardown, then formation
    D.initialize_from_env(_env(4, 1), device="cpu")
    assert fake_formation[1:] == [("shutdown",), ("init", 4, 1, "gloo")]
    D.shutdown()
    assert fake_formation[-1] == ("shutdown",) and D.active_world() is None
    D.shutdown()                          # idempotent
    assert fake_formation[-1] == ("shutdown",) and len(fake_formation) == 4


def test_failed_teardown_raises_world_teardown_error(fake_formation,
                                                     monkeypatch):
    D.initialize_from_env(_env(2, 0), device="cpu")

    def boom():
        raise RuntimeError("store gone")

    monkeypatch.setattr(D, "_torch_shutdown", boom)
    with pytest.raises(D.WorldTeardownError, match="store gone"):
        D.initialize_from_env(_env(3, 0), device="cpu")
    assert D.active_world().num_processes == 2   # the old world stands
    monkeypatch.setattr(D, "_torch_shutdown", lambda: None)


def test_world_needs_a_device_it_can_use(fake_formation):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.initialize_from_env(_env(2, 0))
    assert fake_formation == []


# -- a real 2-rank gloo world from the env -------------------------------------------


def world_worker(rank, n, out_dir):
    import torch.distributed as dist

    cfg = D.initialize_from_env(device="cpu")
    assert cfg.process_id == rank and dist.get_world_size() == n
    assert D.active_backend().name == B.BACKEND_SINGLE
    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x)
    # the same world again forms nothing new
    D.initialize_from_env(device="cpu")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"sum": float(x), "rank": dist.get_rank()}, f)
    D.shutdown()
    assert not dist.is_initialized()


def test_two_rank_gloo_world_forms_from_env(tmp_path):
    run_world(2, "test_torch_dist:world_worker", tmp_path, timeout=120)
    got = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(2)]
    assert got == [{"sum": 3.0, "rank": 0}, {"sum": 3.0, "rank": 1}]


# -- run_world itself ----------------------------------------------------------------


def idle_or_fail_worker(rank, n, out_dir, fail_rank):
    """Rank `fail_rank` prints and exits 3 at once; the others print and
    wait forever, as ranks waiting on a coordinator that never came."""
    print(f"rank {rank} here", flush=True)
    if rank == fail_rank:
        sys.exit(3)
    time.sleep(3600)


@pytest.mark.parametrize("fail_rank", [0, 1])
def test_a_failed_rank_stops_its_world_and_names_every_rank(tmp_path,
                                                            fail_rank):
    t0 = time.monotonic()
    with pytest.raises(AssertionError) as err:
        run_world(3, "test_torch_dist:idle_or_fail_worker", tmp_path,
                  fail_rank, timeout=120)
    assert time.monotonic() - t0 < 60
    text = str(err.value)
    assert f"ranks [({fail_rank}, 3)] failed" in text
    assert f"rank {fail_rank} here" in text
    for r in range(3):
        assert f"--- rank {r}: exit" in text
        assert f"run_world: rank {r} of 3 started" in text


def test_a_world_that_outlives_its_timeout_names_every_rank(tmp_path):
    with pytest.raises(AssertionError, match="outlived 8") as err:
        run_world(2, "test_torch_dist:idle_or_fail_worker", tmp_path, -1,
                  timeout=8)
    assert all(f"run_world: rank {r} of 2 started" in str(err.value)
               for r in range(2))


def test_a_taken_coordinator_port_is_retried(tmp_path, monkeypatch):
    """The first port is held (bound, not listening, as another
    process's socket would be): rank 0's store cannot bind it, and the
    world runs again on a free one."""
    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    ports = [taken.getsockname()[1]]
    real, calls = free_port, []

    def pick():
        calls.append(1)
        return ports.pop(0) if ports else real()

    monkeypatch.setattr(sys.modules[__name__], "free_port", pick)
    try:
        run_world(2, "test_torch_dist:world_worker", tmp_path, timeout=120)
    finally:
        taken.close()
    assert len(calls) == 2        # the taken port, then one that bound
    got = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(2)]
    assert got == [{"sum": 3.0, "rank": 0}, {"sum": 3.0, "rank": 1}]
