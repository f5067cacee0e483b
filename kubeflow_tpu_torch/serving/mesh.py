"""Serving over a device mesh (port of kubeflow_tpu/serving/server.py
`_ServingMesh`, :568-656, and the mesh paths of serve_flax_classifier,
serve_lm_generator and SlotDecoder).

The reference serves a model too big for one chip's memory from one
process: its weights are sharded over the mesh and GSPMD inserts the
collectives. torch drives one device per process, so a meshed server is
a world of processes (one per GPU, or ranks sharing a card over the
`loopback` backend's gloo), and rank 0 is in charge:

- rank 0 owns everything on the host: HTTP, admission, batching, the
  slot table and sampling;
- every rank keeps only its shards of the weights (`ServingMesh.place`:
  `shard_plan`, tensor parallelism, FSDP2, the MoE dispatch choice) and
  runs the same forward on them, on the whole padded batch;
- before each forward rank 0 broadcasts what it needs on the control
  wire (a gloo group over the world, host tensors): the model, the op,
  its integers and tensors (the padded prompt batch and pad lengths, a
  slot admission, the slots to clear, a tick count); with temperature > 0
  it samples and broadcasts the tokens (`share`), so no rank drifts;
- the other ranks run `follow()`: receive, run the same op, repeat,
  until rank 0's stop (ModelServer.close). They serve no HTTP.

Only two loops enter a collective: the mesh's leader thread on rank 0 (a
predict or a decoder step hands its op over and waits) and the follower
loop, so every rank issues them in one order. An idle leader pings every
HEARTBEAT_S, so a lost follower shows within a beat; the wire's group
times out after TIMEOUT_S. The forward's own collectives (tensor
parallelism, FSDP2) run on the world's groups, whose timeout is the
world's formation timeout (parallel/dist.py FORMATION_TIMEOUT_S, 600 s):
a follower that hangs inside a forward holds rank 0 there that long,
and /readyz answers 200 meanwhile. Any failure inside a meshed op loses the
mesh: rank 0 fails every request from then on, its /readyz answers 503
and its process exits nonzero. It never serves on from its own shards,
nor falls back to one process or to the CPU.
"""

from __future__ import annotations

import datetime
import logging
import queue
import threading
from typing import Any, Callable

import torch

log = logging.getLogger("kubeflow_tpu_torch.serving.mesh")

# the wire's collectives give up after TIMEOUT_S; an idle leader pings
# every HEARTBEAT_S, so a lost rank shows within a beat
TIMEOUT_S = 120.0
HEARTBEAT_S = 1.0

_HEADER = 64        # int64 words: counts, the op's words, tensor metas
_WORDS = 10         # at most: model id, op, 8 integers
_META = 8           # a tensor: dtype index, ndim, at most 6 dims
_DTYPES = (torch.int64, torch.float32)
_STOP, _PING = -1, -2     # model ids of the wire's own messages


class MeshLost(RuntimeError):
    """A meshed op failed or a rank is gone: the ranks may disagree, so
    the mesh serves no more."""


class _Wire:
    """Rank 0 -> every rank: a header of int64 words, then each tensor,
    as host tensors over a gloo group of the whole world."""

    def __init__(self, timeout_s: float):
        import torch.distributed as dist

        self._dist = dist
        self.group = dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=timeout_s))

    def _bcast(self, t: torch.Tensor) -> None:
        from kubeflow_tpu_torch.parallel.shardings import COLLECTIVES

        COLLECTIVES.timed(self._dist.broadcast, t, src=0, group=self.group)

    def send(self, words: list[int], tensors=()) -> None:
        if len(words) > _WORDS or 2 + _WORDS + _META * len(tensors) > _HEADER:
            raise ValueError(f"{len(words)} words and {len(tensors)} "
                             "tensors do not fit the wire's header")
        head = torch.zeros(_HEADER, dtype=torch.int64)
        head[0], head[1] = len(words), len(tensors)
        head[2:2 + len(words)] = torch.tensor(words, dtype=torch.int64)
        for i, t in enumerate(tensors):
            meta = [_DTYPES.index(t.dtype), t.ndim, *t.shape]
            at = 2 + _WORDS + _META * i
            head[at:at + len(meta)] = torch.tensor(meta, dtype=torch.int64)
        self._bcast(head)
        for t in tensors:
            self._bcast(t)

    def recv(self) -> tuple[list[int], list[torch.Tensor]]:
        head = torch.empty(_HEADER, dtype=torch.int64)
        self._bcast(head)
        h = head.tolist()
        words = h[2:2 + h[0]]
        tensors = []
        for i in range(h[1]):
            at = 2 + _WORDS + _META * i
            dtype, ndim = _DTYPES[h[at]], h[at + 1]
            t = torch.empty(h[at + 2:at + 2 + ndim], dtype=dtype)
            self._bcast(t)
            tensors.append(t)
        return words, tensors

    def share(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's `t` on every rank (same shape and dtype everywhere)."""
        buf = t.detach().to("cpu").contiguous()
        self._bcast(buf)
        return t if self._dist.get_rank() == 0 else buf.to(t.device)


class _Job:
    __slots__ = ("words", "tensors", "done", "result", "error")

    def __init__(self, words: list[int], tensors: list):
        self.words, self.tensors = words, tensors
        self.done = threading.Event()
        self.result: Any = None
        self.error: BaseException | None = None


def host_tensor(x) -> torch.Tensor:
    """x as a contiguous host tensor the wire carries (int64 or f32)."""
    t = torch.as_tensor(x).detach().to("cpu")
    t = t.to(torch.float32) if t.is_floating_point() else t.to(torch.int64)
    return t.contiguous()


class _Runtime:
    """This process's part of the serving world: the wire, the handlers
    (one per meshed model, registered in the same order on every rank),
    and on rank 0 the leader thread."""

    def __init__(self):
        import torch.distributed as dist

        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.wire = _Wire(TIMEOUT_S)
        self.handlers: list[Callable] = []
        self.lost: BaseException | None = None
        self.on_lost: list[Callable[[BaseException], None]] = []
        self._jobs: "queue.Queue[_Job | None]" = queue.Queue()
        self._lock = threading.Lock()
        self._thread = None
        if self.rank == 0:
            self._thread = threading.Thread(target=self._lead, daemon=True,
                                            name="serving-mesh-leader")
            self._thread.start()

    def register(self, execute: Callable) -> int:
        """`execute(op, words, tensors)` runs one op of a model on this
        rank; returns the model's id on the wire."""
        self.handlers.append(execute)
        return len(self.handlers) - 1

    # -- rank 0 ------------------------------------------------------------

    def call(self, model_id: int, op: int, words=(), tensors=()) -> Any:
        """Run op on every rank (rank 0: through the leader thread); returns
        rank 0's result. MeshLost once the mesh is lost."""
        job = _Job([model_id, op, *map(int, words)],
                   [host_tensor(t) for t in tensors])
        with self._lock:
            if self.lost is not None or self._thread is None:
                raise MeshLost(f"the serving mesh is lost: {self.lost}")
            self._jobs.put(job)
        job.done.wait()
        if job.error is not None:
            raise job.error
        return job.result

    def _lead(self) -> None:
        with torch.no_grad():
            while True:
                try:
                    job = self._jobs.get(timeout=HEARTBEAT_S)
                except queue.Empty:
                    job = _Job([_PING], [])
                if job is None:
                    self._send_quietly([_STOP])
                    return
                try:
                    self.wire.send(job.words, job.tensors)
                    if job.words[0] >= 0:
                        job.result = self.handlers[job.words[0]](
                            job.words[1], job.words[2:], job.tensors)
                except BaseException as e:   # noqa: BLE001 - the mesh is gone
                    job.error = MeshLost(f"meshed op failed: "
                                         f"{type(e).__name__}: {e}")
                    job.error.__cause__ = e
                    job.done.set()
                    self._lose(e)
                    return
                job.done.set()

    def _send_quietly(self, words: list[int]) -> None:
        try:
            self.wire.send(words)
        except Exception as e:   # noqa: BLE001 - a follower already gone
            log.warning("could not tell the followers to stop: %s", e)

    def _lose(self, err: BaseException) -> None:
        log.error("serving mesh lost: %s: %s", type(err).__name__, err)
        with self._lock:
            self.lost = err
            pending = []
            while not self._jobs.empty():
                pending.append(self._jobs.get_nowait())
        for job in pending:
            if job is not None:
                job.error = MeshLost(f"the serving mesh is lost: {err}")
                job.done.set()
        for fn in list(self.on_lost):
            fn(err)

    def stop(self) -> None:
        """Rank 0: tell the followers to stop, then end the leader thread."""
        if self._thread is None:
            return
        with self._lock:
            if self.lost is None:
                self._jobs.put(None)
        self._thread.join(timeout=TIMEOUT_S)
        self._thread = None

    # -- ranks above 0 -----------------------------------------------------

    def follow(self) -> None:
        """Run rank 0's ops until its stop; raises when the wire fails
        (rank 0 gone past the timeout) or an op fails here."""
        with torch.no_grad():
            while True:
                words, tensors = self.wire.recv()
                if words[0] == _STOP:
                    return
                if words[0] == _PING:
                    continue
                self.handlers[words[0]](words[1], words[2:], tensors)


_RUNTIME: _Runtime | None = None
_RUNTIME_LOCK = threading.Lock()


def runtime(device: torch.device) -> _Runtime:
    """This process's serving runtime, formed on first use: the world
    from the JAXJOB_* env (if not formed yet), then the wire."""
    global _RUNTIME
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel import dist as D

    with _RUNTIME_LOCK:
        if _RUNTIME is None:
            if not dist.is_initialized():
                D.initialize_from_env(device=device)
            if not dist.is_initialized():
                raise ValueError(
                    "a serving mesh needs a world of processes: none is "
                    f"formed and the env describes one process "
                    f"({D.ENV_NPROC} unset or 1)")
            _RUNTIME = _Runtime()
        return _RUNTIME


def active() -> _Runtime | None:
    return _RUNTIME


def stop() -> None:
    """End this process's serving runtime (rank 0: the followers stop)."""
    global _RUNTIME
    with _RUNTIME_LOCK:
        rt, _RUNTIME = _RUNTIME, None
    if rt is not None:
        rt.stop()


def follow() -> None:
    """A follower's main loop (ranks above 0), until rank 0 stops."""
    rt = active()
    if rt is None:
        raise RuntimeError("no serving mesh was registered in this process")
    rt.follow()


def world_of(spec) -> int:
    """The ranks a mesh spec names (data unset: 1)."""
    from kubeflow_tpu_torch.parallel.mesh import MeshSpec

    sizes = (spec if isinstance(spec, MeshSpec)
             else MeshSpec.from_dict(spec)).axis_sizes()
    n = 1
    for v in sizes.values():
        n *= max(v, 1)
    return n


def check(mesh_spec, checkpoint_dir: str | None = None
          ) -> tuple[dict, int, int]:
    """The reference's registration checks of a serving mesh: a missing
    checkpoint, an axis decode does not split (seq, pipe), the data axes'
    product (BATCH_AXES, expert included) not a power of two. Returns
    signature_def["mesh"], the world the mesh spans and that product
    (the batch's pad multiple)."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel import dist as D
    from kubeflow_tpu_torch.parallel import mesh as M
    from kubeflow_tpu_torch.runtime.checkpoint import list_steps

    if checkpoint_dir and not list_steps(checkpoint_dir):
        raise FileNotFoundError(f"no checkpoint found in {checkpoint_dir}")
    spec = M._as_spec(mesh_spec)
    signature = (dict(mesh_spec) if isinstance(mesh_spec, dict)
                 else {a: n for a, n in spec.axis_sizes().items() if n != 1})
    for axis in (M.AXIS_SEQ, M.AXIS_PIPELINE):
        if getattr(spec, axis) > 1:
            raise ValueError(
                f"a serving mesh shards over dcn, data, fsdp, expert and "
                f"model; {axis}={getattr(spec, axis)} splits the sequence "
                "or the layers, which decode does not")
    world = (dist.get_world_size() if dist.is_initialized()
             else D.DistConfig.from_env().num_processes)
    sizes = spec.resolve(world).axis_sizes()
    dp = 1
    for a in M.BATCH_AXES:
        dp *= sizes[a]
    if dp & (dp - 1):
        raise ValueError(
            f"serving mesh data axes product {dp} must be a power of two "
            "(batches are padded to powers of two)")
    return signature, world, dp


class ServingMesh:
    """The mesh a model is served over (the reference's `_ServingMesh`)
    across a world of more than one rank (`check` first: a mesh of one
    rank is served by the one-process path): `place` keeps this rank's
    shards of a model; `call` runs a registered op on every rank."""

    def __init__(self, mesh_spec, seed: int = 0,
                 checkpoint_dir: str | None = None,
                 param_dtype: str | None = None, device=None):
        from kubeflow_tpu_torch.device import resolve_device
        from kubeflow_tpu_torch.parallel import dist as D
        from kubeflow_tpu_torch.parallel import mesh as M

        self.seed = seed
        self.checkpoint_dir = checkpoint_dir
        self.param_dtype = param_dtype
        self.signature, world, self.pad_multiple = check(mesh_spec,
                                                         checkpoint_dir)
        if world < 2:
            raise ValueError("a serving mesh of one rank is served by the "
                             "one-process path")
        self.spec = M._as_spec(mesh_spec)
        self.device = resolve_device(device)
        self.runtime = runtime(self.device)
        self.mesh = D.active_backend().mesh(self.spec, self.device.type)
        self.rank = self.mesh.rank

    def place(self, model, cast: bool = True):
        """Keep this rank's shards of `model` (built whole on every rank:
        drawn from the seed on the device, as one process draws them, or
        loaded on the host), on the device, in eval mode: the float
        `param_dtype` cast first, then the cut (shard_plan, tensor
        parallelism, FSDP2, the MoE dispatch choice)."""
        from kubeflow_tpu_torch.models.transformer import as_dtype
        from kubeflow_tpu_torch.parallel import shardings as S

        if cast and self.param_dtype:
            dt = as_dtype(self.param_dtype)
            with torch.no_grad():
                for p in model.parameters():
                    if p.is_floating_point():
                        p.data = p.data.to(dt)
        plan = S.shard_plan(model, self.mesh)
        S.apply_tensor_parallel(model, plan, self.mesh)
        model.to(self.device)      # a model loaded on the host: its shards
        S.apply_fsdp(model, plan, self.mesh)
        if hasattr(model, "moe_blocks"):
            S.apply_moe(model, plan, self.mesh)
        model.eval()
        return model

    def register(self, execute: Callable) -> int:
        return self.runtime.register(execute)

    def call(self, model_id: int, op: int, words=(), tensors=()) -> Any:
        return self.runtime.call(model_id, op, words, tensors)

    def share(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's `t` on every rank; only inside a meshed op."""
        return self.runtime.wire.share(t)

    def healthy(self) -> bool:
        return self.runtime.lost is None

