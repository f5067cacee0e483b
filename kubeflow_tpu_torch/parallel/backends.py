"""Pluggable collectives backends (port of kubeflow_tpu/parallel/backends.py).

A backend owns a process's world I/O: `join`/`leave` (what
`dist.initialize_from_env`/`shutdown` call), `form`/`reshape`/`teardown`
(the world plus its mesh, what the elastic coordinator drives), the
mesh-axes -> levels map (which axes cross the slow level), and
`hierarchical_reduce`, the gradient sum over the batch axes.

- ``SingleBackend`` (`single`, the default): `init_process_group` from
  the JAXJOB_* env and a flat all-reduce.
- ``GpuNodeBackend`` (`gpu`), the counterpart of the reference's
  `TpuIciDcnBackend`: the fast level is the ranks of one node (NVLink),
  the slow level (the `dcn` axis) crosses nodes. Its reduce is the
  MLPerf-pod shape over the mesh's process groups: reduce-scatter over
  the fast axes, one all-reduce over `dcn` of 1/fast of the tensor,
  all-gather back; a flat sum where the leading dim does not tile over
  the fast extent, as the reference falls back.
- ``LoopbackBackend`` (`loopback`): the reference's TCP join barrier
  (4-byte rank, b"go", readiness probes ignored), then a gloo process
  group over a TCP store one port above the coordinator's. One torch
  process drives one device, so the reference's in-process CPU
  "slices" have no counterpart: a multislice loopback world is formed
  of gloo ranks instead, the `dcn` axis over contiguous rank blocks,
  and it reduces in the hierarchical shape. Gloo takes CUDA tensors
  too (all-reduce and broadcast, no reduce-scatter), so loopback is
  also how several processes share one card; their reduce is flat.

Selection: JAXJOB_COLLECTIVES_BACKEND (explicit name, then the caller's
env, then the process env, then `single`). The libtpu MEGASCALE_* env
has no counterpart and is never set.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
from typing import Sequence

import numpy as np

from kubeflow_tpu_torch.parallel import mesh as M

log = logging.getLogger("kubeflow_tpu_torch.backends")

ENV_BACKEND = "JAXJOB_COLLECTIVES_BACKEND"
BACKEND_SINGLE = "single"
BACKEND_LOOPBACK = "loopback"
BACKEND_GPU = "gpu"

LEVEL_ICI = "ici"   # the fast level: the ranks of one node
LEVEL_DCN = "dcn"   # the slow level: across nodes
ENV_DCN_AXES = "JAXJOB_MESH_DCN_AXES"
ENV_LOOPBACK_JOIN_TIMEOUT = "JAXJOB_LOOPBACK_JOIN_TIMEOUT_S"


def dcn_axes_from_env(env: dict[str, str] | None = None) -> tuple[str, ...]:
    src = os.environ if env is None else env
    return tuple(a.strip() for a in src.get(ENV_DCN_AXES, "").split(",")
                 if a.strip())


def level_layout(spec, n_devices: int,
                 levels: dict[str, str] | None = None) -> np.ndarray:
    """The rank array of a level-mapped mesh, in the canonical axis
    order: the axes mapped to LEVEL_DCN are laid outermost (over the
    contiguous rank blocks of the nodes or slices), the rest keep the
    canonical inner order. The default map ({dcn: dcn}) is
    `mesh.rank_layout` itself."""
    spec = M._as_spec(spec).resolve(n_devices)
    sizes = spec.axis_sizes()
    lv = {M.AXIS_DCN: LEVEL_DCN, **(levels or {})}
    lv[M.AXIS_DCN] = LEVEL_DCN      # the dcn axis is DCN by definition
    dcn_axes = [a for a in M.AXIS_NAMES
                if lv.get(a) == LEVEL_DCN and sizes[a] > 1]
    if dcn_axes in ([], [M.AXIS_DCN]):
        return M.rank_layout(spec, n_devices)
    order = dcn_axes + [a for a in M.AXIS_NAMES if a not in dcn_axes]
    arr = np.arange(n_devices).reshape(tuple(sizes[a] for a in order))
    return arr.transpose(tuple(order.index(a) for a in M.AXIS_NAMES))


def build_level_mesh(spec=None, levels: dict[str, str] | None = None,
                     device_type: str = "cuda") -> M.Mesh:
    """The Mesh of `spec` over the process group's world, laid out by
    `level_layout`; the default map gives `mesh.build_mesh`."""
    _, world = M._world()
    ranks = level_layout(spec, world, levels)
    if np.array_equal(ranks, M.rank_layout(spec, world)):
        return M.build_mesh(spec, device_type)
    return M.mesh_from_ranks(ranks, device_type)


# -- collectives on a mesh's process groups ------------------------------------


def _all_reduce(x, group) -> None:
    import torch.distributed as dist

    if group is not None:
        dist.all_reduce(x, group=group)


def _flat_sum(mesh: M.Mesh, x, axes: Sequence[str]):
    _all_reduce(x, mesh.group(axes))
    return x


def _tiled_sum(mesh: M.Mesh, x, ici: Sequence[str], axis: str):
    """reduce-scatter over `ici` -> all-reduce over `axis` -> all-gather
    over `ici`, on dim 0 (which must tile over the ici extent)."""
    import torch
    import torch.distributed as dist

    g = mesh.group(ici)
    y = torch.empty((x.shape[0] // mesh.extent(ici),) + tuple(x.shape[1:]),
                    dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(y, x.contiguous(), group=g)
    _all_reduce(y, mesh.group((axis,)))
    out = torch.empty_like(x)
    dist.all_gather_into_tensor(out, y, group=g)
    return out


# -- the backend protocol ------------------------------------------------------


class CollectivesBackend:
    """World lifecycle + reduction policy. `join`/`leave` are called by
    dist under its world lock; `form`/`reshape`/`teardown` are the world
    plus its mesh."""

    name = "abstract"

    def __init__(self) -> None:
        self._mesh: M.Mesh | None = None
        self._lock = threading.Lock()

    # -- process-level world lifecycle --------------------------------------

    def join(self, cfg, *, wait: bool = True, device=None,
             env: dict[str, str] | None = None) -> bool:
        """Join the world `cfg` describes on `device`. True when this
        backend now holds live state that `leave` must tear down."""
        raise NotImplementedError

    def leave(self) -> None:
        raise NotImplementedError

    def form_group(self, cfg, device, env: dict[str, str] | None = None,
                   address: str | None = None) -> None:
        """The process group of `cfg`'s world, even one of a single rank
        (which `join` never forms)."""
        from kubeflow_tpu_torch.parallel import dist as D

        D._torch_initialize(cfg, device, D.torch_backend(device),
                            address, _generation(env))

    # -- mesh ----------------------------------------------------------------

    def level_map(self, env: dict[str, str] | None = None) -> dict[str, str]:
        lv = {M.AXIS_DCN: LEVEL_DCN}
        for a in dcn_axes_from_env(env):
            lv[a] = LEVEL_DCN
        return lv

    def mesh(self, spec=None, device_type: str | None = None,
             levels: dict[str, str] | None = None) -> M.Mesh:
        from kubeflow_tpu_torch.parallel import dist as D

        if device_type is None:
            dev = D.active_device()
            device_type = dev.type if dev is not None else "cuda"
        m = build_level_mesh(spec, levels if levels is not None
                             else self.level_map(), device_type)
        self._mesh = m
        return m

    def form(self, env: dict[str, str] | None = None, *, spec=None,
             device=None, wait: bool = True) -> M.Mesh:
        """Form the world from `env` (through dist: re-entrancy and
        teardown-on-change hold) and build its mesh."""
        from kubeflow_tpu_torch.parallel import dist as D

        e = dict(os.environ if env is None else env)
        e[ENV_BACKEND] = self.name  # form() pins the selection
        D.initialize_from_env(e, wait=wait, device=device)
        return self.mesh(spec, None if device is None
                         else _device_type(device))

    def reshape(self, env: dict[str, str] | None = None, *, spec=None,
                device=None, wait: bool = True) -> M.Mesh:
        """Re-form at a changed world: teardown, then form."""
        self.teardown()
        return self.form(env, spec=spec, device=device, wait=wait)

    def teardown(self) -> None:
        from kubeflow_tpu_torch.parallel import dist as D

        self._mesh = None
        D.shutdown()

    # -- reduction policy ----------------------------------------------------

    def _axes(self, axis, ici_axes) -> tuple[str, tuple[str, ...]]:
        return (axis or M.AXIS_DCN,
                tuple(ici_axes) if ici_axes is not None else (M.AXIS_DATA,))

    def hierarchical_reduce(self, tree, axis: str | None = None,
                            ici_axes: Sequence[str] | None = None,
                            mesh: M.Mesh | None = None):
        """Sum each tensor of `tree` (a tensor, a list/tuple or a dict of
        them) across `ici_axes` (fast level, default data) and `axis`
        (slow level, default dcn) of `mesh` (default the backend's).
        Single-level backends reduce flat, in place."""
        axis, ici = self._axes(axis, ici_axes)
        m = mesh or self._mesh
        return _tree_map(lambda x: _flat_sum(m, x, ici + (axis,)), tree)


def _generation(env: dict[str, str] | None) -> str:
    from kubeflow_tpu_torch.parallel import dist as D

    return f"gen{(os.environ if env is None else env).get(D.ENV_WORLD_GEN, 0)}"


def _device_type(device) -> str:
    return device if isinstance(device, str) else device.type


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class SingleBackend(CollectivesBackend):
    """init_process_group for a multi-process world, a flat reduction.
    The default."""

    name = BACKEND_SINGLE

    def join(self, cfg, *, wait: bool = True, device=None,
             env: dict[str, str] | None = None) -> bool:
        if not cfg.distributed:
            return False
        log.info("init_process_group(tcp://%s, world_size=%d, rank=%d) "
                 "on %s", cfg.coordinator_address, cfg.num_processes,
                 cfg.process_id, device)
        # the TCP store's clients retry until rank 0 binds it: the
        # readiness probe of the reference is not needed
        self.form_group(cfg, device, env)
        return True

    def leave(self) -> None:
        from kubeflow_tpu_torch.parallel import dist as D

        self._mesh = None      # its process groups hold the TCP store
        D._torch_shutdown()


class GpuNodeBackend(SingleBackend):
    """The hierarchical GPU path: one node's ranks are the fast level
    (NVLink), the `dcn` axis crosses nodes."""

    name = BACKEND_GPU

    def hierarchical_reduce(self, tree, axis: str | None = None,
                            ici_axes: Sequence[str] | None = None,
                            mesh: M.Mesh | None = None):
        """reduce-scatter(fast) -> all-reduce(slow) -> all-gather(fast):
        the slow hop moves 1/fast of the tensor. A flat sum when the
        leading dim does not tile over the fast extent (numerically both
        are plain sums)."""
        axis, ici = self._axes(axis, ici_axes)
        m = mesh or self._mesh
        n_ici = m.extent(ici)

        def red(x):
            if (n_ici > 1 and x.ndim >= 1 and x.shape[0] % n_ici == 0
                    and self._can_scatter(x)):
                return _tiled_sum(m, x, ici, axis)
            return _flat_sum(m, x, ici + (axis,))

        return _tree_map(red, tree)

    @staticmethod
    def _can_scatter(x) -> bool:
        return True


class LoopbackBackend(CollectivesBackend):
    """Hermetic formation: rank 0 binds the coordinator port and admits
    exactly num_processes-1 distinct peers before releasing anyone
    (a missing peer blocks the gang; teardown closes the sockets); then
    the ranks form a gloo process group over a TCP store at the
    coordinator's port + 1."""

    name = BACKEND_LOOPBACK

    def __init__(self) -> None:
        super().__init__()
        self._server: socket.socket | None = None
        self._conns: list[socket.socket] = []
        self._group = False

    @staticmethod
    def _recv_exact(conn: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("loopback peer closed during join")
            buf += chunk
        return buf

    def _join_timeout(self) -> float:
        return float(os.environ.get(ENV_LOOPBACK_JOIN_TIMEOUT, "120"))

    def barrier(self, cfg, *, wait: bool = True) -> None:
        """The TCP join barrier alone (no process group)."""
        from kubeflow_tpu_torch.parallel import dist as D

        with self._lock:
            host, _, port = (cfg.coordinator_address or "").partition(":")
            port = int(port or D.DEFAULT_COORD_PORT)
            timeout = self._join_timeout()
            if cfg.process_id == 0:
                self._serve_barrier(host, port, cfg.num_processes, timeout)
            else:
                if wait:
                    D.wait_for_coordinator(cfg.coordinator_address,
                                           timeout_s=timeout)
                conn = socket.create_connection((host or "127.0.0.1", port),
                                                timeout=timeout)
                conn.settimeout(timeout)
                conn.sendall(cfg.process_id.to_bytes(4, "big"))
                if self._recv_exact(conn, 2) != b"go":
                    raise ConnectionError("loopback barrier refused")
                self._conns.append(conn)
            log.info("loopback world formed: rank %d/%d", cfg.process_id,
                     cfg.num_processes)

    def join(self, cfg, *, wait: bool = True, device=None,
             env: dict[str, str] | None = None) -> bool:
        if not cfg.distributed:
            return False
        self.barrier(cfg, wait=wait)
        from kubeflow_tpu_torch.parallel import dist as D

        host, _, port = cfg.coordinator_address.partition(":")
        try:
            D._torch_initialize(
                cfg, device, "gloo",
                f"{host}:{int(port or D.DEFAULT_COORD_PORT) + 1}",
                _generation(env))
        except BaseException:
            self._close()
            raise
        self._group = True
        return True

    def _serve_barrier(self, host: str, port: int, nproc: int,
                       timeout: float) -> None:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host or "", port))
        srv.listen(nproc)
        srv.settimeout(0.5)
        peers: dict[int, socket.socket] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(peers) < nproc - 1:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"loopback barrier: {len(peers)}/{nproc - 1} peers "
                        f"after {timeout}s")
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                conn.settimeout(timeout)
                try:
                    rank = int.from_bytes(self._recv_exact(conn, 4), "big")
                except ConnectionError:
                    # a wait_for_coordinator readiness probe: it connects
                    # and closes without a handshake, not a peer
                    conn.close()
                    continue
                peers[rank] = conn
            for conn in peers.values():
                conn.sendall(b"go")
        except BaseException:
            for conn in peers.values():
                conn.close()
            srv.close()
            raise
        self._server = srv
        self._conns = list(peers.values())

    def _close(self) -> None:
        for conn in self._conns:
            try:
                conn.close()
            except OSError:
                pass
        self._conns = []
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
            self._server = None

    def leave(self) -> None:
        from kubeflow_tpu_torch.parallel import dist as D

        with self._lock:
            if self._group:
                self._mesh = None
                D._torch_shutdown()
                self._group = False
            self._close()

    def hierarchical_reduce(self, tree, axis: str | None = None,
                            ici_axes: Sequence[str] | None = None,
                            mesh: M.Mesh | None = None):
        # gloo ranks reduce in the hierarchical shape, as the
        # reference's in-process slices do
        return GpuNodeBackend.hierarchical_reduce(self, tree, axis,
                                                  ici_axes, mesh)

    @staticmethod
    def _can_scatter(x) -> bool:
        # gloo reduce-scatters CPU tensors only: ranks on cards (two
        # processes sharing one) sum flat
        return not x.is_cuda


_REGISTRY = {
    BACKEND_SINGLE: SingleBackend,
    BACKEND_LOOPBACK: LoopbackBackend,
    BACKEND_GPU: GpuNodeBackend,
}
_instances: dict[str, CollectivesBackend] = {}
_instances_lock = threading.Lock()


def get_backend(name: str | None = None,
                env: dict[str, str] | None = None) -> CollectivesBackend:
    """The selected backend (a module singleton): the explicit name,
    then the caller's env, then the process env, then `single`."""
    if name is None:
        name = ((env or {}).get(ENV_BACKEND)
                or os.environ.get(ENV_BACKEND) or BACKEND_SINGLE)
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown collectives backend {name!r}; "
            f"known: {sorted(_REGISTRY)}") from None
    with _instances_lock:
        if name not in _instances:
            _instances[name] = cls()
        return _instances[name]
