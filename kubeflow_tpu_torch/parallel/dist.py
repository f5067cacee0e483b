"""Multi-process bootstrap from the JAXJob env (port of
kubeflow_tpu/parallel/dist.py).

The JAXJob controller injects:

    JAXJOB_COORDINATOR_ADDRESS   host:port of process 0
    JAXJOB_NUM_PROCESSES         world size
    JAXJOB_PROCESS_ID            this process's rank
    JAXJOB_NAME / JAXJOB_NAMESPACE  (identification / logging only)

`initialize_from_env()` forms the world those describe: a
`torch.distributed` process group over a TCP store at the coordinator
address (rank 0 binds it), NCCL for CUDA devices and gloo for the CPU
(the `loopback` collectives backend forms a gloo world on any device:
two processes can share one card that way). One process is a no-op. The libtpu MEGASCALE_* env has no
counterpart here and is never set; the JAXJOB_NUM_SLICES /
JAXJOB_SLICE_ID contract stays, and the `dcn` mesh axis falls on the
slice boundary (contiguous rank blocks).

The launcher starts one process per GPU (`--nproc-per-node`): JAX
drives a host's chips from one process, torch drives one device per
process, so a pod's JAXJOB_PROCESS_ID p becomes the global ranks
p * nproc-per-node + local rank (`expand_local`).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import socket
import threading
import time

log = logging.getLogger("kubeflow_tpu_torch.dist")

ENV_COORD = "JAXJOB_COORDINATOR_ADDRESS"
ENV_NPROC = "JAXJOB_NUM_PROCESSES"
ENV_PID = "JAXJOB_PROCESS_ID"
ENV_NAME = "JAXJOB_NAME"
ENV_NAMESPACE = "JAXJOB_NAMESPACE"
# Elastic resize contract (runtime/elastic.py): the controller projects
# its world annotation into the pod at this path; ENV_BATCH_POLICY
# carries spec.elastic.batchPolicy (Preserve|Scale).
ENV_WORLD_FILE = "JAXJOB_WORLD_FILE"
ENV_BATCH_POLICY = "JAXJOB_BATCH_POLICY"
BATCH_PRESERVE = "Preserve"
BATCH_SCALE = "Scale"
# Multislice: the mesh's `dcn` axis spans slices (contiguous rank blocks)
ENV_NUM_SLICES = "JAXJOB_NUM_SLICES"
ENV_SLICE_ID = "JAXJOB_SLICE_ID"
# The port's own key: the local rank the launcher gives each of a
# pod's processes (its device is cuda:<local rank>)
ENV_LOCAL_RANK = "JAXJOB_LOCAL_RANK"
# the elastic world's generation (runtime/elastic.py): each incarnation's
# keys live under their own prefix of the coordinator's TCP store
ENV_WORLD_GEN = "JAXJOB_WORLD_GEN"
DEFAULT_COORD_PORT = 8476
# how long formation and a collective wait for the slowest rank
FORMATION_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class DistConfig:
    coordinator_address: str | None
    num_processes: int
    process_id: int
    job_name: str = ""
    namespace: str = ""
    num_slices: int = 1
    slice_id: int = 0

    @property
    def distributed(self) -> bool:
        return self.num_processes > 1

    @property
    def multislice(self) -> bool:
        return self.num_slices > 1

    @classmethod
    def from_env(cls, env: dict[str, str] | None = None) -> "DistConfig":
        env = dict(os.environ) if env is None else env
        coord = env.get(ENV_COORD)
        nproc = int(env.get(ENV_NPROC, "1"))
        pid = int(env.get(ENV_PID, "0"))
        if coord is not None and ":" not in coord:
            coord = f"{coord}:{DEFAULT_COORD_PORT}"
        return cls(
            coordinator_address=coord,
            num_processes=nproc,
            process_id=pid,
            job_name=env.get(ENV_NAME, ""),
            namespace=env.get(ENV_NAMESPACE, ""),
            num_slices=int(env.get(ENV_NUM_SLICES, "1")),
            slice_id=int(env.get(ENV_SLICE_ID, "0")),
        )

    def to_env(self) -> dict[str, str]:
        """The env block the JAXJob controller injects into each worker."""
        env = {
            ENV_NPROC: str(self.num_processes),
            ENV_PID: str(self.process_id),
        }
        if self.coordinator_address:
            env[ENV_COORD] = self.coordinator_address
        if self.job_name:
            env[ENV_NAME] = self.job_name
        if self.namespace:
            env[ENV_NAMESPACE] = self.namespace
        if self.num_slices > 1:
            env.update(slice_env(self.num_slices, self.slice_id))
        return env


def slice_env(num_slices: int, slice_id: int) -> dict[str, str]:
    """The multislice env block: the JAXJOB_* slice contract only."""
    return {ENV_NUM_SLICES: str(num_slices), ENV_SLICE_ID: str(slice_id)}


def expand_local(env: dict[str, str], nproc_per_node: int,
                 local_rank: int) -> dict[str, str]:
    """The env of local process `local_rank` of a pod that runs
    `nproc_per_node` processes: global rank = JAXJOB_PROCESS_ID x
    nproc_per_node + local rank, world = JAXJOB_NUM_PROCESSES x
    nproc_per_node. A multislice pod's slice id stays its own: its
    processes are one contiguous rank block."""
    cfg = DistConfig.from_env(env)
    out = dict(env)
    out[ENV_NPROC] = str(cfg.num_processes * nproc_per_node)
    out[ENV_PID] = str(cfg.process_id * nproc_per_node + local_rank)
    out[ENV_LOCAL_RANK] = str(local_rank)
    return out


@dataclasses.dataclass(frozen=True)
class WorldSpec:
    """One elastic-world incarnation: the controller's world annotation,
    projected into each pod. `members` is the ordered worker list of the
    current world (a member's rank is its position; the coordinator is
    members[0]); `gen` increments with every resize; `slices` (multislice
    jobs only) is each member's original slice id."""

    gen: int
    size: int
    members: tuple[str, ...]
    coordinator: str | None = None
    slices: tuple[int, ...] | None = None

    def rank_of(self, name: str) -> int | None:
        """This worker's rank in the world; None = not a member (a
        replacement waiting out the join barrier)."""
        try:
            return self.members.index(name)
        except ValueError:
            return None

    @property
    def num_slices(self) -> int:
        return len(set(self.slices)) if self.slices else 1

    def slice_of(self, name: str) -> int | None:
        rank = self.rank_of(name)
        if rank is None or not self.slices:
            return None
        return self.slices[rank]

    def to_json(self) -> str:
        return json.dumps({
            "gen": self.gen, "size": self.size,
            "members": list(self.members),
            **({"coordinator": self.coordinator} if self.coordinator
               else {}),
            **({"slices": list(self.slices)} if self.slices is not None
               else {}),
        }, sort_keys=True)

    @classmethod
    def from_json(cls, text: str | None) -> "WorldSpec | None":
        """None on missing or malformed input: the projected file can be
        mid-write or absent, and a worker keeps its current world then."""
        if not text:
            return None
        try:
            d = json.loads(text)
            members = tuple(str(m) for m in d["members"])
            slices = d.get("slices")
            if slices is not None:
                slices = tuple(int(s) for s in slices)
            spec = cls(gen=int(d["gen"]), size=int(d["size"]),
                       members=members,
                       coordinator=d.get("coordinator") or None,
                       slices=slices)
        except (ValueError, TypeError, KeyError):
            return None
        if spec.size != len(members) or spec.gen < 0:
            return None
        if spec.slices is not None and len(spec.slices) != spec.size:
            return None
        return spec


def free_port(host: str = "127.0.0.1") -> int:
    """A port free on `host` now for a coordinator that a child process
    binds later, drawn from below the kernel's ephemeral range: a port
    from bind(0) is an ephemeral one, which any bind(0) or connect() of
    another process (gloo's listeners, HTTP servers, clients) may take
    before the child binds it, and rank 0's store then fails with
    EADDRINUSE while the other ranks wait on a port nobody listens on."""
    import random

    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            hi = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        hi = 32768
    draw = random.SystemRandom()     # not the seeded global generator
    for _ in range(200):
        port = draw.randrange(max(1024, hi - 12000), hi)
        with socket.socket() as s:
            try:
                s.bind((host, port))
            except OSError:
                continue
            return port
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def wait_for_coordinator(address: str, timeout_s: float = 300.0) -> None:
    """Block until the coordinator's port accepts TCP."""
    host, _, port = address.partition(":")
    deadline = time.monotonic() + timeout_s
    delay = 0.25
    while True:
        try:
            with socket.create_connection(
                    (host, int(port or DEFAULT_COORD_PORT)), timeout=2.0):
                return
        except OSError:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"coordinator {address} not reachable after {timeout_s}s")
            time.sleep(delay)
            delay = min(delay * 2, 5.0)


def torch_backend(device) -> str:
    """The process group's transport: nccl for a CUDA device, gloo for
    the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


# -- world lifecycle (elastic re-formation) ---------------------------------
#
# The world this process belongs to. A re-entry with the same world is a
# no-op; a changed world (an elastic resize) tears the old one down
# first; one process forms nothing.
_WORLD_LOCK = threading.RLock()
_ACTIVE: DistConfig | None = None
_DIST_LIVE = False   # the active backend holds live world state
_BACKEND = None      # the CollectivesBackend that formed the active world
_DEVICE = None       # the torch.device this process trains on


class WorldTeardownError(RuntimeError):
    """Prior distributed state could not be torn down for re-formation;
    the elastic coordinator exits EX_TEMPFAIL instead of resizing."""


def _world_key(cfg: DistConfig) -> tuple:
    return (cfg.coordinator_address, cfg.num_processes, cfg.process_id,
            cfg.num_slices, cfg.slice_id)


def active_world() -> DistConfig | None:
    with _WORLD_LOCK:
        return _ACTIVE


def active_backend():
    with _WORLD_LOCK:
        return _BACKEND


def active_device():
    """The device the active world was formed for (None before the
    first initialize_from_env)."""
    with _WORLD_LOCK:
        return _DEVICE


def _torch_initialize(cfg: DistConfig, device, backend: str,
                      address: str | None = None, prefix: str = "") -> None:
    """init_process_group over a TCP store at `address` (default the
    coordinator's), rank 0 its server, the group's keys under `prefix`.
    A server of an earlier world on the same port can outlive its group
    inside this process, and a new world shares it: the prefix keeps
    the old world's keys out of the new one's rendezvous. A seam: tests
    replace it to fake formation."""
    import datetime

    import torch.distributed as dist

    host, _, port = (address or cfg.coordinator_address).partition(":")
    timeout = datetime.timedelta(seconds=FORMATION_TIMEOUT_S)
    store = dist.TCPStore(host, int(port or DEFAULT_COORD_PORT),
                          cfg.num_processes, cfg.process_id == 0,
                          timeout=timeout, wait_for_workers=False,
                          multi_tenant=True)
    kw = {"device_id": device} if device.type == "cuda" and \
        backend == "nccl" else {}
    dist.init_process_group(
        backend, store=dist.PrefixStore(f"kftpu/{prefix}/", store),
        world_size=cfg.num_processes, rank=cfg.process_id, timeout=timeout,
        **kw)


def _torch_shutdown() -> None:
    """destroy_process_group, then collect what held the groups: the TCP
    store goes only with its last reference, and a store left alive
    would be shared (with its stale keys) by the next world formed on
    the same coordinator port in this process."""
    import gc

    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    gc.collect()


def _teardown_locked() -> None:
    global _ACTIVE, _DIST_LIVE, _BACKEND, _DEVICE
    if _DIST_LIVE:
        try:
            if _BACKEND is not None:
                _BACKEND.leave()
            else:
                _torch_shutdown()
        except Exception as e:
            raise WorldTeardownError(
                f"could not shut down the previous distributed world "
                f"({_ACTIVE}): {type(e).__name__}: {e}") from e
        _DIST_LIVE = False
    _ACTIVE = None
    _BACKEND = None
    _DEVICE = None


def shutdown() -> None:
    """Tear down this process's distributed state (no-op when none);
    WorldTeardownError when that fails."""
    with _WORLD_LOCK:
        _teardown_locked()


def initialize_from_env(env: dict[str, str] | None = None, *,
                        wait: bool = True, device=None) -> DistConfig:
    """Join the world the JAXJOB_* env describes, through the selected
    collectives backend (JAXJOB_COLLECTIVES_BACKEND: single | loopback |
    gpu; parallel/backends.py). `device` is this process's device (cuda
    unless "cpu" is asked for); it picks the transport.

    One process: a no-op. The same world again: a no-op. A changed
    world: tear the old one down (WorldTeardownError if that fails),
    then form the new one."""
    from kubeflow_tpu_torch.device import resolve_device
    from kubeflow_tpu_torch.parallel import backends as B

    cfg = DistConfig.from_env(env)
    if cfg.distributed and cfg.coordinator_address is None:
        # validate before touching world state
        raise ValueError(f"{ENV_NPROC}>1 but {ENV_COORD} unset")
    backend = B.get_backend(env=env)
    with _WORLD_LOCK:
        global _ACTIVE, _DIST_LIVE, _BACKEND, _DEVICE
        if _ACTIVE is not None:
            if _world_key(cfg) == _world_key(_ACTIVE):
                _ACTIVE = cfg  # refresh metadata (job name etc.)
                return cfg
            log.info("world changed (%s -> %s): tearing down prior state",
                     _world_key(_ACTIVE), _world_key(cfg))
            _teardown_locked()
        dev = resolve_device(device) if cfg.distributed else None
        _DIST_LIVE = backend.join(cfg, wait=wait, device=dev, env=env)
        _BACKEND = backend if _DIST_LIVE else None
        _ACTIVE = cfg
        _DEVICE = dev
    return cfg


def is_coordinator(cfg: DistConfig | None = None) -> bool:
    cfg = cfg or DistConfig.from_env()
    return cfg.process_id == 0
