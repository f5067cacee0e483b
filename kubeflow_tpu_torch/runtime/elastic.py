"""Worker-side elastic coordinator (port of kubeflow_tpu/runtime/elastic.py):
shrink or grow the training world in place instead of dying with the
gang.

The JAXJob controller re-stamps the surviving pods' world annotation (a
`parallel.dist.WorldSpec`), projected into each pod at
$JAXJOB_WORLD_FILE. In the pod:

- the world source is polled once per step, through the trainer's
  `stop` flag (agreed over the world, so the gang stops at one step);
- on a changed world the trainer's stop path checkpoints the step, the
  coordinator tears the torch world down (`dist.shutdown()`: the process
  group and its TCP store go, so the new world can bind the same
  coordinator port), re-forms it at the new size and rank, builds a
  fresh Trainer (mesh and shards for the new world) and resumes from
  the checkpoint, which restores onto any world (runtime/checkpoint.py);
  each re-formation is an `elastic.rebuild` span;
- the global batch is preserved across a resize (Preserve, the default)
  or scaled with the world (Scale), `scale_config`;
- a worker the current stamp does not name waits in the join barrier
  until a grow admits it;
- a real preemption notice wins: the worker exits EX_TEMPFAIL (75).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable

from kubeflow_tpu_torch.parallel import dist as D

log = logging.getLogger("kubeflow_tpu_torch.elastic")

BATCH_PRESERVE = D.BATCH_PRESERVE
BATCH_SCALE = D.BATCH_SCALE


def file_world_source(path: str) -> Callable[[], D.WorldSpec | None]:
    """The world stamp in `path`; a missing or partial file reads None
    (keep the current world)."""

    def read() -> D.WorldSpec | None:
        try:
            with open(path) as f:
                return D.WorldSpec.from_json(f.read())
        except OSError:
            return None

    return read


class WorldMembershipError(RuntimeError):
    """Asked to form a world this worker is not a member of."""


@dataclasses.dataclass
class ResizeExit:
    """Why run() returned (summary["elastic"] mirrors this)."""

    kind: str        # "completed" | "preempted"
    resizes: int
    worlds: list[int]


class ElasticCoordinator:
    """Drives Trainer.fit across world incarnations.

    Seams, as the reference's: `source` () -> WorldSpec | None;
    `form_world` WorldSpec -> None (default: dist.initialize_from_env on
    the world's env, on `device`); `mesh_fn` (TrainConfig, world size)
    -> Mesh | None (default: the Trainer builds cfg.mesh over the
    world)."""

    def __init__(
        self,
        source: Callable[[], "D.WorldSpec | None"],
        *,
        my_name: str | None = None,
        notice=None,
        batch_policy: str = BATCH_PRESERVE,
        form_world: "Callable[[D.WorldSpec], None] | None" = None,
        mesh_fn=None,
        device=None,
        join_timeout_s: float = 600.0,
        join_poll_s: float = 1.0,
        sleep=time.sleep,
        clock=time.monotonic,
    ):
        self.source = source
        self.my_name = my_name
        self.notice = notice
        self.batch_policy = batch_policy
        self.form_world = form_world if form_world is not None \
            else self._default_form_world
        self.mesh_fn = mesh_fn
        self.device = device
        self.join_timeout_s = join_timeout_s
        self.join_poll_s = join_poll_s
        self._sleep = sleep
        self._clock = clock

    # -- world plumbing ------------------------------------------------------

    def world_env(self, world: D.WorldSpec,
                  base_env: dict | None = None) -> dict:
        """The JAXJOB_* env of this worker's place in `world` (rank =
        membership position, coordinator = the stamp's); a slice-stamped
        world renumbers the surviving slices densely."""
        env = dict(os.environ if base_env is None else base_env)
        env[D.ENV_NPROC] = str(world.size)
        if self.my_name is None:
            rank = 0  # untracked membership: single-pod/test contract
        else:
            rank = world.rank_of(self.my_name)
            if rank is None:
                raise WorldMembershipError(
                    f"{self.my_name} is not in world gen {world.gen} "
                    f"{world.members}")
        env[D.ENV_PID] = str(rank)
        env[D.ENV_WORLD_GEN] = str(world.gen)
        if world.coordinator:
            env[D.ENV_COORD] = world.coordinator
        if world.slices is not None:
            survivors = sorted(set(world.slices))
            env[D.ENV_NUM_SLICES] = str(len(survivors))
            env[D.ENV_SLICE_ID] = str(survivors.index(world.slices[rank]))
        return env

    def _default_form_world(self, world: D.WorldSpec) -> None:
        D.initialize_from_env(self.world_env(world), device=self.device)

    def _member_world(self) -> "D.WorldSpec | None":
        w = self.source()
        if w is None:
            return None
        if self.my_name is not None and w.rank_of(self.my_name) is None:
            return None
        return w

    def wait_for_membership(self) -> D.WorldSpec:
        """The join barrier: block until the world stamp names us."""
        deadline = self._clock() + self.join_timeout_s
        while True:
            w = self._member_world()
            if w is not None:
                return w
            if self._clock() > deadline:
                raise TimeoutError(
                    f"{self.my_name}: not admitted into the elastic world "
                    f"within {self.join_timeout_s}s")
            self._sleep(self.join_poll_s)

    def _stop_flag(self, world: D.WorldSpec) -> Callable[[], bool]:
        """True on a preemption notice or a stamp other than `world`."""

        def stop() -> bool:
            if self.notice is not None and self.notice():
                return True
            cur = self.source()
            return cur is not None and \
                (cur.gen, cur.members) != (world.gen, world.members)

        return stop

    # -- run -----------------------------------------------------------------

    def run(self, cfg, *, full_world: int | None = None, callback=None,
            trainer_factory=None) -> dict:
        """Train `cfg` to completion across resizes; returns Trainer.fit's
        summary with summary["elastic"] describing the incarnations.
        cfg.checkpoint_dir must be set: the checkpoint carries the state
        across a resize."""
        from kubeflow_tpu_torch.obs import trace as obs_trace
        from kubeflow_tpu_torch.runtime.trainer import Trainer

        if not cfg.checkpoint_dir:
            raise ValueError("elastic training requires checkpoint_dir "
                             "(the resize resumes from the checkpoint)")
        if not cfg.resume:
            raise ValueError("elastic training requires resume=True "
                             "(a resized incarnation restores the "
                             "checkpointed step)")
        make_trainer = trainer_factory or (
            lambda c, world: Trainer(
                c, device=self.device,
                mesh=self.mesh_fn(c, world) if self.mesh_fn else None))
        # always through the join barrier: an unsynced file is never
        # "train solo"
        world = self.wait_for_membership()
        if full_world is None:
            full_world = world.size
        worlds: list[int] = [world.size]
        resizes = 0
        summary = None
        # a re-formation (any pass after the first) is resize-rebuild
        # time: teardown + re-form + trainer rebuild
        rebuild_span = None

        def _finish_rebuild(status: str = "OK") -> None:
            nonlocal rebuild_span
            if rebuild_span is not None:
                rebuild_span.status = status
                obs_trace.TRACER.finish(rebuild_span)
                rebuild_span = None

        while True:
            if resizes and rebuild_span is None:
                rebuild_span = obs_trace.TRACER.begin(
                    "elastic.rebuild", gen=world.gen, size=world.size)
            try:
                self.form_world(world)
            except Exception as e:
                # formation at a stale world (the stamp moved while we
                # waited for peers): retry at the current one
                cur = self._member_world()
                if cur is None or (cur.gen, cur.members) == \
                        (world.gen, world.members):
                    _finish_rebuild("ERROR")
                    raise
                log.warning(
                    "world formation at size %d failed (%s: %s); the "
                    "world moved to gen %d size %d — retrying there",
                    world.size, type(e).__name__, e, cur.gen, cur.size)
                D.shutdown()
                world = cur
                worlds.append(world.size)
                resizes += 1
                continue
            try:
                wcfg = scale_config(cfg, full_world, world.size,
                                    self.batch_policy)
                trainer = make_trainer(wcfg, world.size)
            except ValueError:
                if world.size == full_world:
                    _finish_rebuild("ERROR")
                    raise
                # the resized world does not fit the config: exit for a
                # gang restart at full size instead of crash-looping
                log.exception(
                    "world of %d is incompatible with the config; "
                    "exiting for a gang restart instead of crash-looping",
                    world.size)
                exit_ = ResizeExit("preempted", resizes, worlds)
                _finish_rebuild("ERROR")
                break
            _finish_rebuild()
            summary = trainer.fit(stop=self._stop_flag(world),
                                  callback=callback)
            if not summary.get("preempted"):
                exit_ = ResizeExit("completed", resizes, worlds)
                break
            new = self._member_world()
            resized = new is not None and \
                (new.gen, new.members) != (world.gen, world.members)
            if self.notice is not None and self.notice():
                grace = self.notice.remaining_grace()
                log.warning(
                    "preemption notice (%s grace left%s): exiting for "
                    "a gang restart",
                    f"{grace:.1f}s" if grace is not None else "unknown",
                    "; resize pending" if resized else "")
                exit_ = ResizeExit("preempted", resizes, worlds)
                break
            if not resized:
                exit_ = ResizeExit("preempted", resizes, worlds)
                break
            # the old trainer's mesh holds the world's process groups (and
            # through them its TCP store): drop it before the teardown
            trainer = None
            try:
                D.shutdown()
            except D.WorldTeardownError:
                log.exception("world teardown failed; exiting for a "
                              "gang restart instead")
                exit_ = ResizeExit("preempted", resizes, worlds)
                break
            log.info("elastic resize: world %d (gen %d) -> %d (gen %d), "
                     "resuming from the checkpoint",
                     world.size, world.gen, new.size, new.gen)
            world = new
            worlds.append(world.size)
            resizes += 1
        summary = dict(summary or {})
        summary["elastic"] = {"exit": exit_.kind, "resizes": exit_.resizes,
                              "worlds": exit_.worlds}
        if exit_.kind == "preempted":
            summary["preempted"] = True
        else:
            summary.pop("preempted", None)
        return summary


def scale_config(cfg, full_world: int, world: int, policy: str):
    """TrainConfig for one world incarnation.

    Preserve (default): the global batch is the same at every world size
    (a smaller world holds a larger shard per rank); a config already
    accumulating gradients scales grad_accum_steps so the per-rank
    microbatch stays, where divisibility allows; accumulation is never
    introduced by a resize. Scale: the global batch scales with the
    world."""
    if policy not in (BATCH_PRESERVE, BATCH_SCALE):
        raise ValueError(f"unknown batch policy {policy!r}")
    if world == full_world:
        return cfg
    if policy == BATCH_SCALE:
        scaled = cfg.global_batch * world
        if scaled % full_world:
            raise ValueError(
                f"global_batch {cfg.global_batch} x {world}/{full_world} "
                f"is not integral; Scale policy needs divisibility")
        return dataclasses.replace(cfg, global_batch=scaled // full_world)
    base = cfg.grad_accum_steps
    if base <= 1:
        return cfg
    scaled = base * full_world
    accum = scaled // world if scaled % world == 0 else base
    if cfg.global_batch % accum:
        accum = base
    return dataclasses.replace(cfg, grad_accum_steps=accum)
