"""Checkpoint and resume for the port's training runtime (port of
kubeflow_tpu/runtime/checkpoint.py, in the port's own on-disk format:
the card's machine has no orbax).

Layout: one directory per step, `<dir>/<step>/`, holding the payload
`{"step", "params", "batch_stats": {}, "opt_state"}` written by
`torch.save` in two files, `params.pt` (step, params, batch_stats) and
`opt_state.pt`, and read back with `weights_only=True`. `params` is the
model's state_dict (port names, CPU tensors); `opt_state` maps each
parameter name to its optimizer state (torch.optim.AdamW's `step`,
`exp_avg`, `exp_avg_sq`; runtime/optim.py Adafactor's `step` and `v` or
`v_row`/`v_col`, in the flax layout). The optimizer itself is rebuilt
from the config on restore: it is code, not state. `convert.py`
translates the payload to and from the reference's optax trees.

Contract, as the reference's:
- `save` copies the payload device -> host on the caller, inside a
  `train.checkpoint` span, then writes it on a worker thread into a
  temp directory (fsync, then rename): a save killed part-way is never
  visible as a step. One write is in flight at a time. A step that
  exists is skipped unless `force`, which deletes it, then saves.
- A directory given as a URI (`gs://`, `s3://`, `memory://`,
  `file://`, ...) goes through fsspec, where fsspec imports and has an
  implementation for the scheme (gcsfs, s3fs, ...), and is refused with
  a ValueError naming what is missing where it does not. An object store
  has no rename, so there a step is written in place, `<dir>/<step>/`,
  and counts as written only once its commit marker `COMMIT`, written
  last, is present (orbax's `commit_success` on GCS does the same):
  `list_steps` and every restore skip a step without it, and a save
  over it replaces it. "Atomic" means there that each object appears
  whole (an object store's PUT) and that a step appears only with its
  marker; the manifest is one object, whole but not fsynced. A step
  left without its marker is removed once a newer step commits. No PID
  is probed there: a temp name may come from another host.
- `keep` newest steps are retained (0 keeps every step); older ones go
  once a save lands.
- `restore_latest` tries steps newest first, skips one that fails to
  restore, re-raises the last error when every step fails, and returns
  None only for a directory with no step.
- `manifest.json` (`latest_step`, `steps`, `world_sizes`,
  `slice_counts`) is written atomically after saves finalize.
- `checkpoint_failures_total{op=save|restore}` is registered at 0.
- `restore_variables` reads params only, never the optimizer state.

On a world of several processes the save is collective: the caller
gathers the whole state on every rank (runtime/trainer.py `payload`),
rank 0 alone writes it, and `save` and `wait`/`close` end with rank 0
broadcasting what came of it (saved, skipped or failed) once its part
is done, whether it raised or not: every rank meets there, the others
raise CheckpointError when rank 0 failed, and after `wait` rank 0's
write has landed, so a world that re-forms (an elastic resize) finds
the step on disk. Each rank restores the whole payload and cuts
its own shards from it (`load_payload`): a checkpoint restores onto any
world and mesh, as orbax restores onto a template.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from typing import Any

import torch

from kubeflow_tpu_torch.utils.fsatomic import atomic_write_text

log = logging.getLogger("kubeflow_tpu_torch.checkpoint")

PARAMS_FILE = "params.pt"
OPT_FILE = "opt_state.pt"
COMMIT_FILE = "COMMIT"     # a URI directory's step marker, written last
_TMP_PREFIX = ".tmp-"
# what came of rank 0's save or wait, broadcast to the world
_SKIPPED, _SAVED, _FAILED = 0, 1, 2


class CheckpointError(RuntimeError):
    """Rank 0's save or write failed: what the other ranks of the world
    raise."""


def _resolve(directory: str) -> str:
    """Local paths become absolute; a URI passes through untouched
    (abspath would mangle its scheme into a pod-local path and silently
    defeat a gang restart's resume)."""
    if "://" in directory:
        return directory.rstrip("/")
    return os.path.abspath(directory)


def _normalize_dir(directory: str) -> str:
    """_resolve, and the directory created."""
    directory = _resolve(directory)
    remote = _remote(directory)
    if remote is None:
        os.makedirs(directory, exist_ok=True)
    else:
        remote[0].makedirs(remote[1], exist_ok=True)
    return directory


def _remote(directory: str):
    """(fsspec filesystem, its path) of a URI directory; None for a
    local path. A ValueError names what is missing: fsspec itself, or
    its implementation of the scheme."""
    if "://" not in directory:
        return None
    try:
        import fsspec
    except ImportError as e:
        raise ValueError(f"{directory}: a URI checkpoint directory goes "
                         f"through fsspec, which does not import here "
                         f"({e}); use a local (or mounted) path") from e
    try:
        fs, path = fsspec.core.url_to_fs(directory)
    except (ImportError, ValueError) as e:
        raise ValueError(f"{directory}: fsspec has no implementation for "
                         f"this scheme here ({e}); use a local (or "
                         "mounted) path") from e
    return fs, path.rstrip("/")


def _count_failure(op: str, by: float = 1.0) -> None:
    from kubeflow_tpu_torch.runtime import metrics as rt_metrics

    rt_metrics.REGISTRY.counter_inc(
        "checkpoint_failures_total",
        help_="checkpoint saves/restores that raised", by=by, op=op)


def _to_host(tree: Any) -> Any:
    """The payload with every tensor copied to the CPU (detached)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _nbytes(tree: Any) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return 0


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def list_steps(directory: str) -> list[int]:
    """The finalized steps under `directory`, ascending (under a URI,
    the steps whose commit marker is present)."""
    remote = _remote(directory)
    if remote is not None:
        return sorted(set(_remote_steps(*remote)[0]))
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    return sorted(int(n) for n in names
                  if n.isdigit() and os.path.isdir(os.path.join(directory, n)))


def _remote_steps(fs, root: str) -> tuple[list[int], list[int]]:
    """(committed steps, steps without their marker) under `root`."""
    try:
        names = [p.rstrip("/").rsplit("/", 1)[-1]
                 for p in fs.ls(root, detail=False)]
        marked = {p.rstrip("/").split("/")[-2]
                  for p in fs.glob(f"{root}/*/{COMMIT_FILE}")}
    except FileNotFoundError:
        return [], []
    steps = [int(n) for n in names if n.isdigit()]
    return ([s for s in steps if str(s) in marked],
            [s for s in steps if str(s) not in marked])


def _load(directory: str, step: int, params_only: bool = False) -> dict:
    remote = _remote(directory)
    if remote is not None:
        fs, root = remote
        path = f"{root}/{int(step)}"
        if not fs.exists(f"{path}/{COMMIT_FILE}"):
            raise FileNotFoundError(f"{directory}: step {step} has no "
                                    "commit marker")
        files = [PARAMS_FILE] if params_only else [PARAMS_FILE, OPT_FILE]
        payload = {}
        for name in files:
            with fs.open(f"{path}/{name}", "rb") as f:
                payload.update(torch.load(f, map_location="cpu",
                                          weights_only=True))
        return payload
    path = os.path.join(directory, str(int(step)))
    payload = torch.load(os.path.join(path, PARAMS_FILE), map_location="cpu",
                         weights_only=True)
    if not params_only:
        payload.update(torch.load(os.path.join(path, OPT_FILE),
                                  map_location="cpu", weights_only=True))
    return payload


def _parts(host: dict) -> dict:
    """The step's files: the params part and the optimizer state."""
    return {PARAMS_FILE: {k: v for k, v in host.items() if k != "opt_state"},
            OPT_FILE: {"opt_state": host.get("opt_state", {})}}


class Checkpointer:
    """Async checkpointing with resume-from-latest.

    Usage (what Trainer.fit does):
        ckpt = Checkpointer(cfg.checkpoint_dir, keep=cfg.checkpoint_keep)
        ckpt.restore_latest(trainer)       # gang-restart resume
        ...
        ckpt.save(step, trainer.payload())  # async, non-blocking write
        ...
        ckpt.close()                        # wait + manifest

    A restore target is any object with `load_payload(payload)`."""

    def __init__(self, directory: str, keep: int = 3,
                 world_size: int | None = None, num_slices: int | None = None,
                 rank: int = 0, collective=None):
        """`rank` and `collective` (an object with `agree(int) -> int`,
        rank 0's value on every rank) for a world of several
        processes."""
        self.directory = _normalize_dir(directory)
        self._fs = _remote(self.directory)   # (fs, path) under a URI
        self.rank = rank
        self._collective = collective
        self.keep = keep
        # the failure counter starts at 0 for both ops: an alert on its
        # increase() needs a sample before the first failure
        for op in ("save", "restore"):
            _count_failure(op, by=0.0)
        self.world_size = world_size
        self._world_sizes: dict[int, int] = {}
        self.num_slices = num_slices
        self._slice_counts: dict[int, int] = {}
        self._writer: threading.Thread | None = None
        self._write_error: BaseException | None = None
        if rank == 0 and self._fs is None:
            self._remove_stale_temps()

    def _remove_stale_temps(self) -> None:
        """Temp directories of saves whose process is gone (killed
        mid-write): never steps, only disk."""
        for name in os.listdir(self.directory):
            if not name.startswith(_TMP_PREFIX):
                continue
            try:
                os.kill(int(name.rsplit("-", 1)[1]), 0)
                continue            # its writer is alive
            except (ValueError, IndexError, ProcessLookupError):
                pass
            except PermissionError:
                continue
            shutil.rmtree(os.path.join(self.directory, name),
                          ignore_errors=True)

    # -- inspection --------------------------------------------------------

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return list_steps(self.directory)

    # -- save / restore ----------------------------------------------------

    def save(self, step: int, state: dict, force: bool = False) -> bool:
        """Queue a save of payload `state` at `step`. The device -> host
        copy happens before return; the file write is off-thread. A step
        already in the directory is skipped unless force=True, which
        deletes it first, then saves."""
        from kubeflow_tpu_torch.obs import trace as obs_trace

        step = int(step)
        if self.rank != 0:
            return self._agree(None) == _SAVED
        status = _FAILED
        try:
            # one write in flight: the previous one lands (or raises) first
            self._join_writer()
            if step in self.all_steps():
                if not force:
                    log.warning("checkpoint: step %d already exists in %s; "
                                "skipping (pass force=True to overwrite)",
                                step, self.directory)
                    status = _SKIPPED
                    return False
                self._remove_step(step)
            # the window this call blocks the step loop for: the
            # goodput ledger's `checkpoint` bucket reads this span name
            with obs_trace.TRACER.span("train.checkpoint", step=step) as sp:
                host = _to_host(state)
                nbytes = sp.attrs["bytes"] = _nbytes(host)
            self._writer = threading.Thread(
                target=self._write, args=(step, host), daemon=False,
                name=f"checkpoint-{step}")
            self._writer.start()
            status = _SAVED
        except Exception:
            _count_failure("save")
            raise
        finally:
            self._agree(status)     # every rank meets here, raised or not
        if self.world_size:
            self._world_sizes[step] = self.world_size
        if self.num_slices:
            self._slice_counts[step] = self.num_slices
        log.info("checkpoint: queued save at step %d -> %s (%d bytes, "
                 "blocked %.3f s)", step, self.directory, nbytes,
                 sp.duration)
        return True

    def _agree(self, status: int | None) -> int | None:
        """Rank 0's `status` on every rank of a world (the others pass
        None); they raise CheckpointError when it is a failure."""
        if self._collective is None:
            return status
        got = self._collective.agree(_FAILED if status is None else status)
        if self.rank != 0 and got == _FAILED:
            raise CheckpointError(
                f"checkpoint: rank 0 failed to save to {self.directory}")
        return got

    def _remove_step(self, step: int, missing_ok: bool = False) -> None:
        if self._fs is None:
            shutil.rmtree(os.path.join(self.directory, str(step)),
                          ignore_errors=missing_ok)
            return
        fs, root = self._fs
        try:
            fs.rm(f"{root}/{step}", recursive=True)
        except FileNotFoundError:
            if not missing_ok:
                raise

    def _write(self, step: int, host: dict) -> None:
        if self._fs is not None:
            self._write_remote(step, host)
            return
        t0 = time.perf_counter()
        tmp = os.path.join(self.directory, f"{_TMP_PREFIX}{step}-{os.getpid()}")
        try:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for name, part in _parts(host).items():
                with open(os.path.join(tmp, name), "wb") as f:
                    torch.save(part, f)
                    f.flush()
                    os.fsync(f.fileno())
            _fsync_dir(tmp)
            os.rename(tmp, os.path.join(self.directory, str(step)))
            _fsync_dir(self.directory)
            self._retain()
            log.info("checkpoint: step %d written in %.3f s", step,
                     time.perf_counter() - t0)
        except BaseException as e:  # surfaces at the next join
            shutil.rmtree(tmp, ignore_errors=True)
            self._write_error = e

    def _write_remote(self, step: int, host: dict) -> None:
        """In place under `<dir>/<step>/`, the commit marker last: the
        step is a step once the marker is there."""
        t0 = time.perf_counter()
        fs, root = self._fs
        path = f"{root}/{step}"
        try:
            self._remove_step(step, missing_ok=True)   # a marker-less step
            fs.makedirs(path, exist_ok=True)
            parts = _parts(host)
            for name, part in parts.items():
                with fs.open(f"{path}/{name}", "wb") as f:
                    torch.save(part, f)
            with fs.open(f"{path}/{COMMIT_FILE}", "w") as f:
                f.write(json.dumps({"step": step,
                                    "files": sorted(parts)}) + "\n")
            self._retain()
            log.info("checkpoint: step %d written in %.3f s", step,
                     time.perf_counter() - t0)
        except BaseException as e:  # surfaces at the next join
            self._write_error = e

    def _retain(self) -> None:
        if self._fs is not None:
            steps, unmarked = _remote_steps(*self._fs)
            # a step left without its marker (a writer killed part-way)
            # goes once a newer step has committed
            for old in unmarked:
                if steps and old < max(steps):
                    self._remove_step(old, missing_ok=True)
            steps.sort()
        else:
            steps = self.all_steps()
        for old in steps[:max(0, len(steps) - self.keep)] if self.keep else ():
            self._remove_step(old, missing_ok=True)

    def _join_writer(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            raise err

    def restore(self, step: int, target=None) -> dict:
        """The payload of `step` (CPU tensors), loaded into `target`
        (its `load_payload`) when one is given."""
        t0 = time.perf_counter()
        payload = _load(self.directory, step)
        if target is not None:
            target.load_payload(payload)
        log.info("checkpoint: restored step %d from %s in %.3f s", step,
                 self.directory, time.perf_counter() - t0)
        return payload

    def restore_latest(self, target=None) -> dict | None:
        """Resume-from-latest: the restored payload, or None when the
        directory has no step (a fresh start).

        A step that fails to restore (killed mid-write on a filesystem
        without atomic rename, a truncated file, bit rot) is skipped and
        the previous one tried: raising would wedge every gang restart
        on one bad file. When EVERY step fails the cause is likely
        systematic (the volume, a model mismatch), so the last error is
        raised rather than silently starting fresh."""
        steps = sorted(self.all_steps(), reverse=True)
        last_error: Exception | None = None
        for i, step in enumerate(steps):
            try:
                return self.restore(step, target)
            except Exception as e:
                _count_failure("restore")
                last_error = e
                log.warning(
                    "checkpoint: step %d in %s is unrestorable (%s: %s); "
                    "falling back to %s", step, self.directory,
                    type(e).__name__, e,
                    f"step {steps[i + 1]}" if i + 1 < len(steps)
                    else "no remaining steps")
        if last_error is not None:
            raise last_error
        return None

    # -- lifecycle ---------------------------------------------------------

    def _write_manifest(self) -> None:
        """Crash-consistent resume manifest next to the steps, written
        atomically AFTER saves finalize, so it never names a step that
        is not on disk. World sizes and slice counts of earlier
        incarnations are merged in, pruned to the steps still present."""
        if self._fs is None:
            path = os.path.join(self.directory, "manifest.json")
        else:
            path = f"{self._fs[1]}/manifest.json"
        opener = open if self._fs is None else self._fs[0].open
        try:
            steps = self.all_steps()
            prior: dict = {}
            try:
                with opener(path) as f:
                    prior = json.load(f)
                if not isinstance(prior, dict):
                    prior = {}
            except (OSError, ValueError):
                pass

            def merged(key: str, mine: dict[int, int]) -> dict[str, int]:
                old = prior.get(key) or {}
                out = ({k: v for k, v in old.items()
                        if k.isdigit() and int(k) in steps}
                       if isinstance(old, dict) else {})
                out.update({str(s): n for s, n in mine.items() if s in steps})
                return out

            text = json.dumps({"latest_step": steps[-1] if steps else None,
                               "steps": steps,
                               "world_sizes": merged("world_sizes",
                                                     self._world_sizes),
                               "slice_counts": merged("slice_counts",
                                                      self._slice_counts)},
                              sort_keys=True) + "\n"
            if self._fs is None:
                atomic_write_text(path, text)
            else:
                with opener(path, "w") as f:   # one object, whole
                    f.write(text)
        except OSError as e:
            log.warning("checkpoint: manifest write failed: %s", e)

    def wait(self) -> None:
        """Block until the queued save is durably finalized (on every rank
        of a world: they meet at rank 0's status after its write, and
        raise CheckpointError when that write failed)."""
        if self.rank != 0:
            self._agree(None)
            return
        status = _FAILED
        try:
            self._join_writer()
            status = _SAVED
        except Exception:
            _count_failure("save")
            raise
        finally:
            self._write_manifest()
            self._agree(status)

    def close(self) -> None:
        self.wait()


def restore_variables(directory: str, step: int | None = None
                      ) -> tuple[dict, int]:
    """Inference restore: `({"params": state_dict}, step)` from a
    training checkpoint, for serving. Only `params.pt` is read: the
    optimizer state (2x the params for adamw) never costs a serving
    process its I/O or host memory. The directory resolves as the
    Checkpointer's does: a URI passes through."""
    directory = _resolve(directory)
    steps = list_steps(directory)
    if step is None:
        step = steps[-1] if steps else None
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    payload = _load(directory, step, params_only=True)
    variables = {"params": payload["params"]}
    if payload.get("batch_stats"):
        variables["batch_stats"] = payload["batch_stats"]
    return variables, int(step)


def restore_params(directory: str, step: int | None = None
                   ) -> tuple[dict, int]:
    """Params-only convenience wrapper over restore_variables."""
    variables, step = restore_variables(directory, step)
    return variables["params"], step

