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
- `keep` newest steps are retained (0 keeps every step); older ones go
  once a save lands.
- `restore_latest` tries steps newest first, skips one that fails to
  restore, re-raises the last error when every step fails, and returns
  None only for a directory with no step.
- `manifest.json` (`latest_step`, `steps`, `world_sizes`,
  `slice_counts`) is written atomically after saves finalize.
- `checkpoint_failures_total{op=save|restore}` is registered at 0.
- `restore_variables` reads params only, never the optimizer state.
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
_TMP_PREFIX = ".tmp-"


def _normalize_dir(directory: str) -> str:
    if "://" in directory:
        raise ValueError(f"{directory}: the port checkpoints to a local "
                         "(or mounted) path only")
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    return directory


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
    """The finalized steps under `directory`, ascending."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    return sorted(int(n) for n in names
                  if n.isdigit() and os.path.isdir(os.path.join(directory, n)))


def _load(directory: str, step: int, params_only: bool = False) -> dict:
    path = os.path.join(directory, str(int(step)))
    payload = torch.load(os.path.join(path, PARAMS_FILE), map_location="cpu",
                         weights_only=True)
    if not params_only:
        payload.update(torch.load(os.path.join(path, OPT_FILE),
                                  map_location="cpu", weights_only=True))
    return payload


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
                 world_size: int | None = None, num_slices: int | None = None):
        self.directory = _normalize_dir(directory)
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
        try:
            # one write in flight: the previous one lands (or raises) first
            self._join_writer()
            if step in self.all_steps():
                if not force:
                    log.warning("checkpoint: step %d already exists in %s; "
                                "skipping (pass force=True to overwrite)",
                                step, self.directory)
                    return False
                shutil.rmtree(os.path.join(self.directory, str(step)))
            # the window this call blocks the step loop for: the
            # goodput ledger's `checkpoint` bucket reads this span name
            with obs_trace.TRACER.span("train.checkpoint", step=step) as sp:
                host = _to_host(state)
                nbytes = sp.attrs["bytes"] = _nbytes(host)
        except Exception:
            _count_failure("save")
            raise
        self._writer = threading.Thread(
            target=self._write, args=(step, host), daemon=False,
            name=f"checkpoint-{step}")
        self._writer.start()
        if self.world_size:
            self._world_sizes[step] = self.world_size
        if self.num_slices:
            self._slice_counts[step] = self.num_slices
        log.info("checkpoint: queued save at step %d -> %s (%d bytes, "
                 "blocked %.3f s)", step, self.directory, nbytes,
                 sp.duration)
        return True

    def _write(self, step: int, host: dict) -> None:
        t0 = time.perf_counter()
        tmp = os.path.join(self.directory, f"{_TMP_PREFIX}{step}-{os.getpid()}")
        try:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            parts = {PARAMS_FILE: {k: v for k, v in host.items()
                                   if k != "opt_state"},
                     OPT_FILE: {"opt_state": host.get("opt_state", {})}}
            for name, part in parts.items():
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

    def _retain(self) -> None:
        steps = self.all_steps()
        for old in steps[:max(0, len(steps) - self.keep)] if self.keep else ():
            shutil.rmtree(os.path.join(self.directory, str(old)),
                          ignore_errors=True)

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
        path = os.path.join(self.directory, "manifest.json")
        try:
            steps = self.all_steps()
            prior: dict = {}
            try:
                with open(path) as f:
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

            atomic_write_text(
                path,
                json.dumps({"latest_step": steps[-1] if steps else None,
                            "steps": steps,
                            "world_sizes": merged("world_sizes",
                                                  self._world_sizes),
                            "slice_counts": merged("slice_counts",
                                                   self._slice_counts)},
                           sort_keys=True) + "\n")
        except OSError as e:
            log.warning("checkpoint: manifest write failed: %s", e)

    def wait(self) -> None:
        """Block until the queued save is durably finalized."""
        try:
            self._join_writer()
        except Exception:
            _count_failure("save")
            raise
        finally:
            self._write_manifest()

    def close(self) -> None:
        self.wait()


def restore_variables(directory: str, step: int | None = None
                      ) -> tuple[dict, int]:
    """Inference restore: `({"params": state_dict}, step)` from a
    training checkpoint, for serving. Only `params.pt` is read: the
    optimizer state (2x the params for adamw) never costs a serving
    process its I/O or host memory."""
    directory = os.path.abspath(directory)
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

