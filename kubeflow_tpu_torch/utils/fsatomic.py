"""Crash-consistent small-file writes (the port's copy of
kubeflow_tpu/utils/fsatomic.py): ONE spelling of temp + fsync + rename,
shared by every layer that persists state it may be killed while
writing (the preemption steady state): the checkpoint resume manifest
(runtime/checkpoint.py) and the launcher's exit-time trace dump
(obs/trace.py).
"""

from __future__ import annotations

import os


def atomic_write_text(path: str, text: str) -> None:
    """Write ``text`` to ``path`` so a reader never observes a truncated
    file — it sees the old content or the new, nothing between. The temp
    file lives in the SAME directory (os.replace must not cross
    filesystems); a mid-write kill leaves at worst a stale ``.tmp``
    sibling, never a corrupt live file. The directory fd is fsynced
    after the rename (best-effort: not all filesystems allow it) so the
    rename itself is durable, not just the data."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    tmp = os.path.join(directory,
                       f".{os.path.basename(path)}.{os.getpid()}.tmp")
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        with os.fdopen(fd, "w") as fh:
            fh.write(text)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    try:
        dir_fd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
    except OSError:
        pass
