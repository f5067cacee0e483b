"""Input batches (port of kubeflow_tpu/runtime/data.py): the synthetic LM
generator, the host -> device Prefetcher for real data, and the
per-process batch slice. numpy's default_rng from the same seed gives
synthetic batches bit-equal to the reference's."""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


def synthetic_tokens(batch: int, seq_len: int, vocab: int = 32000,
                     seed: int = 0) -> Iterator[dict]:
    """Infinite synthetic LM batches: the same host batch every step, so
    the input pipeline costs ~0 and the step time is the device's."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (batch, seq_len + 1), dtype=np.int32)
    while True:
        yield {"tokens": tok[:, :-1], "targets": tok[:, 1:]}


class Prefetcher:
    """Host -> device prefetch: a bounded background thread copies batch
    N+1 (a dict of numpy arrays) to `device` while step N runs.

    On a CUDA device each array is pinned and copied `non_blocking` on a
    side stream, and an event marks the copy's end. The consumer's
    stream waits on that event before it uses the batch, and every
    tensor handed out is recorded on the consumer's stream, so the
    caching allocator does not reuse its memory while a kernel of that
    stream may still read it. On the CPU the arrays are copied into
    tensors on the thread. `close()` stops the thread and closes the
    source iterator (a native reader's thread with it)."""

    _DONE = object()

    def __init__(self, it: Iterator[dict], device: torch.device | str,
                 depth: int = 2):
        self._it = it
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self._cuda else None)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put that gives up once close() was called (the
        producer never deadlocks against a consumer that left)."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _to_device(self, batch: dict):
        if not self._cuda:
            return {k: torch.from_numpy(np.array(a)) for k, a in batch.items()}, None
        with torch.cuda.stream(self._stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                   .to(self.device, non_blocking=True)
                   for k, a in batch.items()}
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def _run(self) -> None:
        try:
            for batch in self._it:
                if self._stop.is_set() or not self._put(self._to_device(batch)):
                    return
        except Exception as e:  # surfaces on next()
            self._put(e)
        finally:
            self._put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        item = self._q.get()
        if item is self._DONE:
            self._q.put(self._DONE)  # keep raising for later next() calls
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        out, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in out.values():
                t.record_stream(stream)
        return out

    def close(self) -> None:
        self._stop.set()
        # drain so a producer blocked on a full queue wakes and exits
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)
        if not self._thread.is_alive() and hasattr(self._it, "close"):
            self._it.close()


def per_process_slice(batch: dict, num_processes: int,
                      process_id: int) -> dict:
    """Slice a global host batch down to this process's rows (each
    process feeds only its own devices)."""

    def f(a):
        n = a.shape[0]
        if n % num_processes:
            raise ValueError(f"global batch {n} not divisible by "
                             f"num_processes {num_processes}")
        per = n // num_processes
        return a[process_id * per:(process_id + 1) * per]

    return {k: f(a) for k, a in batch.items()}
