"""KFRecord shards: the real-data input pipeline (the port's copy of
kubeflow_tpu/runtime/records.py; the image shards wait for the ResNet
slice).

KFRecord is the shard format: fixed-size records (tensor-friendly: batch
assembly is a memcpy, random access is offset arithmetic) with
per-record CRC32, read by the native C++ loader (native/kfdata.cc, built
by kubeflow_tpu_torch/native.py) on a background thread — checksums,
shuffling and batching never touch the Python hot path. A pure-Python
reader with the same semantics serves as fallback and as a differential
test oracle for the native one (the shuffle draws differ: the native
pool uses mt19937_64, the Python one PCG64; without a shuffle buffer the
two read identically).

Format:
    header : b"KFR1" | u32 version=1 | u64 record_bytes | u64 n_records
    records: n_records x (record_bytes payload | u32 crc32)
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, Sequence

import numpy as np

MAGIC = b"KFR1"
VERSION = 1
_HEADER = struct.Struct("<4sIQQ")  # magic, version, record_bytes, n_records


# ---------------------------------------------------------------------------
# writer (Python; writing shards is an offline/CI path, not the hot loop)


def write_records(path: str, records: np.ndarray | Sequence[bytes]) -> int:
    """Write a KFRecord shard. `records` is [n, record_bytes] uint8 (or a
    sequence of equal-length bytes). Returns number of records written."""
    if isinstance(records, np.ndarray):
        if records.ndim != 2 or records.dtype != np.uint8:
            raise ValueError(f"records must be [n, record_bytes] uint8, got "
                             f"{records.shape} {records.dtype}")
        rows = [r.tobytes() for r in records]
    else:
        rows = [bytes(r) for r in records]
    if not rows:
        raise ValueError("cannot write an empty shard")
    rb = len(rows[0])
    if any(len(r) != rb for r in rows):
        raise ValueError("all records must have equal length")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_HEADER.pack(MAGIC, VERSION, rb, len(rows)))
        for r in rows:
            f.write(r)
            f.write(struct.pack("<I", zlib.crc32(r) & 0xFFFFFFFF))
    os.replace(tmp, path)  # atomic: readers never see partial shards
    return len(rows)


def read_header(path: str) -> tuple[int, int]:
    """(record_bytes, n_records) of a shard."""
    with open(path, "rb") as f:
        magic, version, rb, n = _HEADER.unpack(f.read(_HEADER.size))
    if magic != MAGIC or version != VERSION:
        raise ValueError(f"{path}: not a KFRecord v{VERSION} file")
    return rb, n


# ---------------------------------------------------------------------------
# readers


def _iter_records_py(path: str, record_bytes: int) -> Iterator[bytes]:
    with open(path, "rb") as f:
        magic, version, rb, n = _HEADER.unpack(f.read(_HEADER.size))
        if magic != MAGIC or version != VERSION:
            raise ValueError(f"{path}: not a KFRecord v{VERSION} file")
        if rb != record_bytes:
            raise ValueError(f"{path}: record_bytes mismatch: file has {rb}, "
                             f"loader expects {record_bytes}")
        for i in range(n):
            payload = f.read(record_bytes)
            crc_raw = f.read(4)
            if len(payload) != record_bytes or len(crc_raw) != 4:
                raise ValueError(f"{path}: truncated record {i}")
            (crc,) = struct.unpack("<I", crc_raw)
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                raise ValueError(f"{path}: crc mismatch in record {i}")
            yield payload


class _PyLoader:
    """Pure-Python loader with the same shuffle/batch semantics as the
    native one (reservoir-swap pool, file order, end-of-data drain)."""

    def __init__(self, paths, record_bytes, batch, shuffle_buffer, seed,
                 loop, drop_remainder):
        self.paths = paths
        self.record_bytes = record_bytes
        self.batch = batch
        self.shuffle_buffer = shuffle_buffer
        self.loop = loop
        self.drop_remainder = drop_remainder
        self._rng = np.random.Generator(np.random.PCG64(seed))
        self._gen = self._batches()

    def _records(self) -> Iterator[bytes]:
        while True:
            for p in self.paths:
                yield from _iter_records_py(p, self.record_bytes)
            if not self.loop:
                return

    def _shuffled(self) -> Iterator[bytes]:
        if self.shuffle_buffer <= 1:
            yield from self._records()
            return
        pool: list[bytes] = []
        for rec in self._records():
            if len(pool) < self.shuffle_buffer:
                pool.append(rec)
                continue
            j = int(self._rng.integers(0, len(pool)))
            pool[j], rec = rec, pool[j]
            yield rec
        self._rng.shuffle(pool)  # end-of-data drain
        yield from pool

    def _batches(self) -> Iterator[np.ndarray]:
        cur: list[bytes] = []
        for rec in self._shuffled():
            cur.append(rec)
            if len(cur) == self.batch:
                yield np.frombuffer(b"".join(cur), np.uint8).reshape(
                    self.batch, self.record_bytes)
                cur = []
        if cur and not self.drop_remainder:
            yield np.frombuffer(b"".join(cur), np.uint8).reshape(
                len(cur), self.record_bytes)

    def next(self) -> np.ndarray | None:
        return next(self._gen, None)

    def close(self) -> None:
        pass


class _NativeLoader:
    def __init__(self, lib, paths, record_bytes, batch, shuffle_buffer, seed,
                 loop, drop_remainder, queue_capacity=4):
        import ctypes

        self._lib = lib
        self._ctypes = ctypes
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._h = lib.kfdl_open(arr, len(paths), record_bytes, batch,
                                shuffle_buffer, seed, int(loop),
                                int(drop_remainder), queue_capacity)
        if not self._h:
            raise ValueError("kfdl_open failed (bad arguments)")
        self.record_bytes = record_bytes
        self.batch = batch

    def next(self) -> np.ndarray | None:
        if self._h is None:  # closed: NULL handle would segfault in C++
            return None
        cap = self.batch * self.record_bytes
        out = np.empty(cap, np.uint8)
        n = self._lib.kfdl_next(
            self._h,
            out.ctypes.data_as(self._ctypes.POINTER(self._ctypes.c_uint8)),
            cap,
        )
        if n < 0:
            err = self._lib.kfdl_error(self._h).decode()
            raise ValueError(err or "kfdata: unknown error")
        if n == 0:
            return None
        assert n % self.record_bytes == 0, (n, self.record_bytes)
        return out[:n].reshape(n // self.record_bytes, self.record_bytes)

    def close(self) -> None:
        if self._h:
            self._lib.kfdl_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class RecordDataset:
    """Iterator of [batch, record_bytes] uint8 batches over KFRecord
    shards; native C++ loader when built, Python fallback otherwise."""

    def __init__(self, paths: Sequence[str], batch: int, *,
                 record_bytes: int | None = None, shuffle_buffer: int = 0,
                 seed: int = 0, loop: bool = False,
                 drop_remainder: bool = True, native: bool | None = None):
        paths = list(paths)
        if not paths:
            raise ValueError("no shard paths given")
        rb = record_bytes if record_bytes is not None else read_header(paths[0])[0]
        lib = None
        if native is None or native:
            from kubeflow_tpu_torch import native as native_pkg

            lib = native_pkg.load()
            if lib is None and native:
                raise RuntimeError("native kfdata library unavailable")
        args = (paths, rb, batch, shuffle_buffer, seed, loop, drop_remainder)
        self._impl = _NativeLoader(lib, *args) if lib else _PyLoader(*args)
        self.record_bytes = rb
        self.native = lib is not None

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        b = self._impl.next()
        if b is None:
            raise StopIteration
        return b

    def close(self) -> None:
        self._impl.close()


def token_batches(paths: Sequence[str], batch: int, seq_len: int, *,
                  shuffle_buffer: int = 0, seed: int = 0,
                  loop: bool = True, segmented: bool = False) -> Iterator[dict]:
    """LM batches from token shards: records are (seq_len+1) int32 tokens;
    yields {"tokens": [b, L], "targets": [b, L]} (next-token shift).

    segmented=True reads packed shards (write_packed_token_shard): each
    record carries tokens AND per-position segment ids, the batch gains
    "segment_ids", and targets at padding or document boundaries are -1
    (the loss-ignore convention the trainer's cross entropy applies)."""
    width = 2 if segmented else 1
    rb = width * (seq_len + 1) * 4
    ds = RecordDataset(paths, batch, record_bytes=rb,
                       shuffle_buffer=shuffle_buffer, seed=seed, loop=loop)
    try:
        for raw in ds:
            row = raw.view(np.int32).reshape(raw.shape[0], width, seq_len + 1)
            tok = row[:, 0]
            if not segmented:
                yield {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
                continue
            seg = row[:, 1]
            # target t+1 trains only within one real document: padding
            # (seg 0) and the first token of the NEXT document are not
            # predictions of the current one
            valid = (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] > 0)
            yield {"tokens": tok[:, :-1],
                   "targets": np.where(valid, tok[:, 1:], -1),
                   "segment_ids": seg[:, :-1]}
    finally:
        # Runs on generator close/GC too, so an abandoned iterator (e.g.
        # Prefetcher torn down mid-epoch) stops the native worker thread.
        ds.close()


def pack_documents(docs: Sequence[np.ndarray], seq_len: int,
                   pad_id: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Greedy best-fit packing of variable-length token documents into
    [n, seq_len+1] rows + matching 1-based segment ids (0 = padding).

    Documents longer than a row are split into row-size pieces (each
    piece its own segment occurrence); short documents share rows, the
    flash kernel's segment mask keeping their attention separate.
    Each piece goes to the open row with the SMALLEST remaining capacity
    that still fits (best-fit via a bisect on sorted remainders) —
    O(n log n) placement, so corpus-scale packing stays minutes, not the
    hours a linear scan over all open rows would take."""
    import bisect

    cap = seq_len + 1
    rows: list[list[np.ndarray]] = []
    remainders: list[tuple[int, int]] = []  # sorted (remaining, row_idx)
    for doc in docs:
        doc = np.asarray(doc, np.int32).ravel()
        if doc.size == 0:
            continue
        for piece_at in range(0, doc.size, cap):
            piece = doc[piece_at:piece_at + cap]
            i = bisect.bisect_left(remainders, (piece.size, -1))
            if i < len(remainders):
                remaining, r = remainders.pop(i)
                rows[r].append(piece)
                remaining -= piece.size
            else:
                rows.append([piece])
                r, remaining = len(rows) - 1, cap - piece.size
            if remaining:
                bisect.insort(remainders, (remaining, r))
    tokens = np.full((len(rows), cap), pad_id, np.int32)
    seg = np.zeros((len(rows), cap), np.int32)
    for r, pieces in enumerate(rows):
        at = 0
        for s, piece in enumerate(pieces, start=1):
            tokens[r, at:at + piece.size] = piece
            seg[r, at:at + piece.size] = s
            at += piece.size
    return tokens, seg


def write_token_shard(path: str, tokens: np.ndarray) -> int:
    """Write [n, seq_len+1] int32 token sequences as a KFRecord shard."""
    if tokens.ndim != 2 or tokens.dtype != np.int32:
        raise ValueError(f"tokens must be [n, seq_len+1] int32, got "
                         f"{tokens.shape} {tokens.dtype}")
    return write_records(path, tokens.view(np.uint8).reshape(tokens.shape[0], -1))


def write_packed_token_shard(path: str, tokens: np.ndarray,
                             segment_ids: np.ndarray) -> int:
    """Write packed rows (pack_documents output) as a KFRecord shard:
    each record is (seq_len+1) tokens followed by (seq_len+1) segment
    ids, both int32 — fixed-size, so the native loader needs no schema."""
    if tokens.shape != segment_ids.shape or tokens.ndim != 2:
        raise ValueError(f"tokens/segment_ids must be matching [n, L+1], "
                         f"got {tokens.shape} vs {segment_ids.shape}")
    recs = np.concatenate([tokens.astype(np.int32),
                           segment_ids.astype(np.int32)], axis=1)
    return write_records(path, recs.view(np.uint8).reshape(recs.shape[0], -1))
