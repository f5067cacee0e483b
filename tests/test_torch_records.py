"""The port's KFR1 record shards (kubeflow_tpu_torch/runtime/records.py) and
native loader (kubeflow_tpu_torch/native.py) against the JAX package's:
the same bytes on disk both ways, the same batches from the same seeded
inputs, and the port's native loader against its Python loader."""

import os
import zlib

import numpy as np
import pytest

from kubeflow_tpu import native as jnative
from kubeflow_tpu.runtime import records as jrecords
from kubeflow_tpu_torch import native as tnative
from kubeflow_tpu_torch.runtime import records as trecords

SEQ = 16


def _docs(seed: int, n: int = 60, longest: int = 50) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 500, int(k), dtype=np.int32)
            for k in rng.integers(1, longest, n)]


def _plain_tokens(seed: int, rows: int = 40) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 500, (rows, SEQ + 1), dtype=np.int32)


@pytest.fixture
def loaders(request, monkeypatch):
    """Both packages on the Python loader, or both on their native one."""
    if request.param == "python":
        monkeypatch.setattr(jnative, "load", lambda: None)
        monkeypatch.setattr(tnative, "load", lambda: None)
    else:
        assert jnative.load() is not None and tnative.load() is not None
    return request.param


def test_port_native_library_builds_into_its_own_build_dir():
    lib = tnative.load()
    assert lib is not None
    path = tnative.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "kubeflow_tpu_torch"
    data = np.arange(1000, dtype=np.uint8)
    import ctypes

    crc = lib.kfdl_crc32(data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         data.size)
    assert crc == zlib.crc32(data.tobytes()) & 0xFFFFFFFF


def test_native_rebuilds_when_the_source_is_newer(tmp_path, monkeypatch):
    src = tmp_path / "kfdata.cc"
    src.write_bytes(tnative.SOURCE.read_bytes())
    lib = tmp_path / "_build" / "libkfdata.so"
    monkeypatch.setattr(tnative, "SOURCE", src)
    monkeypatch.setattr(tnative, "library_path", lambda: lib)
    assert tnative.build() == lib and lib.exists()
    os.utime(lib, (1, 1))                    # older than the source
    first = lib.stat().st_mtime
    assert tnative.build() == lib and lib.stat().st_mtime > first
    # no compiler: the Python loader takes over
    os.utime(lib, (1, 1))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert tnative.build() == lib            # the stale build is kept
    lib.unlink()
    assert tnative.build() is None


@pytest.mark.parametrize("kind", ["plain", "packed"])
def test_shards_are_byte_identical_both_ways(tmp_path, kind):
    if kind == "plain":
        tok = _plain_tokens(0)
        trecords.write_token_shard(str(tmp_path / "t.kfr"), tok)
        jrecords.write_token_shard(str(tmp_path / "j.kfr"), tok)
    else:
        tok, seg = trecords.pack_documents(_docs(0), SEQ)
        trecords.write_packed_token_shard(str(tmp_path / "t.kfr"), tok, seg)
        jrecords.write_packed_token_shard(str(tmp_path / "j.kfr"), tok, seg)
    assert (tmp_path / "t.kfr").read_bytes() == (tmp_path / "j.kfr").read_bytes()
    for path in ("t.kfr", "j.kfr"):
        assert (trecords.read_header(str(tmp_path / path))
                == jrecords.read_header(str(tmp_path / path)))


@pytest.mark.parametrize("loaders", ["python", "native"], indirect=True)
@pytest.mark.parametrize("segmented,shuffle,loop", [
    (False, 0, False), (False, 8, True), (True, 0, True), (True, 8, False)])
def test_token_batches_equal_the_reference(tmp_path, loaders, segmented,
                                           shuffle, loop):
    # the port writes half the shards, the reference the other half
    if segmented:
        for i, (mod, seed) in enumerate(((trecords, 1), (jrecords, 2))):
            tok, seg = mod.pack_documents(_docs(seed), SEQ)
            mod.write_packed_token_shard(str(tmp_path / f"s{i}.kfr"), tok, seg)
    else:
        trecords.write_token_shard(str(tmp_path / "s0.kfr"), _plain_tokens(1))
        jrecords.write_token_shard(str(tmp_path / "s1.kfr"), _plain_tokens(2))
    paths = sorted(str(p) for p in tmp_path.glob("s*.kfr"))
    kw = dict(shuffle_buffer=shuffle, seed=5, loop=loop, segmented=segmented)
    got = trecords.token_batches(paths, 4, SEQ, **kw)
    want = jrecords.token_batches(paths, 4, SEQ, **kw)
    n = 0
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        n += 1
        if n == 25:
            break
    assert n >= 15
    got.close()
    want.close()


def test_pack_documents_equals_the_reference():
    for seed, seq in ((0, 16), (1, 31), (2, 64)):
        docs = _docs(seed, n=80, longest=3 * seq)   # pieces split too
        for a, b in zip(trecords.pack_documents(docs, seq),
                        jrecords.pack_documents(docs, seq)):
            np.testing.assert_array_equal(a, b)
    tok, seg = trecords.pack_documents([np.array([], np.int32)] * 3, 8)
    assert tok.shape == seg.shape == (0, 9)


def test_native_loader_equals_the_python_loader(tmp_path):
    tok, seg = trecords.pack_documents(_docs(3, n=120), SEQ)
    half = tok.shape[0] // 2
    trecords.write_packed_token_shard(str(tmp_path / "a.kfr"), tok[:half],
                                      seg[:half])
    trecords.write_packed_token_shard(str(tmp_path / "b.kfr"), tok[half:],
                                      seg[half:])
    paths = [str(tmp_path / "a.kfr"), str(tmp_path / "b.kfr")]
    for drop in (True, False):
        runs = {}
        for native in (True, False):
            ds = trecords.RecordDataset(paths, 5, native=native,
                                        drop_remainder=drop)
            assert ds.native is native
            runs[native] = list(ds)
            ds.close()
        assert len(runs[True]) == len(runs[False]) > 0
        for a, b in zip(runs[True], runs[False]):
            np.testing.assert_array_equal(a, b)
    # with a shuffle pool both read every record once (their draws differ)
    for native in (True, False):
        ds = trecords.RecordDataset(paths, 1, native=native, shuffle_buffer=16,
                                    seed=3)
        rows = sorted(r.tobytes() for b in ds for r in b)
        ds.close()
        assert rows == sorted(r.tobytes() for r in np.concatenate(
            [tok, seg], 1).view(np.uint8).reshape(tok.shape[0], -1))


@pytest.mark.parametrize("native", [True, False])
def test_corruption_and_mismatch_detected(tmp_path, native):
    trecords.write_token_shard(str(tmp_path / "a.kfr"), _plain_tokens(4, 8))
    raw = bytearray((tmp_path / "a.kfr").read_bytes())
    raw[40] ^= 0xFF                        # inside record 0's payload
    (tmp_path / "bad.kfr").write_bytes(bytes(raw))
    ds = trecords.RecordDataset([str(tmp_path / "bad.kfr")], 4, native=native)
    with pytest.raises(ValueError, match="crc"):
        list(ds)
    ds.close()
    ds = trecords.RecordDataset([str(tmp_path / "a.kfr")], 4, native=native,
                                record_bytes=32)
    with pytest.raises(ValueError, match="record_bytes"):
        list(ds)
    ds.close()


def test_native_none_falls_back_and_true_requires_the_library(tmp_path,
                                                               monkeypatch):
    trecords.write_token_shard(str(tmp_path / "a.kfr"), _plain_tokens(5, 8))
    monkeypatch.setattr(tnative, "load", lambda: None)
    ds = trecords.RecordDataset([str(tmp_path / "a.kfr")], 4)
    assert ds.native is False and len(list(ds)) == 2
    with pytest.raises(RuntimeError, match="native"):
        trecords.RecordDataset([str(tmp_path / "a.kfr")], 4, native=True)
    with pytest.raises(ValueError, match="no shard"):
        trecords.RecordDataset([], 4)


def test_writer_rejects_bad_inputs(tmp_path):
    with pytest.raises(ValueError):
        trecords.write_token_shard(str(tmp_path / "x"), np.zeros((2, 3)))
    with pytest.raises(ValueError):
        trecords.write_packed_token_shard(
            str(tmp_path / "x"), np.zeros((2, 3), np.int32),
            np.zeros((2, 4), np.int32))
    with pytest.raises(ValueError, match="empty"):
        trecords.write_records(str(tmp_path / "x"), [])
    with pytest.raises(ValueError, match="equal length"):
        trecords.write_records(str(tmp_path / "x"), [b"ab", b"abc"])
