"""The port's TSDB persistence and remote write (kubeflow_tpu_torch/obs/
persist.py) against the JAX package's.

Equal stores (seeded scrape cycles, staleness markers among them)
persisted by both packages' `TsdbPersister` write the same files, byte
for byte, segment by segment and snapshot by snapshot; a directory
written by either package restores in the other to the store that was
written, including the markers, and through a kill between a snapshot
and its segments' cleanup, and past a corrupt document. Under one seed,
clock and injected post, `RemoteWriteExporter` ships byte-equal JSONL
bodies with equal backoff sleeps, drops and self-metrics; the default
urllib post delivers the same bytes to a live server.
"""

import os
import random

import numpy as np
import pytest

from kubeflow_tpu.obs import persist as RP
from kubeflow_tpu.obs import tsdb as RS
from kubeflow_tpu.runtime.metrics import MetricsRegistry as RRegistry
from kubeflow_tpu_torch.obs import persist as PP
from kubeflow_tpu_torch.obs import tsdb as PS
from kubeflow_tpu_torch.runtime.metrics import MetricsRegistry as PRegistry
from kubeflow_tpu_torch.utils import httpd
from test_torch_obs_tsdb import Clock, apply_ops, registry_ops, view


def scraped_stores(seed: int, cycles: int, clock: Clock):
    """Equal stores fed by seeded scrape cycles; one target is down on
    some cycles, so staleness markers land."""
    rng = np.random.default_rng(seed)
    regs = PRegistry(), RRegistry()
    down = {int(c) for c in rng.integers(0, cycles, 3)}

    class Flaky:
        def __init__(self, S, reg):
            self.inner = S.RegistryTarget("default/replica", reg,
                                          {"job": "jaxservice"})
            self.instance, self.labels = self.inner.instance, \
                self.inner.labels
            self.cycle = 0

        def fetch(self):
            if self.cycle in down:
                raise OSError("down")
            return self.inner.fetch()

    targets = Flaky(PS, regs[0]), Flaky(RS, regs[1])
    loops = (PS.ScrapeLoop(PS.TimeSeriesStore(max_points=40), [targets[0]],
                           clock=clock),
             RS.ScrapeLoop(RS.TimeSeriesStore(max_points=40), [targets[1]],
                           clock=clock))

    def step(c):
        ops = registry_ops(rng, 5, services=("chat",))
        for reg, tgt in zip(regs, targets):
            apply_ops(reg, ops)
            tgt.cycle = c
        clock.t += 15.0
        assert loops[0].scrape_once() == loops[1].scrape_once()

    return loops[0].store, loops[1].store, step


def _files(d) -> dict:
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("seed", range(3))
def test_flushes_write_equal_files_and_cross_restore(seed, tmp_path):
    clock = Clock(0.0)
    pstore, rstore, step = scraped_stores(seed, 12, clock)
    pdir, rdir = tmp_path / "port", tmp_path / "jax"
    preg, rreg = PRegistry(), RRegistry()
    pp = PP.TsdbPersister(pstore, str(pdir), clock=clock, snapshot_every=4,
                          registry=preg)
    rp = RP.TsdbPersister(rstore, str(rdir), clock=clock, snapshot_every=4,
                          registry=rreg)
    for c in range(12):
        step(c)
        if c % 2:
            assert pp.flush() == rp.flush()
            assert _files(pdir) == _files(rdir)
            assert preg.render() == rreg.render()
    assert b'"stale"' in b"".join(_files(pdir).values())
    # the last flush wrote segments after the snapshot: both kinds restore
    assert any(n.startswith(PP.SEGMENT_PREFIX) for n in _files(pdir))
    assert PP.SNAPSHOT_FILE in _files(pdir)
    for d in (pdir, rdir):
        for S, P in ((PS, PP), (RS, RP)):
            fresh = S.TimeSeriesStore(max_points=40)
            restored = P.TsdbPersister(fresh, str(d)).restore()
            assert view(fresh) == view(pstore) == view(rstore), (d, P)
            assert restored["snapshot_samples"] > 0
    # a restored persister continues the segment numbering alike
    pq = PP.TsdbPersister(PS.TimeSeriesStore(), str(pdir))
    rq = RP.TsdbPersister(RS.TimeSeriesStore(), str(rdir))
    assert pq.restore() == rq.restore()
    assert pq._seq == rq._seq


def test_restore_after_kill_between_snapshot_and_cleanup(tmp_path):
    """Segments a snapshot subsumes are replayed idempotently, and an
    unreadable or unknown-format document is skipped, by both."""
    clock = Clock(0.0)
    pstore, rstore, step = scraped_stores(9, 8, clock)
    d = tmp_path / "d"
    pp = PP.TsdbPersister(pstore, str(d), clock=clock, snapshot_every=100)
    for c in range(8):
        step(c)
        pp.flush()
    segments = {n: b for n, b in _files(d).items()}
    pp.snapshot_now()
    # the kill: the snapshot landed, its segments' unlink never ran
    for n, b in segments.items():
        (d / n).write_bytes(b)
    (d / f"{PP.SEGMENT_PREFIX}99999998.json").write_text("{torn")
    (d / f"{PP.SEGMENT_PREFIX}99999999.json").write_text('{"v": 2}')
    (d / ".snapshot.json.123.tmp").write_text("partial")
    got = PS.TimeSeriesStore(max_points=40)
    want = RS.TimeSeriesStore(max_points=40)
    assert PP.TsdbPersister(got, str(d)).restore() == \
        RP.TsdbPersister(want, str(d)).restore()
    assert view(got) == view(want) == view(rstore)


def test_restore_missing_directory(tmp_path):
    want = RP.TsdbPersister(RS.TimeSeriesStore(), str(tmp_path / "x")) \
        .restore()
    assert PP.TsdbPersister(PS.TimeSeriesStore(), str(tmp_path / "x")) \
        .restore() == want == {"snapshot_samples": 0, "segment_samples": 0,
                               "segments": 0}


class FlakyPost:
    """Records every attempt; fails those the seeded draw picks."""

    def __init__(self, seed: int, p_fail: float):
        self.rng = random.Random(seed)
        self.p_fail = p_fail
        self.attempts: list[tuple[str, bytes, bool]] = []

    def __call__(self, url: str, body: bytes) -> None:
        ok = self.rng.random() >= self.p_fail
        self.attempts.append((url, body, ok))
        if not ok:
            raise OSError("HTTP 503")


@pytest.mark.parametrize("seed", range(4))
def test_remote_write_bodies_byte_equal(seed):
    clock = Clock(0.0)
    pstore, rstore, step = scraped_stores(seed, 10, clock)
    posts = FlakyPost(seed, 0.45), FlakyPost(seed, 0.45)
    sleeps = [], []
    regs = PRegistry(), RRegistry()
    exporters = [
        M.RemoteWriteExporter(store, "http://agg/api/v1/write", post=post,
                              batch=7, clock=clock, retry_base=0.1,
                              retry_cap=0.8, max_retries=3,
                              sleep=slept.append,
                              rng=random.Random(100 + seed).random,
                              registry=reg)
        for M, store, post, slept, reg in zip(
            (PP, RP), (pstore, rstore), posts, sleeps, regs)]
    for c in range(10):
        step(c)
        if c % 3 == 2:
            assert exporters[0].export_once() == exporters[1].export_once()
    assert exporters[0].export_once() == exporters[1].export_once()
    assert posts[0].attempts == posts[1].attempts
    assert sleeps[0] == sleeps[1] and max(sleeps[0]) <= 0.8
    assert exporters[0].dropped == exporters[1].dropped
    assert regs[0].render() == regs[1].render()
    assert any(b'"stale"' in a[1] for a in posts[0].attempts)


def test_default_post_delivers_the_same_bytes():
    got = []

    def write(req):
        got.append((req.header("content-type"), req.body))
        return {"status": "ok"}

    r = httpd.Router("aggregator")
    r.route("POST", "/api/v1/write", write)
    svc = httpd.HttpService(r, "127.0.0.1", 0).serve_background()
    try:
        clock = Clock(0.0)
        pstore, rstore, step = scraped_stores(3, 4, clock)
        for c in range(4):
            step(c)
        url = f"http://127.0.0.1:{svc.port}/api/v1/write"
        sent = (PP.RemoteWriteExporter(pstore, url, batch=50).export_once(),
                RP.RemoteWriteExporter(rstore, url, batch=50).export_once())
    finally:
        svc.shutdown()
    assert sent[0] == sent[1] > 0
    half = len(got) // 2
    assert got[:half] == got[half:]
    assert got[0][0] == "application/x-ndjson"
