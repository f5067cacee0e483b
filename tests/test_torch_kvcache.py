"""The port's copy of the paged-cache allocator (runtime/kvcache.py)
against the reference's cases (tests/test_kvcache.py TestPageAllocator),
against the reference allocator itself under one random sequence of
transitions, and its torch device helpers against the JAX ones."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models.registry import get_model as jax_get_model
from kubeflow_tpu.runtime import kvcache as jkv
from kubeflow_tpu_torch.convert import flax_cache_to_port
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.runtime.kvcache import (
    TRASH_PAGE,
    PageAllocator,
    copy_pages,
    init_paged_cache,
    pages_for,
)


def test_admit_shares_prefix_and_cows_the_full_hit():
    a = PageAllocator(num_pages=24, page_size=8, slots=4,
                      max_pages_per_slot=6)
    row = list(range(1, 33))                    # 4 full pages
    p0 = a.admit(0, row, 0, 40)
    assert p0.shared_pages == 0 and p0.compute_start == 0
    a.check()
    need, cached = a.plan(row, 0, 40)
    assert cached == 32
    p1 = a.admit(1, row, 0, 40)
    assert p1.shared_pages == 4 and p1.compute_start == 31
    assert len(p1.copies) == 1 and a.cow_clones == 1
    a.check()
    p2 = a.admit(2, row[:24] + [9] * 8, 0, 40)  # page-aligned divergence
    assert p2.shared_pages == 3 and p2.compute_start == 24
    assert not p2.copies
    a.check()
    p3 = a.admit(3, row[:28] + [9] * 4, 0, 40)  # mid-page divergence
    assert p3.shared_pages == 3 and p3.compute_start == 24
    a.check()


def test_plan_accounts_for_the_cow_extra_page():
    a = PageAllocator(num_pages=8, page_size=4, slots=2,
                      max_pages_per_slot=3)
    row = list(range(1, 9))
    a.admit(0, row, 0, 8)
    assert a.plan(row, 0, 8) == (1, 8)          # 0 fresh + 1 COW clone
    a.check()


def test_free_returns_pages_and_zeroes_the_table_row():
    a = PageAllocator(num_pages=16, page_size=4, slots=2,
                      max_pages_per_slot=4, prefix_cache=False)
    a.admit(0, list(range(1, 9)), 0, 16)
    a.append(0, 16)
    assert a.used_pages == 4
    a.free(0)
    a.check()
    assert a.used_pages == 0
    assert (a.table[0] == TRASH_PAGE).all()


def test_pool_exhaustion_is_an_error_not_corruption():
    a = PageAllocator(num_pages=4, page_size=4, slots=2,
                      max_pages_per_slot=3, prefix_cache=False)
    a.admit(0, list(range(1, 9)), 0, 12)
    with pytest.raises(RuntimeError, match="exhausted"):
        a.admit(1, list(range(10, 18)), 0, 12)


def test_can_admit_never_counts_its_own_hits_as_evictable():
    a = PageAllocator(num_pages=7, page_size=4, slots=2,
                      max_pages_per_slot=7)
    a.admit(0, list(range(1, 9)), 0, 8)
    a.admit(1, list(range(20, 28)), 0, 8)
    a.free(0)
    a.free(1)
    a.check()
    assert a.free_pages == 2
    row = list(range(1, 9))
    assert a.can_admit(row, 0, 20) is True
    assert a.can_admit(row, 0, 24) is False
    a.admit(0, row, 0, 20)
    a.append(0, 20)
    a.check()


def test_reset_forgets_everything():
    a = PageAllocator(num_pages=16, page_size=4, slots=2,
                      max_pages_per_slot=4)
    a.admit(0, list(range(1, 9)), 0, 12)
    a.reset()
    a.check()
    assert a.free_pages == 15 and a.used_pages == 0


def test_bad_geometry_refused():
    with pytest.raises(ValueError, match="num_pages"):
        PageAllocator(num_pages=1, page_size=4, slots=1, max_pages_per_slot=1)
    a = PageAllocator(num_pages=8, page_size=4, slots=1, max_pages_per_slot=2)
    with pytest.raises(ValueError, match="max_pages_per_slot"):
        a.admit(0, [1, 2], 0, 12)
    a.admit(0, [1, 2], 0, 8)
    with pytest.raises(RuntimeError, match="already admitted"):
        a.admit(0, [1, 2], 0, 8)
    with pytest.raises(ValueError, match="beyond reserved"):
        a.append(0, 9)
    assert pages_for(9, 4) == 3 and pages_for(8, 4) == 2


@pytest.mark.parametrize("seed", [20260804, 7])
def test_random_transitions_match_the_reference_allocator(seed):
    """One random admit/append/write_barrier/free/reset sequence through
    both allocators: every plan, copy list and counter, the tables and
    refcounts agree after every step, and check() holds throughout."""
    rng = random.Random(seed)
    kw = dict(num_pages=48, page_size=4, slots=8, max_pages_per_slot=12)
    mine, ref = PageAllocator(**kw), jkv.PageAllocator(**kw)
    live: dict[int, tuple] = {}
    admits = 0
    for _ in range(3000):
        op = rng.random()
        if op < 0.40 and len(live) < 8:
            slot = next(s for s in range(8) if s not in live)
            plen = rng.randrange(1, 25)
            row = [rng.randrange(0, 4) for _ in range(plen)]
            total = plen + rng.randrange(0, 16)
            if pages_for(total, 4) > 12:
                continue
            pad = rng.randrange(0, 2)
            ok = mine.can_admit(row, pad, total)
            assert ok == ref.can_admit(row, pad, total)
            assert mine.plan(row, pad, total) == ref.plan(row, pad, total)
            if ok:
                assert vars(mine.admit(slot, row, pad, total)) == vars(
                    ref.admit(slot, row, pad, total))
                live[slot] = (total, plen)
                admits += 1
        elif op < 0.80 and live:
            slot = rng.choice(sorted(live))
            total, cur = live[slot]
            if cur < total:
                step = min(total - cur, rng.randrange(1, 4))
                mine.append(slot, cur + step)
                ref.append(slot, cur + step)
                assert mine.write_barrier(slot, cur, cur + step) == \
                    ref.write_barrier(slot, cur, cur + step)
                live[slot] = (total, cur + step)
        elif op < 0.995 and live:
            slot = rng.choice(sorted(live))
            mine.free(slot)
            ref.free(slot)
            del live[slot]
        elif op >= 0.995:
            mine.reset()
            ref.reset()
            live.clear()
        mine.check()
        np.testing.assert_array_equal(mine.table, ref.table)
        np.testing.assert_array_equal(mine._ref, ref._ref)
        assert (mine.free_pages, mine.used_pages, mine.available()) == (
            ref.free_pages, ref.used_pages, ref.available())
    assert admits > 100
    for name in ("prefix_hit_pages", "prefix_hit_tokens", "cow_clones",
                 "admits", "evictions"):
        assert getattr(mine, name) == getattr(ref, name), name


def test_init_paged_cache_matches_jax_and_copy_pages():
    kw = dict(kv_pages=6, kv_page_size=4, max_seq_len=16)
    jm = jax_get_model("transformer-test", dtype=jnp.float32, **kw)
    want = flax_cache_to_port(jax.device_get(jkv.init_paged_cache(jm, 3)))
    tm = get_model("transformer-test", device="cpu", dtype="float32", **kw)
    cache = init_paged_cache(tm, 3)
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in want.items()}
    rng = np.random.default_rng(0)
    jcache = {}
    for name in cache:
        vals = rng.standard_normal(cache[name].shape).astype(np.float32)
        cache[name].copy_(torch.tensor(vals))
        jcache[name] = jnp.asarray(vals)
    src, dst = [1, 4], [2, 5]
    want = jkv.copy_pages(jcache, jnp.asarray(src), jnp.asarray(dst))
    copy_pages(cache, torch.tensor(src), torch.tensor(dst))
    for name in cache:
        np.testing.assert_array_equal(cache[name].numpy(),
                                      np.asarray(want[name]))
