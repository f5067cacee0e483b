"""The port's SlotDecoder (serving/continuous.py), dense and paged,
against JAX `generate` on the same converted weights, in f32 on the CPU
(in bf16 a near-tie can round either way in either framework): greedy
tokens identical, one request at a time and many at once; and the
decoder's own rules: deadline cancel, the admission error that frees
pages before the slot, per-request budgets, recovery from a failed
tick, a malformed row."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from kubeflow_tpu.models.registry import get_model as jax_get_model
from kubeflow_tpu.runtime.generate import generate as jax_generate
from kubeflow_tpu.serving.continuous import SlotDecoder as JaxSlotDecoder
from kubeflow_tpu_torch.convert import flax_to_state_dict
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.serving.continuous import SlotDecoder
from kubeflow_tpu_torch.serving.router import DeadlineExceeded

P = 8


@pytest.fixture(scope="module")
def lm():
    jm = jax_get_model("transformer-test", vocab_size=64, max_seq_len=24,
                       dtype=jnp.float32)
    variables = meta.unbox(jm.init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 1), jnp.int32),
                                   train=False))
    return jm, variables, flax_to_state_dict(
        jax.device_get(variables["params"]))


def torch_model(sd, **kw):
    tm = get_model("transformer-test", device="cpu", vocab_size=64,
                   max_seq_len=24, dtype="float32", **kw)
    tm.load_state_dict(sd)
    return tm


_REF: dict = {}


def reference(lm, tokens, max_new=4):
    """JAX generate on one left-padded row: the new tokens."""
    key = (tuple(tokens), max_new)
    if key not in _REF:
        jm, variables, _ = lm
        row = [int(t) for t in tokens][-P:]
        pad = P - len(row)
        out = jax_generate(jm, variables,
                           jnp.asarray([[0] * pad + row], jnp.int32),
                           max_new_tokens=max_new,
                           pad_len=jnp.asarray([pad], jnp.int32))
        _REF[key] = [int(t) for t in np.asarray(out)[0, P:]]
    return _REF[key]


def submit_all(dec, prompts, **kw):
    results: list = [None] * len(prompts)

    def go(i):
        try:
            results[i] = dec.submit(prompts[i], **kw)
        except Exception as e:  # noqa: BLE001 - asserted by the caller
            results[i] = e

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return results


PAGED = dict(kv_pages=25, kv_page_size=4)


@pytest.mark.parametrize("kw", [{}, PAGED], ids=["dense", "paged"])
def test_sequential_joins_match_generate(lm, kw):
    dec = SlotDecoder(torch_model(lm[2], **kw), None, slots=4, prompt_len=P,
                      max_new_tokens=4)
    try:
        prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [9], [10, 11],
                   list(range(1, 12))]
        assert [dec.submit(p) for p in prompts] == [
            reference(lm, p) for p in prompts]
        st = dec.stats()
        assert st["mode"] == ("paged" if kw else "dense")
        assert st["completed"] == 5
        if kw:
            dec.alloc.check()
            assert st["kv_pages_free"] + st["kv_pages_used"] == 24
    finally:
        dec.close()


@pytest.mark.parametrize("kw", [{}, PAGED], ids=["dense", "paged"])
def test_concurrent_staggered_requests_stay_exact(lm, kw):
    """More requests than slots, joining while others decode; budgets
    run to the last position of the cache (P + N = max_seq_len)."""
    dec = SlotDecoder(torch_model(lm[2], **kw), None, slots=3, prompt_len=P,
                      max_new_tokens=16)
    try:
        prompts = [[i + 1, i + 2, i + 3] for i in range(7)]
        got = submit_all(dec, prompts)
        assert got == [reference(lm, p, 16) for p in prompts]
        if kw:
            dec.alloc.check()
            assert dec.alloc.available() == 24
    finally:
        dec.close()


def test_prefix_reuse_cow_does_not_corrupt_the_sharer(lm):
    dec = SlotDecoder(torch_model(lm[2], **PAGED), None, slots=4,
                      prompt_len=P, max_new_tokens=6)
    try:
        prompt = [3, 1, 4, 1, 5, 9, 2, 6]    # two whole pages
        held, dec._free = dec._free, []      # admit as one burst
        results: list = [None] * 3
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, dec.submit(prompt))) for i in range(3)]
        for t in threads:
            t.start()
        while dec._pending.qsize() < 3:
            threading.Event().wait(0.01)
        dec._free = held
        dec._wake.set()
        for t in threads:
            t.join(timeout=120)
        assert results == [reference(lm, prompt, 6)] * 3
        st = dec.stats()
        assert st["prefix_hit_pages"] >= 2 and st["cow_clones"] >= 1
        dec.alloc.check()
    finally:
        dec.close()


def test_admission_gates_on_pages_not_slots(lm):
    dec = SlotDecoder(torch_model(lm[2], kv_pages=8, kv_page_size=4), None,
                      slots=6, prompt_len=P, max_new_tokens=4,
                      prefix_cache=False)
    try:
        prompts = [[i + 1, i + 2] for i in range(6)]
        assert submit_all(dec, prompts) == [reference(lm, p)
                                            for p in prompts]
        assert dec.stats()["peak_active"] <= 2   # 7 pages / 3 per sequence
    finally:
        dec.close()


@pytest.mark.parametrize("kw", [{}, PAGED], ids=["dense", "paged"])
def test_per_request_budgets(lm, kw):
    dec = SlotDecoder(torch_model(lm[2], **kw), None, slots=4, prompt_len=P,
                      max_new_tokens=6)
    try:
        p = [1, 2, 3]
        full = reference(lm, p, 6)
        assert dec.submit(p, max_new=2) == full[:2]
        assert dec.submit(p, max_new=6) == full
        with pytest.raises(ValueError, match="max_new"):
            dec.submit(p, max_new=7)
        assert dec.stats()["completed"] == 2
    finally:
        dec.close()


class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


@pytest.mark.parametrize("kw", [{}, PAGED], ids=["dense", "paged"])
def test_deadline_cancel_frees_slot_and_pages(lm, kw):
    clock = _Clock()
    dec = SlotDecoder(torch_model(lm[2], **kw), None, slots=2, prompt_len=P,
                      max_new_tokens=6, clock=clock)
    try:
        with pytest.raises(DeadlineExceeded, match="before admission"):
            dec.submit([1, 2], deadline=-1.0)
        real = dec._step

        def late_step(*a):
            # the deadline passes mid-decode (and by less than the 30 s
            # after which submit() gives up on a wedged loop)
            clock.now = 60.0
            return real(*a)

        dec._step = late_step
        with pytest.raises(DeadlineExceeded, match="during decode"):
            dec.submit([1, 2, 3], deadline=50.0)
        dec._step = real
        st = dec.stats()
        assert st["deadline_canceled"] == 2 and st["completed"] == 0
        assert sorted(dec._free) == [0, 1]
        if kw:
            dec.alloc.check()
            assert dec.alloc.available() == 24
        assert dec.submit([1, 2, 3], max_new=4) == reference(lm, [1, 2, 3])
    finally:
        dec.close()


def test_paged_admission_error_frees_pages_before_the_slot(lm):
    """A prefill that raises: its pages go back (free) before its slot
    id does, so nothing leaks; the decoder then serves normally."""
    dec = SlotDecoder(torch_model(lm[2], **PAGED), None, slots=2,
                      prompt_len=P, max_new_tokens=4)
    try:
        order = []
        real_free, real_install = dec.alloc.free, dec._paged_prefill_install

        def free(slot):
            order.append(("pages", slot, list(dec._free)))
            real_free(slot)

        def boom(*a, **k):
            raise RuntimeError("prefill failed (simulated)")

        dec.alloc.free = free
        dec._paged_prefill_install = boom
        with pytest.raises(RuntimeError, match="simulated"):
            dec.submit([5, 6, 7])
        slot = order[0][1]
        assert slot not in order[0][2]     # pages freed while slot still out
        dec.alloc.check()
        assert dec.alloc.available() == 24
        dec._paged_prefill_install = real_install
        assert dec.submit([5, 6, 7]) == reference(lm, [5, 6, 7])
    finally:
        dec.close()


def test_step_failure_recovers_instead_of_zombie(lm):
    dec = SlotDecoder(torch_model(lm[2]), None, slots=2, prompt_len=P,
                      max_new_tokens=3)
    try:
        real, blew = dec._step, []

        def exploding(params, state):
            if not blew:
                blew.append(1)
                raise RuntimeError("out of memory (simulated)")
            return real(params, state)

        dec._step = exploding
        with pytest.raises(RuntimeError, match="simulated"):
            dec.submit([1, 2, 3])
        assert dec.submit([1, 2, 3]) == reference(lm, [1, 2, 3], 3)
    finally:
        dec.close()


def test_malformed_row_fails_only_its_caller(lm):
    dec = SlotDecoder(torch_model(lm[2]), None, slots=4, prompt_len=P,
                      max_new_tokens=3)
    try:
        with pytest.raises(ValueError, match="length"):
            dec.submit_padded([1, 2, 3], 0)
        assert dec.submit([4, 5]) == reference(lm, [4, 5], 3)
    finally:
        dec.close()


def test_close_fails_later_submits(lm):
    dec = SlotDecoder(torch_model(lm[2]), None, slots=2, prompt_len=P,
                      max_new_tokens=3)
    dec.close()
    with pytest.raises(RuntimeError, match="shut down"):
        dec.submit([1])


@pytest.mark.parametrize("kw", [{}, PAGED], ids=["dense", "paged"])
def test_cache_bytes_match_the_reference_decoder(lm, kw):
    jm = jax_get_model("transformer-test", vocab_size=64, max_seq_len=24,
                       dtype=jnp.float32, **kw)
    jdec = JaxSlotDecoder(jm, lm[1], slots=3, prompt_len=P, max_new_tokens=8)
    dec = SlotDecoder(torch_model(lm[2], **kw), None, slots=3, prompt_len=P,
                      max_new_tokens=8)
    try:
        assert dec.stats()["cache_bytes"] == jdec.stats()["cache_bytes"]
    finally:
        jdec.close()
        dec.close()


def test_refused_geometry_and_unported_modes(lm):
    tm = torch_model(lm[2])
    with pytest.raises(ValueError, match="max_seq_len"):
        SlotDecoder(tm, None, slots=2, prompt_len=20, max_new_tokens=8)
    with pytest.raises(ValueError, match="kv_pages"):
        SlotDecoder(torch_model(lm[2], kv_pages=3, kv_page_size=4), None,
                    slots=2, prompt_len=P, max_new_tokens=4)
    # speculative lockstep is ported; a paged draft is refused, as in
    # the reference
    with pytest.raises(ValueError, match="dense cache"):
        SlotDecoder(tm, None, slots=2, prompt_len=P, max_new_tokens=4,
                    draft_model=torch_model(lm[2], **PAGED))
    # mesh serving is ported (tests/test_torch_mesh_serving.py); the
    # paged cache and a draft stay single-chip, as in the reference
    with pytest.raises(ValueError, match="paged KV cache"):
        SlotDecoder(torch_model(lm[2], **PAGED), None, slots=2,
                    prompt_len=P, max_new_tokens=4, mesh=object())
    with pytest.raises(ValueError, match="speculative decoding"):
        SlotDecoder(tm, None, slots=2, prompt_len=P, max_new_tokens=4,
                    draft_model=torch_model(lm[2]), mesh=object())
    assert torch.is_grad_enabled()
