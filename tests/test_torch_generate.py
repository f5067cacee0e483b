"""The port's runtime/generate.py against the JAX package's, on the same
converted weights, in f32 on the CPU.

Greedy tokens must be identical to JAX `generate` (ragged left-padded
batches, GQA, the int8 cache). Chunked prefill is held to the port's
per-token oracle and to JAX's prefill_scan at 1e-5 (the tolerance of
tests/test_generate.py for the same comparison). Sampled tokens cannot
match across RNGs, so sampling is held to its law: seeded and
reproducible, in range, ties at the kth value kept by top-k, and
masked ids never drawn.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from kubeflow_tpu.models.registry import get_model as jax_get_model
from kubeflow_tpu.runtime.generate import generate as jax_generate
from kubeflow_tpu.runtime.generate import init_cache as jax_init_cache
from kubeflow_tpu.runtime.generate import prefill_scan as jax_prefill_scan
from kubeflow_tpu_torch.convert import flax_to_state_dict
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.runtime import generate as G

VOCAB = 256


def _pair(seed=0, **kw):
    kw = dict(max_seq_len=64, **kw)
    jm = jax_get_model("transformer-test", dtype=jnp.float32, **kw)
    params = meta.unbox(jm.init(jax.random.PRNGKey(seed),
                                jnp.zeros((1, 1), jnp.int32),
                                train=False)["params"])
    tm = get_model("transformer-test", device="cpu", dtype="float32", **kw)
    tm.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    return jm, {"params": params}, tm


def _ragged(seed=0, lens=(12, 5, 9, 1), width=12):
    rng = np.random.default_rng(seed)
    rows = np.zeros((len(lens), width), np.int32)
    for i, n in enumerate(lens):
        rows[i, width - n:] = rng.integers(1, VOCAB, n)
    return rows, np.array([width - n for n in lens], np.int32)


@pytest.mark.parametrize("kw", [{}, {"kv_cache_dtype": "int8"},
                                {"n_kv_heads": 1}],
                         ids=["dense", "int8-cache", "gqa4"])
def test_greedy_tokens_identical_to_jax(kw):
    jm, variables, tm = _pair(**kw)
    rows, pads = _ragged()
    want = np.asarray(jax_generate(jm, variables, jnp.asarray(rows),
                                   max_new_tokens=10,
                                   pad_len=jnp.asarray(pads)))
    got = G.generate(tm, None, torch.tensor(rows, dtype=torch.long),
                     max_new_tokens=10,
                     pad_len=torch.tensor(pads, dtype=torch.long))
    assert got.shape == (4, 22)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_without_pad_len_identical_to_jax():
    jm, variables, tm = _pair(seed=3)
    rows = np.random.default_rng(3).integers(0, VOCAB, (2, 8), np.int32)
    want = np.asarray(jax_generate(jm, variables, jnp.asarray(rows),
                                   max_new_tokens=6))
    got = G.generate(tm, None, torch.tensor(rows, dtype=torch.long),
                     max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), want)


def _prefill_pair(tm, rows, pads, **kw):
    prompt = torch.tensor(rows, dtype=torch.long)
    pad = None if pads is None else torch.tensor(pads, dtype=torch.long)
    with torch.no_grad():
        c_new, l_new = G.prefill_scan(tm, None, G.init_cache(tm, len(rows)),
                                      prompt, pad, **kw)
        c_old, l_old = G.prefill_per_token(tm, None,
                                           G.init_cache(tm, len(rows)),
                                           prompt, pad)
    np.testing.assert_allclose(l_new.numpy(), l_old.numpy(), rtol=1e-5,
                               atol=1e-5)
    for name in c_new:
        a, b = c_new[name].numpy(), c_old[name].numpy()
        for r in range(len(rows)):
            # pad positions hold what an all-masked row averages, in
            # both paths; real positions must agree
            p = 0 if pads is None else pads[r]
            np.testing.assert_allclose(a[r, p:], b[r, p:], rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    return l_new


def test_chunked_prefill_matches_oracle_and_jax():
    jm, variables, tm = _pair()
    rows, pads = _ragged(seed=1)
    for pad in (None, pads):
        got = _prefill_pair(tm, rows, pad)
        _, want = jax_prefill_scan(
            jm, variables, jax_init_cache(jm, len(rows)), jnp.asarray(rows),
            None if pad is None else jnp.asarray(pad))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_chunked_prefill_multi_chunk_and_remainder(monkeypatch):
    """Width 5 over 12 positions: full chunks at 0 and 5, a remainder
    of 2; offsets and cross-chunk attention all exercised."""
    monkeypatch.setattr(G, "PREFILL_CHUNK", 5)
    _, _, tm = _pair(seed=1)
    rows, pads = _ragged(seed=2)
    _prefill_pair(tm, rows, pads)
    calls = []
    real = tm.apply
    monkeypatch.setattr(tm, "apply", lambda *a, **k: (
        calls.append(k["decode_index"]), real(*a, **k))[1])
    with torch.no_grad():
        G.prefill_scan(tm, None, G.init_cache(tm, 4),
                       torch.tensor(rows, dtype=torch.long), None)
    assert calls == [0, 5, 10]


def test_prefill_chunk_env_override(monkeypatch):
    monkeypatch.setenv("KFTPU_PREFILL_CHUNK", "3")
    _, _, tm = _pair(seed=2)
    rows, pads = _ragged(seed=3, lens=(10, 7), width=10)
    calls = []
    real = tm.apply
    monkeypatch.setattr(tm, "apply", lambda *a, **k: (
        calls.append(k["decode_index"]), real(*a, **k))[1])
    _prefill_pair(tm, rows, pads)
    assert calls[:4] == [0, 3, 6, 9]       # then the oracle's 10 calls


def test_prefill_empty_prompt_is_noop():
    _, _, tm = _pair()
    cache = G.init_cache(tm, 1)
    before = {k: v.clone() for k, v in cache.items()}
    with torch.no_grad():
        out, logits = G.prefill_scan(tm, None, cache,
                                     torch.zeros(1, 0, dtype=torch.long),
                                     None)
    assert all(torch.equal(out[k], before[k]) for k in before)
    assert logits.shape == (1, VOCAB) and not logits.any()


def test_decode_geometry_refused():
    _, _, tm = _pair()
    with pytest.raises(ValueError, match="max_seq_len"):
        G.check_decode_geometry(tm, 60, 8)
    with pytest.raises(ValueError, match="max_seq_len"):
        G.generate(tm, None, torch.ones(1, 60, dtype=torch.long),
                   max_new_tokens=8)


def test_greedy_is_first_argmax():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    assert G._sample(logits, 0.0, 0, None).tolist() == [1, 0]


def test_sampling_is_seeded_reproducible_and_in_range():
    _, _, tm = _pair()
    prompt = torch.ones(2, 4, dtype=torch.long)
    a, b, c = (G.generate(tm, None, prompt, max_new_tokens=5,
                          temperature=1.0, top_k=10, seed=s)
               for s in (3, 3, 4))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert ((a[:, 4:] >= 0) & (a[:, 4:] < VOCAB)).all()


def test_top_k_keeps_ties_and_never_draws_masked_ids():
    """Ties at the kth value stay in the draw; every id below it is
    masked and never drawn."""
    logits = torch.full((1, 8), -5.0)
    logits[0, [1, 4, 6]] = 2.0                 # three tied at the top
    logits[0, 2] = 1.0                         # kth largest for k=4 ...
    logits[0, 7] = 1.0                         # ... and its tie
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([G._sample(logits.expand(256, 8), 1.0, 4, gen)
                         for _ in range(8)]).flatten()
    assert set(draws.tolist()) == {1, 2, 4, 6, 7}
    draws = torch.stack([G._sample(logits.expand(256, 8), 1.0, 2, gen)
                         for _ in range(8)]).flatten()
    assert set(draws.tolist()) == {1, 4, 6}    # k=2 < the 3-way tie


def test_sampling_follows_the_softmax():
    """Temperature sampling draws ids at their softmax frequencies."""
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.2, 0.0]]))
    gen = torch.Generator().manual_seed(1)
    draws = G._sample(logits.expand(20000, 4), 1.0, 0, gen)
    freq = torch.bincount(draws, minlength=4).float() / 20000
    np.testing.assert_allclose(freq.numpy(), [0.5, 0.3, 0.2, 0.0],
                               atol=0.02)
