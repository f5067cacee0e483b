"""The port's speculative decoding (runtime/speculative.py, the lockstep
SlotDecoder, the served draft model) against the JAX package's, on the
same converted weights, in f32 on the CPU.

Greedy acceptance makes equality exact: every accepted token matched
the target's argmax and the bonus token is the target's argmax, so the
tokens equal plain greedy decode, and with the same draft weights the
rounds, proposals and accept counts equal JAX's too. Tokens and stats
are compared exactly (the cases of tests/test_speculative.py, k in
{1, 2, 4, 7}, a self-draft, a padded prompt), the lockstep SlotDecoder
dense and paged against JAX's with its spec_* counters, the served
batch-1 and continuous paths against the plain served predictions, and
the serving_speculative_* / serving_spec_* series in /metrics.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from kubeflow_tpu.models.registry import get_model as jax_get_model
from kubeflow_tpu.runtime.generate import generate as jax_generate
from kubeflow_tpu.runtime.speculative import (
    speculative_generate as jax_speculative_generate,
)
from kubeflow_tpu.serving.continuous import SlotDecoder as JaxSlotDecoder
from kubeflow_tpu_torch.convert import flax_to_state_dict
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.runtime.generate import generate
from kubeflow_tpu_torch.runtime.speculative import (
    greedy_accept,
    speculative_generate,
)
from kubeflow_tpu_torch.serving import server as S
from kubeflow_tpu_torch.serving.continuous import SlotDecoder

MAX_SEQ = 64
DRAFT = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
             d_ff=64)
PROMPT = (np.arange(10, dtype=np.int32).reshape(1, 10) * 13 + 5) % 250


def _pair(seed, max_seq=MAX_SEQ, **kw):
    """A JAX model with its variables and the port's twin on the same
    (converted) weights."""
    kw = dict(max_seq_len=max_seq, **kw)
    jm = jax_get_model("transformer-test", dtype=jnp.float32, **kw)
    variables = meta.unbox(jm.init(jax.random.PRNGKey(seed),
                                   jnp.zeros((1, 1), jnp.int32), train=False))
    tm = get_model("transformer-test", device="cpu", dtype="float32", **kw)
    tm.load_state_dict(flax_to_state_dict(jax.device_get(
        variables["params"])))
    return jm, variables, tm


@pytest.fixture(scope="module")
def models():
    """(target pair, draft pair): the reference test's models."""
    return _pair(0), _pair(1, **DRAFT)


def _both(models, prompt, n, k, pad=None, self_draft=False):
    (jt, tv, tt), (jd, dv, td) = models
    if self_draft:
        jd, dv, td = jt, tv, tt
    jpad = None if pad is None else jnp.asarray(pad, jnp.int32)
    want, wstats = jax_speculative_generate(
        jt, tv, jd, dv, jnp.asarray(prompt), max_new_tokens=n, k=k,
        pad_len=jpad)
    got, stats = speculative_generate(
        tt, None, td, None, torch.tensor(prompt, dtype=torch.long),
        max_new_tokens=n, k=k,
        pad_len=None if pad is None else torch.tensor(pad))
    return np.asarray(want), wstats, got.numpy(), stats


@pytest.mark.parametrize("k", [1, 2, 4, 7])
def test_tokens_and_stats_equal_jax(models, k):
    want, wstats, got, stats = _both(models, PROMPT, 16, k)
    np.testing.assert_array_equal(got, want)
    assert stats == wstats
    (_, _, tt), _ = models
    greedy = generate(tt, None, torch.tensor(PROMPT, dtype=torch.long),
                      max_new_tokens=16)
    np.testing.assert_array_equal(got, greedy.numpy())
    assert stats["tokens"] == 16 and stats["rounds"] >= 1


def test_self_draft_accepts_everything(models):
    want, wstats, got, stats = _both(models, PROMPT, 12, 4, self_draft=True)
    np.testing.assert_array_equal(got, want)
    assert stats == wstats
    assert stats["accepted"] == stats["drafted"] == stats["rounds"] * 4


def test_padded_prompt(models):
    padded = PROMPT.copy()
    padded[:, :3] = 0
    want, wstats, got, stats = _both(models, padded, 8, 3, pad=[3])
    np.testing.assert_array_equal(got, want)
    assert stats == wstats
    (jt, tv, _), _ = models
    greedy = jax_generate(jt, tv, jnp.asarray(padded), max_new_tokens=8,
                          pad_len=jnp.asarray([3], jnp.int32))
    np.testing.assert_array_equal(got, np.asarray(greedy))


def test_greedy_accept_rule():
    assert greedy_accept([1, 2, 3], [1, 2, 3, 4], 3) == 3
    assert greedy_accept([1, 5, 3], [1, 2, 3, 4], 3) == 1
    assert greedy_accept([9], [1, 2], 1) == 0


def test_refuses_batch_overflow_and_rolling(models):
    (_, _, tt), (_, _, td) = models
    with pytest.raises(ValueError, match="batch-1"):
        speculative_generate(tt, None, td, None,
                             torch.zeros(2, 8, dtype=torch.long),
                             max_new_tokens=4)
    with pytest.raises(ValueError, match="max_seq_len"):
        speculative_generate(tt, None, td, None, torch.tensor(PROMPT),
                             max_new_tokens=60, k=4)
    roll = get_model("transformer-test", device="cpu", max_seq_len=MAX_SEQ,
                     attention_window=16, rolling_kv_cache=True)
    with pytest.raises(ValueError, match="rolling_kv_cache"):
        speculative_generate(roll, None, td, None, torch.tensor(PROMPT),
                             max_new_tokens=4)


P, N = 8, 6
PROMPTS = [[5, 9, 2, 7, 11, 3], [4, 4, 8], list(range(1, 12)), [3]]
PAGED = dict(kv_pages=32, kv_page_size=4)


@pytest.fixture(scope="module")
def slot_models():
    """Target (dense and paged) and draft pairs at max_seq P + N + k."""
    seq = P + N + 4
    return (_pair(0, max_seq=seq), _pair(0, max_seq=seq, **PAGED),
            _pair(1, max_seq=seq, **DRAFT))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("self_draft", [False, True],
                         ids=["draft", "self-draft"])
def test_lockstep_slot_decoder_equals_jax(slot_models, paged, self_draft):
    (jt, tv, tt), (jp, pv, tp), (jd, dv, td) = slot_models
    jtarget, ttarget = (jp, tp) if paged else (jt, tt)
    if self_draft:
        jd, dv, td = jt, tv, tt
    kw = dict(slots=2, prompt_len=P, max_new_tokens=N, draft_k=4)
    jdec = JaxSlotDecoder(jtarget, tv, draft_model=jd, draft_variables=dv,
                          **kw)
    try:
        want = [jdec.submit(p) for p in PROMPTS]
        wstats = jdec.stats()
    finally:
        jdec.close()
    dec = SlotDecoder(ttarget, None, draft_model=td, **kw)
    try:
        got = [dec.submit(p) for p in PROMPTS]
        stats = dec.stats()
        if paged:
            dec.alloc.check()
    finally:
        dec.close()
    assert got == want
    for key in ("spec_rounds", "spec_tokens_emitted", "spec_tokens_accepted",
                "spec_drafted", "completed", "prefill_tokens_computed",
                "cache_bytes", "mode", "speculative"):
        assert stats[key] == wstats[key], key
    # and the tokens are plain greedy decode's
    for p, out in zip(PROMPTS, got):
        row = [0] * (P - len(p[-P:])) + p[-P:]
        g = generate(tt, None, torch.tensor([row]), max_new_tokens=N,
                     pad_len=torch.tensor([P - len(p[-P:])]))
        assert out == g[0, P:].tolist()


def test_lockstep_refusals(slot_models):
    (_, _, tt), (_, _, tp), (_, _, td) = slot_models
    kw = dict(slots=2, prompt_len=P, max_new_tokens=N)
    with pytest.raises(ValueError, match="greedy-only"):
        SlotDecoder(tt, None, draft_model=td, temperature=0.5, **kw)
    with pytest.raises(ValueError, match="draft_k"):
        SlotDecoder(tt, None, draft_model=td, draft_k=0, **kw)
    with pytest.raises(ValueError, match="dense cache"):
        SlotDecoder(tt, None, draft_model=tp, **kw)
    roll = get_model("transformer-test", device="cpu", max_seq_len=P + N + 4,
                     attention_window=8, rolling_kv_cache=True)
    with pytest.raises(ValueError, match="rolling_kv_cache"):
        SlotDecoder(roll, None, draft_model=td, **kw)
    with pytest.raises(ValueError, match="max_seq_len"):
        SlotDecoder(tt, None, draft_model=td, draft_k=5, **kw)


LM = dict(prompt_len=8, max_new_tokens=6, vocab_size=64)
INSTANCES = [{"tokens": [9, 8, 7, 6, 5]}, {"tokens": [1, 2, 3]},
             {"tokens": list(range(1, 12))}]


@pytest.fixture(scope="module")
def served_weights():
    """Target weights for max_seq 8 + 6 + 3 and the JAX server's
    plain predictions on them."""
    from kubeflow_tpu.serving.server import serve_lm_generator as jax_serve

    jm, variables, _ = _pair(0, max_seq=17, vocab_size=64)
    jsv = jax_serve("plain", "transformer-test", dtype=jnp.float32, **LM)
    try:
        want = jsv.predict(INSTANCES)
    finally:
        jsv.close()
    return flax_to_state_dict(jax.device_get(variables["params"])), want


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["batch-1", "lockstep"])
def test_served_speculative_matches_plain(served_weights, continuous):
    weights, want = served_weights
    spec = S.serve_lm_generator(
        "spec", "transformer-test", device="cpu", state_dict=weights,
        dtype="float32", draft_model="transformer-test", draft_k=3,
        continuous_batching=continuous, **LM)
    try:
        got = spec.predict(INSTANCES)
        assert spec.signature["draft_k"] == 3
        assert spec.signature["draft_model"] == "transformer-test"
        if continuous:
            assert spec.decoder().stats()["speculative"]
    finally:
        spec.close()
    assert np.asarray(got).tolist() == np.asarray(want).tolist()


def _metric(text: str, name: str, model: str) -> float:
    for line in text.splitlines():
        if line.startswith(f'{name}{{model="{model}"}} '):
            return float(line.split()[-1])
    raise AssertionError(f"{name} for {model} not in /metrics")


def test_speculative_metrics_in_the_scrape(served_weights):
    weights, _ = served_weights
    b1 = S.serve_lm_generator(
        "specm", "transformer-test", device="cpu", state_dict=weights,
        dtype="float32", draft_model="transformer-test", draft_k=2, **LM)
    ls = S.serve_lm_generator(
        "specl", "transformer-test", device="cpu", state_dict=weights,
        dtype="float32", draft_model="transformer-test", draft_k=2,
        continuous_batching=True, **LM)
    server = S.ModelServer()
    server.register(b1)
    server.register(ls)
    svc = server.serve(host="127.0.0.1", port=0).serve_background()
    try:
        for name in ("specm", "specl"):
            req = urllib.request.Request(
                f"http://127.0.0.1:{svc.port}/v1/models/{name}:predict",
                data=json.dumps({"instances": [{"tokens": [4, 2]}]}).encode(),
                method="POST")
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert len(json.loads(resp.read())["predictions"][0]) == 6
        with urllib.request.urlopen(
                f"http://127.0.0.1:{svc.port}/metrics", timeout=60) as resp:
            text = resp.read().decode()
        stats = ls.decoder().stats()
    finally:
        svc.shutdown()
        server.close()
    drafted = _metric(text, "serving_speculative_drafted_total", "specm")
    accepted = _metric(text, "serving_speculative_accepted_total", "specm")
    assert drafted > 0 and drafted % 2 == 0 and 0 <= accepted <= drafted
    assert _metric(text, "serving_spec_rounds_total", "specl") == \
        stats["spec_rounds"]
    assert _metric(text, "serving_spec_tokens_accepted_total", "specl") == \
        stats["spec_tokens_accepted"]
