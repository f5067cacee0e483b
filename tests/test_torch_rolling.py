"""The port's rolling-window KV cache (models/transformer.py
`_decode_rolling`) against the JAX package's, and against the port's
own full cache under the same window, in f32 on the CPU.

The cases of tests/test_generate.py TestRollingKvCache, each held two
ways: the port's rolling tokens equal its full-cache tokens under the
same window (a memory layout change, never a semantics change), and
they equal JAX's rolling tokens. Step by step, the logits of every
decode call equal JAX's within 1e-4 (absolute and relative, the
tolerance of test_torch_decode.py) and the caches agree leaf by leaf:
f32 within 1e-5; int8 codes within one step at a rounding boundary in
>= 99.9% of entries equal, scales within 1e-5. Tokens are exact.
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
from kubeflow_tpu.serving.continuous import SlotDecoder as JaxSlotDecoder
from kubeflow_tpu_torch.convert import (
    flax_cache_to_port,
    flax_to_state_dict,
    port_cache_to_flax,
)
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.runtime.generate import generate, init_cache
from kubeflow_tpu_torch.serving.continuous import SlotDecoder

VOCAB, MAX_SEQ = 64, 64
TOL = dict(atol=1e-4, rtol=1e-4)
KV = pytest.mark.parametrize("kv", ["auto", "int8"])


def _models(window, seed=3, **kw):
    """(JAX rolling model, its variables, port rolling, port full): one
    set of weights under one window."""
    kw = dict(vocab_size=VOCAB, max_seq_len=MAX_SEQ, attention_window=window,
              **kw)
    jm = jax_get_model("transformer-test", dtype=jnp.float32,
                       rolling_kv_cache=True, **kw)
    variables = meta.unbox(jm.init(jax.random.PRNGKey(seed),
                                   jnp.zeros((1, 1), jnp.int32), train=False))
    sd = flax_to_state_dict(jax.device_get(variables["params"]))
    out = []
    for rolling in (True, False):
        tm = get_model("transformer-test", device="cpu", dtype="float32",
                       rolling_kv_cache=rolling, **kw)
        tm.load_state_dict(sd)
        out.append(tm)
    return jm, variables, out[0], out[1]


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(1, VOCAB, shape,
                                                dtype=np.int32)


def _generate_three(window, prompt, n, pad=None, **kw):
    """Tokens of JAX rolling, port rolling and port full generate."""
    jm, variables, roll, full = _models(window, **kw)
    jpad = None if pad is None else jnp.asarray(pad, jnp.int32)
    tpad = None if pad is None else torch.tensor(pad, dtype=torch.long)
    want = np.asarray(jax_generate(jm, variables, jnp.asarray(prompt),
                                   max_new_tokens=n, pad_len=jpad))
    t = torch.tensor(prompt, dtype=torch.long)
    got_roll = generate(roll, None, t, max_new_tokens=n, pad_len=tpad)
    got_full = generate(full, None, t, max_new_tokens=n, pad_len=tpad)
    return want, got_roll.numpy(), got_full.numpy()


@KV
def test_cache_is_window_sized(kv):
    jm, _, roll, full = _models(16, kv_cache_dtype=kv)
    want = flax_cache_to_port(jax.device_get(jax_init_cache(jm, 2)))
    got = init_cache(roll, 2)
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in want.items()}
    assert all(v.shape[1] == 16 for v in got.values())
    assert all(v.shape[1] == MAX_SEQ for v in init_cache(full, 2).values())
    # a window wider than max_seq keeps max_seq positions
    _, _, wide, _ = _models(MAX_SEQ + 9, kv_cache_dtype=kv)
    assert all(v.shape[1] == MAX_SEQ for v in init_cache(wide, 1).values())


@pytest.mark.parametrize("window,plen,n,kv", [
    (16, 12, 24, "auto"),      # 36 positions: wraps the 16 slots twice
    (16, 10, 20, "int8"),
    (8, 20, 12, "auto"),       # the prompt is longer than the window
    (8, 21, 10, "int8"),
], ids=["wrap-twice", "int8", "prompt-over-window", "int8-prompt-over"])
def test_greedy_equal_past_the_wrap(window, plen, n, kv):
    prompt = _tokens((2, plen), seed=7)
    want, roll, full = _generate_three(window, prompt, n, kv_cache_dtype=kv)
    np.testing.assert_array_equal(roll, want)
    np.testing.assert_array_equal(roll, full)


def test_equal_with_left_padding():
    real = _tokens((2, 6), seed=9)
    prompt = np.concatenate([np.zeros((2, 3), np.int32), real], axis=1)
    prompt[1, :5] = 0
    want, roll, full = _generate_three(8, prompt, 10, pad=[3, 5])
    np.testing.assert_array_equal(roll, want)
    np.testing.assert_array_equal(roll, full)


class _Steps:
    """The same decode calls through the JAX and the port rolling
    models; logits compared per call, caches by compare()."""

    def __init__(self, window, batch, **kw):
        self.jm, variables, self.tm, _ = _models(window, **kw)
        self.params = variables["params"]
        self.jcache = jax_init_cache(self.jm, batch)
        self.tcache = init_cache(self.tm, batch)

    def step(self, toks, index, pad_len=None):
        jkw, tkw = {}, {}
        if pad_len is not None:
            jkw["pad_len"] = jnp.asarray(pad_len, jnp.int32)
            tkw["pad_len"] = torch.tensor(pad_len, dtype=torch.long)
        vec = not isinstance(index, int)
        want, mut = self.jm.apply(
            {"params": self.params, "cache": self.jcache}, jnp.asarray(toks),
            train=False, mutable=["cache"],
            decode_index=jnp.asarray(index, jnp.int32) if vec else index,
            **jkw)
        self.jcache = mut["cache"]
        with torch.no_grad():
            got = self.tm(torch.tensor(toks, dtype=torch.long),
                          decode_index=(torch.tensor(index) if vec
                                        else index),
                          cache=self.tcache, **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def compare(self):
        want = flax_cache_to_port(jax.device_get(self.jcache))
        assert set(want) == set(self.tcache)
        for name, w in want.items():
            g = self.tcache[name]
            assert g.shape == w.shape and g.dtype == w.dtype, name
            if g.dtype == torch.int8:
                diff = (g.int() - w.int()).abs()
                assert int(diff.max()) <= 1, name
                assert float((diff == 0).float().mean()) >= 0.999, name
            else:
                np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                           rtol=1e-5, err_msg=name)


@KV
def test_steps_match_jax_scalar_and_per_row(kv):
    """A 19-token chunk into 8 slots (only its last 8 columns land), a
    chunk that wraps, single ticks, then per-row ticks at different
    positions, with left padding on one row."""
    run = _Steps(8, 2, kv_cache_dtype=kv)
    toks = _tokens((2, 19))
    toks[1, :4] = 0
    pad = [0, 4]
    run.step(toks, 0, pad_len=pad)
    run.compare()
    run.step(_tokens((2, 5), seed=1), 19, pad_len=pad)
    run.step(_tokens((2, 1), seed=2), 24, pad_len=pad)
    run.compare()
    for i, idx in enumerate(([25, 25], [26, 3], [27, 30])):
        run.step(_tokens((2, 1), seed=3 + i), idx, pad_len=pad)
    run.compare()


def test_per_row_chunk_refused_as_in_jax():
    run = _Steps(8, 2)
    idx = np.array([0, 2], np.int32)
    with pytest.raises(ValueError, match="single-token"):
        run.jm.apply({"params": run.params, "cache": run.jcache},
                     jnp.zeros((2, 3), jnp.int32), train=False,
                     decode_index=jnp.asarray(idx), mutable=["cache"])
    with pytest.raises(ValueError, match="single-token"):
        run.tm(torch.zeros(2, 3, dtype=torch.long),
               decode_index=torch.tensor(idx), cache=run.tcache)


def test_python_mod_dates_the_slots():
    """pos_abs = cur - ((cur - slot) mod W) needs the floor mod: at the
    first chunk (cur = -1) every slot must date before position 0, so
    the zero-filled cache is masked out entirely."""
    cur, w = -1, 8
    slots = torch.arange(w)
    pos_abs = cur - ((cur - slots) % w)
    assert (pos_abs < 0).all()
    assert pos_abs.tolist() == [cur - ((cur - s) % w) for s in range(w)]


@KV
def test_continuous_batching_slots_equal(kv):
    jm, variables, roll, full = _models(16, kv_cache_dtype=kv)
    prompts = [[5, 9, 2, 7, 11, 3], [4, 4, 8], list(range(1, 9))]
    outs = {}
    for name, model in (("roll", roll), ("full", full)):
        dec = SlotDecoder(model, None, slots=2, prompt_len=8,
                          max_new_tokens=20)
        try:
            outs[name] = [dec.submit(p) for p in prompts]
        finally:
            dec.close()
    jdec = JaxSlotDecoder(jm, variables, slots=2, prompt_len=8,
                          max_new_tokens=20)
    try:
        outs["jax"] = [jdec.submit(p) for p in prompts]
    finally:
        jdec.close()
    assert outs["roll"] == outs["jax"]
    assert outs["roll"] == outs["full"]


def test_rolling_without_window_refuses():
    jm = jax_get_model("transformer-test", max_seq_len=MAX_SEQ,
                       rolling_kv_cache=True)
    tok = jnp.zeros((1, 4), jnp.int32)
    variables = meta.unbox(jm.init(jax.random.PRNGKey(0), tok))
    with pytest.raises(ValueError, match="attention_window"):
        jax_generate(jm, variables, tok, max_new_tokens=2)
    tm = get_model("transformer-test", device="cpu", max_seq_len=MAX_SEQ,
                   rolling_kv_cache=True)
    with pytest.raises(ValueError, match="attention_window"):
        generate(tm, None, torch.zeros(1, 4, dtype=torch.long),
                 max_new_tokens=2)
    with pytest.raises(ValueError, match="attention_window"):
        init_cache(tm, 1)


@KV
def test_cache_converts_both_ways(kv):
    """A JAX rolling cache after a wrapping chunk goes to the port's
    flat dict and back to the same flax tree, leaf for leaf."""
    run = _Steps(8, 2, kv_cache_dtype=kv)
    run.step(_tokens((2, 13)), 0)
    tree = jax.device_get(run.jcache)
    back = port_cache_to_flax(flax_cache_to_port(tree))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
