"""The port's KV-cache decode paths against the JAX package's, on the
same converted weights, in f32 on the CPU.

Each case runs one sequence of decode calls through both models (the
JAX one with a mutable flax cache, the port with its flat cache dict)
and compares the logits of every call and the caches leaf by leaf.
Tolerances: logits 1e-4 absolute and relative, the tolerance of
test_torch_transformer.py (two layers of f32 matmuls summed in another
order); f32 cache tensors 1e-5. int8 cache codes round the same f32
values, which differ in the last bits, so a code may land one step
away at a rounding boundary: codes must agree in >= 99.9% of entries
and never differ by more than 1; the per-(position, head) scales are
f32 and held to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from kubeflow_tpu.models.registry import get_model as jax_get_model
from kubeflow_tpu.runtime.generate import init_cache as jax_init_cache
from kubeflow_tpu.runtime.kvcache import init_paged_cache as jax_init_paged
from kubeflow_tpu_torch.convert import flax_cache_to_port, flax_to_state_dict
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.runtime.generate import init_cache
from kubeflow_tpu_torch.runtime.kvcache import init_paged_cache

VOCAB, MAX_SEQ = 64, 24
TOL = dict(atol=1e-4, rtol=1e-4)


def _pair(seed=0, **kw):
    kw = dict(vocab_size=VOCAB, max_seq_len=MAX_SEQ, **kw)
    jm = jax_get_model("transformer-test", dtype=jnp.float32, **kw)
    params = meta.unbox(jm.init(jax.random.PRNGKey(seed),
                                jnp.zeros((1, 1), jnp.int32),
                                train=False)["params"])
    tm = get_model("transformer-test", device="cpu", dtype="float32", **kw)
    tm.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    return jm, params, tm


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(1, VOCAB, shape,
                                                dtype=np.int32)


class _Run:
    """The same decode calls on both sides; compare() holds the caches."""

    def __init__(self, jm, params, tm, jcache, tcache):
        self.jm, self.params, self.tm = jm, params, tm
        self.jcache, self.tcache = jcache, tcache

    def step(self, toks, index, pad_len=None, page_table=None):
        jkw, tkw = {}, {}
        for name, val in (("pad_len", pad_len), ("page_table", page_table)):
            if val is not None:
                jkw[name] = jnp.asarray(val, jnp.int32)
                tkw[name] = torch.tensor(np.asarray(val), dtype=torch.long)
        jidx = index if isinstance(index, int) else jnp.asarray(index,
                                                                jnp.int32)
        tidx = index if isinstance(index, int) else torch.tensor(
            np.asarray(index), dtype=torch.long)
        want, mut = self.jm.apply(
            {"params": self.params, "cache": self.jcache},
            jnp.asarray(toks), train=False, decode_index=jidx,
            mutable=["cache"], **jkw)
        self.jcache = mut["cache"]
        with torch.no_grad():
            got = self.tm(torch.tensor(toks, dtype=torch.long),
                          decode_index=tidx, cache=self.tcache, **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return got

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


def _dense(batch, **kw):
    jm, params, tm = _pair(**kw)
    return _Run(jm, params, tm, jax_init_cache(jm, batch),
                init_cache(tm, batch))


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_chunk_then_single_ticks(kv):
    """A scalar-index chunk (the prefill write, dynamic_update_slice),
    then single tokens at the following positions."""
    run = _dense(2, kv_cache_dtype=kv)
    run.step(_tokens((2, 8)), 0)
    for i, tok in enumerate(_tokens((3, 2, 1), seed=1)):
        run.step(tok, 8 + i)
    run.compare()


def test_cache_leaves_and_dtypes_match_jax():
    for kv in ("auto", "int8"):
        jm, _, tm = _pair(kv_cache_dtype=kv)
        want = flax_cache_to_port(jax.device_get(jax_init_cache(jm, 3)))
        got = init_cache(tm, 3)
        assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
            k: (tuple(v.shape), v.dtype) for k, v in want.items()}


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_vector_index_single_token(kv):
    """Per-row positions, one token (the continuous decoder's tick: the
    one-hot write)."""
    run = _dense(3, kv_cache_dtype=kv)
    run.step(_tokens((3, 6)), 0)
    run.step(_tokens((3, 1), seed=2), [6, 3, 5])
    run.step(_tokens((3, 1), seed=3), [7, 4, 6])
    run.compare()


def test_vector_index_chunk():
    """Per-row positions with a multi-token chunk (each row's chunk
    lands at its own start)."""
    run = _dense(2)
    run.step(_tokens((2, 5)), 0)
    run.step(_tokens((2, 3), seed=4), [5, 2])
    run.compare()


def test_scalar_chunk_past_the_end_shifts():
    """A scalar-index chunk that would overrun max_seq is shifted back
    to fit, as dynamic_update_slice does."""
    run = _dense(1)
    run.step(_tokens((1, 4)), MAX_SEQ - 2)
    run.compare()


def test_pad_len_masks_left_padding():
    run = _dense(2)
    toks = _tokens((2, 8))
    toks[1, :3] = 0
    pad = [0, 3]
    run.step(toks, 0, pad_len=pad)
    run.step(_tokens((2, 1), seed=5), 8, pad_len=pad)
    run.step(_tokens((2, 1), seed=6), [9, 9], pad_len=pad)
    run.compare()


def test_attention_window():
    run = _dense(2, attention_window=4)
    run.step(_tokens((2, 7)), 0)
    run.step(_tokens((2, 1), seed=7), 7)
    run.step(_tokens((2, 1), seed=8), [8, 8])
    run.compare()


def test_one_past_the_end_tick_is_dropped():
    """An idle lockstep slot sits at position max_seq_len: its write
    matches no column and is dropped, while the other rows decode."""
    run = _dense(2)
    run.step(_tokens((2, MAX_SEQ - 1)), 0)
    run.step(_tokens((2, 1), seed=9), [MAX_SEQ - 1, MAX_SEQ - 1])
    run.step(_tokens((2, 1), seed=10), [MAX_SEQ, 5])
    run.compare()


def _paged(batch, pages=12, page_size=4, mp=6):
    jm, params, tm = _pair(kv_pages=pages, kv_page_size=page_size)
    return _Run(jm, params, tm, jax_init_paged(jm, mp),
                init_paged_cache(tm, mp))


def test_paged_chunk_then_ticks():
    """Write the chunk into its pages, then attend through the table;
    the pools are compared page by page."""
    run = _paged(2)
    table = np.array([[3, 5, 1, 0, 0, 0], [2, 4, 6, 0, 0, 0]], np.int32)
    pad = [0, 2]
    toks = _tokens((2, 8))
    toks[1, :2] = 0
    run.step(toks, [0, 0], pad_len=pad, page_table=table)
    run.step(_tokens((2, 1), seed=11), [8, 8], pad_len=pad,
             page_table=table)
    run.step(_tokens((2, 1), seed=12), [9, 9], pad_len=pad,
             page_table=table)
    run.compare()


def test_paged_one_past_the_table_clamps_to_trash():
    """A freed slot's row is all trash page and its position runs one
    past the table: the gather clamps to the last entry and the write
    lands in page 0, as in the reference."""
    run = _paged(2, mp=2)
    table = np.array([[1, 2], [3, 4]], np.int32)
    run.step(_tokens((2, 8)), [0, 0], page_table=table)
    table[1] = 0
    run.step(_tokens((2, 1), seed=13), [7, 8], page_table=table)
    run.compare()


def test_unported_and_invalid_decode_paths_raise():
    tm = get_model("transformer-test", device="cpu", rolling_kv_cache=True,
                   max_seq_len=16)
    with pytest.raises(ValueError, match="attention_window"):
        init_cache(tm, 1)
    tm = get_model("transformer-test", device="cpu", max_seq_len=16)
    with pytest.raises(ValueError, match="cache="):
        tm(torch.zeros(1, 1, dtype=torch.long), decode_index=0)
    with pytest.raises(ValueError, match="kv_pages"):
        tm(torch.zeros(1, 1, dtype=torch.long), decode_index=0,
           cache=init_cache(tm, 1), page_table=torch.zeros(1, 2))
    tm = get_model("transformer-test", device="cpu", kv_pages=4,
                   kv_page_size=4, kv_cache_dtype="int8", max_seq_len=16)
    with pytest.raises(ValueError, match="int8 page pools"):
        tm(torch.zeros(1, 1, dtype=torch.long), decode_index=0,
           cache=init_paged_cache(tm, 2),
           page_table=torch.ones(1, 2, dtype=torch.long))
