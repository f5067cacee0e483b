"""The port's BERT encoder (kubeflow_tpu_torch/models/bert.py) against the
JAX package's on the same token ids and the same weights (converted by
`convert.py`), in f32 on the CPU: logits within 1e-4.

The padding mask is the trap: the reference passes `tokens != 0` as
segment ids, so pads attend to pads and tokens to tokens. A key-padding
mask gives other hidden states, at the pads and (through the [CLS] row
when position 0 is a pad) in the logits; the cases put pads mid-sequence,
at the tail and at position 0.

bf16: the two-class logits are a projection of the [CLS] row onto two
directions, so their relative error per row is the row's up to
cancellation. At bert-base width the reference's own bf16 logits miss
2e-2 per row of its f32 ones; the port's bf16 error is held to the same
size as the reference's, and its final hidden rows to 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from kubeflow_tpu.models.registry import get_model as jax_model
from kubeflow_tpu_torch import convert
from kubeflow_tpu_torch.models.registry import get_model, list_models
from kubeflow_tpu_torch.ops import kernel_check

LOGIT_TOL = 1e-4


def _tokens(seed, batch=4, length=24, vocab=512):
    tok = np.random.default_rng(seed).integers(
        1, vocab, (batch, length)).astype(np.int32)
    tok[0, 7:12] = 0                 # a run of pads mid-sequence
    tok[1, 0] = 0                    # [CLS] position itself a pad
    tok[2, -9:] = 0                  # tail padding
    tok[3, 3] = tok[3, 15] = 0       # scattered pads
    return tok


def _pair(seed=0, name="bert-test", dtype=jnp.float32, **kw):
    tok = _tokens(seed)
    jm = jax_model(name, dtype=dtype, **kw)
    params = meta.unbox(jax.device_get(
        jm.init(jax.random.PRNGKey(seed), tok)["params"]))
    tm = get_model(name, device="cpu", dtype="float32", **kw)
    tm.load_state_dict(convert.flax_to_state_dict(params), strict=True)
    return jm, params, tm, tok


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, {}), (2, {"n_heads": 2}), (3, {"n_layers": 3}),
    (4, {"num_classes": 5})], ids=["base", "seed1", "heads2", "depth3",
                                   "classes5"])
def test_logits_match_jax_with_pads(seed, kw):
    jm, params, tm, tok = _pair(seed, **kw)
    want = np.asarray(jm.apply({"params": params}, tok))
    with torch.no_grad():
        got = tm(torch.from_numpy(tok)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_padding_mask_is_segment_ids_not_key_padding():
    """With a key-padding mask (every query sees only real tokens) the
    [CLS] row of a sequence that starts with a pad changes."""
    from kubeflow_tpu_torch.models import encoder

    jm, params, tm, tok = _pair(0)
    want = np.asarray(jm.apply({"params": params}, tok))
    real = encoder.reference_attention

    def key_padding(q, k, v, causal=False, segment_ids=None):
        keep = (segment_ids != 0)[:, None, None, :]          # [B,1,1,L]
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
        p = torch.softmax(torch.where(keep, s, -1e30), -1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v)

    try:
        encoder.reference_attention = key_padding
        with torch.no_grad():
            wrong = tm(torch.from_numpy(tok)).numpy()
    finally:
        encoder.reference_attention = real
    assert np.abs(wrong[1] - want[1]).max() > 10 * LOGIT_TOL


def test_conversion_round_trip_init_and_ring():
    jm, params, tm, _ = _pair(0)
    back = convert.state_dict_to_flax(tm.state_dict(), tm.cfg.head_dim)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, want)
    fresh = get_model("bert-test", device="cpu")
    assert 0.9 < float(fresh.embedding.detach().std()) < 1.1   # normal(1.0)
    assert 0.015 < float(fresh.pos_embedding.detach().std()) < 0.025
    assert fresh(torch.from_numpy(_tokens(0))).dtype == torch.float32
    # ring is ported (tests/test_torch_ring.py holds it to the reference's
    # BERT ring); an unknown implementation is refused
    ring = get_model("bert-test", device="cpu", attention_impl="ring")
    assert ring.cfg.attention_impl == "ring"
    with pytest.raises(ValueError, match="unknown attention_impl"):
        get_model("bert-test", device="cpu", attention_impl="flash")


@pytest.mark.parametrize("name,seq", [("bert-test", None), ("bert-test", 64),
                                      ("bert-base", 512)])
def test_flops_per_token_is_the_reference_count(name, seq):
    assert name in list_models()
    assert get_model(name, device="meta").flops_per_token(seq) == \
        jax_model(name).flops_per_token(seq)


def test_bf16_error_is_the_reference_s():
    """bert-base width, 2 layers: the reference's bf16 logits against its
    f32 ones, and the port's against its own, on the same weights."""
    tok = np.random.default_rng(0).integers(1, 512, (16, 64)).astype(
        np.int32)
    tok[::2, -20:] = 0
    j32 = jax_model("bert-base", dtype=jnp.float32, n_layers=2)
    j16 = jax_model("bert-base", n_layers=2)
    params = meta.unbox(jax.device_get(
        j32.init(jax.random.PRNGKey(0), tok[:1])["params"]))
    ref32 = torch.from_numpy(np.array(j32.apply({"params": params}, tok)))
    ref16 = torch.from_numpy(np.asarray(
        j16.apply({"params": params}, tok)).astype(np.float32))
    sd = convert.flax_to_state_dict(params)
    out, hidden = {}, {}
    for dtype in ("float32", "bfloat16"):
        m = get_model("bert-base", device="cpu", dtype=dtype, n_layers=2)
        m.load_state_dict(sd)
        h = m.ln_f.register_forward_hook(
            lambda mod, i, o, d=dtype: hidden.__setitem__(d, o.float()))
        with torch.no_grad():
            out[dtype] = m(torch.from_numpy(tok)).float()
        h.remove()
    np.testing.assert_allclose(out["float32"], ref32, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    ref_err = kernel_check.errors(ref16, ref32)["max_row_err"]
    port_err = kernel_check.errors(out["bfloat16"], out["float32"])[
        "max_row_err"]
    assert ref_err > 2e-2            # the reference's own miss
    assert port_err <= 2 * ref_err
    assert kernel_check.errors(hidden["bfloat16"], hidden["float32"])[
        "max_row_err"] <= 2e-2
