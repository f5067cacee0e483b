"""The port's TransformerLM against the JAX package's on the same weights.

`transformer-test` is initialised in flax, converted with
kubeflow_tpu_torch.convert, and both models run the same numpy tokens on
the CPU. Tolerances: f32 logits 1e-4 and f32 loss gradients 1e-4
absolute + 1e-3 relative (two layers of f32 matmuls summed in another
order, through flash attention at 2e-5 and 5e-4); bf16 logits 6e-2
(bf16 rounds each projection output: ~2^-8 relative per layer, on
logits of magnitude ~1).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models.registry import get_model as jax_get_model
from kubeflow_tpu.runtime.trainer import _xent_loss as jax_xent_loss
from kubeflow_tpu_torch.convert import flax_to_state_dict
from kubeflow_tpu_torch.models import transformer as T
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.runtime.trainer import _xent_loss

SEQ = 64


def _pair(dtype_jax, dtype_torch, impl, seed=0):
    jm = jax_get_model("transformer-test", dtype=dtype_jax, attention_impl=impl)
    tokens = np.random.default_rng(seed).integers(0, 256, (2, SEQ),
                                                  dtype=np.int32)
    params = nn.unbox(
        jm.init(jax.random.PRNGKey(seed), jnp.asarray(tokens))["params"])
    tm = get_model("transformer-test", device="cpu", dtype=dtype_torch,
                   attention_impl=impl)
    tm.load_state_dict(flax_to_state_dict(jax.device_get(params)), strict=True)
    return jm, params, tm, tokens


@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_f32_logits_and_grads_match_jax(impl):
    jm, params, tm, tokens = _pair(jnp.float32, torch.float32, impl)
    targets = np.roll(tokens, -1, axis=1)
    targets[:, -1] = -1                      # ignored position

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(tokens))
        return jax_xent_loss(logits, jnp.asarray(targets)), logits

    (jloss, jlogits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    logits = tm(torch.tensor(tokens))
    assert logits.dtype == torch.float32 and logits.shape == (2, SEQ, 256)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    loss = _xent_loss(logits, torch.tensor(targets))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    loss.backward()
    want = flax_to_state_dict(jax.device_get(jgrads))
    got = dict(tm.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(),
                                   atol=1e-4, rtol=1e-3, err_msg=name)


def test_bf16_logits_within_bound():
    jm, params, tm, tokens = _pair(jnp.bfloat16, torch.bfloat16, "reference")
    jlogits = jm.apply({"params": params}, jnp.asarray(tokens))
    logits = tm(torch.tensor(tokens))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=6e-2, rtol=6e-2)


def test_return_hidden_is_final_norm_output():
    jm, params, tm, tokens = _pair(jnp.float32, torch.float32, "reference")
    jh = jm.apply({"params": params}, jnp.asarray(tokens), return_hidden=True)
    h = tm(torch.tensor(tokens), return_hidden=True)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("name", sorted(T.CONFIGS))
def test_flops_per_token_matches_jax(name):
    jm = jax_get_model(name)
    cfg = T.TransformerConfig(**T.CONFIGS[name])
    for seq in (None, 2048):
        assert T.flops_per_token(cfg, seq) == jm.flops_per_token(seq)


def test_registry_names_cover_the_reference_dense_configs():
    from kubeflow_tpu.models.registry import list_models as jax_models
    from kubeflow_tpu_torch.models.registry import list_models

    names = list_models()
    assert set(T.CONFIGS) <= set(names) <= set(jax_models())
    # the rest are the classifiers (tests/test_torch_{resnet,vit,bert}.py)
    assert set(names) - set(T.CONFIGS) == {
        "resnet18", "resnet50", "resnet101", "vit-test", "vit-s16",
        "vit-b16", "bert-test", "bert-base"}


def test_unported_paths_raise():
    # MoE, ring/Ulysses and pipeline stages are ported (tests/
    # test_torch_{moe,ring,ulysses,pipeline}.py): their configs build
    for kw in (dict(moe_every=2), dict(attention_impl="ring"),
               dict(attention_impl="ulysses"), dict(pipeline_stages=2)):
        T.TransformerConfig(**kw)
    # the rolling cache is ported; without a window it is refused, as
    # in the reference
    tm = get_model("transformer-test", device="cpu", rolling_kv_cache=True)
    with pytest.raises(ValueError, match="attention_window"):
        tm(torch.zeros(1, 8, dtype=torch.long), decode_index=0, cache={})


def test_model_kwargs_dtype_by_name():
    assert T.TransformerConfig(dtype="float32").dtype == torch.float32
    with pytest.raises(ValueError):
        T.TransformerConfig(dtype="float33")


def test_rope_matches_jax():
    from kubeflow_tpu.models.transformer import rope as jrope

    x = np.random.default_rng(0).standard_normal((2, 16, 3, 8), np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    want = jrope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = T.rope(torch.tensor(x), torch.tensor(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
