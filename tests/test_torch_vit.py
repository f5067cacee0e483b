"""The port's ViT (kubeflow_tpu_torch/models/vit.py) against the JAX
package's on the same numpy images and the same weights (converted by
`convert.py`), in f32 on the CPU: logits within 1e-4.

The head starts at zero in both (the reference's init), so the cases
draw every parameter from a seeded normal first: a zero head would hide
every fault below it. The traps each fail a case: flax's gelu is the
tanh approximation, qkv is a DenseGeneral to (3, heads, d_head), the
patches are (row, column) blocks flattened (dy, dx, c), the position
table is added in the model dtype.
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

LOGIT_TOL = 1e-4


def _random_params(params, seed, std=0.3):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * std
                                   ).astype(np.float32), params)


def _pair(seed=0, batch=3, **kw):
    x = np.random.default_rng(seed).standard_normal(
        (batch, 32, 32, 3)).astype(np.float32)
    jm = jax_model("vit-test", dtype=jnp.float32, **kw)
    params = meta.unbox(jax.device_get(
        jm.init(jax.random.PRNGKey(seed), x)["params"]))
    params = _random_params(params, seed + 1)
    tm = get_model("vit-test", device="cpu", dtype="float32", **kw)
    tm.load_state_dict(convert.flax_to_state_dict(params), strict=True)
    return jm, params, tm, x


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, {}), (2, {"n_heads": 4}), (3, {"n_layers": 3, "d_ff": 48}),
    (4, {"patch_size": 4})], ids=["base", "seed1", "heads4", "depth3",
                                  "patch4"])
def test_logits_match_jax(seed, kw):
    jm, params, tm, x = _pair(seed, **kw)
    want = np.asarray(jm.apply({"params": params}, x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_block_matches_jax_and_its_gelu_is_the_tanh_approximation():
    """One block per token (no pooling to average a fault away), with
    large activations so gelu's two forms differ past the tolerance."""
    from kubeflow_tpu.models.vit import ViTBlock, ViTConfig
    from kubeflow_tpu_torch.models import encoder

    cfg = ViTConfig(d_model=32, n_heads=2, d_ff=64, dtype=jnp.float32)
    x = (np.random.default_rng(0).standard_normal((2, 16, 32)) * 3).astype(
        np.float32)
    blk = ViTBlock(cfg)
    params = _random_params(meta.unbox(jax.device_get(
        blk.init(jax.random.PRNGKey(0), x)["params"])), 1, std=0.5)
    want = np.asarray(blk.apply({"params": params}, x))
    tb = encoder.EncoderBlock(32, 2, 64, torch.float32, "cpu")
    tb.load_state_dict(convert.flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tb(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    real = torch.nn.functional.gelu
    try:
        encoder.F.gelu = lambda t, approximate="none": real(t)
        with torch.no_grad():
            exact = tb(torch.from_numpy(x)).numpy()
    finally:
        encoder.F.gelu = real
    assert np.abs(exact - want).max() > 10 * LOGIT_TOL


def test_conversion_round_trip_and_shapes():
    jm, params, tm, _ = _pair(0)
    back = convert.state_dict_to_flax(tm.state_dict(), tm.cfg.head_dim)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, want)
    assert tuple(tm.layer_0.qkv.weight.shape) == (3 * 32, 32)
    assert tm.head_kernel.shape == (32, 10)


def test_bf16_head_gives_f32_logits_and_init_matches_the_reference():
    tm = get_model("vit-test", device="cpu")
    x = torch.zeros(2, 32, 32, 3)
    assert tm(x).dtype == torch.float32
    assert float(tm.head_kernel.detach().abs().max()) == 0.0   # zero init
    assert tm.pos_embed.dtype == torch.float32
    assert float(tm.layer_0.fc1.bias.detach().abs().max()) == 0.0
    std = float(tm.layer_0.qkv.weight.detach().std())
    assert 0.015 < std < 0.025                                  # normal(0.02)
    with pytest.raises(ValueError, match="32px RGB"):
        tm(torch.zeros(2, 16, 16, 3))


@pytest.mark.parametrize("name", ["vit-test", "vit-s16", "vit-b16"])
def test_flops_per_image_is_the_reference_count(name):
    assert name in list_models()
    tm = get_model(name, device="meta")
    jm = jax_model(name)
    assert tm.fwd_flops_per_image() == jm.fwd_flops_per_image()
    assert tm.cfg.d_model == jm.cfg.d_model
    assert tm.cfg.n_layers == jm.cfg.n_layers
