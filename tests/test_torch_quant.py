"""The port's int8/int4 quantization against the JAX package's.

ops/quantize.py and serving/quant.py must give bit-identical codes and
scales on the same f32 input (one f32 division for the scale, one for
the quotient, round half to even), including the embedding's per-row
scales, the flax-layout reduce axes of q/k/v/o, and the int4 fallback
to int8 on an odd last axis. Dequantized weights are bit-identical too,
and greedy tokens through a QuantizedModel equal the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from kubeflow_tpu.models.registry import get_model as jax_get_model
from kubeflow_tpu.ops import quantize as jq
from kubeflow_tpu.runtime.generate import generate as jax_generate
from kubeflow_tpu.serving import quant as jquant
from kubeflow_tpu_torch.convert import (
    flax_name,
    flax_to_state_dict,
    quantized_to_flax,
)
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.ops import quantize as tq
from kubeflow_tpu_torch.runtime.generate import generate
from kubeflow_tpu_torch.serving.quant import (
    QTensor,
    QuantizedModel,
    dequantize_params,
    quantize_params,
)


def _x(shape, seed=0, scale=3.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x *= scale
    x[..., 0] = 0.0                 # a zero channel / row somewhere
    return x


@pytest.mark.parametrize("axes", [-1, (0,), (0, 1), (1, 2)])
@pytest.mark.parametrize("fn", ["symmetric_int8", "symmetric_int4"])
def test_symmetric_codes_and_scales_bit_identical(fn, axes):
    x = _x((6, 5, 8))
    x[0] = 0.0                      # a whole zero slice: scale 1
    q, s = getattr(tq, fn)(torch.tensor(x), axes)
    jqv, jsv = getattr(jq, fn)(jnp.asarray(x), axes)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jsv))


def test_round_half_to_even():
    # amax 127 -> scale 1: the quotients are exactly x
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]])
    q, s = tq.symmetric_int8(x, -1)
    assert s.item() == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2]]


def test_pack_unpack_round_trip_and_bytes_match_jax():
    q = torch.tensor(np.random.default_rng(0).integers(-8, 8, (3, 10)),
                     dtype=torch.int8)
    packed = tq.pack_int4(q)
    assert packed.dtype == torch.uint8 and packed.shape == (3, 5)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jq.pack_int4(jnp.asarray(q))))
    assert torch.equal(tq.unpack_int4(packed), q)
    # the even index is the low nibble
    assert tq.pack_int4(torch.tensor([[1, -1]], dtype=torch.int8)).item() \
        == 0xF1
    # another axis: pairs along dim 0
    assert torch.equal(tq.unpack_int4(tq.pack_int4(q.T, 0), 0), q.T)
    with pytest.raises(ValueError, match="even"):
        tq.pack_int4(torch.zeros(2, 3, dtype=torch.int8))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v)})
    return out


def _params(seed=0, **kw):
    jm = jax_get_model("transformer-test", **kw)
    params = meta.unbox(jm.init(jax.random.PRNGKey(seed),
                                jnp.zeros((1, 1), jnp.int32),
                                train=False)["params"])
    return jm, jax.device_get(params)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kw", [{}, {"vocab_size": 255, "n_kv_heads": 4}],
                         ids=["test", "odd-vocab"])
def test_quantize_params_bit_identical_to_jax(bits, kw):
    """Every leaf of the quantized tree: codes, scales and the leaves
    left exact, under their flax paths and in the flax layout. The odd
    vocab makes lm_head's last axis odd, so int4 falls back to int8."""
    _, params = _params(**kw)
    want = _flat(jquant.quantize_params({"params": params},
                                        bits=bits)["params"])
    sd = flax_to_state_dict(params)
    qp = quantize_params(sd, head_dim=16, bits=bits)
    got = quantized_to_flax(qp, head_dim=16)
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        if key.endswith(("/int8", "/int4", "/scale")):
            assert got[key].dtype == w.dtype, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)
    kinds = {flax_name(n): p.kind for n, p in qp.items()
             if isinstance(p, QTensor)}
    if bits == 4 and kw:
        assert kinds["lm_head/kernel"] == "int8"
        assert kinds["embedding"] == "int4"


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dequantize_bit_identical_to_jax(bits, dtype):
    _, params = _params(seed=1)
    jd = jquant.dequantize_params(
        jquant.quantize_params({"params": params}, bits=bits),
        dtype=getattr(jnp, dtype))["params"]
    want = flax_to_state_dict(jax.device_get(jd))
    got = dequantize_params(
        quantize_params(flax_to_state_dict(params), 16, bits=bits),
        getattr(torch, dtype))
    assert set(got) == set(want)
    for name, w in want.items():
        # the JAX side passes through f32 in flax_to_state_dict: exact
        # for bf16 values
        np.testing.assert_array_equal(got[name].float().numpy(), w.numpy(),
                                      err_msg=name)


def test_quantize_rules():
    with pytest.raises(ValueError, match="bits"):
        quantize_params({}, 16, bits=3)
    sd = {"tiny": torch.ones(2, 2), "ln.scale": torch.ones(5000),
          "ints": torch.zeros(100, 100, dtype=torch.int32),
          "big.weight": torch.ones(128, 64)}
    q = quantize_params(sd, 16, min_size=1024)
    assert q["tiny"] is sd["tiny"] and q["ln.scale"] is sd["ln.scale"]
    assert q["ints"] is sd["ints"] and isinstance(q["big.weight"], QTensor)
    assert q["big.weight"].nbytes == 128 * 64 + 4 * 128
    zero = quantize_params({"w.weight": torch.zeros(64, 64)}, 16)
    assert torch.equal(dequantize_params(zero, torch.float32)["w.weight"],
                       torch.zeros(64, 64))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_model_greedy_tokens_equal_jax(bits):
    """Served weight-only quantization end to end: an f32 model with
    weights dequantized to bf16 (QuantizedModel's default), greedy."""
    jm, params = _params(seed=2, dtype=jnp.float32, max_seq_len=32)
    tm = get_model("transformer-test", device="cpu", dtype="float32",
                   max_seq_len=32)
    tm.load_state_dict(flax_to_state_dict(params))
    prompt = np.random.default_rng(2).integers(0, 256, (2, 8), np.int32)
    want = np.asarray(jax_generate(
        jquant.QuantizedModel(jm),
        jquant.quantize_params({"params": params}, bits=bits),
        jnp.asarray(prompt), max_new_tokens=8))
    got = generate(QuantizedModel(tm),
                   quantize_params(tm.state_dict(), 16, bits=bits),
                   torch.tensor(prompt, dtype=torch.long), max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)
