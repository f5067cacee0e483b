"""Weight-only int8 at gpt-350m width against the JAX package: the
port's greedy tokens, full precision and int8, equal the reference's on
the same converted weights (f32 on the CPU). Its own file: it takes
~20 s, mostly the reference's generate at d 1024 and vocab 32000."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.core import meta

from kubeflow_tpu.models.registry import get_model as jax_get_model
from kubeflow_tpu.runtime.generate import generate as jax_generate
from kubeflow_tpu.serving import quant as jquant
from kubeflow_tpu_torch.convert import flax_to_state_dict
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.runtime.generate import generate
from kubeflow_tpu_torch.serving.quant import QuantizedModel, quantize_params


def test_int8_weight_tokens_equal_jax_at_gpt350m_width():
    """gpt-350m width (d 1024, 16 heads of 64, d_ff 4096, vocab 32000)
    at 4 layers: the port's f32 and int8-weight greedy tokens equal the
    reference's on the same weights. How often the int8 run agrees with
    the f32 one is then a property of the model, not of the port: on
    random weights at this width one flipped token changes the rest of
    its row."""
    p, n = 64, 16
    kw = dict(n_layers=4, vocab_size=32000, max_seq_len=p + n)
    jm = jax_get_model("gpt-350m", dtype=jnp.float32, **kw)
    params = jax.device_get(meta.unbox(jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1), jnp.int32),
        train=False)["params"]))
    tm = get_model("gpt-350m", device="cpu", dtype="float32", **kw)
    tm.load_state_dict(flax_to_state_dict(params))
    rng = np.random.default_rng(1)
    lens = (5, 17, 33, 64)
    rows = np.zeros((len(lens), p), np.int32)
    for i, k in enumerate(lens):
        rows[i, p - k:] = rng.integers(1, 32000, k)
    pads = np.array([p - k for k in lens], np.int32)
    variables = {"params": params}
    for jmodel, jvars, tmodel, tparams in (
            (jm, variables, tm, None),
            (jquant.QuantizedModel(jm), jquant.quantize_params(variables),
             QuantizedModel(tm), quantize_params(tm.state_dict(), 64))):
        want = np.asarray(jax_generate(jmodel, jvars, jnp.asarray(rows),
                                       max_new_tokens=n,
                                       pad_len=jnp.asarray(pads)))
        got = generate(tmodel, tparams, torch.tensor(rows, dtype=torch.long),
                       max_new_tokens=n,
                       pad_len=torch.tensor(pads, dtype=torch.long))
        np.testing.assert_array_equal(got.numpy(), want)
