"""The port's `entry()` twin (kubeflow_tpu_torch/entry.py) against
`__graft_entry__.entry`, on the CPU.

Same model (gpt-125m widths, 4 layers, vocab 8192, max_seq 512, bf16,
attention auto: the plain reference attention on the CPU in both
frameworks), same tokens. With the zero params of both entries the
logits are equal exactly (all zero). With random params drawn by flax
and converted (`convert.flax_to_state_dict`), both forwards run in
bf16, whose rounding differs between the frameworks: each logits row
(one token's 8192 logits) is held within 2e-2 of its L2 norm, the
per-row limit chip_smoke.py holds bf16 logits to (REF_ROW_TOL).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import entry as jax_entry
from kubeflow_tpu_torch import entry as E
from kubeflow_tpu_torch.convert import flax_to_state_dict

ROW_TOL = 2e-2


@pytest.fixture(scope="module")
def both():
    return jax_entry(), E.entry(device="cpu")


def _row_err(got: np.ndarray, want: np.ndarray) -> float:
    got = got.reshape(-1, got.shape[-1]).astype(np.float64)
    want = want.reshape(-1, want.shape[-1]).astype(np.float64)
    num = np.linalg.norm(got - want, axis=1)
    den = np.maximum(np.linalg.norm(want, axis=1), 1e-30)
    return float((num / den).max())


def test_shapes_and_zero_params_match(both):
    (jfn, (jparams, jtok)), (fn, (params, tok)) = both
    assert tuple(tok.shape) == tuple(jtok.shape) == (2, 256)
    assert tok.device.type == "cpu" and int(tok.min()) == int(tok.max()) == 1
    assert all(float(p.abs().max()) == 0 for p in params.values())
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in params.values()) == n_jax
    want = np.asarray(jfn(jparams, jtok))
    got = fn(params, tok)
    assert got.shape == (2, 256, 8192) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_params_logits_match(both):
    (jfn, (jparams, jtok)), (fn, (_, tok)) = both
    leaves, tree = jax.tree.flatten(jparams)
    keys = jax.random.split(jax.random.PRNGKey(0), len(leaves))
    drawn = jax.tree.unflatten(tree, [
        jax.random.normal(k, x.shape, jnp.float32)
        * (1.0 if x.ndim == 2 and x.shape[0] == 8192 else 0.02)
        + (1.0 if x.ndim == 1 else 0.0)
        for k, x in zip(keys, leaves)])
    # distinct tokens, so every row differs
    jtok = jnp.asarray(np.random.default_rng(0).integers(
        0, 8192, (2, 256)), jnp.int32)
    want = np.asarray(jfn(drawn, jtok))
    params = flax_to_state_dict(jax.device_get(drawn["params"]))
    got = fn(params, torch.tensor(np.asarray(jtok), dtype=torch.long))
    assert np.isfinite(got.numpy()).all()
    assert _row_err(got.numpy(), want) <= ROW_TOL


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.entry()
