"""The port's chunked LM-head cross-entropy against the JAX package's.

Same numpy hidden states, head kernel and labels (some negative, hence
ignored). Tolerances: f32 1e-5 (loss) and 1e-5 (grads); with bf16
operands both sides multiply the same rounded values in f32, so the
bound stays 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.xent import chunked_lm_xent as jax_xent
from kubeflow_tpu_torch.ops.xent import chunked_lm_xent, head_logits


def _data(seed=0, b=2, l=32, d=16, v=50):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((b, l, d), dtype=np.float32)
    kernel = (0.5 * rng.standard_normal((d, v))).astype(np.float32)
    labels = rng.integers(0, v, (b, l), dtype=np.int32)
    labels[rng.random((b, l)) < 0.2] = -1
    return hidden, kernel, labels


@pytest.mark.parametrize("n_chunks", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_xent_matches_jax(n_chunks, dtype):
    hidden, kernel, labels = _data()
    tol = 1e-5 if dtype == "float32" else 1e-4

    def jloss(h, k):
        return jax_xent(h, k, jnp.asarray(labels), n_chunks,
                        compute_dtype=getattr(jnp, dtype))

    (jl, jacc), (jdh, jdk) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(hidden),
                                             jnp.asarray(kernel))
    h = torch.tensor(hidden, requires_grad=True)
    k = torch.tensor(kernel, requires_grad=True)
    loss, acc = chunked_lm_xent(h, k, torch.tensor(labels), n_chunks,
                                compute_dtype=getattr(torch, dtype))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=tol, atol=tol)
    assert acc.item() == pytest.approx(float(jacc))
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(jdh), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(k.grad.numpy(), np.asarray(jdk), atol=tol,
                               rtol=tol)


def test_all_labels_ignored_gives_zero_loss():
    hidden, kernel, labels = _data()
    loss, acc = chunked_lm_xent(torch.tensor(hidden), torch.tensor(kernel),
                                torch.full_like(torch.tensor(labels), -1), 2)
    assert loss.item() == 0.0 and acc.item() == 0.0


def test_ragged_chunks_raise():
    hidden, kernel, labels = _data(l=30)
    with pytest.raises(ValueError):
        chunked_lm_xent(torch.tensor(hidden), torch.tensor(kernel),
                        torch.tensor(labels), 4)


def test_head_logits_are_f32_of_rounded_operands():
    hidden, kernel, _ = _data()
    x, w = torch.tensor(hidden), torch.tensor(kernel)
    got = head_logits(x, w, torch.bfloat16)
    assert got.dtype == torch.float32
    want = x.bfloat16().double() @ w.bfloat16().double()
    torch.testing.assert_close(got.double(), want, atol=1e-5, rtol=1e-5)
