"""The flash block sizes' order (kubeflow_tpu_torch/ops/attention.py
`flash_blocks`), the reference's (kubeflow_tpu/ops/attention.py
`attention`): the call's block_q / block_k first, then
$KFTPU_FLASH_BLOCK_Q / $KFTPU_FLASH_BLOCK_K read at each call, then the
default. `attention()`, `seq_attention`'s blocks and Ulysses (through
`attention()`) take it; the plain version's output at the variables'
blocks equals its output at the same explicit blocks.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.ops import attention as A
from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.ops import seq_attention as S
from kubeflow_tpu_torch.parallel.mesh import AxisGroup


@pytest.fixture
def no_env(monkeypatch):
    monkeypatch.delenv(A.ENV_BLOCK_Q, raising=False)
    monkeypatch.delenv(A.ENV_BLOCK_K, raising=False)
    return monkeypatch


def test_explicit_beats_the_variables_beat_the_default(no_env):
    assert A.flash_blocks()[:2] == (fa.DEFAULT_BLOCK_Q, fa.DEFAULT_BLOCK_K)
    no_env.setenv(A.ENV_BLOCK_Q, "64")
    no_env.setenv(A.ENV_BLOCK_K, "32")
    bq, bk, origin = A.flash_blocks()
    assert (bq, bk) == (64, 32)
    assert "$KFTPU_FLASH_BLOCK_Q" in origin and "$KFTPU_FLASH_BLOCK_K" in origin
    bq, bk, origin = A.flash_blocks(128, 0)
    assert (bq, bk) == (128, 32)
    assert "block_q from the call" in origin and "$KFTPU_FLASH_BLOCK_K" in origin
    no_env.delenv(A.ENV_BLOCK_Q)
    assert A.flash_blocks(0, 16) == (fa.DEFAULT_BLOCK_Q, 16,
                                     "block_q by default, block_k from the "
                                     "call")


def _qkv(seed=0, b=2, length=64, h=4, hkv=2, d=16):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal((b, length, n, d)),
                         dtype=torch.float32) for n in (h, hkv, hkv)]


@pytest.fixture
def seen(monkeypatch):
    """The block sizes each flash_attention call was given."""
    calls = []
    real = fa.flash_attention

    def spy(*args, **kw):
        calls.append((kw["block_q"], kw["block_k"]))
        return real(*args, **kw)

    monkeypatch.setattr(fa, "flash_attention", spy)
    return calls


def test_attention_takes_the_variables_between_the_call_and_default(
        no_env, seen):
    q, k, v = _qkv()
    no_env.setenv(A.ENV_BLOCK_Q, "16")
    no_env.setenv(A.ENV_BLOCK_K, "32")
    from_env = A.attention(q, k, v, impl="flash", window=24)
    explicit = A.attention(q, k, v, impl="flash", window=24, block_q=16,
                           block_k=32)
    A.attention(q, k, v, impl="flash", window=24, block_q=32, block_k=16)
    assert seen == [(16, 32), (16, 32), (32, 16)]
    assert torch.equal(from_env, explicit)
    no_env.delenv(A.ENV_BLOCK_Q)
    no_env.delenv(A.ENV_BLOCK_K)
    A.attention(q, k, v, impl="flash")
    assert seen[-1] == (fa.DEFAULT_BLOCK_Q, fa.DEFAULT_BLOCK_K)


def test_seq_attention_blocks_take_the_same_rule(no_env, seen):
    """seq_attention's own flash call (a group of 2 whose gathers are
    this rank's block twice, so no world is needed) and Ulysses at
    extent 1 (attention())."""
    from kubeflow_tpu_torch.ops.ulysses import ulysses_attention

    q, k, v = _qkv(length=32)
    no_env.setattr(S, "gather_seq", lambda x, seq: torch.cat([x, x], 1))
    no_env.setattr(S, "_all_gather", lambda x, g, n: torch.cat([x] * n, 1))
    no_env.setenv(A.ENV_BLOCK_Q, "16")
    no_env.setenv(A.ENV_BLOCK_K, "8")
    S.seq_attention(q, k, v, seq=AxisGroup(None, 0, 2), impl="flash")
    S.seq_attention(q, k, v, seq=AxisGroup(None, 1, 2), impl="flash",
                    block_k=16)
    ulysses_attention(q, k, v, seq=AxisGroup(None, 0, 1), impl="flash")
    assert seen == [(16, 8), (16, 16), (16, 8)]
