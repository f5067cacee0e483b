"""Remat in the port's TransformerLM (`remat`, `remat_policy`) against
no remat and against the JAX package.

- Values: remat changes what is saved, never a value. In f32 the loss
  and every gradient equal no-remat's at rtol 1e-6 (the recompute runs
  the same CPU kernels on the same inputs), and the loss equals the JAX
  trainer's at the same policy at rtol 1e-5, as
  tests/test_transformer.py holds the JAX policies to each other.
- What is saved: the bytes the forward leaves alive for the backward,
  against tools/remat_plan.residual_bytes (jax's saved_residuals) for
  the same model and tokens. Only the order of the policies is
  compared: the two frameworks save different tensors (torch keeps the
  bf16 weight copies its matmuls take; eager selective checkpointing
  caches the matmul outputs `dots` names even where the backward does
  not read them).
- The flash forward's launches: once per layer per step, twice under
  `full`, which replays it.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from kubeflow_tpu.models.registry import get_model as jax_get_model
from kubeflow_tpu.runtime import trainer as jtrainer
from kubeflow_tpu_torch.convert import flax_to_state_dict
from kubeflow_tpu_torch.models import transformer as T
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.ops.xent import chunked_lm_xent
from kubeflow_tpu_torch.runtime import trainer as ttrainer
from kubeflow_tpu_torch.runtime.trainer import _xent_loss

POLICIES = ["full", "dots", "mlp", "slim", "slim@1"]
SEQ = 128


def _tokens(seed=0, b=2, seq=SEQ):
    return np.random.default_rng(seed).integers(0, 256, (b, seq),
                                                dtype=np.int32)


def _loss_and_grads(policy, dtype="float32"):
    kw = {} if policy is None else dict(remat=True, remat_policy=policy)
    model = get_model("transformer-test", device="cpu", dtype=dtype,
                      attention_impl="flash", **kw)
    tok = torch.tensor(_tokens()).long()
    targets = tok.roll(-1, 1)
    targets[:, -1] = -1
    loss = _xent_loss(model(tok), targets)
    loss.backward()
    return loss.item(), {n: p.grad.clone()
                         for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_equals_no_remat(policy):
    want_loss, want = _loss_and_grads(None)
    got_loss, got = _loss_and_grads(policy)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=0, err_msg=name)


def _train_cfg(mod, policy):
    return mod.TrainConfig.from_dict(dict(
        model="transformer-test", task="lm", global_batch=8, seq_len=64,
        vocab_size=256, optimizer="adamw", learning_rate=1e-3,
        warmup_steps=1, total_steps=2, remat=True, remat_policy=policy,
        model_kwargs={"dtype": "float32", "attention_impl": "flash"}))


@pytest.mark.parametrize("policy", POLICIES)
def test_loss_matches_jax_at_the_same_policy(policy):
    jt = jtrainer.Trainer(_train_cfg(jtrainer, policy))
    state = jt.init_state()
    batch = next(jt.data_iter())
    tt = ttrainer.Trainer(_train_cfg(ttrainer, policy), device="cpu")
    assert tt.model.cfg.remat and tt.model.cfg.remat_policy == policy
    tt.model.load_state_dict(flax_to_state_dict(jax.device_get(state.params)))
    _, m = jt.train_step(state, batch)
    got = tt.train_step({k: torch.from_numpy(np.asarray(v))
                         for k, v in batch.items()})
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]),
                               rtol=1e-5)


class _Held(TorchDispatchMode):
    """Records every tensor the ops under it make; `alive()` gives, once
    per storage, those still referenced: after a forward, what the
    backward holds (tensors autograd saved, the checkpoints' inputs, and
    the outputs selective checkpointing cached, which no saved-tensor
    hook sees). Tensors made inside a Block are marked so."""

    def __init__(self, model):
        super().__init__()
        self.made = []
        self.in_block = 0
        for blk in model.blocks():
            blk.register_forward_pre_hook(lambda *_: self._enter(1))
            blk.register_forward_hook(lambda *_: self._enter(-1))

    def _enter(self, step):
        self.in_block += step

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.made.append((tuple(t.shape), t.dtype, self.in_block > 0,
                                  weakref.ref(t.untyped_storage())))
        return out

    def alive(self):
        gc.collect()
        held = {}
        for shape, dtype, in_block, ref in self.made:
            s = ref()
            if s is not None:
                held.setdefault(s.data_ptr(),
                                (s.nbytes(), shape, dtype, in_block))
        return list(held.values())


def _held(policy, seq=SEQ):
    """What the backward holds after the bf16 forward and the chunked
    loss (4 chunks), transformer-test through flash, tokens [2, seq]."""
    kw = {} if policy == "none" else dict(remat=True, remat_policy=policy)
    model = get_model("transformer-test", device="cpu",
                      attention_impl="flash", **kw)
    tok = torch.tensor(_tokens(seq=seq)).long()
    mode = _Held(model)
    with mode:
        hidden = model(tok, return_hidden=True)
        loss, _ = chunked_lm_xent(hidden, model.lm_head.kernel,
                                  tok.roll(-1, 1), 4,
                                  compute_dtype=model.cfg.dtype)
        del hidden
    held = mode.alive()
    loss.backward()                    # the held tensors do serve it
    return held, model.cfg


def test_saved_bytes_order_matches_the_reference():
    from tools import remat_plan

    order = ["none", "full", "dots", "mlp", "slim"]
    got = {p: sum(h[0] for h in _held(p)[0]) for p in order}
    want = {}
    tok = jnp.asarray(_tokens())
    for p in order:
        kw = {} if p == "none" else dict(remat=True, remat_policy=p)
        jm = jax_get_model("transformer-test", attention_impl="flash", **kw)
        want[p] = remat_plan.residual_bytes(jm, tok, p, xent_chunks=4)[0]
    assert sorted(order, key=got.get) == sorted(order, key=want.get) == [
        "full", "slim", "dots", "mlp", "none"], (got, want)


def test_slim_saves_no_wide_or_f32_stream_tensor():
    # 64 tokens, so that no length-wide tensor (lse) is d_ff-wide too
    seq = 64
    held, cfg = _held("slim", seq)
    in_block = [h for h in held if h[3]]
    assert in_block
    stream = (2, seq, cfg.d_model)
    for _, shape, dtype, _ in in_block:
        assert shape[-1] != cfg.d_ff, (shape, dtype)
        assert not (dtype == torch.float32 and shape == stream), shape
    # no remat keeps both, inside the blocks
    plain = [h for h in _held("none", seq)[0] if h[3]]
    assert any(h[1][-1] == cfg.d_ff for h in plain)
    assert any(h[2] == torch.float32 and h[1] == stream for h in plain)


@pytest.mark.parametrize("policy,per_layer", [
    ("none", 1), ("full", 2), ("dots", 1), ("mlp", 1), ("slim", 1),
    ("slim@1", 1)])
def test_flash_forward_runs_per_layer(policy, per_layer, monkeypatch):
    calls = []
    plain = fa.flash_fwd_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_fwd_plain", counted)
    _loss_and_grads(None if policy == "none" else policy)
    # slim@1: the one slim block saves (out, lse), the other block
    # saves everything
    assert len(calls) == per_layer * 2


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def _backward_matmuls(policy):
    kw = {} if policy == "none" else dict(remat=True, remat_policy=policy)
    model = get_model("transformer-test", device="cpu",
                      attention_impl="flash", **kw)
    loss = model(torch.tensor(_tokens()).long()).square().mean()
    with _CountMM() as count:
        loss.backward()
    return count.n


@pytest.mark.parametrize("policy,per_layer", [
    ("full", 6), ("dots", 0), ("mlp", 2), ("slim", 2)])
def test_matmuls_replayed_per_layer(policy, per_layer):
    """The backward's replay: full runs the block's q, k, v, o, gate and
    up matmuls again, mlp and slim only gate and up, dots none; none
    replays the down projection, after which nothing the backward needs
    is left to rebuild."""
    replayed = _backward_matmuls(policy) - _backward_matmuls("none")
    assert replayed == per_layer * 2


@pytest.mark.parametrize("policy", ["slim@0", "slim@3", "foo", "slim@x",
                                    "@2", "foo@1"])
def test_malformed_policies_raise_the_reference_error(policy):
    jm = jax_get_model("transformer-test", remat=True, remat_policy=policy)
    tok = jnp.zeros((1, 8), jnp.int32)
    with pytest.raises(ValueError) as want:
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), tok))
    with pytest.raises(ValueError) as got:
        T.TransformerConfig(n_layers=2, remat=True, remat_policy=policy)
    assert str(got.value) == str(want.value)
