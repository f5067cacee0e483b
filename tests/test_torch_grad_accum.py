"""Gradient accumulation in the port's Trainer (`grad_accum_steps`): an
accumulated step equals the full-batch step and the JAX trainer's
accumulated step, with tests/test_grad_accum.py's tolerances (loss rtol
1e-5, accuracy 1e-6, params rtol 1e-4 and atol 1e-6, f32 model).
"""

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.parallel.mesh import build_mesh
from kubeflow_tpu.runtime import trainer as jtrainer
from kubeflow_tpu_torch.convert import flax_to_state_dict
from kubeflow_tpu_torch.runtime import trainer as ttrainer

LOSS_TOL = dict(rtol=1e-5)
ACC_TOL = dict(rtol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


def _cfg(mod, **kw):
    base = dict(model="transformer-test", task="lm", global_batch=8,
                seq_len=32, vocab_size=256, optimizer="adafactor",
                learning_rate=1e-3, total_steps=3, warmup_steps=1,
                log_every=10**9, model_kwargs={"dtype": "float32"})
    base.update(kw)
    return mod.TrainConfig.from_dict(base)


def _batch(trainer, sparse_rows=()):
    """The first synthetic batch; rows in `sparse_rows` keep only their
    first 4 targets (the rest -1, ignored)."""
    b = {k: torch.from_numpy(np.array(v))
         for k, v in next(trainer.data_iter()).items()}
    for r in sparse_rows:
        b["targets"][r, 4:] = -1
    return b


def _step(accum, batch=None, **kw):
    """(loss, accuracy, params) after one step from seed-0 weights."""
    tt = ttrainer.Trainer(_cfg(ttrainer, grad_accum_steps=accum, **kw),
                          device="cpu")
    m = tt.train_step(batch if batch is not None else _batch(tt))
    return (float(m["loss"]), float(m["accuracy"]),
            {n: p.detach().clone() for n, p in tt.model.named_parameters()})


def _assert_same(got, want):
    np.testing.assert_allclose(got[0], want[0], **LOSS_TOL)
    np.testing.assert_allclose(got[1], want[1], **ACC_TOL)
    for name, p in want[2].items():
        np.testing.assert_allclose(got[2][name].numpy(), p.numpy(),
                                   **PARAM_TOL, err_msg=name)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_accum_step_equals_full_batch_step(optimizer):
    _assert_same(_step(4, optimizer=optimizer), _step(0, optimizer=optimizer))


def test_accum_composes_with_chunked_xent():
    _assert_same(_step(2, xent_chunks=4), _step(0, xent_chunks=4))


def test_accum_weights_microbatches_by_valid_count():
    """Rows 0 and 4 keep 4 targets and the rest all 32: with the strided
    split, microbatch 0 (rows 0 and 4) has 8 valid targets, the other
    three 64 each. Weighted by valid count the step is the full batch's;
    a plain mean of the microbatch means misses it."""
    tt = ttrainer.Trainer(_cfg(ttrainer), device="cpu")
    batch = _batch(tt, sparse_rows=(0, 4))
    full = _step(0, batch)
    _assert_same(_step(4, batch), full)

    micro = [{k: v[m::4] for k, v in batch.items()} for m in range(4)]
    counts = [int((mb["targets"] >= 0).sum()) for mb in micro]
    assert counts == [8, 64, 64, 64]
    tt = ttrainer.Trainer(_cfg(ttrainer), device="cpu")
    means = [tt.loss(mb)[0] for mb in micro]
    unweighted = float((sum(means) / 4).detach())
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(unweighted, full[0], **LOSS_TOL)
    # and its gradient misses too
    tt.opt.zero_grad()
    (sum(means) / 4).backward()
    plain = {n: p.grad.clone() for n, p in tt.model.named_parameters()}
    tt.opt.zero_grad()
    tt.loss(batch)[0].backward()
    with pytest.raises(AssertionError):
        for n, p in tt.model.named_parameters():
            np.testing.assert_allclose(plain[n].numpy(), p.grad.numpy(),
                                       **PARAM_TOL, err_msg=n)


def test_accum_step_matches_jax():
    """The same accumulated step in the JAX trainer, on a one-device
    mesh, from the same converted weights."""
    cfg = _cfg(jtrainer, grad_accum_steps=4)
    jt = jtrainer.Trainer(cfg, mesh=build_mesh(cfg.mesh,
                                               devices=jax.devices()[:1]))
    state = jt.init_state()
    tt = ttrainer.Trainer(_cfg(ttrainer, grad_accum_steps=4), device="cpu")
    tt.model.load_state_dict(flax_to_state_dict(jax.device_get(state.params)))
    batch = next(jt.data_iter())
    state, m = jt.train_step(state, batch)
    got = tt.train_step({k: torch.from_numpy(np.array(v))
                         for k, v in batch.items()})
    want = flax_to_state_dict(jax.device_get(state.params))
    _assert_same((float(got["loss"]), float(got["accuracy"]),
                  {n: p.detach() for n, p in tt.model.named_parameters()}),
                 (float(m["loss"]), float(m["accuracy"]), want))


def test_rejects_indivisible_accum():
    with pytest.raises(ValueError, match="not divisible by"):
        ttrainer.Trainer(_cfg(ttrainer, grad_accum_steps=3), device="cpu")
