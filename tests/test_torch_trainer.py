"""The port's Trainer against the JAX Trainer: 10-step loss curves from the
same converted init and the same synthetic batches, the learning-rate
schedule against optax's, and the port launcher on the CPU.

Loss-curve tolerance: 2e-4 relative per step in f32. The two frameworks
sum gradients in another order (~1e-6 relative); adam divides by
sqrt(v), which amplifies that for the smallest gradients, and ten
updates compound it, staying well inside 2e-4 at lr 1e-2.
"""

import json

import jax
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.runtime import trainer as jtrainer
from kubeflow_tpu_torch.convert import flax_to_state_dict
from kubeflow_tpu_torch.runtime import launcher
from kubeflow_tpu_torch.runtime import trainer as ttrainer

STEPS = 10


def _cfg(mod, **kw):
    base = dict(model="transformer-test", task="lm", global_batch=8,
                seq_len=32, vocab_size=256, learning_rate=1e-2,
                weight_decay=1e-4, warmup_steps=3, total_steps=STEPS,
                model_kwargs={"dtype": "float32"})
    base.update(kw)
    return mod.TrainConfig.from_dict(base)


@pytest.mark.parametrize("optimizer,extra", [
    ("adamw", {}),
    ("sgdm", {}),
    ("adamw", {"xent_chunks": 4,
               "model_kwargs": {"dtype": "float32", "attention_impl": "flash"}}),
], ids=["adamw", "sgdm", "adamw-chunked-flash"])
def test_loss_curve_matches_jax(optimizer, extra):
    jt = jtrainer.Trainer(_cfg(jtrainer, optimizer=optimizer, **extra))
    state = jt.init_state()
    tt = ttrainer.Trainer(_cfg(ttrainer, optimizer=optimizer, **extra),
                          device="cpu")
    tt.model.load_state_dict(flax_to_state_dict(jax.device_get(state.params)))

    jdata, want = jt.data_iter(), []
    for _ in range(STEPS):
        state, m = jt.train_step(state, next(jdata))
        want.append(float(m["loss"]))
    got = []
    summary = tt.fit(callback=lambda i, m: got.append(float(m["loss"])))
    assert summary["steps"] == STEPS and tt.step == STEPS
    assert summary["mfu"] is None            # no peak for the CPU
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert want[-1] < want[0]                # the curve actually moves


@pytest.mark.parametrize("warmup,total", [(3, 10), (0, 5), (10, 4), (1, 1)])
def test_schedule_matches_optax(warmup, total):
    cfg = ttrainer.TrainConfig(learning_rate=0.3, warmup_steps=warmup,
                               total_steps=total)
    sched = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=0.3, warmup_steps=warmup,
        decay_steps=max(total, warmup + 1))
    for step in range(total + 5):
        assert ttrainer.warmup_cosine_lr(step, cfg) == pytest.approx(
            float(sched(step)), rel=1e-6, abs=1e-9)
    if warmup:
        assert ttrainer.warmup_cosine_lr(0, cfg) == 0.0   # first update: lr 0


def test_launcher_cpu_prints_summary(tmp_path, capsys):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(
        "model: transformer-test\ntask: lm\nglobal_batch: 2\nseq_len: 32\n"
        "vocab_size: 256\noptimizer: adamw\nlearning_rate: 0.001\n"
        "warmup_steps: 1\ntotal_steps: 3\nxent_chunks: 2\n"
        "model_kwargs:\n  dtype: float32\n  attention_impl: flash\n")
    assert launcher.main(["--config", str(cfg), "--device", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    summary = json.loads(last)["summary"]
    assert summary["steps"] == 3 and summary["start_step"] == 0
    assert set(summary) == {"steps", "start_step", "step_time_s",
                            "examples_per_sec", "mfu", "final"}
    assert np.isfinite(summary["final"]["loss"])


def test_train_config_rejects_unknown_keys():
    with pytest.raises(ValueError, match="unknown TrainConfig keys"):
        ttrainer.TrainConfig.from_dict({"modle": "llama-1b"})
    with pytest.raises(ValueError, match="unknown mesh axes"):
        ttrainer.TrainConfig.from_dict({"mesh": {"tensor": 2}})
    with pytest.raises(NotImplementedError):
        ttrainer.TrainConfig.from_dict({"mesh": {"fsdp": 4}})


@pytest.mark.parametrize("kw", [
    {"task": "classification"},
    {"task": "classification", "checkpoint_dir": "ckpt"},
    {"task": "seq_classification", "data_path": "shards-*"},
    {"task": "seq_classification", "eval_every": 5}])
def test_unported_config_raises(kw):
    # checkpoints, shards, eval and profiling are ported for task="lm"
    # (tests/test_torch_checkpoint.py, test_torch_runtime_hooks.py); the
    # other tasks still raise with any of them
    cfg = _cfg(ttrainer, **kw)
    with pytest.raises(NotImplementedError):
        ttrainer.Trainer(cfg, device="cpu")


def test_optimizer_update_rules_match_optax():
    """One update of each optimizer from the same params and gradient."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((4, 3)).astype(np.float32)
    g0 = rng.standard_normal((4, 3)).astype(np.float32)
    for name in ("adamw", "sgdm"):
        cfg = ttrainer.TrainConfig(optimizer=name, learning_rate=0.1,
                                   weight_decay=0.01, warmup_steps=0,
                                   total_steps=10)
        tx = jtrainer.make_optimizer(jtrainer.TrainConfig(
            optimizer=name, learning_rate=0.1, weight_decay=0.01,
            warmup_steps=0, total_steps=10))
        p, st = p0, tx.init(p0)
        param = torch.nn.Parameter(torch.tensor(p0))
        opt = ttrainer.make_optimizer(cfg, [param])
        for step in range(3):
            upd, st = tx.update(g0, st, p)
            p = optax.apply_updates(p, upd)
            param.grad = torch.tensor(g0)
            for group in opt.param_groups:
                group["lr"] = ttrainer.warmup_cosine_lr(step, cfg)
            opt.step()
            np.testing.assert_allclose(param.detach().numpy(), np.asarray(p),
                                       atol=1e-6, rtol=1e-6, err_msg=name)


def test_peak_table():
    from kubeflow_tpu_torch.runtime import metrics

    assert metrics.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert metrics.peak_flops("NVIDIA H100 PCIe") == 756e12
    assert metrics.peak_flops("TPU v5 lite") is None
    meter = metrics.StepMeter(1e12, "NVIDIA A100-SXM4-80GB")
    meter._times.append(1.0)
    assert meter.mfu is None
