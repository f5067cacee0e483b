"""The port's Trainer on the classification tasks (ResNet, ViT, BERT)
against the JAX package's Trainer, and their state through checkpoints:
the port's own, and orbax <-> port both ways (`convert.py`).

Tolerances, in f32: one step's loss within 1e-5 relative; parameters and
batch_stats after one sgdm step within 1e-5 (the frameworks sum in
another order, ~1e-7 of each value at these sizes); a step after a move
between the frameworks within 1e-4, as tests/test_torch_checkpoint.py.
"""

import json
import pathlib

import jax
import numpy as np
import pytest
import torch
from flax.core import meta

from kubeflow_tpu.runtime import checkpoint as jckpt
from kubeflow_tpu.runtime import data as jdata
from kubeflow_tpu.runtime import records as jrecords
from kubeflow_tpu.runtime import trainer as jtrainer
from kubeflow_tpu_torch import convert
from kubeflow_tpu_torch.runtime import checkpoint as ckpt
from kubeflow_tpu_torch.runtime import data, launcher, records
from kubeflow_tpu_torch.runtime import trainer as ttrainer
from kubeflow_tpu_torch.utils import yaml_lite

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEP_TOL = 1e-5
INTEROP_TOL = 1e-4

RESNET = dict(model="resnet18", task="classification", global_batch=8,
              image_size=32, num_classes=10, optimizer="sgdm",
              learning_rate=0.1, weight_decay=1e-4, warmup_steps=0,
              total_steps=4, log_every=1,
              model_kwargs={"num_filters": 8, "dtype": "float32"})
TASKS = {
    "resnet18": RESNET,
    "resnet50-s2d": {**RESNET, "model": "resnet50", "model_kwargs": {
        "num_filters": 8, "dtype": "float32", "stem": "space_to_depth"}},
    "vit-test": {**RESNET, "model": "vit-test",
                 "model_kwargs": {"dtype": "float32"}},
    "bert-test": {**RESNET, "model": "bert-test",
                  "task": "seq_classification", "seq_len": 16,
                  "vocab_size": 512, "num_classes": 2,
                  "model_kwargs": {"dtype": "float32"}},
}


def port(cfg: dict, **kw) -> ttrainer.Trainer:
    return ttrainer.Trainer(ttrainer.TrainConfig.from_dict({**cfg, **kw}),
                            device="cpu")


def jax_trainer(cfg: dict, **kw) -> jtrainer.Trainer:
    return jtrainer.Trainer(jtrainer.TrainConfig.from_dict({**cfg, **kw}))


def state_of(state) -> dict[str, np.ndarray]:
    """A JAX TrainState's params and batch_stats by port name."""
    host = jax.device_get(state)
    out = convert.flax_to_state_dict(meta.unbox(host.params))
    out.update(convert.flax_to_state_dict(host.batch_stats or {}))
    return {n: t.numpy() for n, t in out.items()}


def port_state(t: ttrainer.Trainer) -> dict[str, np.ndarray]:
    return {n: v.detach().numpy().copy()
            for n, v in t.model.state_dict().items()}


def assert_close(got: dict, want: dict, tol: float) -> None:
    assert set(got) == set(want)
    for name in sorted(want):
        np.testing.assert_allclose(got[name], want[name], rtol=tol, atol=tol,
                                   err_msg=name)


def aligned(cfg: dict, **kw):
    """The reference's trainer and initial state, and a port trainer
    loaded with that state."""
    jt = jax_trainer(cfg, **kw)
    state = jt.init_state()
    t = port(cfg, **kw)
    t.model.load_state_dict({n: torch.from_numpy(a)
                             for n, a in state_of(state).items()})
    return jt, state, t


@pytest.mark.parametrize("name", list(TASKS))
def test_one_step_and_eval_match_jax(name):
    cfg = TASKS[name]
    jt, state, t = aligned(cfg)
    batch = next(jt.data_iter())
    state, m = jt.train_step(state, batch)
    got = t.train_step(t._to_device(next(t.data_iter())))
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]),
                               rtol=STEP_TOL)
    assert float(got["accuracy"]) == float(m["accuracy"])
    assert_close(port_state(t), state_of(state), STEP_TOL)
    ev, pev = jt.eval_step(state, batch), t.eval_step(t._to_device(batch))
    np.testing.assert_allclose(float(pev["loss"]), float(ev["loss"]),
                               rtol=STEP_TOL)
    assert float(pev["accuracy"]) == float(ev["accuracy"])
    assert t.model.training              # eval_step restores train mode


def test_grad_accumulation_carries_batch_stats_as_the_reference():
    jt, state, t = aligned(RESNET, grad_accum_steps=2, global_batch=16)
    batch = next(jt.data_iter())
    state, m = jt.train_step(state, batch)
    got = t.train_step(t._to_device(batch))
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]),
                               rtol=STEP_TOL)
    assert_close(port_state(t), state_of(state), STEP_TOL)


def test_sgdm_is_optax_chain_with_batchnorm_over_three_steps():
    """add_decayed_weights then nesterov momentum: the trace carries over
    steps, so three steps at a warmup-cosine schedule."""
    cfg = {**RESNET, "warmup_steps": 1, "weight_decay": 1e-2}
    jt, state, t = aligned(cfg)
    batch = next(jt.data_iter())
    for _ in range(3):
        state, _ = jt.train_step(state, batch)
        t.train_step(t._to_device(batch))
    assert_close(port_state(t), state_of(state), INTEROP_TOL)


def test_data_iterators_equal_the_reference(tmp_path):
    a = next(data.synthetic_images(4, 16, 10, seed=3))
    b = next(jdata.synthetic_images(4, 16, 10, seed=3))
    for k in ("image", "label"):
        np.testing.assert_array_equal(a[k], b[k])
    a = next(data.synthetic_token_classes(4, 8, 100, 3, seed=2))
    b = next(jdata.synthetic_token_classes(4, 8, 100, 3, seed=2))
    for k in ("tokens", "label"):
        np.testing.assert_array_equal(a[k], b[k])
    imgs = np.random.default_rng(0).integers(0, 255, (12, 8, 8, 3),
                                             dtype=np.uint8)
    labels = np.arange(12, dtype=np.int32)
    mine, ref = str(tmp_path / "p.kfr"), str(tmp_path / "r.kfr")
    assert records.write_image_shard(mine, imgs, labels) == 12
    jrecords.write_image_shard(ref, imgs, labels)
    assert open(mine, "rb").read() == open(ref, "rb").read()
    got = records.image_batches([mine], 4, 8, loop=False)
    want = jrecords.image_batches([ref], 4, 8, loop=False)
    n = 0
    for g, w in zip(got, want):
        for k in ("image", "label"):
            np.testing.assert_array_equal(g[k], w[k])
        n += 1
    assert n == 3
    # the trainer reads them for classification
    t = port(RESNET, image_size=8, data_path=str(tmp_path / "p*.kfr"))
    first = next(t.data_iter())
    np.testing.assert_array_equal(first["label"], labels[:8])


def test_checkpoint_resume_carries_batch_stats_and_momentum(tmp_path):
    d = str(tmp_path / "ckpt")
    a = port(RESNET, checkpoint_dir=d, checkpoint_every=1)
    a.fit(steps=2)
    payload = ckpt.Checkpointer(d).restore(2)
    stats = payload["batch_stats"]
    assert stats and set(stats) == {n for n, _ in a.model.named_buffers()}
    assert set(payload["params"]) == {n for n, _ in
                                      a.model.named_parameters()}
    assert float(stats["bn_init.mean"].abs().max()) > 0    # moved
    assert all(set(st) == {"momentum_buffer"}
               for st in payload["opt_state"].values())
    b = port(RESNET, checkpoint_dir=d, checkpoint_every=1)
    summary = b.fit(steps=4)
    assert summary["start_step"] == 2 and b.step == 4
    straight = port(RESNET)
    straight.fit(steps=4)
    assert_close(port_state(b), port_state(straight), 1e-6)
    variables, step = ckpt.restore_variables(d)
    assert step == 4 and set(variables) == {"params", "batch_stats"}


def test_jax_orbax_checkpoint_resumes_on_the_port(tmp_path):
    jd, pd = str(tmp_path / "orbax"), str(tmp_path / "port")
    jt = jax_trainer(RESNET, checkpoint_dir=jd)
    jt.fit(steps=2)
    jck = jckpt.Checkpointer(jd)
    state2 = jax.device_get(jck.restore_latest(jt.init_state()))
    jck.close()
    assert int(state2.step) == 2
    convert.write_port_checkpoint(pd, 2, meta.unbox(state2.params),
                                  state2.opt_state, "sgdm",
                                  batch_stats=state2.batch_stats)
    state3, m = jt.train_step(state2, next(jt.data_iter()))
    t = port(RESNET, checkpoint_dir=pd)
    losses = []
    summary = t.fit(steps=3, callback=lambda i, m: losses.append(
        float(m["loss"])))
    assert summary["start_step"] == 2 and t.step == 3
    np.testing.assert_allclose(losses, [float(m["loss"])], rtol=INTEROP_TOL)
    assert_close(port_state(t), state_of(state3), INTEROP_TOL)


def test_port_checkpoint_resumes_on_jax(tmp_path):
    pd = str(tmp_path / "port")
    port(RESNET, checkpoint_dir=pd).fit(steps=2)
    payload = ckpt.Checkpointer(pd).restore(2)
    t = port(RESNET, checkpoint_dir=pd)
    want = []
    t.fit(steps=3, callback=lambda i, m: want.append(float(m["loss"])))

    jt = jax_trainer(RESNET)
    template = jt.init_state()
    params = convert.state_dict_to_flax(payload["params"], None)
    stats = convert.state_dict_to_flax(payload["batch_stats"], None)
    with pytest.raises(ValueError, match="step="):
        convert.opt_state_to_flax(payload["opt_state"], payload["params"],
                                  template.opt_state, None)
    opt_state = convert.opt_state_to_flax(
        payload["opt_state"], payload["params"], template.opt_state, None,
        step=2)
    assert (jax.tree.structure(opt_state)
            == jax.tree.structure(template.opt_state))
    assert (jax.tree.structure(stats)
            == jax.tree.structure(jax.device_get(template.batch_stats)))
    state2 = template.replace(step=np.asarray(2, np.int32), params=params,
                              batch_stats=stats, opt_state=opt_state)
    state3, m = jt.train_step(state2, next(jt.data_iter()))
    np.testing.assert_allclose([float(m["loss"])], want, rtol=INTEROP_TOL)
    assert_close(state_of(state3), port_state(t), INTEROP_TOL)


def test_sgdm_state_round_trip():
    t = port(RESNET)
    t.fit(steps=2)
    p = t.payload()
    template = jax_trainer(RESNET).init_state()
    flax_state = convert.opt_state_to_flax(p["opt_state"], p["params"],
                                           template.opt_state, None, step=2)
    back = convert.opt_state_to_port(
        flax_state, convert.state_dict_to_flax(p["params"], None), "sgdm")
    assert set(back) == set(p["opt_state"])
    for name, st in p["opt_state"].items():
        np.testing.assert_array_equal(back[name]["momentum_buffer"].numpy(),
                                      st["momentum_buffer"].numpy(),
                                      err_msg=name)
    counts = [int(n.count) for n in convert._states(flax_state)
              if "count" in n._fields]
    assert counts == [2]


@pytest.mark.parametrize("cfg,want", [
    (dict(model="resnet50", model_kwargs={"stem": "space_to_depth"},
          global_batch=256, image_size=224), 6.34e12),
    (dict(model="resnet18", global_batch=32, image_size=224), None),
    (dict(model="vit-b16", global_batch=128, image_size=224), 13.4e12),
    (dict(model="bert-base", task="seq_classification", global_batch=32,
          seq_len=512, num_classes=2), 9.28e12)],
    ids=["resnet50-s2d", "resnet18", "vit-b16", "bert-base"])
def test_flops_per_step_is_the_reference_count(cfg, want):
    from kubeflow_tpu.models import resnet as jresnet
    from kubeflow_tpu.models.registry import get_model as jax_model

    cfg = {"task": "classification", **cfg}
    t = ttrainer.Trainer(ttrainer.TrainConfig.from_dict(cfg), device="meta")
    if cfg["model"].startswith("resnet"):
        ref = 3.0 * cfg["global_batch"] * jresnet.fwd_flops(
            cfg["model"], cfg["image_size"], 1000, 64,
            cfg.get("model_kwargs", {}).get("stem", "conv7"))
    elif cfg["model"].startswith("vit"):
        ref = 3.0 * cfg["global_batch"] * jax_model(
            cfg["model"]).fwd_flops_per_image()
    else:
        ref = (jax_model(cfg["model"]).flops_per_token(cfg["seq_len"])
               * cfg["global_batch"] * cfg["seq_len"])
    assert t.flops_per_step() == ref
    if want:
        assert abs(ref - want) < 0.005 * want


def test_launcher_trains_a_resnet_config_on_the_cpu(tmp_path, capsys):
    example = yaml_lite.loads((ROOT / "examples" / "resnet50.yaml"
                               ).read_text())
    cfg = ttrainer.TrainConfig.from_dict(example)
    assert (cfg.model, cfg.task, cfg.optimizer, cfg.global_batch) == (
        "resnet50", "classification", "sgdm", 256)
    small = {**example, "model": "resnet18", "global_batch": 4,
             "image_size": 16, "total_steps": 2, "log_every": 1,
             "model_kwargs": {**example["model_kwargs"], "num_filters": 8},
             "checkpoint_dir": str(tmp_path / "ckpt")}
    path = tmp_path / "resnet.json"
    path.write_text(json.dumps(small))
    assert launcher.main(["--config", str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[-1])["summary"]
    assert summary["steps"] == 2 and np.isfinite(summary["final"]["loss"])
    variables, step = ckpt.restore_variables(str(tmp_path / "ckpt"))
    assert step == 2 and variables["batch_stats"]


@pytest.mark.parametrize("kw,err,match", [
    # whole-forward remat takes the reference's dots|full only
    ({"remat": True, "remat_policy": "mlp"}, ValueError, "dots|full"),
    ({"model_kwargs": {"num_classes": 5}}, ValueError, "conflicts"),
    ({"task": "seq_classification", "model": "bert-test",
      "data_path": "shards-*"}, ValueError, "no labels"),
    ({"task": "regression"}, ValueError, "unknown task")],
    ids=["remat", "num-classes", "seq-shards", "task"])
def test_refused_configs(kw, err, match):
    with pytest.raises(err, match=match):
        port(RESNET, **kw)


def test_lm_payload_keeps_its_layout():
    """An LM has no buffers: its batch_stats is empty and its params are
    the whole state_dict, as in the checkpoints of earlier runs."""
    t = port({"model": "transformer-test", "task": "lm", "global_batch": 2,
              "seq_len": 8, "vocab_size": 256, "total_steps": 1,
              "optimizer": "adamw", "model_kwargs": {"dtype": "float32"}})
    p = t.payload()
    assert p["batch_stats"] == {} and set(p["params"]) == set(
        t.model.state_dict())
