"""The port's checkpoint and resume (kubeflow_tpu_torch/runtime/checkpoint.py
and Trainer.fit) against the reference's contract, and checkpoints moved
between the JAX package (orbax) and the port, both ways.

Tolerances: a 2+2-step resumed port run against 4 straight steps uses
the reference's own (rtol 2e-4, atol 2e-5, tests/test_checkpoint.py);
the step after a move between the frameworks is held within 1e-4 (the
two frameworks sum gradients in another order, ~1e-6 relative, and one
update of lr 1e-2 moves the parameters ~1e-2).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.runtime import checkpoint as jckpt
from kubeflow_tpu.runtime import trainer as jtrainer
from kubeflow_tpu_torch import convert
from kubeflow_tpu_torch.runtime import checkpoint as ckpt
from kubeflow_tpu_torch.runtime import metrics as rt_metrics
from kubeflow_tpu_torch.runtime import records
from kubeflow_tpu_torch.runtime import trainer as ttrainer

BASE = dict(model="transformer-test", task="lm", global_batch=8, seq_len=32,
            vocab_size=256, learning_rate=1e-2, weight_decay=1e-4,
            warmup_steps=1, total_steps=4, log_every=1,
            model_kwargs={"dtype": "float32"})
HEAD_DIM = 16          # transformer-test: d_model 64 over 4 heads
INTEROP_TOL = 1e-4


def port(**kw) -> ttrainer.Trainer:
    return ttrainer.Trainer(ttrainer.TrainConfig.from_dict({**BASE, **kw}),
                            device="cpu")


def jax_trainer(**kw) -> jtrainer.Trainer:
    return jtrainer.Trainer(jtrainer.TrainConfig.from_dict({**BASE, **kw}))


def params_of(t: ttrainer.Trainer) -> dict[str, np.ndarray]:
    return {n: p.detach().numpy().copy() for n, p in t.model.named_parameters()}


def assert_params_close(got: dict, want: dict, **tol) -> None:
    assert set(got) == set(want)
    for name in sorted(want):
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **tol)


def counter(op: str) -> float:
    return dict((lab["op"], v) for lab, v in
                rt_metrics.REGISTRY.series("checkpoint_failures_total"))[op]


def test_save_and_resume_continues_from_latest(tmp_path):
    d = str(tmp_path / "ckpt")
    port(checkpoint_dir=d, checkpoint_every=2).fit(steps=4)
    ck = ckpt.Checkpointer(d)
    assert ck.latest_step() == 4 and set(ck.all_steps()) >= {2, 4}
    ck.close()
    # a fresh trainer (a gang restart) resumes at 4 and runs 2 more
    t2 = port(checkpoint_dir=d, checkpoint_every=2)
    summary = t2.fit(steps=6)
    assert summary["start_step"] == 4 and t2.step == 6
    # the target reached already: a no-op run, same summary schema
    t3 = port(checkpoint_dir=d)
    s3 = t3.fit(steps=6)
    assert s3 == {"steps": 6, "start_step": 6, "step_time_s": None,
                  "examples_per_sec": 0.0, "mfu": 0.0, "final": {}}
    assert t3.step == 6


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_resume_matches_uninterrupted_run(tmp_path, optimizer):
    a = port(optimizer=optimizer)
    a.fit(steps=4)
    d = str(tmp_path / "ckpt")
    port(optimizer=optimizer, checkpoint_dir=d, checkpoint_every=2).fit(steps=2)
    b = port(optimizer=optimizer, checkpoint_dir=d, checkpoint_every=2)
    summary = b.fit(steps=4)
    assert summary["start_step"] == 2
    assert_params_close(params_of(b), params_of(a), rtol=2e-4, atol=2e-5)


def test_resume_on_packed_shards_sees_the_straight_runs_batches(tmp_path):
    """Real data: a resumed run skips the batches its steps before the
    checkpoint consumed, so 2+2 steps equal 4 straight ones on shards."""
    rng = np.random.default_rng(0)
    docs = [rng.integers(1, 256, int(n), dtype=np.int32)
            for n in rng.integers(4, 60, 120)]
    tok, seg = records.pack_documents(docs, BASE["seq_len"])
    records.write_packed_token_shard(str(tmp_path / "a.kfr"), tok, seg)
    data = dict(data_path=str(tmp_path / "*.kfr"), packed_data=True,
                shuffle_buffer=8, optimizer="adamw")
    a = port(**data)
    a.fit(steps=4)
    d = str(tmp_path / "ckpt")
    port(checkpoint_dir=d, **data).fit(steps=2)
    b = port(checkpoint_dir=d, **data)
    assert b.fit(steps=4)["start_step"] == 2
    assert_params_close(params_of(b), params_of(a), rtol=2e-4, atol=2e-5)


def test_restore_latest_none_on_empty_dir(tmp_path):
    ck = ckpt.Checkpointer(str(tmp_path / "empty"))
    assert ck.restore_latest(port()) is None
    assert ck.latest_step() is None
    ck.close()


def _two_steps(tmp_path) -> str:
    d = str(tmp_path / "ckpt")
    port(checkpoint_dir=d, checkpoint_every=1).fit(steps=2)
    assert ckpt.list_steps(d) == [1, 2]
    return d


def test_corrupt_newest_step_is_skipped(tmp_path):
    d = _two_steps(tmp_path)
    with open(os.path.join(d, "2", ckpt.PARAMS_FILE), "r+b") as f:
        f.truncate(3)
    before = counter("restore")
    t = port(checkpoint_dir=d)
    summary = t.fit(steps=3)
    assert summary["start_step"] == 1 and t.step == 3
    assert counter("restore") == before + 1


def test_all_steps_corrupt_reraises(tmp_path):
    d = _two_steps(tmp_path)
    for step in ("1", "2"):
        os.remove(os.path.join(d, step, ckpt.OPT_FILE))
    with pytest.raises(FileNotFoundError):
        port(checkpoint_dir=d).fit(steps=3)


def test_half_written_temp_dir_is_never_a_step(tmp_path, monkeypatch):
    d = str(tmp_path / "ckpt")
    os.makedirs(d)
    # a writer killed mid-save: its temp directory, pid long gone
    dead = os.path.join(d, ".tmp-7-999999999")
    os.makedirs(dead)
    open(os.path.join(dead, ckpt.PARAMS_FILE), "wb").write(b"PK\x03")
    ck = ckpt.Checkpointer(d)
    assert ck.all_steps() == [] and not os.path.exists(dead)
    # a write that fails part-way leaves no step and surfaces at wait()
    real_save = torch.save
    calls = []

    def dies_on_second_file(obj, f):
        calls.append(f)
        if len(calls) == 2:
            raise OSError("disk gone")
        real_save(obj, f)

    monkeypatch.setattr(torch, "save", dies_on_second_file)
    before = counter("save")
    assert ck.save(3, port().payload())
    with pytest.raises(OSError, match="disk gone"):
        ck.wait()
    assert ck.all_steps() == [] and os.listdir(d) == ["manifest.json"]
    assert counter("save") == before + 1
    assert json.loads(open(os.path.join(d, "manifest.json")).read())[
        "latest_step"] is None


def test_keep_n(tmp_path):
    d = str(tmp_path / "ckpt")
    t = port()
    ck = ckpt.Checkpointer(d, keep=2)
    for step in range(1, 5):
        assert ck.save(step, t.payload())
    ck.close()
    assert ck.all_steps() == [3, 4]


def test_existing_step_is_skipped_unless_forced(tmp_path):
    d = str(tmp_path / "ckpt")
    t = port()
    ck = ckpt.Checkpointer(d)
    assert ck.save(3, t.payload())
    t.fit(steps=2)             # the params move (the first update has lr 0)
    assert ck.save(3, t.payload()) is False
    ck.wait()
    kept = ck.restore(3)["params"]["embedding"]
    assert not torch.equal(kept, t.model.embedding.detach())
    assert ck.save(3, t.payload(), force=True)
    ck.close()
    assert torch.equal(ck.restore(3)["params"]["embedding"],
                       t.model.embedding.detach())


def test_manifest_matches_the_reference_schema(tmp_path):
    import jax.numpy as jnp

    class State:                         # what the reference's _payload reads
        step = jnp.asarray(2)
        params = {"w": jnp.ones((2,))}
        batch_stats = {}
        opt_state = {"m": jnp.zeros((2,))}

    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    jck = jckpt.Checkpointer(jd, world_size=1, num_slices=1)
    jck.save(2, State())
    jck.close()
    pck = ckpt.Checkpointer(pd, world_size=1, num_slices=1)
    pck.save(2, port().payload())
    pck.close()
    want = json.load(open(os.path.join(jd, "manifest.json")))
    got = json.load(open(os.path.join(pd, "manifest.json")))
    assert got == want == {"latest_step": 2, "steps": [2],
                           "world_sizes": {"2": 1}, "slice_counts": {"2": 1}}


def test_failure_counter_is_registered_at_zero():
    ckpt._count_failure("save", by=0.0)
    text = rt_metrics.REGISTRY.render()
    for op in ("save", "restore"):
        assert f'checkpoint_failures_total{{op="{op}"}}' in text


def test_restore_variables_reads_params_only(tmp_path):
    d = _two_steps(tmp_path)
    for step in ("1", "2"):
        os.remove(os.path.join(d, step, ckpt.OPT_FILE))
    variables, step = ckpt.restore_variables(d)
    assert step == 2 and set(variables) == {"params"}
    params, step = ckpt.restore_params(d, step=1)
    assert step == 1 and "embedding" in params
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ckpt.restore_variables(str(tmp_path / "nothing"))


# -- between the JAX package and the port -----------------------------------

def _jax_step3(jt, state, batch):
    state, m = jt.train_step(state, batch)
    return jax.device_get(state), float(m["loss"])


def _port_named(flax_params) -> dict[str, np.ndarray]:
    return {n: t.numpy() for n, t in
            convert.flax_to_state_dict(jax.device_get(flax_params)).items()}


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_jax_orbax_checkpoint_resumes_on_the_port(tmp_path, optimizer):
    jd, pd = str(tmp_path / "orbax"), str(tmp_path / "port")
    jt = jax_trainer(optimizer=optimizer, checkpoint_dir=jd)
    jt.fit(steps=2)
    # a process with JAX reads the orbax checkpoint with the reference's
    # own restore, then hands numpy trees to the port's writer
    jck = jckpt.Checkpointer(jd)
    state2 = jck.restore_latest(jt.init_state())
    jck.close()
    assert int(state2.step) == 2
    convert.write_port_checkpoint(pd, 2, jax.device_get(state2.params),
                                  jax.device_get(state2.opt_state), optimizer)
    state3, want_loss = _jax_step3(jt, state2, next(jt.data_iter()))

    t = port(optimizer=optimizer, checkpoint_dir=pd)
    losses = []
    summary = t.fit(steps=3, callback=lambda i, m: losses.append(float(m["loss"])))
    assert summary["start_step"] == 2 and t.step == 3
    np.testing.assert_allclose(losses, [want_loss], rtol=INTEROP_TOL)
    assert_params_close(params_of(t), _port_named(state3.params),
                        rtol=INTEROP_TOL, atol=INTEROP_TOL)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_port_checkpoint_resumes_on_jax(tmp_path, optimizer):
    pd = str(tmp_path / "port")
    port(optimizer=optimizer, checkpoint_dir=pd).fit(steps=2)
    payload = ckpt.Checkpointer(pd).restore(2)
    t = port(optimizer=optimizer, checkpoint_dir=pd)
    want_loss = []
    t.fit(steps=3, callback=lambda i, m: want_loss.append(float(m["loss"])))

    jt = jax_trainer(optimizer=optimizer)
    template = jt.init_state()
    flax_params = convert.state_dict_to_flax(payload["params"], HEAD_DIM)
    opt_state = convert.opt_state_to_flax(payload["opt_state"],
                                          payload["params"],
                                          template.opt_state, HEAD_DIM)
    assert (jax.tree.structure(opt_state)
            == jax.tree.structure(template.opt_state))
    for got, want in zip(jax.tree.leaves(opt_state),
                         jax.tree.leaves(template.opt_state)):
        assert np.shape(got) == np.shape(want)
    state2 = template.replace(step=np.asarray(2, np.int32),
                              params=flax_params, opt_state=opt_state)
    state3, loss = _jax_step3(jt, state2, next(jt.data_iter()))
    np.testing.assert_allclose([loss], want_loss, rtol=INTEROP_TOL)
    assert_params_close(_port_named(state3.params), params_of(t),
                        rtol=INTEROP_TOL, atol=INTEROP_TOL)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_opt_state_round_trip(optimizer):
    t = port(optimizer=optimizer)
    t.fit(steps=2)
    sd = t.model.state_dict()
    state = t.payload()["opt_state"]
    template = jax_trainer(optimizer=optimizer).init_state()
    flax_state = convert.opt_state_to_flax(state, sd, template.opt_state,
                                           HEAD_DIM)
    back = convert.opt_state_to_port(
        flax_state, convert.state_dict_to_flax(sd, HEAD_DIM), optimizer)
    assert set(back) == set(state)
    for name, st in state.items():
        assert set(back[name]) == set(st), name
        for key, v in st.items():
            np.testing.assert_array_equal(np.asarray(back[name][key]),
                                          np.asarray(v), err_msg=f"{name} {key}")
    flat = convert.state_dict_to_flax(sd, HEAD_DIM)
    assert _port_named(flat).keys() == sd.keys()
    for name, a in _port_named(flat).items():
        np.testing.assert_array_equal(a, sd[name].numpy(), err_msg=name)


def test_write_port_checkpoint_keeps_the_steps_already_there(tmp_path):
    d = str(tmp_path / "port")
    ck = ckpt.Checkpointer(d, keep=0)
    payload = port().payload()
    for step in (10, 20, 30):
        assert ck.save(step, payload)
    ck.close()
    state = jax.device_get(jax_trainer(optimizer="adamw").init_state())
    convert.write_port_checkpoint(d, 2, state.params, state.opt_state,
                                  "adamw")
    assert ckpt.list_steps(d) == [2, 10, 20, 30]
    params, step = ckpt.restore_params(d, step=2)
    assert step == 2
    assert_params_close({n: v.numpy() for n, v in params.items()},
                        _port_named(state.params), rtol=0, atol=0)
