"""The port's elastic coordinator (kubeflow_tpu_torch/runtime/elastic.py)
against the reference's runtime/elastic.py: `scale_config` on a grid of
policies, world sizes, batches and accumulation; the join barrier; the
world env of a stamp; and a real resize: two gloo processes train from
a world file, rank 0 rewrites the file to shrink the world to itself
after step 2 and to grow it back after step 4; the removed worker exits
as preempted and comes back through the join barrier. Under Preserve
the final params equal an uninterrupted one-process run within 1e-6
(f32), and rank 0's two re-formations are `elastic.rebuild` spans.
"""

import json
import os

import numpy as np
import pytest

from kubeflow_tpu_torch.parallel import dist as D
from kubeflow_tpu_torch.runtime import elastic as E
from test_torch_dist import free_port, run_world

CFG = dict(model="transformer-test", task="lm", global_batch=4, seq_len=16,
           vocab_size=256, optimizer="sgdm", learning_rate=0.05,
           warmup_steps=0, total_steps=8, log_every=1,
           model_kwargs={"dtype": "float32"})


@pytest.mark.parametrize("policy", ["Preserve", "Scale", "Halve"])
@pytest.mark.parametrize("full,world", [(4, 4), (4, 2), (8, 2), (3, 1),
                                        (2, 4), (4, 3)])
@pytest.mark.parametrize("batch,accum", [(32, 0), (32, 2), (10, 4), (5, 3)])
def test_scale_config_matches_reference(policy, full, world, batch, accum):
    from kubeflow_tpu.runtime import elastic as RE
    from kubeflow_tpu.runtime.trainer import TrainConfig as RCfg
    from kubeflow_tpu_torch.runtime.trainer import TrainConfig

    def outcome(mod, cls):
        cfg = cls(global_batch=batch, grad_accum_steps=accum)
        try:
            out = mod.scale_config(cfg, full, world, policy)
        except ValueError as e:
            return ("ValueError", str(e))
        return (out is cfg, out.global_batch, out.grad_accum_steps)

    assert outcome(E, TrainConfig) == outcome(RE, RCfg)
    assert (E.BATCH_PRESERVE, E.BATCH_SCALE) == (RE.BATCH_PRESERVE,
                                                 RE.BATCH_SCALE)


def test_join_barrier_waits_for_membership():
    stamps = [None, D.WorldSpec(0, 1, ("w0",)),
              D.WorldSpec(1, 2, ("w0", "w1"), coordinator="h:9")]
    clock = [0.0]
    coord = E.ElasticCoordinator(lambda: stamps[0], my_name="w1",
                                 join_timeout_s=5, join_poll_s=1,
                                 sleep=lambda s: (clock.__setitem__(
                                     0, clock[0] + s), stamps.pop(0)),
                                 clock=lambda: clock[0])
    w = coord.wait_for_membership()
    assert w.members == ("w0", "w1") and clock[0] == 2
    env = coord.world_env(w, {})
    assert env == {D.ENV_NPROC: "2", D.ENV_PID: "1", D.ENV_COORD: "h:9",
                   D.ENV_WORLD_GEN: "1"}
    late = E.ElasticCoordinator(lambda: D.WorldSpec(0, 1, ("w0",)),
                                my_name="w9", join_timeout_s=0.2,
                                join_poll_s=0.05)
    with pytest.raises(TimeoutError, match="not admitted"):
        late.wait_for_membership()
    with pytest.raises(E.WorldMembershipError):
        late.world_env(D.WorldSpec(0, 1, ("w0",)), {})


def test_world_env_matches_reference():
    from kubeflow_tpu.parallel import dist as RD
    from kubeflow_tpu.runtime import elastic as RE

    text = '{"gen": 2, "size": 3, "members": ["a", "b", "c"], ' \
        '"coordinator": "a:1", "slices": [3, 1, 3]}'
    for name in ("a", "b", "c"):
        got = E.ElasticCoordinator(lambda: None, my_name=name).world_env(
            D.WorldSpec.from_json(text), {})
        want = RE.ElasticCoordinator(lambda: None, my_name=name).world_env(
            RD.WorldSpec.from_json(text), {})
        # the port adds the generation, its store's key prefix
        assert got.pop(D.ENV_WORLD_GEN) == "2" and got == want


def test_elastic_requires_a_checkpoint():
    from kubeflow_tpu_torch.runtime.trainer import TrainConfig

    coord = E.ElasticCoordinator(lambda: None)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        coord.run(TrainConfig.from_dict(CFG))
    with pytest.raises(ValueError, match="resume"):
        coord.run(TrainConfig.from_dict(dict(CFG, checkpoint_dir="x",
                                             resume=False)))


def _stamp(path, gen, members, coordinator):
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(D.WorldSpec(gen, len(members), tuple(members),
                            coordinator=coordinator).to_json())
    os.replace(tmp, path)


def elastic_worker(rank, n, out_dir):
    from kubeflow_tpu_torch.obs import trace as obs_trace
    from kubeflow_tpu_torch.runtime.trainer import TrainConfig

    world_file = os.path.join(out_dir, "world.json")
    # every world re-forms on the first stamp's coordinator port
    coordinator = E.file_world_source(world_file)().coordinator
    cfg = TrainConfig.from_dict(dict(
        CFG, checkpoint_dir=os.path.join(out_dir, "ckpt")))
    steps = []

    def drive(i, m):
        # rank 0 resizes: to itself after step 2, back to both after 4
        steps.append(float(m["loss"]))
        if rank == 0 and len(steps) == 2:
            _stamp(world_file, 1, ["w0"], coordinator)
        if rank == 0 and len(steps) == 4:
            _stamp(world_file, 2, ["w0", "w1"], coordinator)

    def coord():
        return E.ElasticCoordinator(E.file_world_source(world_file),
                                    my_name=f"w{rank}", device="cpu",
                                    join_timeout_s=120, join_poll_s=0.05)

    runs = [coord().run(cfg, full_world=2, callback=drive)]
    if rank == 1:
        # removed by the shrink: back as a replacement through the barrier
        assert runs[0]["elastic"]["exit"] == "preempted"
        D.shutdown()
        runs.append(coord().run(cfg, full_world=2, callback=drive))
    rebuilds = [s.name for s in obs_trace.COLLECTOR.spans()
                if s.name == "elastic.rebuild"]
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"runs": [r["elastic"] for r in runs],
                   "final": runs[-1]["final"], "rebuilds": len(rebuilds)}, f)
    D.shutdown()


def test_shrink_and_grow_back_equal_an_uninterrupted_run(tmp_path):
    from kubeflow_tpu_torch.runtime.checkpoint import restore_params
    from kubeflow_tpu_torch.runtime.trainer import TrainConfig, Trainer

    _stamp(tmp_path / "world.json", 0, ["w0", "w1"],
           f"127.0.0.1:{free_port()}")
    run_world(2, "test_torch_elastic:elastic_worker", tmp_path, timeout=240)
    r0, r1 = (json.loads((tmp_path / f"rank{r}.json").read_text())
              for r in range(2))
    assert r0["runs"] == [{"exit": "completed", "resizes": 2,
                           "worlds": [2, 1, 2]}]
    assert r1["runs"][0]["exit"] == "preempted"
    assert r1["runs"][1] == {"exit": "completed", "resizes": 0,
                             "worlds": [2]}
    assert r0["rebuilds"] == 2 and r0["final"] == r1["final"]

    straight = Trainer(TrainConfig.from_dict(
        dict(CFG, checkpoint_dir=str(tmp_path / "straight"))), device="cpu")
    want = straight.fit()
    np.testing.assert_allclose(r0["final"]["loss"], want["final"]["loss"],
                               atol=1e-5)
    got, step = restore_params(str(tmp_path / "ckpt"))
    ref, _ = restore_params(str(tmp_path / "straight"))
    assert step == 8
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-6,
                                   err_msg=k)
