"""Expert parallelism in the port's trainer: the reference's MoE witness
(`__graft_entry__.py` `moe_equivalence_losses`) in a 4-process gloo
world on the CPU.

One moe-test model (f32, capacity factor 4: no token overflows, so the
two dispatch paths keep the same tokens), one seed and one global batch
under `dp_dense` (data 4, the dense one-hot oracle) and `dp_ep_sparse`
(data 2 x expert 2: the experts split over `expert`, tokens exchanged by
all-to-all). The witness is the logits at the initial params, the whole
params after one sgdm step and both step losses, held at the
reference's `SPMD_PARITY_TOLS` (loss 1e-5, logits 1e-4, params 1e-6),
and each layout against the reference's own witness on virtual CPU
devices at tests/test_torch_spmd.py's 2e-4. Besides: data 2 x model 2
(tensor-parallel experts on the dense path) and data 2 x expert 2 on
the forced dense path (the expert slices gathered, their gradients
summed back over `expert`) equal one process, the
gathered payload of each layout equals one process's optimizer state
and loads back bit for bit, and the step reports moe_sparse_dispatch
1.0 under `expert` 2 and 0.0 under the forced dense path.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_dist import run_world
from test_torch_spmd import (
    REF_RTOL,
    TOLS,
    _assert_parity,
    _merged,
    _run,
)

BATCH = 8

MOE = dict(model="moe-test", task="lm", seq_len=32, vocab_size=256,
           optimizer="sgdm", learning_rate=0.1, total_steps=2,
           warmup_steps=0, global_batch=BATCH, log_every=10**9)


def _kw(impl: str) -> dict:
    return {"dtype": "float32", "moe_impl": impl, "moe_capacity_factor": 4.0}


LAYOUTS = {
    "dp_dense": dict(MOE, mesh={"data": 4}, model_kwargs=_kw("dense")),
    "dp_ep_sparse": dict(MOE, mesh={"data": 2, "expert": 2},
                         model_kwargs=_kw("sparse")),
    "dp_tp": dict(MOE, mesh={"data": 2, "model": 2},
                  model_kwargs=_kw("auto")),
    "ep_dense": dict(MOE, mesh={"data": 2, "expert": 2},
                     model_kwargs=_kw("dense")),
}


def ep_worker(rank, n, out_dir):
    from kubeflow_tpu_torch.parallel import dist as D

    D.initialize_from_env(device="cpu")
    init = torch.load(os.path.join(out_dir, "init.pt"), weights_only=True)
    from kubeflow_tpu_torch.runtime.trainer import TrainConfig, Trainer

    for name, cfg in LAYOUTS.items():
        out = _run(name, cfg, init)
        trainer = Trainer(TrainConfig.from_dict(cfg), device="cpu")
        m = trainer.train_step(trainer._to_device(next(trainer.data_iter())))
        out["dispatch"] = float(m["moe_sparse_dispatch"])
        out["local_w_gate"] = tuple(trainer.model.layer_1.moe.w_gate.shape)
        torch.save(out, os.path.join(out_dir, f"{name}_rank{rank}.pt"))
    D.shutdown()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's initial moe-test params (seed 0) as the port's state
    dict, and its own dp_dense / dp_ep_sparse witnesses on 4 virtual
    devices."""
    import jax

    import __graft_entry__ as G
    from kubeflow_tpu.parallel.mesh import MeshSpec
    from kubeflow_tpu.runtime import trainer as jtrainer
    from kubeflow_tpu_torch.convert import flax_to_state_dict

    root = tmp_path_factory.mktemp("moe_ep")
    jt = jtrainer.Trainer(jtrainer.TrainConfig.from_dict(dict(
        {k: v for k, v in MOE.items() if k != "log_every"},
        model_kwargs=_kw("dense"))))
    init = flax_to_state_dict(jax.device_get(jt.init_state().params))
    torch.save(init, root / "init.pt")
    ref = {}
    for name, spec, impl in (("dp_dense", MeshSpec(data=4), "dense"),
                             ("dp_ep_sparse", MeshSpec(data=2, expert=2),
                              "sparse")):
        ref[name] = G._layout_witness(dict(
            model="moe-test", model_kwargs=_kw(impl), global_batch=BATCH,
            mesh=spec), jax.devices()[:4])
    return root, init, ref


@pytest.fixture(scope="module")
def world(reference):
    root, _, _ = reference
    run_world(4, "test_torch_moe_ep:ep_worker", root, timeout=300)
    return {name: [torch.load(root / f"{name}_rank{r}.pt",
                              weights_only=False) for r in range(4)]
            for name in LAYOUTS}


@pytest.fixture(scope="module")
def single(reference):
    _, init, _ = reference
    return {name: _run(name, {k: v for k, v in cfg.items() if k != "mesh"},
                       init) for name, cfg in LAYOUTS.items()}


def test_dense_and_sparse_layouts_agree_at_the_reference_tolerances(world):
    """assert_spmd_parity over the two layouts: the pairwise spreads of
    the losses, the logits and the params after one step."""
    a, b = _merged(world["dp_dense"]), _merged(world["dp_ep_sparse"])
    for i in (0, 1):
        assert abs(a["losses"][i] - b["losses"][i]) <= TOLS["loss"]
    assert float((a["logits"] - b["logits"]).abs().max()) <= TOLS["logits"]
    for k, v in a["params"].items():
        d = float((b["params"][k] - v).abs().max())
        assert d <= TOLS["params"], (k, d)


@pytest.mark.parametrize("name", ["dp_dense", "dp_ep_sparse"])
def test_layout_equals_the_reference_witness(name, world, reference):
    import jax

    from kubeflow_tpu_torch.convert import state_dict_to_flax

    _, _, ref = reference
    got = _merged(world[name])
    np.testing.assert_allclose(got["losses"], ref[name]["losses"],
                               rtol=REF_RTOL)
    np.testing.assert_allclose(got["logits"].numpy(), ref[name]["logits"],
                               rtol=REF_RTOL, atol=TOLS["logits"])
    flat = np.concatenate([np.asarray(x, np.float32).ravel() for x in
                           jax.tree.leaves(state_dict_to_flax(
                               got["params"], 16))])
    np.testing.assert_allclose(flat, ref[name]["params"], rtol=REF_RTOL,
                               atol=TOLS["params"])


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_equals_one_process(name, world, single):
    """Each layout against the same config on one process (which takes
    the sparse path unless the config forces dense), with the gathered
    optimizer state and the payload round trip."""
    outs = world[name]
    assert len({tuple(o["losses"]) for o in outs}) == 1
    _assert_parity(name, _merged(outs), single[name])


def test_expert_weights_are_split_over_the_expert_axis(world):
    """Under expert 2 each rank holds and trains half the experts and the
    step takes the sparse path; the gathered params hold all experts."""
    assert [o["dispatch"] for o in world["dp_dense"]] == [0.0] * 4
    assert [o["dispatch"] for o in world["dp_tp"]] == [0.0] * 4
    assert [o["dispatch"] for o in world["ep_dense"]] == [0.0] * 4
    assert {o["local_w_gate"] for o in world["ep_dense"]} == {(2, 64, 128)}
    outs = world["dp_ep_sparse"]
    assert [o["dispatch"] for o in outs] == [1.0] * 4
    assert {o["local_w_gate"] for o in outs} == {(2, 64, 128)}
    assert tuple(outs[0]["params"]["layer_1.moe.w_gate"].shape) == (4, 64,
                                                                    128)
    for o in outs[1:]:
        torch.testing.assert_close(o["params"]["layer_1.moe.w_gate"],
                                   outs[0]["params"]["layer_1.moe.w_gate"])
