"""The seq mesh axis under the local attention impls (auto, flash,
reference; kubeflow_tpu_torch/ops/seq_attention.py: this rank's q block
over the K/V gathered from every rank, the causal key prefix) in gloo
worlds of 2 and 4 CPU processes.

Op level, f32, on tests/test_torch_ring.py's inputs and cases (causal,
GQA, window, segment ids, bidirectional) and a bidirectional window:
each rank's output and its dq, dk and dv, concatenated over the ranks,
equal the JAX package's reference attention over the whole sequence
within 2e-5 (the ring tests' tolerance), under each impl (flash is the
plain blockwise version on the CPU; auto there is reference, as the
reference's rule). The bidirectional window also at seq 4, and at the
smallest input it once diverged on (one position a rank, window 1: q
was placed end-aligned over the gathered keys, not at its rank's
positions).

Trainer level, the SPMD witness protocol (tests/test_torch_spmd.py,
SPMD_PARITY_TOLS: loss 1e-5, logits 1e-4, params 1e-6): transformer-test
at seq 2 under auto, flash and reference, flash with a window and with
packed segment ids, and data 2 x seq 2, each equal to one process; the
reference and auto impls at seq 2 also against the reference trainer's
witness on a seq mesh of virtual CPU devices (REF_RTOL), as
tests/test_torch_ring.py holds dp_tp_sp.
"""

import functools
import os

import numpy as np
import pytest
import torch

from test_torch_ring import (
    CASES,
    _coords,
    _lm,
    assert_ops,
    inputs,
    lm_init,
    merged,
    op_outputs,
    spawn,
)
from test_torch_spmd import REF_RTOL, TOLS

IMPLS = ("auto", "flash", "reference")
# non-causal attention with a window: q must sit at its true positions
WINDOW_CASES = {"bidirectional_window": dict(hkv=2, causal=False, window=10)}
SEQ_CASES = {**CASES, **WINDOW_CASES}
# the smallest input the bidirectional window diverged on (the output's
# max |d| 1.42 at seq 2): batch 1, one position a rank, 2 q / 2 kv
# heads, D 8
TINY_CASES = {"bidirectional_window_1": dict(hkv=2, causal=False, window=1)}
LAYOUTS = {
    2: {"sp_auto": _lm("auto", {"data": 1, "seq": 2}),
        "sp_flash": _lm("flash", {"data": 1, "seq": 2}),
        "sp_reference": _lm("reference", {"data": 1, "seq": 2}),
        "sp_flash_window": _lm("flash", {"data": 1, "seq": 2},
                               attention_window=10),
        "sp_flash_packed": _lm("flash", {"data": 1, "seq": 2})},
    4: {"dp_sp_flash": _lm("flash", {"data": 2, "seq": 2})},
}


def tiny_inputs(n: int, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    return {key: rng.standard_normal((1, n, 2, 8)).astype(np.float32)
            for key in ("q", "ct", "k2", "v2")}


def _witness(name: str, cfg: dict, init: dict) -> dict:
    """tests/test_torch_spmd.py's LM witness of one layout (on its world,
    if it has a mesh); `*_packed` steps once on two documents a row."""
    from test_torch_spmd import _lm_witness, _packed

    from kubeflow_tpu_torch.runtime.trainer import TrainConfig, Trainer

    trainer = Trainer(TrainConfig.from_dict(cfg), device="cpu")
    trainer.load_payload({"step": 0, "params": init, "batch_stats": {},
                          "opt_state": {}})
    batch = next(trainer.data_iter())
    packed = name.endswith("_packed")
    return _lm_witness(trainer, _packed(batch) if packed else batch,
                       steps=1 if packed else 2)


def seq_local_worker(rank, n, out_dir):
    from kubeflow_tpu_torch.ops.seq_attention import seq_attention
    from kubeflow_tpu_torch.parallel import backends as BK
    from kubeflow_tpu_torch.parallel import dist as DI
    from kubeflow_tpu_torch.parallel.mesh import axis_group

    DI.initialize_from_env(device="cpu")
    data = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    init = torch.load(os.path.join(out_dir, "init.pt"), weights_only=True)
    mesh = BK.get_backend().mesh({"data": 1, "seq": n}, "cpu")
    seq = axis_group(mesh, ("seq",))
    tiny = tiny_inputs(n)
    out = {"ops": {}, "tiny": {}}
    for impl in IMPLS:
        fn = functools.partial(seq_attention, impl=impl)
        out["ops"][impl] = op_outputs(fn, seq, data,
                                      SEQ_CASES if n == 2 else WINDOW_CASES)
        out["tiny"][impl] = op_outputs(fn, seq, tiny, TINY_CASES)
    for name, cfg in LAYOUTS[n].items():
        res = _witness(name, cfg, init)
        res["coords"] = _coords(cfg["mesh"], n, rank)
        out[name] = res
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    DI.shutdown()


def jax_full_reference(data: dict, cases: dict = SEQ_CASES) -> dict:
    """{case: (out, dq, dk, dv)} of the reference's attention over the
    whole sequence, one process."""
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.ops.attention import reference_attention

    res = {}
    for name, c in cases.items():
        hkv = c["hkv"]
        seg = jnp.asarray(data["seg"]) if c.get("segments") else None

        def loss(q, k, v, c=c, seg=seg):
            out = reference_attention(q, k, v, causal=c.get("causal", True),
                                      segment_ids=seg,
                                      window=c.get("window", 0))
            return jnp.sum(out * data["ct"]), out

        (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True)(
            jnp.asarray(data["q"]), jnp.asarray(data[f"k{hkv}"]),
            jnp.asarray(data[f"v{hkv}"]))
        res[name] = tuple(np.asarray(t) for t in (out, *grads))
    return res


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("seq_local")
    data = inputs()
    np.savez(root / "inputs.npz", **data)
    init = lm_init(root)
    return root, data, init


def _world(setup, n):
    return spawn(setup[0], n, "test_torch_seq_local:seq_local_worker",
                 ("inputs.npz", "init.pt"))


@pytest.fixture(scope="module")
def world2(setup):
    return _world(setup, 2)


@pytest.fixture(scope="module")
def world4(setup):
    return _world(setup, 4)


@pytest.fixture(scope="module")
def single(setup):
    return {name: _witness(name, {k: v for k, v in cfg.items()
                                  if k != "mesh"}, setup[2])
            for name, cfg in {**LAYOUTS[2], **LAYOUTS[4]}.items()}


@pytest.mark.parametrize("impl", IMPLS)
def test_seq_ops_equal_the_reference_over_the_whole_sequence(impl, setup,
                                                             world2):
    assert_ops([{"ops": r["ops"][impl]} for r in world2],
               jax_full_reference(setup[1]))


@pytest.mark.parametrize("impl", IMPLS)
def test_seq_window_without_causality_at_seq_4(impl, setup, world4):
    assert_ops([{"ops": r["ops"][impl]} for r in world4],
               jax_full_reference(setup[1], WINDOW_CASES))


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("impl", IMPLS)
def test_seq_window_without_causality_at_one_position_a_rank(impl, sp,
                                                             world2, world4):
    outs = world2 if sp == 2 else world4
    assert_ops([{"ops": r["tiny"][impl]} for r in outs],
               jax_full_reference(tiny_inputs(sp), TINY_CASES))


@pytest.mark.parametrize("name", [*LAYOUTS[2], *LAYOUTS[4]])
def test_seq_layout_equals_one_process(name, world2, world4, single):
    outs = world2 if name in LAYOUTS[2] else world4
    got = merged([o[name] for o in outs])
    assert len({tuple(o[name]["losses"]) for o in outs}) == 1
    want = single[name]
    for i, (a, b) in enumerate(zip(got["losses"], want["losses"])):
        assert abs(a - b) <= TOLS["loss"], (name, "loss", i, a, b)
    d = float((got["logits"] - want["logits"]).abs().max())
    assert d <= TOLS["logits"], (name, "logits", d)
    assert set(got["params"]) == set(want["params"])
    for k, v in want["params"].items():
        d = float((got["params"][k] - v).abs().max())
        assert d <= TOLS["params"], (name, "params", k, d)


def test_seq_layout_equals_the_reference_witness(world2):
    """The reference's trainer on a seq-2 mesh of virtual devices with
    attention_impl reference (GSPMD gathers K/V) against the port's
    world under reference and auto (the reference path on the CPU)."""
    import jax

    import __graft_entry__ as G
    from kubeflow_tpu.parallel.mesh import MeshSpec
    from kubeflow_tpu_torch.convert import state_dict_to_flax

    ref = G._layout_witness(dict(
        model="transformer-test", global_batch=8,
        model_kwargs={"attention_impl": "reference", "dtype": "float32"},
        mesh=MeshSpec(data=1, seq=2)), jax.devices()[:2])
    for name in ("sp_reference", "sp_auto"):
        got = merged([o[name] for o in world2])
        np.testing.assert_allclose(got["losses"], ref["losses"],
                                   rtol=REF_RTOL, err_msg=name)
        np.testing.assert_allclose(got["logits"].numpy(), ref["logits"],
                                   rtol=REF_RTOL, atol=TOLS["logits"],
                                   err_msg=name)
        flat = np.concatenate([np.asarray(x, np.float32).ravel() for x in
                               jax.tree.leaves(state_dict_to_flax(
                                   got["params"], 16))])
        np.testing.assert_allclose(flat, ref["params"], rtol=REF_RTOL,
                                   atol=TOLS["params"], err_msg=name)


def test_seq_takes_every_impl_and_refuses_others():
    """Every attention impl of the LM and BERT now trains on a seq axis;
    `apply_seq` sets the group on the model and each LM block."""
    import types

    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.ops.seq_attention import seq_attention
    from kubeflow_tpu_torch.parallel import shardings as S
    from kubeflow_tpu_torch.parallel.mesh import AxisGroup

    group = AxisGroup(None, 0, 2)
    for impl in S.SEQ_IMPLS:
        model = get_model("transformer-test", device="cpu",
                          attention_impl=impl)
        S.apply_seq(model, group)
        assert model.seq is group
        assert all(b.attn.seq is group for b in model.blocks())
    bert = get_model("bert-test", device="cpu")
    S.apply_seq(bert, group)
    assert bert.seq is group
    other = types.SimpleNamespace(
        cfg=types.SimpleNamespace(attention_impl="paged"), blocks=list)
    with pytest.raises(ValueError, match="takes attention_impl"):
        S.apply_seq(other, group)
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="takes impl"):
        seq_attention(q, q, q, seq=group, impl="ring")
