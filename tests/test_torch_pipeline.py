"""The port's pipeline parallelism (kubeflow_tpu_torch/parallel/
pipeline.py) in a gloo world of 4 CPU processes (data 2 x pipe 2),
against the JAX package's SPMDPipeline and its sequential model.

- GPipe over pipe 2 with n_mb 1, 2 and 4 equals the reference's
  sequential model and its pipelined model on the restacked weights
  (tests/test_pipeline.py:38-60, same model and tolerance), the weights
  reaching the port through convert.py's stage-stacked tree; the
  gradients of one GPipe step equal the sequential model's.
- One trainer step at data 2 x pipe 2 (pp_microbatches 2) equals one
  process (the SPMD witness protocol of tests/test_torch_spmd.py: the
  logits, the params after a step, both losses, the gathered optimizer
  state and the payload round trip across the stages).
- The reference's refusals and convert.py's stacked tree both ways.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_dist import run_world
from test_torch_ring import merged
from test_torch_spmd import _assert_parity, _run

MODEL_KW = dict(vocab_size=128, d_model=32, n_layers=4, n_heads=2,
                n_kv_heads=2, head_dim=16, d_ff=64, max_seq_len=64,
                attention_impl="reference")
PP_TOL = dict(atol=5e-3, rtol=5e-2)     # tests/test_pipeline.py
N_MB = (1, 2, 4)

TRAIN = dict(model="transformer-test", task="lm", seq_len=32,
             vocab_size=256, optimizer="sgdm", learning_rate=0.1,
             total_steps=2, warmup_steps=0, global_batch=8,
             log_every=10**9, pp_microbatches=2,
             model_kwargs={"dtype": "float32"})


def pipe_worker(rank, n, out_dir):
    import torch.nn.functional as F

    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.parallel import backends as BK
    from kubeflow_tpu_torch.parallel import dist as DI
    from kubeflow_tpu_torch.parallel.mesh import axis_group
    from kubeflow_tpu_torch.parallel.pipeline import GPipe, apply_pipeline

    DI.initialize_from_env(device="cpu")
    mesh = BK.get_backend().mesh({"data": 2, "pipe": 2}, "cpu")
    pipe = axis_group(mesh, ("pipe",))
    sd = torch.load(os.path.join(out_dir, "pp_params.pt"), weights_only=True)
    tok = torch.tensor(np.load(os.path.join(out_dir, "tokens.npy"))).long()
    tgt = torch.tensor(np.load(os.path.join(out_dir, "targets.npy"))).long()
    out = {"stage": pipe.rank}
    for n_mb in N_MB:
        model = get_model("transformer-test", device="cpu", dtype="float32",
                          pipeline_stages=2, pp_microbatches=n_mb, **MODEL_KW)
        model.load_state_dict(sd)
        apply_pipeline(model, pipe)
        gp = GPipe(model, pipe)
        out[f"logits{n_mb}"] = gp.logits(tok)
        if n_mb == 2:
            def loss_fn(x, y):
                logits = model.head(x)
                return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                       y.reshape(-1)), torch.zeros(())
            _, _, count = gp.step(tok, tgt, loss_fn)
            out["n"] = float(count)      # the last stage counts targets
            out["grads"] = {k: p.grad.clone() for k, p in
                            model.named_parameters() if p.grad is not None}
    cfg = dict(TRAIN, mesh={"data": 2, "pipe": 2})
    init = torch.load(os.path.join(out_dir, "init.pt"), weights_only=True)
    res = _run("dp_pp", cfg, init)
    from test_torch_ring import _coords

    res["coords"] = _coords(cfg["mesh"], n, rank)
    out["dp_pp"] = res
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    DI.shutdown()


def _restack(seq_params: dict, pp: int, n_layers: int) -> dict:
    """tests/test_pipeline.py `_restack_params`."""
    import jax
    import jax.numpy as jnp

    lps = n_layers // pp
    out = {k: v for k, v in seq_params.items() if not k.startswith("layer_")}
    stages = {}
    for p in range(lps):
        per = [seq_params[f"layer_{s * lps + p}"] for s in range(pp)]
        stages[f"block_{p}"] = jax.tree.map(
            lambda *leaves: jnp.stack(leaves, axis=0), *per)
    out["pipeline"] = {"ticks": {"stages": stages}}
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import optax
    from flax.core import meta

    from kubeflow_tpu.models.registry import get_model as jax_get_model
    from kubeflow_tpu.runtime import trainer as jtrainer
    from kubeflow_tpu_torch.convert import flax_to_state_dict

    root = tmp_path_factory.mktemp("pipe")
    tok = jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, 128)
    tgt = jax.random.randint(jax.random.PRNGKey(2), (4, 16), 0, 128)
    seq_model = jax_get_model("transformer-test", dtype=jnp.float32,
                              **MODEL_KW)
    variables = meta.unbox(seq_model.init(jax.random.PRNGKey(0), tok,
                                          train=False))
    seq_logits = np.asarray(seq_model.apply(variables, tok, train=False))
    pp_params = _restack(variables["params"], 2, 4)
    pp_logits = {}
    for n_mb in N_MB:
        pm = jax_get_model("transformer-test", dtype=jnp.float32,
                           pipeline_stages=2, pp_microbatches=n_mb,
                           **MODEL_KW)
        pp_logits[n_mb] = np.asarray(pm.apply({"params": pp_params}, tok,
                                              train=False))

    def loss(p):
        logits = seq_model.apply({"params": p}, tok, train=False)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, tgt).mean()

    grads = flax_to_state_dict(jax.device_get(jax.grad(loss)(
        variables["params"])))
    # the port reads the stage-stacked tree through convert.py
    torch.save(flax_to_state_dict(jax.device_get(pp_params)),
               root / "pp_params.pt")
    np.save(root / "tokens.npy", np.asarray(tok))
    np.save(root / "targets.npy", np.asarray(tgt))
    jt = jtrainer.Trainer(jtrainer.TrainConfig.from_dict(
        {k: v for k, v in TRAIN.items() if k != "log_every"}))
    init = flax_to_state_dict(jax.device_get(jt.init_state().params))
    torch.save(init, root / "init.pt")
    return root, seq_logits, pp_logits, grads, init, variables, pp_params


@pytest.fixture(scope="module")
def world(reference):
    root = reference[0]
    run_world(4, "test_torch_pipeline:pipe_worker", root, timeout=300)
    return [torch.load(root / f"rank{r}.pt", weights_only=False)
            for r in range(4)]


@pytest.mark.parametrize("n_mb", N_MB)
def test_gpipe_equals_the_sequential_and_the_pipelined_reference(
        n_mb, reference, world):
    _, seq_logits, pp_logits, *_ = reference
    for r in world:
        got = r[f"logits{n_mb}"].numpy()
        np.testing.assert_allclose(got, seq_logits, **PP_TOL)
        np.testing.assert_allclose(got, pp_logits[n_mb], rtol=1e-5,
                                   atol=1e-5)


def test_gpipe_gradients_equal_the_sequential_model(reference, world):
    """tests/test_pipeline.py's gradient check: the embedding (used on
    stage 0) and every block's weights (on its stage), per rank; the
    head's on the last stage."""
    grads = reference[3]
    seen = set()
    n = 4 * 16           # every target is valid
    assert [r["n"] for r in world] == [0.0, n, 0.0, n]
    for r in world:
        for k, g in r["grads"].items():
            np.testing.assert_allclose((g / n).numpy(),
                                       grads[k].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
            seen.add(k)
        layers = {k.split(".")[0] for k in r["grads"] if
                  k.startswith("layer_")}
        assert layers == ({"layer_0", "layer_1"} if r["stage"] == 0
                          else {"layer_2", "layer_3"})
    assert seen == set(grads)


def test_train_step_at_data_2_pipe_2_equals_one_process(reference, world):
    init = reference[4]
    want = _run("dp_pp", {k: v for k, v in TRAIN.items()}, init)
    got = [r["dp_pp"] for r in world]
    assert len({tuple(o["losses"]) for o in got}) == 1
    _assert_parity("dp_pp", merged(got), want)


def test_convert_maps_the_stage_stacked_tree_both_ways(reference):
    import jax

    from kubeflow_tpu_torch import convert

    *_, variables, pp_params = reference
    sd = convert.flax_to_state_dict(pp_params)
    assert sd.keys() == convert.flax_to_state_dict(
        variables["params"]).keys()
    back = convert.state_dict_to_flax(sd, 16, pipeline_stages=2)
    assert jax.tree.structure(back) == jax.tree.structure(pp_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(pp_params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_stacked_optimizer_states_both_ways(reference):
    """sgdm's trace and adamw's moments over the stage-stacked tree;
    adafactor's, which the reference keeps per stacked tensor, refused."""
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.runtime import trainer as jtrainer
    from kubeflow_tpu_torch import convert

    *_, pp_params = reference
    sd = convert.flax_to_state_dict(pp_params)
    for name in ("sgdm", "adamw", "adafactor"):
        tx = jtrainer.make_optimizer(jtrainer.TrainConfig(
            optimizer=name, learning_rate=1e-2, warmup_steps=0,
            total_steps=10))
        st = tx.init(pp_params)
        g = jax.tree.map(lambda p: jnp.full_like(p, 0.1), pp_params)
        _, st = tx.update(g, st, pp_params)
        if name == "adafactor":
            with pytest.raises(ValueError, match="stage-stacked"):
                convert.opt_state_to_port(st, pp_params, name)
            continue
        port = convert.opt_state_to_port(st, pp_params, name)
        assert set(port) == set(sd)
        again = convert.opt_state_to_flax(port, sd, st, 16, step=1,
                                          pipeline_stages=2)
        for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(st)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kw,batch,match", [
    (dict(pipeline_stages=3), 4, "not divisible by pipeline_stages"),
    (dict(pipeline_stages=2, pp_microbatches=3), 4,
     "batch 4 not divisible by n_microbatches 3"),
    (dict(pipeline_stages=2, attention_impl="ring"), 4, "dense blocks"),
    (dict(pipeline_stages=2, remat=True, remat_policy="slim@2"), 4,
     "mixed remat policy"),
], ids=["layers", "microbatches", "ring", "mixed-remat"])
def test_pipeline_refusals_are_the_reference_s(kw, batch, match):
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.models.registry import get_model as jax_get_model
    from kubeflow_tpu_torch.models.registry import get_model

    base = {**MODEL_KW, **kw}
    tok = np.zeros((batch, 8), np.int32)
    with pytest.raises(ValueError, match=match):
        jax_get_model("transformer-test", **base).init(
            jax.random.PRNGKey(0), jnp.asarray(tok), train=False)
    tm = get_model("transformer-test", device="cpu", **base)
    with pytest.raises(ValueError, match=match):
        tm(torch.tensor(tok).long())


def test_pipeline_refuses_moe_and_decode():
    from kubeflow_tpu_torch.models.registry import get_model

    tok = torch.zeros(4, 8, dtype=torch.long)
    moe = get_model("moe-test", device="cpu", pipeline_stages=2)
    with pytest.raises(ValueError, match="no moe/ring/ulysses"):
        moe(tok)
    tm = get_model("transformer-test", device="cpu", pipeline_stages=2)
    with pytest.raises(ValueError, match="decode is not supported"):
        tm(tok, decode_index=0, cache={})


def test_dcn_pipeline_levels_lay_out_as_the_reference():
    import jax

    from kubeflow_tpu.parallel import backends as RB
    from kubeflow_tpu.parallel import mesh as RM
    from kubeflow_tpu.parallel import pipeline as RP
    from kubeflow_tpu_torch.parallel import backends as B
    from kubeflow_tpu_torch.parallel import pipeline as P

    assert P.dcn_pipeline_levels() == RP.dcn_pipeline_levels()
    spec = {"data": 2, "pipe": 2, "model": 2}
    want = RB.build_level_mesh(RM.MeshSpec(**spec), jax.devices()[:8],
                               levels=RP.dcn_pipeline_levels())
    got = B.level_layout(spec, 8, P.dcn_pipeline_levels())
    np.testing.assert_array_equal(
        got, np.vectorize(lambda d: d.id)(want.devices))
