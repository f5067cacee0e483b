"""The port's Adafactor (kubeflow_tpu_torch/runtime/optim.py) against
optax.adafactor as the JAX trainer builds it (`make_optimizer`).

Per-update tolerance: atol 1e-6, rtol 1e-5 in f32 over 3 updates. Both
sides compute the same f32 arithmetic; the means, rms and powers may
round in another order (a few ulps), and the update, at most lr times
the parameter's rms, carries that into the parameter.
Loss-curve tolerance: 2e-4 relative per step, that of
tests/test_torch_trainer.py (two frameworks summing gradients in another
order, compounded over ten updates).

Each of the four traps of the port has its own case: factoring follows
the flax shape, not the port's; weight decay is added after the learning
rate and not scaled by it; the second-moment decay is 0 at the first
update; eps is added to g^2 before the row and column means.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models.registry import get_model as jax_get_model
from kubeflow_tpu.runtime import trainer as jtrainer
from kubeflow_tpu_torch.convert import (
    flax_layout,
    flax_shape,
    flax_to_state_dict,
)
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.runtime import optim
from kubeflow_tpu_torch.runtime import trainer as ttrainer

UPDATES = 3

# flax shape -> the port parameter that holds it (None: a plain tensor in
# that shape). q-like and o-like are not factored in their flax shape
# (second-largest dim 32), though their port layout [128, 128] would be;
# hd128-like is factored over dims 0 and 2, its heads kept.
SHAPES = {
    "vector": ((128,), None),
    "unfactored": ((100, 64), None),
    "factored": ((256, 128), None),
    "q_like": ((128, 4, 32), "layer_0.attn.q.weight"),
    "hd128_like": ((128, 2, 128), "layer_0.attn.q.weight"),
    "o_like": ((4, 32, 128), "layer_0.attn.o.weight"),
}


def _cfgs(wd, lr=0.1, warmup=1):
    kw = dict(optimizer="adafactor", learning_rate=lr, weight_decay=wd,
              warmup_steps=warmup, total_steps=10)
    return ttrainer.TrainConfig(**kw), jtrainer.TrainConfig(**kw)


def _port(flax_array, name):
    """(port tensor, layout) of a flax-shaped array."""
    if name is None:
        return torch.tensor(flax_array), None
    parts = name.split(".")
    tree = {parts[0]: {parts[1]: {parts[2]: {"kernel": flax_array}}}}
    head_dim = flax_array.shape[2] if parts[2] != "o" else flax_array.shape[1]
    t = flax_to_state_dict(tree)[name]
    return t, flax_layout(name, t.shape, head_dim)


def _in_flax(t, layout):
    t = t.detach()
    return (t if layout is None else t.view(layout[0]).permute(layout[1])
            ).numpy().copy()


def _run_both(shape, name, wd, grads, p0, lr=0.1, warmup=1):
    """Params after each update, port and optax, in the flax layout."""
    tcfg, jcfg = _cfgs(wd, lr, warmup)
    tx = jtrainer.make_optimizer(jcfg)
    p, st = p0, tx.init(p0)
    t0, layout = _port(p0, name)
    param = torch.nn.Parameter(t0.clone())
    opt = ttrainer.make_optimizer(tcfg, [param], layouts=[layout])
    assert isinstance(opt, optim.Adafactor)
    out = []
    for step, g in enumerate(grads):
        upd, st = tx.update(g, st, p)
        p = optax.apply_updates(p, upd)
        param.grad = _port(g, name)[0]
        for group in opt.param_groups:
            group["lr"] = ttrainer.warmup_cosine_lr(step, tcfg)
        opt.step()
        out.append((_in_flax(param, layout), np.asarray(p)))
    return out, opt.state[param]


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_updates_match_optax(case, wd):
    shape, name = SHAPES[case]
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal(shape).astype(np.float32)
    grads = [rng.standard_normal(shape).astype(np.float32)
             for _ in range(UPDATES)]
    out, state = _run_both(shape, name, wd, grads, p0)
    for step, (got, want) in enumerate(out):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5,
                                   err_msg=f"{case} update {step}")
    # the state lives in the flax shape, factored as optax factors it
    dims = optax._src.factorized._factored_dims(shape, True, 128)
    assert optim.factored_dims(shape) == dims
    if dims is None:
        assert tuple(state["v"].shape) == shape
    else:
        assert set(state) == {"step", "v_row", "v_col"}


def test_factoring_follows_the_flax_shape():
    """The trap: q/k/v/o are factored by their flax shape, never by the
    port's [out, in] layout."""
    cfg = jax_get_model("llama-1b").cfg
    d, hd = cfg.d_model, cfg.head_dim
    q_port = (cfg.n_heads * hd, d)                   # [2048, 2048]
    assert optim.factored_dims(q_port) is not None
    for name, port in (("layer_0.attn.q.weight", q_port),
                       ("layer_0.attn.k.weight", (cfg.n_kv_heads * hd, d)),
                       ("layer_0.attn.o.weight", (d, cfg.n_heads * hd))):
        assert optim.factored_dims(flax_shape(name, port, hd)) is None, name
    # head_dim 128: [2048, 16, 128] factors over dims 0 and 2
    assert optim.factored_dims(
        flax_shape("layer_0.attn.q.weight", (2048, 2048), 128)) == (2, 0)


def test_zero_gradient_rows_stay_finite():
    """eps is added to g^2 before the row and column means: a gradient
    row and column of zeros gives a finite update, equal to optax's."""
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal((256, 128)).astype(np.float32)
    grads = []
    for _ in range(UPDATES):
        g = rng.standard_normal((256, 128)).astype(np.float32)
        g[3], g[:, 5] = 0.0, 0.0
        grads.append(g)
    for got, want in _run_both((256, 128), None, 0.0, grads, p0)[0]:
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


def test_weight_decay_is_not_scaled_by_the_learning_rate():
    """The first update runs at lr 0 (warmup): only the decay moves the
    parameters, by exactly wd * p."""
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal((256, 128)).astype(np.float32)
    g = rng.standard_normal((256, 128)).astype(np.float32)
    (got, want), = _run_both((256, 128), None, 0.1, [g], p0, warmup=5)[0]
    np.testing.assert_allclose(got, p0 - np.float32(0.1) * p0, rtol=1e-7)
    np.testing.assert_allclose(got, want, rtol=1e-7)


def test_first_update_has_decay_zero():
    """decay_rate_t = 1 - (t + 1)^-0.8 with t from 0: the first update's
    second moment is g^2 + eps, with nothing of its zero init."""
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal((100, 64)).astype(np.float32)
    g = rng.standard_normal((100, 64)).astype(np.float32)
    _, state = _run_both((100, 64), None, 0.0, [g], p0)
    np.testing.assert_array_equal(state["v"].numpy(),
                                  np.square(g) + np.float32(1e-30))
    assert state["step"] == 1


# transformer-test has no dim >= 128 beside another: these widths make
# every projection, the embedding and the head factored
FACTORED_MODEL = {"dtype": "float32", "d_model": 128, "n_heads": 2,
                  "n_kv_heads": 1, "head_dim": 128, "d_ff": 256}
STEPS = 10


def _train_cfg(mod):
    return mod.TrainConfig.from_dict(dict(
        model="transformer-test", task="lm", global_batch=8, seq_len=32,
        vocab_size=256, optimizer="adafactor", learning_rate=1e-2,
        weight_decay=1e-4, warmup_steps=3, total_steps=STEPS,
        model_kwargs=dict(FACTORED_MODEL)))


def test_loss_curve_matches_jax():
    jt = jtrainer.Trainer(_train_cfg(jtrainer))
    state = jt.init_state()
    params = jax.device_get(state.params)
    tt = ttrainer.Trainer(_train_cfg(ttrainer), device="cpu")
    tt.model.load_state_dict(flax_to_state_dict(params))
    # factoring happens on this config, in the flax shapes
    shapes = {n: flax_shape(n, p.shape, 128)
              for n, p in tt.model.named_parameters()}
    factored = [n for n, s in shapes.items() if optim.factored_dims(s)]
    assert "layer_0.attn.q.weight" in factored and "embedding" in factored
    # q [128, 2, 128]: over dims 0 and 2, the heads kept
    assert set(optim.factored_dims(shapes["layer_0.attn.q.weight"])) == {0, 2}

    jdata, want = jt.data_iter(), []
    for _ in range(STEPS):
        state, m = jt.train_step(state, next(jdata))
        want.append(float(m["loss"]))
    got = []
    tt.fit(callback=lambda i, m: got.append(float(m["loss"])))
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert want[-1] < want[0]


@pytest.mark.parametrize("model", ["llama-1b", "llama-1b-hd128"])
def test_flax_shape_matches_the_jax_tree(model):
    """convert.flax_shape of every port parameter is the shape the JAX
    tree holds; neither model is allocated (jax.eval_shape, and the
    port's shapes from a model built on the meta device)."""
    jm = jax_get_model(model)
    tok = jax.ShapeDtypeStruct((1, 128), np.int32)
    tree = jax.eval_shape(lambda t: jm.init(jax.random.PRNGKey(0), t), tok)
    want = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}.{k}" if prefix else k
            if hasattr(v, "shape"):
                want[key.replace(".kernel", ".weight")
                     if not key.startswith("lm_head") else key] = \
                    tuple(v.shape)
            else:
                walk(v, key)

    from flax.core import meta
    walk(meta.unbox(tree["params"]), "")
    with torch.device("meta"):
        tm = get_model(model, device="meta")
    hd = tm.cfg.head_dim
    got = {n: flax_shape(n, p.shape, hd) for n, p in tm.named_parameters()}
    assert got == want
