"""The port's MoE (kubeflow_tpu_torch/ops/moe.py) against the JAX
package's ops/moe.py, in f32 on the CPU, on the same numpy inputs and
converted weights.

- `MoEBlock`, dense and sparse: output, the aux loss, moe_fill and
  moe_drop, and the gradients of the input and of every weight, at the
  default capacity factor and at 0.5, where the same tokens must drop.
  The reference's sparse path runs under a one-device mesh (its
  `_sparse_ok` needs an ambient mesh); the port is told (`sparse`).
- Sparse equals dense at capacity factor 4 (no token drops), and the
  sparse kernel equals a per-token loop, as tests/test_moe.py:92 holds
  the reference's.
- The moe-test LM: logits (the dense path, as the reference's meshless
  apply), one trainer step's loss with the aux term and its moe_*
  metrics against the JAX trainer on a one-device mesh (sparse), with
  and without gradient accumulation; the metrics in /metrics.
- Generate: greedy tokens identical to the reference's generate.
- Checkpoints: a run resumes its MoE state; params and adamw/adafactor
  states through convert.py both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from kubeflow_tpu.models.registry import get_model as jax_get_model
from kubeflow_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeflow_tpu.ops import moe as jmoe
from kubeflow_tpu.parallel.mesh import MeshSpec, build_mesh
from kubeflow_tpu.runtime import trainer as jtrainer
from kubeflow_tpu_torch import convert
from kubeflow_tpu_torch.models import transformer as T
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.ops import moe as tmoe
from kubeflow_tpu_torch.runtime import trainer as ttrainer

TOL = dict(rtol=1e-5, atol=1e-5)
WIDTH = dict(d_model=32, d_ff=64, n_experts=4, expert_top_k=2)


def _one_device_mesh():
    return build_mesh(MeshSpec(data=1), devices=jax.devices()[:1])


def _block_pair(cf, sparse, seed=0, b=2, s=16):
    """The reference's MoEBlock and the port's on the same weights, and
    an input x."""
    jcfg = JaxConfig(dtype=jnp.float32, **WIDTH)
    jm = jmoe.MoEBlock(jcfg, capacity_factor=cf)
    x = np.random.default_rng(seed).standard_normal(
        (b, s, WIDTH["d_model"])).astype(np.float32)
    params = meta.unbox(jm.init(jax.random.PRNGKey(seed),
                                jnp.asarray(x))["params"])
    tcfg = T.TransformerConfig(dtype="float32", moe_capacity_factor=cf,
                               **WIDTH)
    tm = tmoe.MoEBlock(tcfg, "cpu")
    with torch.no_grad():
        tm.router.weight.copy_(torch.tensor(np.asarray(
            params["router"]["kernel"]).T))
        for leaf in ("w_gate", "w_up", "w_down"):
            getattr(tm, leaf).copy_(torch.tensor(np.asarray(params[leaf])))
    tm.sparse = sparse
    return jm, params, tm, x


def _jax_run(jm, params, x, ct, sparse):
    """(y, aux, diagnostics, grads of x and params) of the reference; the
    sparse path under a one-device mesh."""
    def loss(p, xx):
        y, muts = jm.apply({"params": p}, xx,
                           mutable=["losses", "diagnostics"])
        aux = muts["losses"]["moe_aux"][0]
        return jnp.sum(y * ct) + aux, (y, aux, muts["diagnostics"])

    f = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)
    if sparse:
        with _one_device_mesh():
            (_, (y, aux, diag)), (gp, gx) = f(params, jnp.asarray(x))
    else:
        (_, (y, aux, diag)), (gp, gx) = f(params, jnp.asarray(x))
    diag = {k: float(v[0]) for k, v in diag.items()}
    return np.asarray(y), float(aux), diag, gp, np.asarray(gx)


def _port_run(tm, x, ct):
    xt = torch.tensor(x, requires_grad=True)
    y = tm(xt)
    aux = tm.stats["aux"]
    ((y * torch.tensor(ct)).sum() + aux).backward()
    kept, routed, slots = tm.stats["counts"].tolist()
    return (y.detach().numpy(), float(aux.detach()), kept, routed, slots,
            xt.grad)


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cf1.25", "cf0.5"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_moe_block_matches_reference(cf, sparse):
    jm, params, tm, x = _block_pair(cf, sparse)
    ct = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    y, aux, diag, gp, gx = _jax_run(jm, params, x, ct, sparse)
    ty, taux, kept, routed, slots, tgx = _port_run(tm, x, ct)
    np.testing.assert_allclose(ty, y, **TOL)
    np.testing.assert_allclose(taux, aux, rtol=1e-6)
    assert diag["moe_sparse_dispatch"] == float(sparse) == tm.stats["sparse"]
    np.testing.assert_allclose(kept / slots, diag["moe_fill"], rtol=1e-6)
    np.testing.assert_allclose(1.0 - kept / routed, diag["moe_drop"],
                               rtol=1e-6, atol=1e-7)
    if cf < 1:      # the overflow case: tokens must really drop
        assert diag["moe_drop"] > 0.1
    np.testing.assert_allclose(tgx.numpy(), gx, **TOL)
    np.testing.assert_allclose(tm.router.weight.grad.numpy().T,
                               np.asarray(gp["router"]["kernel"]), **TOL)
    for leaf in ("w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(getattr(tm, leaf).grad.numpy(),
                                   np.asarray(gp[leaf]), **TOL, err_msg=leaf)


def test_dense_and_sparse_drop_the_reference_s_tokens():
    """At capacity factor 0.5 the dense path drops per row and the sparse
    path per shard, so they keep different tokens: each must keep the
    reference's own set (equal outputs row by row)."""
    outs = {}
    for sparse in (False, True):
        jm, params, tm, x = _block_pair(0.5, sparse, seed=3)
        ct = np.zeros(x.shape, np.float32)
        y, *_ = _jax_run(jm, params, x, ct, sparse)
        ty, *_ = _port_run(tm, x, ct)
        zero_rows = np.all(y == 0, axis=-1)
        np.testing.assert_array_equal(np.all(ty == 0, axis=-1), zero_rows)
        np.testing.assert_allclose(ty, y, **TOL)
        outs[sparse] = ty
    assert not np.allclose(outs[False], outs[True])


def test_sparse_equals_dense_at_capacity_4():
    _, _, dense, x = _block_pair(4.0, False, seed=2)
    _, _, sparse, _ = _block_pair(4.0, True, seed=2)
    ct = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    yd, auxd, keptd, routedd, _, gxd = _port_run(dense, x, ct)
    ys, auxs, kepts, routeds, _, gxs = _port_run(sparse, x, ct)
    assert keptd == routedd == kepts == routeds      # nothing drops
    np.testing.assert_allclose(ys, yd, **TOL)
    np.testing.assert_allclose(auxs, auxd, rtol=1e-6)
    np.testing.assert_allclose(gxs.numpy(), gxd.numpy(), **TOL)
    for leaf in ("w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(getattr(sparse, leaf).grad.numpy(),
                                   getattr(dense, leaf).grad.numpy(), **TOL)


def test_sparse_kernel_equals_per_token_loop_and_reference():
    """tests/test_moe.py:92's check of the sparse kernel (ample capacity:
    nothing drops; each routed pair through its expert), on the port's
    kernel, and its output against the reference kernel's."""
    rng = np.random.default_rng(2)
    t, d, f, e, k = 32, 64, 128, 4, 2
    x = rng.standard_normal((t, d)).astype(np.float32)
    idx = rng.integers(0, e, (t, k)).astype(np.int32)
    gates = rng.standard_normal((t, k)).astype(np.float32)
    gates = np.exp(gates) / np.exp(gates).sum(-1, keepdims=True)
    wg, wu = (rng.standard_normal((e, d, f)).astype(np.float32) * 0.02
              for _ in range(2))
    wd = rng.standard_normal((e, f, d)).astype(np.float32) * 0.02
    y, kept, routed, slots = tmoe.sparse_dispatch_mlp(
        *map(torch.tensor, (x, gates)), torch.tensor(idx).long(),
        *map(torch.tensor, (wg, wu, wd)), 8.0, torch.float32)
    assert int(kept) == routed == t * k and slots >= int(kept)
    ref = np.zeros((t, d), np.float32)
    for ti in range(t):
        for ki in range(k):
            ei = idx[ti, ki]
            h = x[ti] @ wg[ei]
            h = h / (1 + np.exp(-h)) * (x[ti] @ wu[ei])
            ref[ti] += gates[ti, ki] * (h @ wd[ei])
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-4, atol=1e-5)
    cfg = JaxConfig(dtype=jnp.float32, d_model=d, d_ff=f, n_experts=e)
    jy, jkept, jrouted, jslots = jmoe.sparse_dispatch_mlp(
        cfg, jnp.asarray(x), jnp.asarray(gates), jnp.asarray(idx),
        jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wd), 8.0)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    assert (int(kept), routed, slots) == (int(jkept), int(jrouted),
                                          int(jslots))


def _lm_pair(seed=0, **kw):
    jm = jax_get_model("moe-test", dtype=jnp.float32, **kw)
    params = meta.unbox(jm.init(jax.random.PRNGKey(seed),
                                jnp.zeros((1, 1), jnp.int32),
                                train=False)["params"])
    tm = get_model("moe-test", device="cpu", dtype="float32", **kw)
    tm.load_state_dict(convert.flax_to_state_dict(jax.device_get(params)))
    return jm, params, tm


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_lm_logits_match_reference(cf):
    jm, params, tm = _lm_pair(moe_capacity_factor=cf)
    assert [hasattr(b, "moe") for b in tm.blocks()] == [False, True]
    tok = np.random.default_rng(0).integers(0, 256, (3, 24)).astype(np.int32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(tok),
                               train=False))
    got = tm(torch.tensor(tok).long())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    assert tm.moe_blocks()[0].stats["sparse"] == 0.0    # no mesh: dense


def _lm_cfg(**kw):
    base = dict(model="moe-test", task="lm", global_batch=4, seq_len=16,
                vocab_size=256, optimizer="adamw", learning_rate=1e-2,
                total_steps=4, warmup_steps=1, log_every=1,
                model_kwargs={"dtype": "float32", "moe_capacity_factor": 1.0})
    base.update(kw)
    return base


@pytest.mark.parametrize("accum", [0, 2])
def test_moe_train_step_matches_jax_trainer(accum):
    """Loss (cross entropy plus aux_loss_weight x the aux losses) and the
    moe_* metrics of three steps against the JAX trainer on a one-device
    mesh, where the reference takes the sparse path; the parameters
    after them (sgdm: an update linear in the gradient)."""
    base = _lm_cfg(grad_accum_steps=accum, optimizer="sgdm",
                   learning_rate=0.1)
    jt = jtrainer.Trainer(jtrainer.TrainConfig.from_dict(
        {k: v for k, v in base.items() if k != "log_every"}),
        mesh=_one_device_mesh())
    state = jt.init_state()
    batch = next(jt.data_iter())
    pt = ttrainer.Trainer(ttrainer.TrainConfig.from_dict(base), device="cpu")
    pt.model.load_state_dict(convert.flax_to_state_dict(
        jax.device_get(state.params)))
    local = pt._to_device(batch)
    for _ in range(3):
        state, m = jt.train_step(state, batch)
        pm = pt.train_step(local)
        assert set(pm) == {"loss", "accuracy", "moe_fill", "moe_drop",
                           "moe_sparse_dispatch"}
        np.testing.assert_allclose(float(pm["loss"]), float(m["loss"]),
                                   rtol=2e-6)
        for k in ("moe_fill", "moe_drop", "moe_sparse_dispatch"):
            np.testing.assert_allclose(float(pm[k]), float(m[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    assert float(pm["moe_sparse_dispatch"]) == 1.0
    want = convert.flax_to_state_dict(jax.device_get(state.params))
    for n, p in pt.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=n)


def test_aux_loss_weight_reaches_the_loss():
    """The same step with aux_loss_weight 0 gives the bare cross entropy;
    the difference is the weight times the layers' aux losses."""
    losses = {}
    for w in (0.0, 0.5):
        pt = ttrainer.Trainer(ttrainer.TrainConfig.from_dict(
            _lm_cfg(aux_loss_weight=w)), device="cpu")
        losses[w] = float(pt.train_step(pt._to_device(
            next(pt.data_iter())))["loss"])
        aux = float(pt._moe_aux().detach())
    assert abs(losses[0.5] - losses[0.0] - 0.5 * aux) < 1e-5


def test_moe_metrics_in_the_log_and_registry(caplog):
    from kubeflow_tpu_torch.runtime import metrics as rt_metrics

    pt = ttrainer.Trainer(ttrainer.TrainConfig.from_dict(
        _lm_cfg(total_steps=3)), device="cpu")
    with caplog.at_level("INFO", logger="kubeflow_tpu_torch.trainer"):
        summary = pt.fit()
    assert summary["final"]["moe_sparse_dispatch"] == 1.0
    assert "moe_fill=" in caplog.text and "moe_drop=" in caplog.text
    text = rt_metrics.REGISTRY.render()
    for k in ("jaxrt_moe_fill", "jaxrt_moe_drop", "jaxrt_moe_sparse_dispatch"):
        assert k in text


def test_moe_generate_tokens_identical_to_jax():
    from kubeflow_tpu.runtime.generate import generate as jax_generate
    from kubeflow_tpu_torch.runtime.generate import generate

    jm, params, tm = _lm_pair(max_seq_len=64)
    prompt = np.random.default_rng(5).integers(1, 256, (3, 10)).astype(
        np.int32)
    want = np.asarray(jax_generate(jm, {"params": params},
                                   jnp.asarray(prompt), max_new_tokens=12))
    got = generate(tm, None, torch.tensor(prompt).long(), max_new_tokens=12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_moe_convert_round_trip_with_optimizer_states():
    """layer_i/moe/{router/kernel, w_gate, w_up, w_down} and their adamw
    and adafactor states through convert.py both ways."""
    import optax

    _, params, tm = _lm_pair()
    flat = convert.flax_to_state_dict(params)
    assert {"layer_1.moe.router.weight", "layer_1.moe.w_gate",
            "layer_1.moe.w_up", "layer_1.moe.w_down"} <= set(flat)
    assert tuple(flat["layer_1.moe.router.weight"].shape) == (4, 64)
    back = convert.state_dict_to_flax(tm.state_dict(), tm.cfg.head_dim)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for name in ("adamw", "adafactor"):
        tx = jtrainer.make_optimizer(jtrainer.TrainConfig(
            optimizer=name, learning_rate=1e-3, warmup_steps=0,
            total_steps=10))
        st = tx.init(params)
        g = jax.tree.map(lambda p: jnp.ones_like(p) * 0.1, params)
        _, st = tx.update(g, st, params)
        port = convert.opt_state_to_port(st, params, name)
        assert "layer_1.moe.w_down" in port
        again = convert.opt_state_to_flax(port, tm.state_dict(), st,
                                          tm.cfg.head_dim)
        for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(st)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       err_msg=name)


def test_moe_checkpoint_resume_equals_straight_run(tmp_path):
    """A run stopped at step 2 and resumed to 4 equals a straight 4-step
    run: the MoE weights and their optimizer state are in the payload."""
    straight = ttrainer.Trainer(ttrainer.TrainConfig.from_dict(
        _lm_cfg(log_every=100)), device="cpu")
    straight.fit(4)
    cfg = _lm_cfg(log_every=100, checkpoint_dir=str(tmp_path / "ck"),
                  checkpoint_every=2)
    ttrainer.Trainer(ttrainer.TrainConfig.from_dict(cfg),
                     device="cpu").fit(2)
    resumed = ttrainer.Trainer(ttrainer.TrainConfig.from_dict(cfg),
                               device="cpu")
    summary = resumed.fit(4)
    assert summary["start_step"] == 2
    want = dict(straight.model.named_parameters())
    for n, p in resumed.model.named_parameters():
        torch.testing.assert_close(p, want[n], rtol=0, atol=0, msg=n)


def test_flops_per_token_counts_active_parameters():
    for name in ("moe-test", "gpt-moe-8e"):
        tm = get_model(name, device="meta")
        assert tm.flops_per_token(2048) == jax_get_model(
            name).flops_per_token(2048)
    dense = get_model("gpt-350m", device="meta").flops_per_token(2048)
    assert get_model("gpt-moe-8e", device="meta").flops_per_token(2048) > dense


def test_sparse_refusal_and_dispatch_choice():
    class _Mesh:
        def __init__(self, **kw):
            self.shape = {a: 1 for a in ("dcn", "data", "fsdp", "pipe",
                                         "expert", "seq", "model")}
            self.shape.update(kw)

    from kubeflow_tpu_torch.parallel.shardings import moe_sparse_ok

    cfg = T.TransformerConfig(moe_every=2, n_experts=4)
    assert moe_sparse_ok(cfg, _Mesh(expert=2, data=2))
    assert not moe_sparse_ok(cfg, _Mesh(model=2))
    assert not moe_sparse_ok(cfg, _Mesh(expert=3))
    assert not moe_sparse_ok(T.TransformerConfig(moe_impl="dense"), _Mesh())
    with pytest.raises(ValueError, match="moe_impl='sparse' requires"):
        moe_sparse_ok(T.TransformerConfig(moe_impl="sparse"), _Mesh(seq=2))


@pytest.mark.parametrize("kw", [{}, dict(kv_pages=25, kv_page_size=4)],
                         ids=["dense", "paged"])
def test_moe_slot_decoder_matches_jax_generate(kw):
    """The continuous slot decoder over moe-test (the dense dispatch at
    one token a slot per tick, as the reference's meshless decoder)
    returns JAX generate's tokens for each left-padded prompt."""
    import threading

    from kubeflow_tpu.runtime.generate import generate as jax_generate
    from kubeflow_tpu_torch.serving.continuous import SlotDecoder

    p, n = 8, 6
    jm, params, _ = _lm_pair(max_seq_len=24)
    tm = get_model("moe-test", device="cpu", dtype="float32", max_seq_len=24,
                   **kw)
    tm.load_state_dict(convert.flax_to_state_dict(jax.device_get(params)))
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 11], [12], [13, 14]]
    want = []
    for row in prompts:
        pad = p - len(row)
        out = jax_generate(jm, {"params": params},
                           jnp.asarray([[0] * pad + row], jnp.int32),
                           max_new_tokens=n,
                           pad_len=jnp.asarray([pad], jnp.int32))
        want.append([int(t) for t in np.asarray(out)[0, p:]])
    dec = SlotDecoder(tm, None, slots=3, prompt_len=p, max_new_tokens=n)
    got: list = [None] * len(prompts)
    try:
        threads = [threading.Thread(
            target=lambda i=i: got.__setitem__(i, dec.submit(prompts[i])))
            for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        dec.close()
    assert got == want
