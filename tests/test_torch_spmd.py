"""The port's sharded training step equals its single-process step
(the reference's SPMD witness protocol, `__graft_entry__.py`
`_layout_witness`): one model, seed and global batch; per layout the
logits at the initial params, the flat params after one sgdm step and
both step losses, held at `SPMD_PARITY_TOLS` (loss 1e-5, logits 1e-4,
params 1e-6; f32, transformer-test).

Layouts, each a world of gloo processes on the CPU: `dp` (data 2),
`fsdp_accum` (fsdp 2, grad_accum 2), `dp_tp` (data 2 x model 2),
`dcn_dp` (dcn 2 x data 2 through the hierarchical `gpu` backend) and
`tp_gqa` (model 4 over transformer-test's 2 KV heads, which
replicate). `dp_tp` is also held against the reference's own
`data=2, model=2` witness on virtual CPU devices, at
tests/test_torch_trainer.py's tolerance (2e-4 relative). Besides:
Adafactor under fsdp 2 (factored statistics over sharded dims) over 3
steps but for the few elements whose gradient is rounding noise, and
after three updates on seeded gradients both sides share, ResNet-18 at
data 2 (BatchNorm over the global batch: eval logits and batch_stats
after a step) and packed batches whose ranks hold
uneven numbers of valid targets (the global-mean loss) each equal one
process. In every layout the gathered optimizer state (the checkpoint
payload) equals one process's, and a fresh trainer on the same mesh
that loads that payload gathers it back bit for bit. One spawn per
world size runs all of that size's layouts.
"""

import os
import zlib

import numpy as np
import pytest
import torch

from test_torch_dist import run_world

TOLS = {"loss": 1e-5, "logits": 1e-4, "params": 1e-6}   # SPMD_PARITY_TOLS
REF_RTOL = 2e-4          # tests/test_torch_trainer.py, port vs JAX
BATCH = 8

LM = dict(model="transformer-test", task="lm", seq_len=32, vocab_size=256,
          optimizer="sgdm", learning_rate=0.1, total_steps=2, warmup_steps=0,
          global_batch=BATCH, log_every=10**9,
          model_kwargs={"dtype": "float32"})
ADAFACTOR = dict(LM, optimizer="adafactor", learning_rate=1e-2,
                 total_steps=3, warmup_steps=1,
                 model_kwargs={"dtype": "float32", "d_model": 128,
                               "d_ff": 256})
RESNET = dict(model="resnet18", task="classification", image_size=16,
              num_classes=10, optimizer="sgdm", learning_rate=0.1,
              total_steps=2, warmup_steps=0, global_batch=BATCH,
              log_every=10**9,
              model_kwargs={"dtype": "float32", "num_filters": 8})

# layout -> (world size, config overrides)
LAYOUTS = {
    "dp": (2, dict(mesh={"data": 2})),
    "fsdp_accum": (2, dict(mesh={"data": 1, "fsdp": 2}, grad_accum_steps=2)),
    "dp_tp": (4, dict(mesh={"data": 2, "model": 2})),
    "dcn_dp": (4, dict(mesh={"dcn": 2, "data": 2})),
    "tp_gqa": (4, dict(mesh={"data": 1, "model": 4})),
}
# a gradient element below GRAD_NOISE times its leaf's median |g| is
# rounding noise; at most GRAD_NOISE_ELEMENTS of them, over all leaves
GRAD_NOISE = 1e-6
GRAD_NOISE_ELEMENTS = 4
EXTRA = {   # world-2 runs besides the witness layouts
    "adafactor_fsdp": dict(ADAFACTOR, mesh={"data": 1, "fsdp": 2}),
    "resnet_dp": dict(RESNET, mesh={"data": 2}),
    "packed_dp": dict(LM, mesh={"data": 2}),
}


def _packed(batch: dict) -> dict:
    """Two documents a row; the first half of the rows (rank 0's block
    at data 2) keeps 4 valid targets a row, the rest all but the
    boundary: the ranks hold very different valid counts."""
    b = {k: np.array(v) for k, v in batch.items()}
    rows, length = b["tokens"].shape
    seg = np.ones((rows, length), np.int32)
    seg[:, length // 2:] = 2
    b["segment_ids"] = seg
    b["targets"][:, length // 2 - 1] = -1
    b["targets"][:rows // 2, 4:] = -1
    return b


def _lm_witness(trainer, batch, steps=2):
    """(this rank's logits at the initial params, the whole params after
    one step, the step losses)."""
    local = trainer._to_device(batch)
    trainer.model.eval()
    with torch.no_grad():
        if trainer.gpipe is not None:      # every stage gets the logits
            logits = trainer.gpipe.logits(local["tokens"])
        else:
            logits = trainer.model(local["tokens"],
                                   segment_ids=local.get("segment_ids"))
    trainer.model.train()
    losses, params = [], None
    for i in range(steps):
        losses.append(float(trainer.train_step(local)["loss"]))
        if i == 0:
            params = {n: t.clone()
                      for n, t in trainer.payload()["params"].items()}
    return {"logits": logits.detach(), "params": params, "losses": losses,
            "final": trainer.payload()["params"]}


def _resnet_witness(trainer, batch):
    local = trainer._to_device(batch)
    loss = float(trainer.train_step(local)["loss"])
    trainer.model.eval()
    with torch.no_grad():
        logits = trainer.model(local["image"])
    trainer.model.train()
    p = trainer.payload()
    return {"logits": logits, "losses": [loss], "params": p["params"],
            "batch_stats": p["batch_stats"]}


def _watch_gradients(trainer) -> dict:
    """Fills, per parameter, the elements whose gradient was rounding
    noise at any optimizer step this one-process trainer takes: not 0
    (a row no token touched is 0 on every layout) and below GRAD_NOISE
    times its leaf's median |g|."""
    noise = {}
    params = dict(trainer.model.named_parameters())
    step = trainer.opt.step

    def watched():
        for n, p in params.items():
            g = p.grad.detach().abs()
            hit = (g > 0) & (g < GRAD_NOISE * g.median())
            noise[n] = noise[n] | hit if n in noise else hit
        step()

    trainer.opt.step = watched
    return noise


def _shared_gradient_steps(trainer, batch, steps: int) -> dict:
    """The whole params after `steps` updates whose gradients are drawn
    from a seed per parameter and step (each rank keeps its FSDP2 block),
    so a world and one process step on the same gradients. Adafactor's
    g / sqrt(v) turns a gradient that cancels to rounding noise into an
    O(0.1) update; the world's gradient (two half-batch GEMMs summed by
    the reduce-scatter) and one process's (one GEMM) differ at that
    noise, so the end-to-end witness cannot hold the optimizer alone."""
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    step = trainer.opt.step

    def seeded_step():
        for p in trainer.model.parameters():
            gen = torch.Generator().manual_seed(
                zlib.crc32(f"{names[id(p)]}/{trainer.step}".encode()))
            g = torch.randn(tuple(p.shape), generator=gen) * 1e-3
            if hasattr(p, "to_local"):     # FSDP2's Shard(d): a chunk
                mesh, (place,) = p.device_mesh, p.placements
                g = g.chunk(mesh.size(), place.dim)[mesh.get_local_rank()]
                p.grad.to_local().copy_(g)
            else:
                p.grad.copy_(g)
        step()

    trainer.opt.step = seeded_step
    local = trainer._to_device(batch)
    for _ in range(steps):
        trainer.train_step(local)
    return trainer.payload()["params"]


def _run(name: str, cfg_kw: dict, init: dict | None):
    """One layout's witness in this process (on its world, if any)."""
    from kubeflow_tpu_torch.runtime.trainer import TrainConfig, Trainer

    cfg = TrainConfig.from_dict(cfg_kw)
    trainer = Trainer(cfg, device="cpu")
    if init is not None:
        trainer.load_payload({"step": 0, "params": init, "batch_stats": {},
                              "opt_state": {}})
    batch = next(trainer.data_iter())
    noise = (_watch_gradients(trainer) if name == "adafactor_fsdp"
             and "mesh" not in cfg_kw else None)
    if name == "resnet_dp":
        out = _resnet_witness(trainer, batch)
    elif name == "packed_dp":
        out = _lm_witness(trainer, _packed(batch), steps=1)
    else:
        out = _lm_witness(trainer, batch,
                          steps=3 if name == "adafactor_fsdp" else 2)
    out["dp_index"] = trainer.mesh.index(("dcn", "data", "fsdp", "expert"))
    out["dp"] = trainer.dp
    if noise is not None:
        out["grad_noise"] = noise
    if name == "adafactor_fsdp":
        out["shared"] = _shared_gradient_steps(Trainer(cfg, device="cpu"),
                                               batch, steps=3)
    # the whole state, gathered; a fresh trainer on the same mesh cuts its
    # shards from it and gathers the same state back
    payload = trainer.payload()
    fresh = Trainer(cfg, device="cpu")
    fresh.load_payload(payload)
    out["opt_state"] = payload["opt_state"]
    out["roundtrip"] = _same_state(payload, fresh.payload())
    return out


def _same_state(a: dict, b: dict) -> bool:
    def flat(p):
        items = [(f"params/{k}", v) for k, v in p["params"].items()]
        items += [(f"stats/{k}", v) for k, v in p["batch_stats"].items()]
        items += [(f"opt/{n}/{k}", v) for n, st in p["opt_state"].items()
                  for k, v in st.items()]
        return dict(items)

    fa, fb = flat(a), flat(b)
    return a["step"] == b["step"] and set(fa) == set(fb) and all(
        torch.equal(torch.as_tensor(fa[k]), torch.as_tensor(fb[k]))
        for k in fa)


def _configs(world: int) -> dict:
    out = {n: dict(LM, **kw) for n, (w, kw) in LAYOUTS.items() if w == world}
    if world == 2:
        out.update(EXTRA)
    return out


def spmd_worker(rank, n, out_dir):
    from kubeflow_tpu_torch.parallel import dist as D

    D.initialize_from_env(device="cpu")
    init = torch.load(os.path.join(out_dir, "init.pt"), weights_only=True)
    for name, cfg in _configs(n).items():
        out = _run(name, cfg, init if cfg["task"] == "lm" and
                   cfg["model_kwargs"].get("d_model") is None else None)
        torch.save(out, os.path.join(out_dir, f"{name}_rank{rank}.pt"))
    D.shutdown()


def _gather_logits(outs: list[dict]) -> torch.Tensor:
    """The global batch's logits from every rank's rows (ranks of one dp
    index hold the same rows)."""
    by_index = {o["dp_index"]: o["logits"] for o in outs}
    return torch.cat([by_index[i] for i in range(outs[0]["dp"])])


def _assert_opt_state(name, got: dict, want: dict):
    """The gathered optimizer state equals one process's (momentum,
    Adafactor's factored statistics): the payload a sharded world saves."""
    assert set(got) == set(want), name
    for n, st in want.items():
        for k, v in st.items():
            np.testing.assert_allclose(
                torch.as_tensor(got[n][k]).float().numpy(),
                torch.as_tensor(v).float().numpy(), rtol=1e-4, atol=1e-7,
                err_msg=f"{name} {n} {k}")


def _assert_parity(name, got: dict, want: dict, tols=TOLS):
    assert got["roundtrip"], f"{name}: payload -> load_payload -> payload"
    for i, (a, b) in enumerate(zip(got["losses"], want["losses"])):
        assert abs(a - b) <= tols["loss"], (name, "loss", i, a, b)
    d = float((got["logits"] - want["logits"]).abs().max())
    assert d <= tols["logits"], (name, "logits", d)
    assert set(got["params"]) == set(want["params"])
    for k, v in want["params"].items():
        d = float((got["params"][k] - v).abs().max())
        assert d <= tols["params"], (name, "params", k, d)
    _assert_opt_state(name, got["opt_state"], want["opt_state"])


@pytest.fixture(scope="module")
def reference_init(tmp_path_factory):
    """The reference's initial params of the witness config (seed 0),
    converted to the port's state dict, and its `data=2, model=2`
    witness on 4 of the virtual CPU devices."""
    import jax

    import __graft_entry__ as G
    from kubeflow_tpu.parallel.mesh import MeshSpec
    from kubeflow_tpu.runtime import trainer as jtrainer
    from kubeflow_tpu_torch.convert import flax_to_state_dict

    root = tmp_path_factory.mktemp("spmd")
    jt = jtrainer.Trainer(jtrainer.TrainConfig.from_dict(
        {k: v for k, v in LM.items() if k != "log_every"}))
    init = flax_to_state_dict(jax.device_get(jt.init_state().params))
    torch.save(init, root / "init.pt")
    ref = G._layout_witness(dict(
        model="transformer-test", global_batch=BATCH,
        model_kwargs={"attention_impl": "reference", "dtype": "float32"},
        mesh=MeshSpec(data=2, model=2)), jax.devices()[:4])
    return root, init, ref


@pytest.fixture(scope="module")
def single(reference_init):
    """Every layout's config on one process (no world)."""
    _, init, _ = reference_init
    out = {}
    for world in (2, 4):
        for name, cfg in _configs(world).items():
            kw = {k: v for k, v in cfg.items() if k != "mesh"}
            out[name] = _run(name, kw, init if name in LAYOUTS or
                             name == "packed_dp" else None)
    return out


def _world_outputs(root, world: int) -> dict:
    outs = {}
    for name in _configs(world):
        outs[name] = [torch.load(root / f"{name}_rank{r}.pt",
                                 weights_only=False) for r in range(world)]
    return outs


@pytest.fixture(scope="module")
def world2(reference_init):
    root, _, _ = reference_init
    run_world(2, "test_torch_spmd:spmd_worker", root, timeout=300)
    return _world_outputs(root, 2)


@pytest.fixture(scope="module")
def world4(reference_init):
    root, _, _ = reference_init
    run_world(4, "test_torch_spmd:spmd_worker", root, timeout=300,
              env={"JAXJOB_COLLECTIVES_BACKEND": "gpu"})
    return _world_outputs(root, 4)


def _merged(outs: list[dict]) -> dict:
    o = dict(outs[0])
    o["logits"] = _gather_logits(outs)
    for r in outs[1:]:    # every rank gathered the same whole params
        for k, v in r["params"].items():
            assert torch.equal(v, o["params"][k]), k
    return o


@pytest.mark.parametrize("name", ["dp", "fsdp_accum"])
def test_two_rank_layouts_equal_one_process(name, world2, single):
    outs = world2[name]
    assert outs[0]["losses"] == outs[1]["losses"]
    _assert_parity(name, _merged(outs), single[name])


@pytest.mark.parametrize("name", ["dp_tp", "dcn_dp", "tp_gqa"])
def test_four_rank_layouts_equal_one_process(name, world4, single):
    outs = world4[name]
    assert len({tuple(o["losses"]) for o in outs}) == 1
    _assert_parity(name, _merged(outs), single[name])


def test_dp_tp_equals_the_reference_witness(world4, reference_init):
    import jax

    from kubeflow_tpu_torch.convert import state_dict_to_flax

    _, _, ref = reference_init
    got = _merged(world4["dp_tp"])
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=REF_RTOL)
    np.testing.assert_allclose(got["logits"].numpy(), ref["logits"],
                               rtol=REF_RTOL, atol=TOLS["logits"])
    flat = np.concatenate([np.asarray(x, np.float32).ravel() for x in
                           jax.tree.leaves(state_dict_to_flax(
                               got["params"], 16))])
    np.testing.assert_allclose(flat, ref["params"], rtol=REF_RTOL,
                               atol=TOLS["params"])


def test_adafactor_under_fsdp_equals_one_process(world2, single):
    """End to end: losses, the optimizer state, the params after the
    first update and after three. Adafactor's g / sqrt(v) turns a
    gradient that cancels to rounding noise into an O(0.1) update, and
    the world's gradient (two half-batch GEMMs summed by the
    reduce-scatter) and one process's (one GEMM) differ at that noise:
    the three-update hold leaves out the elements whose one-process
    gradient was noise at some step (`_watch_gradients`), a handful.
    Besides, the params after three updates on gradients the world and
    one process share (`_shared_gradient_steps`), every element."""
    got, want = _merged(world2["adafactor_fsdp"]), single["adafactor_fsdp"]
    assert all(o["roundtrip"] for o in world2["adafactor_fsdp"])
    _assert_opt_state("adafactor_fsdp", got["opt_state"], want["opt_state"])
    np.testing.assert_allclose(got["losses"], want["losses"],
                               atol=TOLS["loss"])
    for k, v in want["params"].items():
        d = float((got["params"][k] - v).abs().max())
        assert d <= TOLS["params"], ("first update", k, d)
    noise = want["grad_noise"]
    assert set(noise) == set(want["final"])
    dropped = sum(int(m.sum()) for m in noise.values())
    assert dropped <= GRAD_NOISE_ELEMENTS, dropped
    for k, v in want["final"].items():
        d = float((got["final"][k] - v).abs().masked_fill(noise[k], 0).max())
        assert d <= TOLS["params"], ("three updates", k, d)
    for o in world2["adafactor_fsdp"]:
        for k, v in want["shared"].items():
            d = float((o["shared"][k] - v).abs().max())
            assert d <= TOLS["params"], ("shared gradients", k, d)


def test_resnet_batchnorm_over_the_global_batch(world2, single):
    got, want = world2["resnet_dp"], single["resnet_dp"]
    assert got[0]["losses"] == got[1]["losses"]
    assert all(o["roundtrip"] for o in got)
    merged = _merged(got)
    np.testing.assert_allclose(merged["losses"], want["losses"],
                               atol=TOLS["loss"])
    np.testing.assert_allclose(merged["logits"].numpy(),
                               want["logits"].numpy(), atol=TOLS["logits"])
    for k, v in want["batch_stats"].items():
        for r in got:
            np.testing.assert_allclose(r["batch_stats"][k].numpy(),
                                       v.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    for k, v in want["params"].items():
        d = float((merged["params"][k] - v).abs().max())
        assert d <= TOLS["params"], (k, d)


def test_uneven_valid_counts_give_the_global_mean(world2, single):
    got, want = _merged(world2["packed_dp"]), single["packed_dp"]
    _assert_parity("packed_dp", got, want)
    # the mean of the two ranks' own means is another number
    assert abs(want["losses"][0] - got["losses"][0]) <= TOLS["loss"]
