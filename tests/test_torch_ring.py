"""The port's ring attention (kubeflow_tpu_torch/ops/ring_attention.py) and
the `seq` mesh axis, in gloo worlds of 2 and 4 CPU processes, against
the JAX package's ring attention on a seq mesh of virtual CPU devices.

Op level, f32, on the same numpy inputs (each rank its block of
positions): output and the gradients of q, k and v for causal, GQA,
windowed (at seq 4 the window caps the ring at 3 of 4 hops), packed
(segment ids, which travel with K/V) and bidirectional attention,
within the reference's own 2e-5 (tests/test_ring_attention.py).

Trainer level, the reference's SPMD witness protocol (tests/
test_torch_spmd.py): transformer-test with ring attention at seq 2, a
windowed ring at seq 4, data 2 x seq 2, moe-test on the dense path at
seq 2 (capacity counted over whole rows across the seq ranks), and the
reference's `dp_tp_sp` layout as model 2 x seq 2, each equal to one
process (where ring is the plain attention over the whole sequence);
`dp_tp_sp` also against the reference's own witness on virtual devices.
BERT with ring: bert-test over seq 2 and 4 equals the reference's BERT
ring logits.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_dist import run_world
from test_torch_spmd import REF_RTOL, TOLS, _assert_parity, _run

B, L, H, D = 2, 32, 4, 16
OP_TOL = dict(rtol=2e-5, atol=2e-5)    # tests/test_ring_attention.py

CASES = {
    "causal": dict(hkv=4),
    "gqa": dict(hkv=2),
    "window": dict(hkv=2, window=10),
    "segments": dict(hkv=4, segments=True),
    "bidirectional": dict(hkv=4, causal=False),
    "bidirectional_segments": dict(hkv=2, causal=False, segments=True),
}

LM = dict(model="transformer-test", task="lm", seq_len=32, vocab_size=256,
          optimizer="sgdm", learning_rate=0.1, total_steps=2, warmup_steps=0,
          global_batch=8, log_every=10**9)


def _lm(impl: str, mesh: dict, **model_kwargs) -> dict:
    return dict(LM, mesh=mesh, model_kwargs={"dtype": "float32",
                                             "attention_impl": impl,
                                             **model_kwargs})


RING_LAYOUTS = {
    2: {"sp": _lm("ring", {"data": 1, "seq": 2}),
        "moe_sp": dict(_lm("ring", {"data": 1, "seq": 2}, moe_impl="dense",
                           moe_capacity_factor=1.0), model="moe-test")},
    4: {"sp_window": _lm("ring", {"data": 1, "seq": 4}, attention_window=10),
        "dp_sp": _lm("ring", {"data": 2, "seq": 2}),
        "dp_tp_sp": _lm("ring", {"data": 1, "model": 2, "seq": 2})},
}


def inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    out = {"q": rng.standard_normal((B, L, H, D)).astype(np.float32),
           "ct": rng.standard_normal((B, L, H, D)).astype(np.float32),
           "seg": np.repeat(np.array([[1, 1, 1, 2], [1, 2, 2, 3]],
                                     np.int32), L // 4, axis=1)}
    for hkv in (2, 4):
        out[f"k{hkv}"] = rng.standard_normal((B, L, hkv, D)).astype(np.float32)
        out[f"v{hkv}"] = rng.standard_normal((B, L, hkv, D)).astype(np.float32)
    return out


def _coords(spec: dict, n: int, rank: int) -> dict:
    from kubeflow_tpu_torch.parallel.mesh import AXIS_NAMES, rank_layout

    where = np.nonzero(rank_layout(spec, n) == rank)
    return dict(zip(AXIS_NAMES, (int(c[0]) for c in where)))


def op_outputs(fn, seq, data: dict, cases: dict | None = None) -> dict:
    """Each case (of `cases`, default CASES) through `fn` (ring or
    ulysses) on this rank's block: {case: (out, dq, dk, dv)} as numpy."""
    n, r, length = seq.size, seq.rank, data["q"].shape[1]
    cut = slice(r * length // n, (r + 1) * length // n)
    res = {}
    for name, c in (CASES if cases is None else cases).items():
        hkv = c["hkv"]
        q, k, v = (torch.tensor(data[key][:, cut].copy(), requires_grad=True)
                   for key in ("q", f"k{hkv}", f"v{hkv}"))
        seg = torch.tensor(data["seg"][:, cut].copy()) \
            if c.get("segments") else None
        out = fn(q, k, v, seq=seq, causal=c.get("causal", True),
                 segment_ids=seg, window=c.get("window", 0))
        (out * torch.tensor(data["ct"][:, cut].copy())).sum().backward()
        res[name] = tuple(t.detach().numpy() for t in
                          (out, q.grad, k.grad, v.grad))
    return res


def world_run(rank, n, out_dir, fn, layouts: dict, extra=None) -> None:
    """The op cases through `fn` on a seq-n mesh, then each trainer
    layout's witness (`_run`), saved per rank."""
    from kubeflow_tpu_torch.parallel import backends as BK
    from kubeflow_tpu_torch.parallel import dist as DI
    from kubeflow_tpu_torch.parallel.mesh import axis_group

    DI.initialize_from_env(device="cpu")
    data = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    mesh = BK.get_backend().mesh({"data": 1, "seq": n}, "cpu")
    out = {"ops": op_outputs(fn, axis_group(mesh, ("seq",)), data)}
    if extra is not None:
        out.update(extra(mesh, out_dir))
    init = torch.load(os.path.join(out_dir, "init.pt"), weights_only=True)
    for name, cfg in layouts.items():
        res = _run(name, cfg, init if cfg["model"] == "transformer-test"
                   else None)
        res["coords"] = _coords(cfg["mesh"], n, rank)
        out[name] = res
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    DI.shutdown()


def _bert_extra(mesh, out_dir):
    """bert-test with ring over the seq group: this rank's logits."""
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.parallel.mesh import axis_group

    seq = axis_group(mesh, ("seq",))
    bert = get_model("bert-test", device="cpu", dtype="float32",
                     attention_impl="ring")
    bert.load_state_dict(torch.load(os.path.join(out_dir, "bert.pt"),
                                    weights_only=True))
    bert.seq = seq
    tok = np.load(os.path.join(out_dir, "bert_tokens.npy"))
    n = seq.size
    cut = slice(seq.rank * tok.shape[1] // n,
                (seq.rank + 1) * tok.shape[1] // n)
    with torch.no_grad():
        logits = bert(torch.tensor(tok[:, cut]).long())
    return {"bert": logits.numpy()}


def ring_worker(rank, n, out_dir):
    from kubeflow_tpu_torch.ops.ring_attention import ring_attention

    world_run(rank, n, out_dir, ring_attention, RING_LAYOUTS[n], _bert_extra)


# -- the reference side ---------------------------------------------------------


def jax_op_reference(impl: str, sp: int, data: dict) -> dict:
    """{case: (out, dq, dk, dv)} of the reference's `impl` (ring or
    ulysses) under a seq-sp mesh of virtual devices."""
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.parallel.mesh import MeshSpec, build_mesh

    if impl == "ring":
        from kubeflow_tpu.ops.ring_attention import ring_attention as fn
    else:
        from kubeflow_tpu.ops.ulysses import ulysses_attention as fn
    mesh = build_mesh(MeshSpec(data=1, seq=sp), devices=jax.devices()[:sp])
    res = {}
    for name, c in CASES.items():
        hkv = c["hkv"]
        seg = jnp.asarray(data["seg"]) if c.get("segments") else None
        kw = dict(mesh=mesh, segment_ids=seg, window=c.get("window", 0),
                  causal=c.get("causal", True))
        if impl == "ulysses":
            kw["impl"] = "reference"

        def loss(q, k, v):
            out = fn(q, k, v, **kw)
            return jnp.sum(out * data["ct"]), out

        with mesh:
            (_, out), grads = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1, 2), has_aux=True))(
                    jnp.asarray(data["q"]), jnp.asarray(data[f"k{hkv}"]),
                    jnp.asarray(data[f"v{hkv}"]))
        res[name] = tuple(np.asarray(t) for t in (out, *grads))
    return res


def lm_init(root) -> dict:
    """The reference's transformer-test params at seed 0, as the port's
    state dict (the witness configs' common start)."""
    import jax

    from kubeflow_tpu.runtime import trainer as jtrainer
    from kubeflow_tpu_torch.convert import flax_to_state_dict

    jt = jtrainer.Trainer(jtrainer.TrainConfig.from_dict(
        {k: v for k, v in LM.items() if k != "log_every"}
        | {"model_kwargs": {"dtype": "float32"}}))
    init = flax_to_state_dict(jax.device_get(jt.init_state().params))
    torch.save(init, root / "init.pt")
    return init


def merged(outs: list[dict]) -> dict:
    """The global batch's logits from every rank's block (rows by the
    batch index, positions by the seq index) and rank 0's whole params
    (every rank gathered the same)."""
    o = dict(outs[0])
    blocks = {}
    for r in outs:
        c = r["coords"]
        blocks.setdefault(c["data"], {})[c["seq"]] = r["logits"]
    o["logits"] = torch.cat([torch.cat([row[s] for s in sorted(row)], 1)
                             for _, row in sorted(blocks.items())])
    for r in outs[1:]:
        for k, v in r["params"].items():
            assert torch.equal(v, o["params"][k]), k
    return o


def single_runs(layouts: dict, init) -> dict:
    return {name: _run(name, {k: v for k, v in cfg.items() if k != "mesh"},
                       init if cfg["model"] == "transformer-test" else None)
            for name, cfg in layouts.items()}


def assert_ops(got: list[dict], want: dict) -> None:
    for name, ref in want.items():
        parts = [r["ops"][name] for r in got]
        for i, what in enumerate(("out", "dq", "dk", "dv")):
            full = np.concatenate([p[i] for p in parts], axis=1)
            np.testing.assert_allclose(full, ref[i], **OP_TOL,
                                       err_msg=f"{name} {what}")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from flax.core import meta

    from kubeflow_tpu.models.registry import get_model as jax_get_model
    from kubeflow_tpu_torch.convert import flax_to_state_dict

    root = tmp_path_factory.mktemp("ring")
    data = inputs()
    np.savez(root / "inputs.npz", **data)
    init = lm_init(root)
    jb = jax_get_model("bert-test", dtype=jnp.float32, attention_impl="ring")
    tok = np.random.default_rng(7).integers(1, 512, (2, 64)).astype(np.int32)
    params = meta.unbox(jb.init(jax.random.PRNGKey(0), jnp.asarray(tok),
                                train=False)["params"])
    torch.save(flax_to_state_dict(jax.device_get(params)), root / "bert.pt")
    np.save(root / "bert_tokens.npy", tok)
    return root, data, init, (jb, params, tok)


def spawn(root, n: int, target: str, files) -> list[dict]:
    """Run `target` in a world of n with `files` of `root` beside it;
    each rank's saved output."""
    w = root / f"w{n}"
    w.mkdir()
    for f in files:
        os.link(root / f, w / f)
    run_world(n, target, w, timeout=300)
    return [torch.load(w / f"rank{r}.pt", weights_only=False)
            for r in range(n)]


def _world(setup, n):
    return spawn(setup[0], n, "test_torch_ring:ring_worker",
                 ("inputs.npz", "init.pt", "bert.pt", "bert_tokens.npy"))


@pytest.fixture(scope="module")
def world2(setup):
    return _world(setup, 2)


@pytest.fixture(scope="module")
def world4(setup):
    return _world(setup, 4)


@pytest.fixture(scope="module")
def single(setup):
    return single_runs({**RING_LAYOUTS[2], **RING_LAYOUTS[4]}, setup[2])


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_ops_equal_the_reference_ring(sp, setup, world2, world4):
    got = world2 if sp == 2 else world4
    assert_ops(got, jax_op_reference("ring", sp, setup[1]))


def test_ring_without_a_seq_group_is_the_plain_attention(setup):
    """No seq group: the reference's fallback to reference_attention."""
    from kubeflow_tpu_torch.ops.attention import reference_attention
    from kubeflow_tpu_torch.ops.ring_attention import ring_attention

    data = setup[1]
    q, k, v = (torch.tensor(data[key]) for key in ("q", "k2", "v2"))
    seg = torch.tensor(data["seg"])
    for causal in (True, False):
        torch.testing.assert_close(
            ring_attention(q, k, v, causal=causal, segment_ids=seg, window=5),
            reference_attention(q, k, v, causal=causal, segment_ids=seg,
                                window=5), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["sp", "moe_sp", "sp_window", "dp_sp",
                                  "dp_tp_sp"])
def test_seq_layout_equals_one_process(name, world2, world4, single):
    outs = world2 if name in RING_LAYOUTS[2] else world4
    got = [o[name] for o in outs]
    assert len({tuple(o["losses"]) for o in got}) == 1
    _assert_parity(name, merged(got), single[name])


def test_dp_tp_sp_equals_the_reference_witness(world4, setup):
    """`spmd_equivalence_losses`' dp_tp_sp layout (model 2 x seq 2, ring),
    the port's world against the reference's own on 4 virtual devices."""
    import jax

    import __graft_entry__ as G
    from kubeflow_tpu.parallel.mesh import MeshSpec
    from kubeflow_tpu_torch.convert import state_dict_to_flax

    ref = G._layout_witness(dict(
        model="transformer-test", global_batch=LM["global_batch"],
        model_kwargs={"attention_impl": "ring", "dtype": "float32"},
        mesh=MeshSpec(data=1, model=2, seq=2)), jax.devices()[:4])
    got = merged([o["dp_tp_sp"] for o in world4])
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=REF_RTOL)
    np.testing.assert_allclose(got["logits"].numpy(), ref["logits"],
                               rtol=REF_RTOL, atol=TOLS["logits"])
    flat = np.concatenate([np.asarray(x, np.float32).ravel() for x in
                           jax.tree.leaves(state_dict_to_flax(
                               got["params"], 16))])
    np.testing.assert_allclose(flat, ref["params"], rtol=REF_RTOL,
                               atol=TOLS["params"])


@pytest.mark.parametrize("sp", [1, 2, 4])
def test_bert_ring_equals_the_reference(sp, setup, world2, world4):
    """bert-test, attention_impl ring: one process (the plain attention,
    no padding mask) and seq groups of 2 and 4 against the reference's
    BERT ring (on a seq mesh for sp > 1)."""
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.parallel.mesh import MeshSpec, build_mesh
    from kubeflow_tpu_torch.models.registry import get_model

    root, _, _, (jb, params, tok) = setup
    if sp == 1:
        want = np.asarray(jb.apply({"params": params}, jnp.asarray(tok),
                                   train=False))
        bert = get_model("bert-test", device="cpu", dtype="float32",
                         attention_impl="ring")
        bert.load_state_dict(torch.load(root / "bert.pt", weights_only=True))
        got = bert(torch.tensor(tok).long()).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        return
    mesh = build_mesh(MeshSpec(data=1, seq=sp), devices=jax.devices()[:sp])
    with mesh:
        want = np.asarray(jax.jit(lambda p, t: jb.apply(
            {"params": p}, t, train=False))(params, jnp.asarray(tok)))
    for r in (world2 if sp == 2 else world4):
        np.testing.assert_allclose(r["bert"], want, rtol=1e-4, atol=1e-4)
