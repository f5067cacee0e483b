"""The port's classifiers and LM served over a mesh of two ranks (a gloo
world of 2 processes on the CPU, rank 0 predicting, rank 1 following),
f32, at weights converted from the reference's flax trees:

- ViT (vit-test, 32 px) and BERT (bert-test) at `model=2`, by the
  encoders' annotations; ResNet-18 (32 px) at `fsdp=2`, by the fsdp
  heuristic, in eval mode: softmax rows within 1e-5 of one port process
  and of the reference's sharded `serve_flax_classifier` on the 8
  virtual CPU devices (ViT and BERT: of the reference model's rows, as
  its server draws its own weights, in which ViT's head is zero and
  every row uniform, and casts inputs to f32, which BERT's token ids
  cannot take); `signature_def["mesh"]`.
- transformer-test at `model=2`: greedy tokens of the generate path and
  of the slot decoder, with and without the rolling cache, equal one
  process's and the reference's meshed server's.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_dist import run_world

PROB_TOL = 1e-5
MODEL2 = {"model": 2}
CLASSIFIERS = {   # name -> (registry model, mesh, model kwargs)
    "vit": ("vit-test", MODEL2, {}),
    "bert": ("bert-test", MODEL2, {}),
    "resnet": ("resnet18", {"fsdp": 2}, {"num_classes": 10,
                                        "num_filters": 8}),
}
P, N, VOCAB = 8, 4, 64
PROMPTS = [{"tokens": [1, 2, 3]}, {"tokens": list(range(1, 12))},
           {"tokens": [7]}]
LM_CASES = {
    "generate": {},
    "slots": dict(continuous_batching=True, decode_slots=2),
    "slots_rolling": dict(continuous_batching=True, decode_slots=2,
                          attention_window=4, rolling_kv_cache=True),
}


def _inputs(name: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    if name == "bert":
        toks = rng.integers(1, 512, (4, 16))
        toks[1, 10:] = 0            # padding
        return toks.astype(np.int64)
    return rng.standard_normal((4, 32, 32, 3)).astype(np.float32)


def _classifier(name, mesh, state_dict):
    from kubeflow_tpu_torch.serving import server as S

    zoo, _, kw = CLASSIFIERS[name]
    return S.serve_flax_classifier(name, zoo, mesh=mesh, device="cpu",
                                   state_dict=state_dict, dtype="float32",
                                   **kw)


def _lm(name, mesh, weights):
    from kubeflow_tpu_torch.serving import server as S

    return S.serve_lm_generator(
        name, "transformer-test", device="cpu", dtype="float32",
        prompt_len=P, max_new_tokens=N, vocab_size=VOCAB, mesh=mesh,
        state_dict=weights, **LM_CASES[name])


def _moe(mesh):
    """moe-test (an MoE block every 2nd layer) behind the slot decoder,
    random weights from seed 0 (drawn alike in every process)."""
    from kubeflow_tpu_torch.serving import server as S

    return S.serve_lm_generator(
        "moe", "moe-test", device="cpu", dtype="float32", prompt_len=P,
        max_new_tokens=N, mesh=mesh, continuous_batching=True,
        decode_slots=2)


def serving_worker(rank, n, out_dir):
    from kubeflow_tpu_torch.parallel import dist as D
    from kubeflow_tpu_torch.serving import mesh as serving_mesh
    from kubeflow_tpu_torch.serving import server as S

    D.initialize_from_env(device="cpu")
    weights = torch.load(os.path.join(out_dir, "weights.pt"),
                         weights_only=True)
    server = S.ModelServer()
    for name, (_, mesh, _) in CLASSIFIERS.items():
        server.register(_classifier(name, mesh, weights[name]))
    for name in LM_CASES:
        server.register(_lm(name, MODEL2, weights["lm"]))
    server.register(_moe(MODEL2))
    if rank > 0:
        serving_mesh.follow()
        D.shutdown()
        return
    out = {name: np.asarray(server._get(name).predict(list(_inputs(name))))
           for name in CLASSIFIERS}
    out.update({name: server._get(name).predict(PROMPTS)
                for name in [*LM_CASES, "moe"]})
    dec = server._get("moe").decoder()
    out["moe_sparse"] = [b.sparse for b in dec.model.moe_blocks()]
    out["signature"] = server._get("vit").signature
    server.close()
    torch.save(out, os.path.join(out_dir, "rank0.pt"))
    D.shutdown()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Each model's reference weights (PRNGKey(0)) as port state dicts,
    and the reference's sharded predictions."""
    import jax
    import jax.numpy as jnp
    from flax.core import meta

    from kubeflow_tpu.models.registry import get_model as jax_get_model
    from kubeflow_tpu.serving import server as jserver
    from kubeflow_tpu_torch.convert import flax_to_state_dict

    root = tmp_path_factory.mktemp("mesh_cls")
    weights, ref = {}, {}
    for name, (zoo, mesh, kw) in CLASSIFIERS.items():
        x = _inputs(name)
        jm = jax_get_model(zoo, dtype=jnp.float32, **kw)
        v = jax.device_get(meta.unbox(jm.init(
            jax.random.PRNGKey(0), jnp.asarray(x), train=False)))
        if name == "vit":       # a zero head makes every row uniform
            v["params"]["head_kernel"] = np.random.default_rng(5).normal(
                0.0, 0.5, v["params"]["head_kernel"].shape).astype(
                    np.float32)
        weights[name] = {**flax_to_state_dict(v["params"]),
                         **flax_to_state_dict(v.get("batch_stats", {}))}
        if name != "resnet":
            # the reference's server draws its own weights (the drawn
            # ViT head is not them) and casts every input to f32, which
            # BERT's token ids cannot take: its model's rows
            ref[name] = np.asarray(jax.nn.softmax(
                jm.apply(v, jnp.asarray(x), train=False), axis=-1))
            continue
        served = jserver.serve_flax_classifier(
            "r", zoo, mesh=mesh, dtype=jnp.float32, **kw)
        ref[name] = np.asarray(served.predict(list(x)))
    jm = jax_get_model("transformer-test", vocab_size=VOCAB,
                       max_seq_len=P + N, dtype=jnp.float32)
    params = meta.unbox(jm.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 1), jnp.int32),
                                train=False)["params"])
    weights["lm"] = flax_to_state_dict(jax.device_get(params))
    served = jserver.serve_lm_generator(
        "x", "transformer-test", dtype=jnp.float32, prompt_len=P,
        max_new_tokens=N, vocab_size=VOCAB, mesh=MODEL2)
    try:
        ref["lm"] = served.predict(PROMPTS)
    finally:
        served.close()
    torch.save(weights, root / "weights.pt")
    return root, weights, ref


@pytest.fixture(scope="module")
def world(reference):
    root, _, _ = reference
    run_world(2, "test_torch_mesh_classifier:serving_worker", root,
              timeout=300)
    return torch.load(root / "rank0.pt", weights_only=False)


@pytest.mark.parametrize("name", sorted(CLASSIFIERS))
def test_meshed_rows_equal_one_process_and_the_reference(name, world,
                                                         reference):
    _, weights, ref = reference
    single = _classifier(name, None, weights[name])
    want = np.asarray(single.predict(list(_inputs(name))))
    got = world[name]
    assert got.shape == want.shape == (4, 10 if name != "bert" else 2)
    assert float(np.ptp(want, axis=1).min()) > 1e-3     # not uniform
    np.testing.assert_allclose(got, want, atol=PROB_TOL, rtol=PROB_TOL)
    np.testing.assert_allclose(got, ref[name], atol=PROB_TOL, rtol=PROB_TOL)


@pytest.mark.parametrize("name", sorted(LM_CASES))
def test_meshed_lm_tokens_equal_one_process_and_the_reference(
        name, world, reference):
    _, weights, ref = reference
    single = _lm(name, None, weights["lm"])
    try:
        want = [list(map(int, r)) for r in single.predict(PROMPTS)]
    finally:
        single.close()
    assert [list(map(int, r)) for r in world[name]] == want
    if "rolling" not in name:       # the reference's mesh: full cache
        assert want == [list(map(int, r)) for r in ref["lm"]]


def test_moe_under_a_serving_mesh(world):
    """The reference's dispatch choice on the serving mesh: model 2 keeps
    the dense dispatch (moe_sparse_ok), so the tokens are one
    process's."""
    single = _moe(None)
    try:
        want = [list(map(int, r)) for r in single.predict(PROMPTS)]
    finally:
        single.close()
    assert world["moe_sparse"] and not any(world["moe_sparse"])
    assert [list(map(int, r)) for r in world["moe"]] == want


def test_signature_names_the_mesh(world):
    assert world["signature"]["mesh"] == MODEL2
    assert world["signature"]["method_name"] == "predict"
