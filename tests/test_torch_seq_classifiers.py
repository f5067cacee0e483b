"""The classifier tasks on a seq mesh axis, in a gloo world of 2 CPU
processes, against one process (tests/test_torch_spmd.py's
SPMD_PARITY_TOLS: loss 1e-5, logits 1e-4, params 1e-6; f32).

`seq_classification` (bert-test) cuts only the tokens into blocks of
positions: BERT's attention under `reference` gathers K/V and the
padding mask from every rank (ops/seq_attention.py), under `ring` the
blocks travel the ring, and [CLS] reaches every rank through
`_FromFirst`; the label replicates. `classification` (vit-test;
resnet18, whose BatchNorm statistics then move on every rank alike)
keeps whole images and labels on every seq rank, as the reference's
batch spec has no seq: each gradient sums over seq and divides by the
valid count summed there too, so the step is one process's.

BERT (reference impl) and ViT start from the reference's initial
params, and their seq-2 worlds are also held against the reference
trainer's witness on a seq-2 mesh of virtual CPU devices (REF_RTOL),
whose batch spec replicates the classifier batch over seq.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_dist import run_world
from test_torch_spmd import REF_RTOL, TOLS

BASE = dict(global_batch=4, optimizer="sgdm", learning_rate=0.1,
            warmup_steps=0, total_steps=2, log_every=10**9)
LAYOUTS = {
    "bert_reference": dict(BASE, model="bert-test",
                           task="seq_classification", seq_len=32,
                           vocab_size=512, num_classes=2,
                           model_kwargs={"dtype": "float32"}),
    "bert_ring": dict(BASE, model="bert-test", task="seq_classification",
                      seq_len=32, vocab_size=512, num_classes=2,
                      model_kwargs={"dtype": "float32",
                                    "attention_impl": "ring"}),
    "vit": dict(BASE, model="vit-test", task="classification",
                image_size=32, num_classes=10,
                model_kwargs={"dtype": "float32"}),
    "resnet": dict(BASE, model="resnet18", task="classification",
                   image_size=16, num_classes=10,
                   model_kwargs={"dtype": "float32", "num_filters": 8}),
}


# the layouts that start from the reference's params and are held
# against its seq-2 witness
REF_LAYOUTS = ("bert_reference", "vit")


def _witness(cfg: dict, init: dict | None = None) -> dict:
    """Logits at the initial params (eval mode), the step losses (two;
    one for ResNet, as tests/test_torch_spmd.py's BatchNorm witness), the
    whole state after them; from `init` where given."""
    from kubeflow_tpu_torch.runtime.trainer import (
        TrainConfig,
        Trainer,
        _batch_xy,
    )

    trainer = Trainer(TrainConfig.from_dict(cfg), device="cpu")
    if init is not None:
        trainer.model.load_state_dict(init)
    local = trainer._to_device(next(trainer.data_iter()))
    x, _ = _batch_xy(trainer.cfg, local)
    trainer.model.eval()
    with torch.no_grad():
        logits = trainer.model(x)
    trainer.model.train()
    steps = 1 if cfg["model"].startswith("resnet") else 2
    losses = [float(trainer.train_step(local)["loss"]) for _ in range(steps)]
    p = trainer.payload()
    return {"logits": logits, "losses": losses, "params": p["params"],
            "batch_stats": p["batch_stats"], "shape": tuple(x.shape)}


def seq_cls_worker(rank, n, out_dir):
    from kubeflow_tpu_torch.parallel import dist as DI

    DI.initialize_from_env(device="cpu")
    out = {name: _witness(dict(cfg, mesh={"data": 1, "seq": n}),
                          _init(out_dir, name))
           for name, cfg in LAYOUTS.items()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    DI.shutdown()


def _init(root, name: str) -> dict | None:
    path = os.path.join(root, f"init_{name}.pt")
    return torch.load(path, weights_only=True) if os.path.exists(path) \
        else None


def jax_seq2_witness(cfg: dict) -> tuple[dict, dict]:
    """The reference trainer on a seq-2 mesh of 2 virtual CPU devices:
    (its initial params by port name, its witness: logits at them in
    eval mode, two step losses, the params after both)."""
    import jax
    from flax.core import meta

    from kubeflow_tpu.parallel.mesh import MeshSpec, build_mesh
    from kubeflow_tpu.runtime import trainer as jtrainer
    from kubeflow_tpu_torch.convert import flax_to_state_dict

    jcfg = jtrainer.TrainConfig.from_dict(
        dict(cfg, mesh=MeshSpec(data=1, seq=2)))
    mesh = build_mesh(jcfg.mesh, devices=jax.devices()[:2])
    jt = jtrainer.Trainer(jcfg, mesh=mesh)
    state = jt.init_state()
    batch = next(jt.data_iter())
    x = batch["tokens" if cfg["task"] == "seq_classification" else "image"]

    def params(st) -> dict:
        return flax_to_state_dict(jax.device_get(meta.unbox(st.params)))

    init = params(state)
    with mesh:
        logits = jax.jit(lambda p, x: jt.model.apply(
            {"params": p}, x, train=False))(state.params, x)
    losses = []
    for _ in range(2):
        state, m = jt.train_step(state, batch)
        losses.append(float(m["loss"]))
    return init, {"logits": np.asarray(jax.device_get(logits), np.float32),
                  "losses": losses, "params": params(state)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("seq_cls")
    refs = {}
    for name in REF_LAYOUTS:
        init, refs[name] = jax_seq2_witness(LAYOUTS[name])
        torch.save(init, root / f"init_{name}.pt")
    return root, refs


@pytest.fixture(scope="module")
def world(setup):
    root = setup[0]
    run_world(2, "test_torch_seq_classifiers:seq_cls_worker", root,
              timeout=300)
    return [torch.load(root / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


def test_classifiers_at_seq2_equal_one_process(setup, world):
    outs = world
    for name, cfg in LAYOUTS.items():
        want = _witness(cfg, _init(setup[0], name))
        for r, o in enumerate(outs):
            got = o[name]
            # tokens are cut into blocks of positions; images are whole
            if cfg["task"] == "seq_classification":
                assert got["shape"][1] == cfg["seq_len"] // 2, name
            else:
                assert got["shape"] == want["shape"], name
            for i, (a, b) in enumerate(zip(got["losses"], want["losses"])):
                assert abs(a - b) <= TOLS["loss"], (name, r, "loss", i, a, b)
            d = float((got["logits"] - want["logits"]).abs().max())
            assert d <= TOLS["logits"], (name, r, "logits", d)
            for part in ("params", "batch_stats"):
                assert set(got[part]) == set(want[part]), (name, part)
                for k, v in want[part].items():
                    d = float((got[part][k] - v).abs().max())
                    assert d <= TOLS["params"], (name, r, part, k, d)


@pytest.mark.parametrize("name", REF_LAYOUTS)
def test_classifiers_at_seq2_equal_the_reference_witness(name, setup, world):
    ref = setup[1][name]
    for r, o in enumerate(world):
        got = o[name]
        np.testing.assert_allclose(got["losses"], ref["losses"],
                                   rtol=REF_RTOL, err_msg=f"{name} {r}")
        np.testing.assert_allclose(got["logits"].numpy(), ref["logits"],
                                   rtol=REF_RTOL, atol=TOLS["logits"],
                                   err_msg=f"{name} {r}")
        assert set(got["params"]) == set(ref["params"]), name
        for k, v in ref["params"].items():
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(),
                                       rtol=REF_RTOL, atol=TOLS["params"],
                                       err_msg=f"{name} {r} {k}")
