"""The classifiers' sharded training step equals their single-process
step: ViT and BERT on `data=2, model=2` (the encoders' tensor-parallel
annotations: qkv on heads, fc1/fc2 on columns, the gathered patch,
position, word-embedding and head weights) and on `fsdp=2` (FSDP2 over
the annotated dims), ResNet-18 on `fsdp=2` (the fsdp heuristic, and
BatchNorm statistics over every batch axis).

Each layout runs in a world of gloo processes on the CPU (f32, sgdm:
its update is linear in the gradient, so the witness is not the
optimizer's conditioning): the logits at the initial params, both step
losses and the params after each step, held at the reference's
`SPMD_PARITY_TOLS` (loss 1e-5, logits 1e-4, params 1e-6) against one
process; ResNet-18's batch statistics after a step within rtol 1e-5. In
every layout the gathered checkpoint payload loads into a fresh trainer
on the same mesh and gathers back bit for bit. One spawn per world size.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_dist import run_world
from test_torch_spmd import TOLS, _gather_logits, _same_state

BATCH = 8
VIT = dict(model="vit-test", task="classification", image_size=32,
           num_classes=10, optimizer="sgdm", learning_rate=0.1,
           total_steps=2, warmup_steps=0, global_batch=BATCH,
           log_every=10**9, model_kwargs={"dtype": "float32"})
BERT = dict(VIT, model="bert-test", task="seq_classification", seq_len=16,
            vocab_size=512,
            num_classes=2)
RESNET = dict(VIT, model="resnet18", image_size=16,
              model_kwargs={"dtype": "float32", "num_filters": 8})

# world size -> {layout: config}
WORLDS = {
    4: {"vit_dp_tp": dict(VIT, mesh={"data": 2, "model": 2}),
        "bert_dp_tp": dict(BERT, mesh={"data": 2, "model": 2})},
    2: {"vit_fsdp": dict(VIT, mesh={"data": 1, "fsdp": 2}),
        "bert_fsdp": dict(BERT, mesh={"data": 1, "fsdp": 2}),
        "resnet_fsdp": dict(RESNET, mesh={"data": 1, "fsdp": 2})},
}


def _witness(cfg_kw: dict) -> dict:
    from kubeflow_tpu_torch.runtime.trainer import TrainConfig, Trainer

    cfg = TrainConfig.from_dict(cfg_kw)
    trainer = Trainer(cfg, device="cpu")
    batch = next(trainer.data_iter())
    local = trainer._to_device(batch)
    x = local["image" if cfg.task == "classification" else "tokens"]
    trainer.model.eval()
    with torch.no_grad():
        logits = trainer.model(x)
    trainer.model.train()
    losses, params = [], []
    for _ in range(2):
        losses.append(float(trainer.train_step(local)["loss"]))
        params.append({n: t.clone()
                       for n, t in trainer.payload()["params"].items()})
    payload = trainer.payload()
    fresh = Trainer(cfg, device="cpu")
    fresh.load_payload(payload)
    return {"logits": logits.detach(), "losses": losses, "params": params,
            "batch_stats": payload["batch_stats"],
            "roundtrip": _same_state(payload, fresh.payload()),
            "dp_index": trainer.mesh.index(("dcn", "data", "fsdp", "expert")),
            "dp": trainer.dp,
            "foreach": trainer.opt.defaults.get("foreach"),
            "split": {n: tuple(torch.as_tensor(p.to_local() if hasattr(
                p, "to_local") else p).shape)
                for n, p in trainer.model.named_parameters()}}


def classifier_worker(rank, n, out_dir):
    from kubeflow_tpu_torch.parallel import dist as D

    D.initialize_from_env(device="cpu")
    for name, cfg in WORLDS[n].items():
        torch.save(_witness(cfg), os.path.join(out_dir,
                                               f"{name}_rank{rank}.pt"))
    D.shutdown()


@pytest.fixture(scope="module")
def single():
    return {name: _witness({k: v for k, v in cfg.items() if k != "mesh"})
            for layouts in WORLDS.values() for name, cfg in layouts.items()}


def _world(tmp_path_factory, n: int) -> dict:
    root = tmp_path_factory.mktemp(f"cls{n}")
    run_world(n, "test_torch_spmd_classifiers:classifier_worker", root,
              timeout=300)
    return {name: [torch.load(root / f"{name}_rank{r}.pt",
                              weights_only=False) for r in range(n)]
            for name in WORLDS[n]}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _world(tmp_path_factory, 4)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _world(tmp_path_factory, 2)


def _assert_parity(name: str, outs: list[dict], want: dict) -> None:
    for o in outs:
        assert o["roundtrip"], name
        assert o["losses"] == outs[0]["losses"], name
        for step, (a, b) in enumerate(zip(o["losses"], want["losses"])):
            assert abs(a - b) <= TOLS["loss"], (name, "loss", step, a, b)
        for step in range(2):
            for k, v in want["params"][step].items():
                d = float((o["params"][step][k] - v).abs().max())
                assert d <= TOLS["params"], (name, "params", step, k, d)
    d = float((_gather_logits(outs) - want["logits"]).abs().max())
    assert d <= TOLS["logits"], (name, "logits", d)


@pytest.mark.parametrize("name", ["vit_dp_tp", "bert_dp_tp"])
def test_encoders_on_data_and_model_equal_one_process(name, world4, single):
    outs = world4[name]
    _assert_parity(name, outs, single[name])
    split = outs[0]["split"]
    whole = single[name]["split"]
    # the annotations split what they name over model 2
    assert split["layer_0.qkv.weight"][0] * 2 == whole["layer_0.qkv.weight"][0]
    assert split["layer_0.fc1.bias"][0] * 2 == whole["layer_0.fc1.bias"][0]
    assert split["layer_0.fc2.weight"][1] * 2 == whole["layer_0.fc2.weight"][1]
    emb = "head_kernel" if name.startswith("vit") else "embedding"
    assert split[emb] != whole[emb]


@pytest.mark.parametrize("name", ["vit_fsdp", "bert_fsdp", "resnet_fsdp"])
def test_classifiers_on_fsdp_equal_one_process(name, world2, single):
    _assert_parity(name, world2[name], single[name])
    # FSDP2 shards some parameters and leaves the small ones whole: the
    # optimizer cannot take both in one foreach kernel (a CUDA default)
    assert all(o["foreach"] is False for o in world2[name])


def test_resnet_batch_statistics_over_fsdp(world2, single):
    """BatchNorm's statistics after a step on fsdp 2 (each rank holds
    half of the batch) equal one process's over the whole batch."""
    want = single["resnet_fsdp"]["batch_stats"]
    assert want
    for o in world2["resnet_fsdp"]:
        for k, v in want.items():
            np.testing.assert_allclose(o["batch_stats"][k].numpy(),
                                       v.numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
