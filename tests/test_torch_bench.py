"""The port's LM bench (kubeflow_tpu_torch/bench.py): its defaults are the
operating point tools/lm_best.json pins, its TrainConfig is the one
`bench.py run_lm` builds, and it refuses to run without a GPU."""

import json
import pathlib

import pytest
import torch

from kubeflow_tpu_torch import bench

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_defaults_are_the_pinned_operating_point():
    best = json.loads((ROOT / "tools" / "lm_best.json").read_text())
    args = bench.parse_args([])
    cfg = bench.train_config(args)
    assert (cfg.model, cfg.seq_len, cfg.global_batch) == (
        best["model"], best["seq_len"], best["global_batch"])
    assert args.lm_attention == best["attention"]
    assert cfg.model_kwargs["attention_impl"] == best["attention"]
    assert (cfg.optimizer, cfg.remat, cfg.remat_policy, cfg.xent_chunks,
            cfg.grad_accum_steps) == (
        best["optimizer"], best["remat"], best["remat_policy"],
        best["xent_chunks"], best["grad_accum"])
    # run_lm's fixed values; weight_decay left at the TrainConfig default
    assert (cfg.learning_rate, cfg.warmup_steps, cfg.weight_decay,
            cfg.vocab_size) == (3e-4, 5, 1e-4, 32000)


def test_flags_reach_the_config():
    cfg = bench.train_config(bench.parse_args([
        "--lm-model", "gpt-125m", "--lm-batch", "4", "--seq-len", "512",
        "--lm-optimizer", "adamw", "--no-lm-remat", "--lm-xent-chunks", "0",
        "--lm-grad-accum", "2", "--lm-window", "128", "--steps", "7"]))
    assert (cfg.model, cfg.global_batch, cfg.seq_len, cfg.optimizer,
            cfg.remat, cfg.xent_chunks, cfg.grad_accum_steps,
            cfg.total_steps) == ("gpt-125m", 4, 512, "adamw", False, 0, 2, 7)
    assert cfg.model_kwargs == {"attention_impl": "flash",
                                "max_seq_len": 512, "attention_window": 128}


def test_bench_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--steps", "1"])


def test_resnet_workload_is_run_resnet_s_config():
    args = bench.parse_args(["--workload", "resnet"])
    cfg = bench.resnet_config(args)
    # bench.py run_resnet's fixed values and defaults
    assert (cfg.model, cfg.task, cfg.global_batch, cfg.image_size,
            cfg.num_classes) == ("resnet50", "classification", 256, 224, 1000)
    assert cfg.model_kwargs == {"stem": "space_to_depth"}
    assert (cfg.optimizer, cfg.learning_rate, cfg.warmup_steps,
            cfg.total_steps, cfg.remat) == ("sgdm", 0.1, 5, 20, False)
    cfg = bench.resnet_config(bench.parse_args([
        "--workload", "resnet", "--model", "resnet18", "--batch", "64",
        "--image-size", "128", "--stem", "conv7", "--steps", "3"]))
    assert (cfg.model, cfg.global_batch, cfg.image_size, cfg.total_steps,
            cfg.model_kwargs) == ("resnet18", 64, 128, 3, {"stem": "conv7"})
    for policy in ("full", "dots"):
        cfg = bench.resnet_config(bench.parse_args([
            "--workload", "resnet", "--resnet-remat", policy]))
        assert (cfg.remat, cfg.remat_policy) == (True, policy)
    with pytest.raises(SystemExit):          # the reference's choices
        bench.parse_args(["--workload", "resnet", "--resnet-remat", "mlp"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.main(["--workload", "resnet", "--steps", "1"])


def test_moe_model_and_its_keys_in_the_line():
    """`--lm-model gpt-moe-8e` builds the reference's MoE config, and the
    line carries the step's moe_* keys as the reference's bench.py
    rounds them (one trainer step of moe-test on the CPU)."""
    from kubeflow_tpu_torch.runtime.trainer import Trainer

    cfg = bench.train_config(bench.parse_args([
        "--lm-model", "gpt-moe-8e", "--lm-batch", "4",
        "--lm-remat-policy", "dots"]))
    assert (cfg.model, cfg.global_batch, cfg.remat_policy) == (
        "gpt-moe-8e", 4, "dots")
    small = bench.train_config(bench.parse_args([
        "--lm-model", "moe-test", "--lm-batch", "2", "--seq-len", "16",
        "--lm-attention", "reference", "--lm-xent-chunks", "0"]))
    small.model_kwargs["dtype"] = "float32"
    small.vocab_size = 256
    trainer = Trainer(small, device="cpu")
    m = trainer.train_step(trainer._to_device(next(trainer.data_iter())))
    keys = bench.moe_keys(m)
    assert set(keys) == {"moe_fill", "moe_drop", "moe_sparse_dispatch"}
    assert keys["moe_sparse_dispatch"] == 1.0
    assert keys["moe_fill"] == round(float(m["moe_fill"]), 4)
    assert bench.moe_keys({"loss": 1.0}) == {}
