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
