"""Training benchmarks on one GPU: the port's twins of `bench.py run_lm`
and `run_resnet`.

    python -m kubeflow_tpu_torch.bench [--steps 20] [--warmup 3]
        [--lm-model llama-1b] [--lm-batch 8] [--seq-len 2048]
        [--lm-optimizer adafactor] [--lm-remat | --no-lm-remat]
        [--lm-remat-policy slim] [--lm-xent-chunks 8] [--lm-grad-accum 0]
    python -m kubeflow_tpu_torch.bench --workload resnet [--steps 20]
        [--model resnet50] [--batch 256] [--image-size 224]
        [--stem space_to_depth]

`--workload lm` (the default) runs the operating point
`tools/lm_best.json` pins for the reference: llama-1b, seq 2048, global
batch 8, adafactor, slim remat, 8 xent chunks, flash attention, with the
TrainConfig `run_lm` builds (lr 3e-4, warmup 5, weight_decay left at its
1e-4 default). `--workload resnet` runs `run_resnet`'s: ResNet-50 with
the space_to_depth stem, 224px, batch 256, synthetic images, sgdm with
lr 0.1 and warmup 5. Either way: warm-up steps, then `--steps` steps
timed on the host clock between two `torch.cuda.synchronize` calls, one
batch resident on the card; MFU from the port's StepMeter. Prints one
JSON line with the reference's fields, plus the card and the peak device
memory. Runs on a CUDA device only: without one it raises.
`--resnet-remat full|dots` checkpoints the whole forward, as the
reference's flag (the line then carries `resnet_remat`).
An MoE model (`--lm-model gpt-moe-8e`) adds the reference's moe_fill,
moe_drop and moe_sparse_dispatch keys to the line, read from the last
warm-up step, so the dispatch path that ran is on record.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="lm", choices=["lm", "resnet"])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--model", default="resnet50")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--stem", default="space_to_depth",
                   choices=["space_to_depth", "conv7"])
    p.add_argument("--resnet-remat", default="", choices=["", "full", "dots"],
                   help="checkpoint the whole forward under this policy")
    p.add_argument("--lm-model", default="llama-1b")
    p.add_argument("--lm-batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--lm-attention", default="flash",
                   help="attention_impl: flash | auto | reference")
    p.add_argument("--lm-optimizer", default="adafactor",
                   choices=["adafactor", "adamw", "sgdm"])
    p.add_argument("--lm-remat", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--lm-remat-policy", default="slim",
                   help="full | dots | mlp | slim, or <policy>@<layers>")
    p.add_argument("--lm-xent-chunks", type=int, default=8)
    p.add_argument("--lm-window", type=int, default=0)
    p.add_argument("--lm-grad-accum", type=int, default=0)
    return p.parse_args(argv)


def train_config(args: argparse.Namespace):
    """The TrainConfig of `bench.py run_lm` for these flags."""
    from kubeflow_tpu_torch.runtime.trainer import TrainConfig

    return TrainConfig.from_dict(dict(
        model=args.lm_model,
        model_kwargs={"attention_impl": args.lm_attention,
                      "max_seq_len": args.seq_len,
                      **({"attention_window": args.lm_window}
                         if args.lm_window else {})},
        task="lm",
        global_batch=args.lm_batch,
        seq_len=args.seq_len,
        vocab_size=32000,
        optimizer=args.lm_optimizer,
        learning_rate=3e-4,
        total_steps=args.steps,
        warmup_steps=5,
        remat=args.lm_remat,
        remat_policy=args.lm_remat_policy,
        xent_chunks=args.lm_xent_chunks,
        grad_accum_steps=args.lm_grad_accum,
        log_every=10**9,
    ))


def resnet_config(args: argparse.Namespace):
    """The TrainConfig of `bench.py run_resnet` for these flags."""
    from kubeflow_tpu_torch.runtime.trainer import TrainConfig

    return TrainConfig.from_dict(dict(
        remat=bool(args.resnet_remat),
        remat_policy=args.resnet_remat or "full",
        model=args.model,
        model_kwargs={"stem": args.stem},
        task="classification",
        global_batch=args.batch,
        image_size=args.image_size,
        num_classes=1000,
        optimizer="sgdm",
        learning_rate=0.1,
        total_steps=args.steps,
        warmup_steps=5,
        log_every=10**9,
    ))


def moe_keys(metrics: dict) -> dict:
    """The moe_* step metrics, rounded as the reference's bench rounds
    them (bench.py:178-184)."""
    return {k: round(float(v), 4) for k, v in sorted(metrics.items())
            if k.startswith("moe_")}


def _timed(trainer, steps: int, warmup: int
           ) -> tuple[float, float, str, dict]:
    """Mean step seconds of `steps` chained steps on one resident batch
    after `warmup` steps, the final loss, the card's name and the last
    warm-up step's metrics."""
    import torch

    kind = torch.cuda.get_device_name(trainer.device)
    batch = next(trainer._device_iter(trainer.data_iter()))
    torch.cuda.reset_peak_memory_stats()
    for _ in range(max(1, warmup)):
        m = trainer.train_step(batch)
    warm = {k: float(v) for k, v in m.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        m = trainer.train_step(batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    final_loss = float(m["loss"])
    if not math.isfinite(final_loss):
        raise RuntimeError(f"{trainer.cfg.model} loss is {final_loss}")
    return dt, final_loss, kind, warm


def _mfu(trainer, dt: float, kind: str) -> float | None:
    from kubeflow_tpu_torch.runtime.metrics import StepMeter

    meter = StepMeter(trainer.flops_per_step(), kind)
    meter._times.append(dt)
    return meter.mfu


def run_resnet(args: argparse.Namespace) -> dict:
    import torch

    from kubeflow_tpu_torch.runtime.trainer import Trainer

    trainer = Trainer(resnet_config(args), device="cuda")
    dt, final_loss, kind, _ = _timed(trainer, args.steps, args.warmup)
    mfu = _mfu(trainer, dt, kind)
    return {
        "model": args.model,
        "mfu": None if mfu is None else round(mfu, 4),
        "images_per_sec": round(args.batch / dt, 1),
        "step_time_ms": round(dt * 1e3, 2),
        "global_batch": args.batch,
        "image_size": args.image_size,
        "stem": args.stem,
        **({"resnet_remat": args.resnet_remat} if args.resnet_remat else {}),
        "final_loss": final_loss,
        "device": kind,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def run_lm(args: argparse.Namespace) -> dict:
    import torch

    from kubeflow_tpu_torch.runtime.trainer import Trainer

    trainer = Trainer(train_config(args), device="cuda")
    dt, final_loss, kind, warm = _timed(trainer, args.steps, args.warmup)
    mfu = _mfu(trainer, dt, kind)
    return {
        "model": args.lm_model,
        "attention": args.lm_attention,
        "tokens_per_sec": round(args.lm_batch * args.seq_len / dt),
        "step_time_ms": round(dt * 1e3, 2),
        "seq_len": args.seq_len,
        "global_batch": args.lm_batch,
        "mfu": None if mfu is None else round(mfu, 4),
        "optimizer": args.lm_optimizer,
        "remat": args.lm_remat,
        "remat_policy": args.lm_remat_policy,
        "xent_chunks": args.lm_xent_chunks,
        "grad_accum": args.lm_grad_accum,
        **({"window": args.lm_window} if args.lm_window else {}),
        "n_params_m": round(trainer.n_params / 1e6, 1),
        **moe_keys(warm),
        "final_loss": final_loss,
        "device": kind,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    run = run_resnet if args.workload == "resnet" else run_lm
    print(json.dumps(run(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
