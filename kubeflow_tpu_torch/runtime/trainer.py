"""The LM training loop on one device (port of kubeflow_tpu/runtime/trainer.py
for task="lm").

One step: forward through TransformerLM (rematerialized per block under
`remat`), the loss (chunked over the sequence when `xent_chunks` > 1),
backward (over `grad_accum_steps` microbatches when > 1), and an
optimizer update whose learning rate follows the reference's optax
warmup-cosine schedule.

`fit` is the reference's loop: resume from the latest checkpoint, batches
from synthetic data or KFR1 token shards (packed shards bring segment
ids, which reach the flash kernels) through the Prefetcher, periodic
saves and evals, a profiler window, a `stop` flag polled once a step
(preemption), `train.fit` / `train.step` spans and the jaxrt_* gauges.
The first step (kernel builds, allocator warm-up) stays out of the
meter. It returns the reference's summary dict.
"""

from __future__ import annotations

import dataclasses
import glob
import logging
import math
import time
from typing import Callable, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.convert import flax_layout
from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.parallel.mesh import MeshSpec
from kubeflow_tpu_torch.runtime import metrics as rt_metrics
from kubeflow_tpu_torch.runtime.data import synthetic_tokens
from kubeflow_tpu_torch.runtime.optim import Adafactor

log = logging.getLogger("kubeflow_tpu_torch.trainer")


@dataclasses.dataclass
class TrainConfig:
    """Declarative training config: the reference's keys and defaults, so
    the same JSON/YAML loads. A task the port lacks yet raises in
    Trainer, naming its ROADMAP item; a mesh above one device raises in
    MeshSpec."""

    model: str = "resnet50"
    model_kwargs: dict = dataclasses.field(default_factory=dict)
    task: str = "classification"
    global_batch: int = 32
    image_size: int = 224
    num_classes: int = 1000
    seq_len: int = 1024
    vocab_size: int = 32000
    mesh: MeshSpec = dataclasses.field(default_factory=MeshSpec)
    optimizer: str = "sgdm"       # sgdm | adamw | adafactor
    learning_rate: float = 0.1
    weight_decay: float = 1e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    remat: bool = False
    remat_policy: str = "full"
    pp_microbatches: int = 4
    aux_loss_weight: float = 0.01
    xent_chunks: int = 0
    grad_accum_steps: int = 0
    seed: int = 0
    log_every: int = 20
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0
    checkpoint_keep: int = 3
    resume: bool = True
    data_path: str | None = None
    shuffle_buffer: int = 0
    packed_data: bool = False
    eval_every: int = 0
    eval_steps: int = 8
    eval_data_path: str | None = None
    flash_block_q: int = 0
    flash_block_k: int = 0
    profile_dir: str | None = None
    profile_start_step: int = 2
    profile_steps: int = 3

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        d = dict(d)
        if "mesh" in d and not isinstance(d["mesh"], MeshSpec):
            d["mesh"] = MeshSpec.from_dict(d["mesh"])
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown TrainConfig keys {sorted(unknown)}")
        return cls(**d)


def _unported(cfg: TrainConfig) -> str | None:
    """The first config feature the port lacks, with its ROADMAP item."""
    if cfg.task != "lm":
        return f"task={cfg.task!r} (ROADMAP Queue 1, slice 5)"
    return None


def warmup_cosine_lr(step: int, cfg: TrainConfig) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total,
    warmup + 1)) at update count `step` (0 for the first update, which
    therefore runs at lr 0)."""
    peak, warmup = cfg.learning_rate, cfg.warmup_steps
    decay = max(cfg.total_steps, warmup + 1) - warmup
    if step < warmup:
        return peak * step / warmup
    count = min(step - warmup, decay)
    return peak * 0.5 * (1.0 + math.cos(math.pi * count / decay))


def make_optimizer(cfg: TrainConfig, params,
                   layouts=None) -> torch.optim.Optimizer:
    """adamw: b1 .9, b2 .95, eps 1e-8, decoupled decay on every param
    (optax.adamw). sgdm: decay added to the gradient, then nesterov
    momentum .9 (optax add_decayed_weights + sgd). adafactor: optax's, as
    the reference builds it (runtime/optim.py), factoring each parameter
    in its reference shape, which `layouts` (one (view, perm) per
    parameter, `convert.flax_layout`) gives. The learning rate is set
    from warmup_cosine_lr before each update."""
    params = list(params)
    if cfg.optimizer == "sgdm":
        return torch.optim.SGD(params, lr=0.0, momentum=0.9, nesterov=True,
                               weight_decay=cfg.weight_decay)
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.95), eps=1e-8,
                                 weight_decay=cfg.weight_decay)
    if cfg.optimizer == "adafactor":
        return Adafactor(params, layouts=layouts,
                         weight_decay=cfg.weight_decay or None)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def _masked_accuracy(pred: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """argmax hit-rate over valid (non-negative) labels only."""
    valid = labels >= 0
    return ((pred == labels) & valid).sum() / valid.sum().clamp_min(1)


def _xent_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Integer-label cross entropy in f32, mean over valid positions;
    negative labels are ignored."""
    valid = labels >= 0
    ce = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                         labels.clamp_min(0).reshape(-1).long(),
                         reduction="none").view(labels.shape)
    return (ce * valid).sum() / valid.sum().clamp_min(1)


class Trainer:
    """Builds the model and optimizer from a TrainConfig, on `device`
    (cuda unless "cpu" is asked for)."""

    def __init__(self, cfg: TrainConfig, device=None):
        missing = _unported(cfg)
        if missing:
            raise NotImplementedError(f"not ported yet: {missing}")
        self.accum = max(1, cfg.grad_accum_steps)
        if cfg.global_batch % self.accum:
            raise ValueError(
                f"global_batch {cfg.global_batch} not divisible by "
                f"grad_accum_steps {self.accum}")
        self.cfg = cfg
        self.device = resolve_device(device)
        kw = dict(cfg.model_kwargs)
        # the model remats per block (models/transformer.py), as the
        # reference's LM does
        if cfg.remat:
            kw.setdefault("remat", True)
            kw.setdefault("remat_policy", cfg.remat_policy)
        if cfg.flash_block_q:
            kw.setdefault("flash_block_q", cfg.flash_block_q)
        if cfg.flash_block_k:
            kw.setdefault("flash_block_k", cfg.flash_block_k)
        # synthetic targets draw from cfg.vocab_size: the head must match
        kw.setdefault("vocab_size", cfg.vocab_size)
        self.model = get_model(cfg.model, device=self.device, seed=cfg.seed,
                               **kw)
        self.n_params = sum(p.numel() for p in self.model.parameters())
        head_dim = self.model.cfg.head_dim
        named = list(self.model.named_parameters())
        self.opt = make_optimizer(
            cfg, [p for _, p in named],
            layouts=[flax_layout(n, p.shape, head_dim) for n, p in named])
        self.step = 0          # optimizer updates applied so far

    def data_iter(self, data_path: str | None = None,
                  seed: int | None = None) -> Iterator[dict]:
        """Host batches: KFR1 token shards matching `data_path` (default
        cfg.data_path; packed shards add segment_ids and -1 targets at
        padding and document boundaries), else synthetic tokens."""
        cfg = self.cfg
        data_path = data_path if data_path is not None else cfg.data_path
        seed = seed if seed is not None else cfg.seed
        if data_path:
            from kubeflow_tpu_torch.runtime.records import token_batches

            paths = sorted(glob.glob(data_path))
            if not paths:
                raise FileNotFoundError(f"no shards match {data_path!r}")
            return token_batches(paths, cfg.global_batch, cfg.seq_len,
                                 shuffle_buffer=cfg.shuffle_buffer,
                                 seed=seed, loop=True,
                                 segmented=cfg.packed_data)
        return synthetic_tokens(cfg.global_batch, cfg.seq_len, cfg.vocab_size,
                                seed)

    def eval_data_iter(self) -> Iterator[dict]:
        """Held-out batches: eval_data_path shards when given, else the
        training source at a shifted seed (a smoke eval, not held-out)."""
        cfg = self.cfg
        return self.data_iter(data_path=cfg.eval_data_path or cfg.data_path,
                              seed=cfg.seed + 1)

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.from_numpy(np.array(a)).to(self.device)
                for k, a in batch.items()}

    def _device_iter(self, it: Iterator[dict]) -> Iterator[dict]:
        """Copy each distinct host batch to the device once: the synthetic
        iterator yields the same arrays every step."""
        last_key, last_val = None, None
        for b in it:
            key = tuple(id(a) for a in b.values())
            if key != last_key:
                last_val = self._to_device(b)
                last_key = key
            yield last_val

    # -- checkpoint payload --------------------------------------------------

    def payload(self) -> dict:
        """The training state as the checkpoint payload (live device
        tensors; runtime/checkpoint.py copies them to the host): the
        update count, the model's state_dict, no batch stats, and each
        parameter's optimizer state by parameter name."""
        state = {n: self.opt.state[p]
                 for n, p in self.model.named_parameters()
                 if p in self.opt.state}
        return {"step": self.step, "params": self.model.state_dict(),
                "batch_stats": {}, "opt_state": state}

    def load_payload(self, payload: dict) -> None:
        """Load a checkpoint payload into the model and the optimizer
        (rebuilt from the config: only its state is data)."""
        self.model.load_state_dict(payload["params"], strict=True)
        names = [n for n, _ in self.model.named_parameters()]
        opt_state = payload.get("opt_state") or {}
        unknown = set(opt_state) - set(names)
        if unknown:
            raise ValueError(f"optimizer state for unknown parameters "
                             f"{sorted(unknown)[:5]}")
        groups = self.opt.state_dict()["param_groups"]
        self.opt.load_state_dict({
            "state": {i: opt_state[n] for i, n in enumerate(names)
                      if n in opt_state},
            "param_groups": groups})
        self.step = int(payload["step"])

    def loss(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """(loss, accuracy) of one batch, differentiable in the loss."""
        cfg = self.cfg
        x, y = batch["tokens"], batch["targets"]
        seg = batch.get("segment_ids")
        if cfg.xent_chunks > 1:
            from kubeflow_tpu_torch.ops.xent import chunked_lm_xent

            hidden = self.model(x, segment_ids=seg, return_hidden=True)
            return chunked_lm_xent(hidden, self.model.lm_head.kernel, y,
                                   cfg.xent_chunks,
                                   compute_dtype=self.model.cfg.dtype)
        logits = self.model(x, segment_ids=seg)
        return _xent_loss(logits, y), _masked_accuracy(logits.argmax(-1), y)

    def train_step(self, batch: dict) -> dict:
        """One update. Returns {"loss", "accuracy"} as device scalars."""
        self.opt.zero_grad(set_to_none=True)
        if self.accum > 1:
            loss, acc = self._accumulate(batch)
        else:
            loss, acc = self.loss(batch)
            loss.backward()
        lr = warmup_cosine_lr(self.step, self.cfg)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.step += 1
        return {"loss": loss.detach(), "accuracy": acc.detach()}

    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict:
        """{"loss", "accuracy"} of one batch in eval mode, as device
        scalars; the chunked head when training chunks it (a config that
        only fits because of the chunks must not run out of memory at
        its first eval)."""
        was_training = self.model.training
        self.model.eval()
        try:
            loss, acc = self.loss(batch)
        finally:
            self.model.train(was_training)
        return {"loss": loss, "accuracy": acc}

    def _accumulate(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """The gradients of `accum` microbatches in the parameters' .grad,
        as the reference's train_step_accum combines them: row r goes to
        microbatch r % accum; each microbatch's loss is the mean over its
        valid (>= 0) targets and weighs by its valid count n_i, so grads =
        sum(g_i n_i) / max(sum(n_i), 1), the full batch's token-weighted
        mean however unevenly the targets are masked. Returns the loss and
        accuracy combined with the same weights."""
        loss_sum = acc_sum = n_sum = 0.0
        for m in range(self.accum):
            micro = {k: v[m::self.accum] for k, v in batch.items()}
            loss, acc = self.loss(micro)
            n = (micro["targets"] >= 0).sum().float()
            (loss * n).backward()
            loss_sum = loss_sum + loss.detach() * n
            acc_sum = acc_sum + acc.detach() * n
            n_sum = n_sum + n
        n = n_sum.clamp_min(1.0)
        for p in self.model.parameters():
            if p.grad is not None:
                p.grad = (p.grad / n).to(p.dtype)
        return loss_sum / n, acc_sum / n

    def flops_per_step(self) -> float:
        """Analytic train-step FLOPs (2 per MAC, train = 3x forward)."""
        cfg = self.cfg
        return (self.model.flops_per_token(seq_len=cfg.seq_len)
                * cfg.global_batch * cfg.seq_len)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self, steps: int | None = None,
            callback: Callable[[int, dict], None] | None = None,
            stop: Callable[[], bool] | None = None) -> dict:
        """Run the loop to the global step target `steps` (default
        total_steps); return the summary: steps, start_step, step_time_s,
        examples_per_sec, mfu, final, and "preempted" / "eval" when they
        apply.

        With cfg.checkpoint_dir and cfg.resume, training resumes from
        the latest checkpoint and runs only the remaining steps; real
        data then skips the batches the earlier run consumed, so the
        resumed run sees the batches an uninterrupted one would. `stop`
        is polled once per step (runtime.preemption's SIGTERM notice):
        when it returns True the loop saves the step (unless it is saved
        already) and returns early with summary["preempted"] = True."""
        from kubeflow_tpu_torch.obs import trace as obs_trace

        cfg = self.cfg
        steps = steps or cfg.total_steps
        ckpt = None
        if cfg.checkpoint_dir:
            from kubeflow_tpu_torch.runtime.checkpoint import Checkpointer

            ckpt = Checkpointer(cfg.checkpoint_dir, keep=cfg.checkpoint_keep,
                                world_size=1, num_slices=1)
            if cfg.resume:
                try:
                    # loads into self; the host copy is not kept
                    restored = ckpt.restore_latest(self) is not None
                except BaseException:
                    ckpt.close()
                    raise
                if restored:
                    log.info("resumed from checkpoint at step %d", self.step)
        start_step = self.step
        if start_step >= steps:
            # the target is reached already: a no-op run, same schema
            if ckpt:
                ckpt.close()
            return {"steps": steps, "start_step": start_step,
                    "step_time_s": None, "examples_per_sec": 0.0,
                    "mfu": 0.0, "final": {}}

        kind = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "")
        # each metered step is a train.step span; metering starts after
        # the first step, hence the +1 global-step base
        meter = rt_metrics.StepMeter(self.flops_per_step(), kind,
                                     tracer=obs_trace.TRACER,
                                     step_base=start_step + 1)
        last: dict = {}
        last_saved = -1
        last_eval: dict = {}
        first_dt = float("nan")

        def maybe_save(gstep: int) -> None:
            nonlocal last_saved
            if ckpt and cfg.checkpoint_every and gstep % cfg.checkpoint_every == 0:
                if ckpt.save(gstep, self.payload()):
                    last_saved = gstep

        def maybe_eval(gstep: int) -> None:
            # a FRESH iterator per eval scores the same leading window
            # every time, so the metric compares across steps
            nonlocal last_eval
            if not (cfg.eval_every and gstep % cfg.eval_every == 0):
                return
            eval_iter = iter(self.eval_data_iter())
            sums: dict = {}
            try:
                for _ in range(max(1, cfg.eval_steps)):
                    m = self.eval_step(self._to_device(next(eval_iter)))
                    for k, v in m.items():
                        sums[k] = sums.get(k, 0.0) + float(v)
            finally:
                if hasattr(eval_iter, "close"):
                    eval_iter.close()    # a native reader's thread
            last_eval = {k: v / max(1, cfg.eval_steps) for k, v in sums.items()}
            last_eval["perplexity"] = math.exp(min(last_eval["loss"], 30.0))
            # without eval_data_path this reads the TRAINING source at a
            # shifted seed: marked so it is not taken for held-out numbers
            smoke = not cfg.eval_data_path
            last_eval["smoke"] = float(smoke)
            what = "training-data smoke eval" if smoke else "held-out eval"
            for k, v in last_eval.items():
                rt_metrics.REGISTRY.gauge(f"jaxrt_eval_{k}", v, f"{what} {k}")
            log.info("%s @ step %d: %s", what, gstep,
                     " ".join(f"{k}={v:.4f}" for k, v in sorted(last_eval.items())))

        from kubeflow_tpu_torch.runtime.profiler import TraceWindow

        trace = TraceWindow(cfg.profile_dir, cfg.profile_start_step,
                            cfg.profile_steps)
        ok = preempted = False
        data = None
        # nest under the caller's span (the launcher's "worker"), else
        # under the pod's TRACEPARENT, else start a new trace
        fit_span = obs_trace.TRACER.begin(
            "train.fit",
            parent=obs_trace.TRACER.current() or obs_trace.context_from_env(),
            model=cfg.model, global_batch=cfg.global_batch,
            start_step=start_step, steps=steps)
        self.model.train()
        try:
            # inside the try: a glob that matches nothing still closes
            # the checkpointer on the way out
            if cfg.data_path:
                from kubeflow_tpu_torch.runtime.data import Prefetcher

                it = self.data_iter()
                for _ in range(start_step):
                    next(it)     # the batches of the steps before the resume
                data = Prefetcher(it, self.device)
            else:
                data = self._device_iter(self.data_iter())
            for i in range(steps - start_step):
                if stop is not None and stop():
                    preempted = True
                    # no force: a step that is on disk already (resumed
                    # at N, preempted before N+1) stays as it is
                    if ckpt and self.step != last_saved:
                        if ckpt.save(self.step, self.payload()):
                            last_saved = self.step
                    log.warning("preempted at step %d: checkpoint saved, "
                                "exiting early", self.step)
                    break
                trace.step(start_step + i)
                batch = next(data)
                if i == 0:
                    # the first step builds kernels and warms the
                    # allocator: kept out of the meter window
                    t0 = time.perf_counter()
                    with obs_trace.TRACER.span("train.step", step=start_step,
                                               compile=True):
                        m = self.train_step(batch)
                        self._sync()
                    first_dt = time.perf_counter() - t0
                    log.info("first step (incl. kernel build): %.2fs", first_dt)
                    last = {k: float(v) for k, v in m.items()}
                else:
                    meter.start()
                    m = self.train_step(batch)
                    self._sync()
                    meter.stop()
                    if (i + 1) % cfg.log_every == 0 or i == steps - start_step - 1:
                        last = {k: float(v) for k, v in m.items()}
                        self._publish(meter, last)
                        mfu = meter.mfu
                        log.info("step %d loss=%.4f acc=%.3f %.1f ex/s "
                                 "step=%.1fms%s", start_step + i + 1,
                                 last["loss"], last["accuracy"],
                                 meter.throughput(cfg.global_batch),
                                 meter.step_time * 1e3,
                                 "" if mfu is None else f" mfu={mfu * 100:.1f}%")
                maybe_save(start_step + i + 1)
                maybe_eval(start_step + i + 1)
                if callback:
                    callback(i, m)
            ok = True
        finally:
            try:
                meter.close()  # a step that raised still exports, as ERROR
                trace.stop()
                if hasattr(data, "close"):
                    data.close()
                if ckpt:
                    # the final save only on a completed run: the stop
                    # branch saved the preempted step already. Always
                    # close, so a queued write lands even when unwinding
                    # on an exception.
                    try:
                        if ok and not preempted and self.step != last_saved:
                            ckpt.save(self.step, self.payload(), force=True)
                    finally:
                        ckpt.close()
            except BaseException:
                ok = False
                raise
            finally:
                # the final save and its write are inside train.fit
                fit_span.attrs["preempted"] = preempted
                if not ok and fit_span.status == "OK":
                    fit_span.status = "ERROR"
                obs_trace.TRACER.finish(fit_span)
        if meter.steps == 0 and math.isfinite(first_dt):
            meter._times.append(first_dt)   # single-step run

        def finite(x):
            # the launcher json.dumps the summary: bare NaN is not JSON
            return x if x is not None and math.isfinite(x) else None

        summary = {
            "steps": steps,
            "start_step": start_step,
            "step_time_s": finite(meter.step_time),
            "examples_per_sec": finite(meter.throughput(cfg.global_batch)),
            "mfu": finite(meter.mfu),
            "final": {k: finite(v) for k, v in last.items()},
        }
        if preempted:
            summary["preempted"] = True
        if last_eval:
            summary["eval"] = {k: finite(v) for k, v in last_eval.items()}
        return summary

    def _publish(self, meter: rt_metrics.StepMeter, last: dict) -> None:
        """The jaxrt_* gauges controllers and dashboards read (the
        reference's names)."""
        reg = rt_metrics.REGISTRY
        reg.gauge("jaxrt_step_seconds", meter.step_time, "mean step wall time")
        reg.gauge("jaxrt_examples_per_sec",
                  meter.throughput(self.cfg.global_batch), "training throughput")
        if meter.mfu is not None:
            reg.gauge("jaxrt_mfu", meter.mfu, "model FLOPs utilization")
        reg.gauge("jaxrt_loss", last["loss"], "training loss")
