"""The training loop on one device (port of kubeflow_tpu/runtime/trainer.py).

Tasks, as the reference's `_batch_xy` selects them: `lm` (TransformerLM,
next-token targets), `classification` (images and labels: ResNet, ViT)
and `seq_classification` (tokens and one label per sequence: BERT).
One step: the forward (an LM rematerialized per block under `remat`, a
classifier's whole forward checkpointed under `remat` with the
reference's dots|full policies, BatchNorm's running statistics moving
once), the loss (an LM's chunked over the sequence when `xent_chunks` > 1),
backward (over `grad_accum_steps` microbatches when > 1), and an
optimizer update whose learning rate follows the reference's optax
warmup-cosine schedule. A ResNet's BatchNorm statistics move with each
training forward and travel in the checkpoint payload's `batch_stats`,
as the reference keeps them beside `params`.

`fit` is the reference's loop: resume from the latest checkpoint, batches
from synthetic data or KFR1 token or image shards (packed token shards
bring segment ids, which reach the flash kernels) through the Prefetcher, periodic
saves and evals, a profiler window and the on-demand capture's windows
(runtime/profiler.py), a `stop` flag polled once a step
(preemption), `train.fit` / `train.step` spans and the jaxrt_* gauges.
The first step (kernel builds, allocator warm-up) stays out of the
meter. It returns the reference's summary dict.

On a mesh (`TrainConfig.mesh`, built through the collectives backend
over the process group's world; parallel/mesh.py) every rank builds the
same model from the seed, then keeps its shards (parallel/shardings.py:
tensor parallelism over `model`, FSDP2 over `fsdp`). Every rank draws
the same global batch and keeps its contiguous block of rows over the
batch axes, as each JAX process `device_put`s the global array under
the batch sharding; microbatches are strided within it. The loss and
its gradient are those of the global mean over valid targets: each
rank's gradient weighs by its valid count, the backend's
`hierarchical_reduce` sums them over the batch axes, and the sum is
divided by the all-reduced count. Eval metrics are global, the stop
flag is agreed over the world every step (any rank's stop stops all at
that step), and the checkpoint holds the whole state, written by rank 0.

The other axes: `seq` cuts every row of tokens into blocks of
positions, one per rank of a seq group (the LM's ring or Ulysses
attention spans them, its local impls and BERT's attention gather K/V
over the group), and the loss sums over seq as over the batch axes;
images and labels, as the reference's batch spec, replicate over seq
(each gradient then sums over seq and divides by the count summed
there too); `expert`
shards the batch and the MoE experts (parallel/shardings.py
`apply_moe`); `pipe` runs the GPipe schedule over stages
(parallel/pipeline.py), the last stage taking the loss. MoE blocks add
`aux_loss_weight` times their load-balancing losses (summed over the
layers, as the reference's loss) and report `moe_fill`, `moe_drop` and
`moe_sparse_dispatch` in the step metrics, averaged over the layers and
weighted by valid targets across microbatches.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import glob
import logging
import math
import time
from typing import Callable, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.convert import flax_layout, flax_shape
from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.models.resnet import BatchNorm
from kubeflow_tpu_torch.parallel import shardings as S
from kubeflow_tpu_torch.parallel.mesh import (
    AXIS_DCN,
    AXIS_FSDP,
    AXIS_MODEL,
    AXIS_PIPELINE,
    AXIS_SEQ,
    BATCH_AXES,
    Mesh,
    MeshSpec,
    axis_group,
    local_batch_size,
    mesh_summary,
)
from kubeflow_tpu_torch.runtime import metrics as rt_metrics
from kubeflow_tpu_torch.runtime.data import (
    synthetic_images,
    synthetic_token_classes,
    synthetic_tokens,
)
from kubeflow_tpu_torch.runtime.optim import Adafactor, factored_dims

log = logging.getLogger("kubeflow_tpu_torch.trainer")


@dataclasses.dataclass
class TrainConfig:
    """Declarative training config: the reference's keys and defaults, so
    the same JSON/YAML loads. A feature the port lacks yet raises in
    Trainer, naming its ROADMAP item."""

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


TASKS = ("classification", "seq_classification", "lm")


# a classifier's whole-forward remat policies (the reference's
# jax.checkpoint policies: nothing_saveable, dots_with_no_batch_dims_saveable)
CLASSIFIER_REMAT = ("full", "dots")


def _save_dots(ctx, func, *args, **kwargs):
    """`dots` for a classifier: the outputs of plain linear GEMMs
    (F.linear's mm/addmm), as jax's dots_with_no_batch_dims_saveable
    saves dot_generals without batch dims; no convolution (not a
    dot_general) and no bmm (batch dims)."""
    from torch.utils.checkpoint import CheckpointPolicy

    if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_contexts(policy: str):
    """(forward, recompute) contexts of a classifier's checkpointed
    forward: under `dots` the selective-checkpoint pair; the recompute
    leaves BatchNorm's running statistics where the forward moved them."""
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    from kubeflow_tpu_torch.models.resnet import frozen_batch_stats

    fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
    if policy == "dots":
        fwd, rec = create_selective_checkpoint_contexts(_save_dots)

    @contextlib.contextmanager
    def replay():
        with rec, frozen_batch_stats():
            yield

    return fwd, replay()


def _batch_xy(cfg: TrainConfig, batch: dict):
    """Input and target of a batch, per task (the reference's)."""
    if cfg.task == "classification":
        return batch["image"], batch["label"]
    if cfg.task == "seq_classification":
        return batch["tokens"], batch["label"]
    return batch["tokens"], batch["targets"]


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


def make_optimizer(cfg: TrainConfig, params, layouts=None, shards=None,
                   global_shapes=None) -> torch.optim.Optimizer:
    """adamw: b1 .9, b2 .95, eps 1e-8, decoupled decay on every param
    (optax.adamw). sgdm: decay added to the gradient, then nesterov
    momentum .9 (optax add_decayed_weights + sgd). adafactor: optax's, as
    the reference builds it (runtime/optim.py), factoring each parameter
    in its reference shape, which `layouts` (one (view, perm) per
    parameter, `convert.flax_layout`) gives, with its statistics over
    the whole parameter on a mesh (`shards`, `global_shapes`). The
    learning rate is set from warmup_cosine_lr before each update."""
    params = list(params)
    # the foreach kernels take plain tensors or DTensors (FSDP2's shards),
    # not a mix: a mesh that leaves some parameters whole updates them
    # one by one
    mixed = len({hasattr(p, "to_local") for p in params}) > 1
    foreach = False if mixed else None
    if cfg.optimizer == "sgdm":
        return torch.optim.SGD(params, lr=0.0, momentum=0.9, nesterov=True,
                               weight_decay=cfg.weight_decay, foreach=foreach)
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.95), eps=1e-8,
                                 weight_decay=cfg.weight_decay,
                                 foreach=foreach)
    if cfg.optimizer == "adafactor":
        return Adafactor(params, layouts=layouts,
                         weight_decay=cfg.weight_decay or None,
                         shards=shards, global_shapes=global_shapes)
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


class _World:
    """The world-wide collectives of the loop: the gang-agreed stop and
    the checkpoint's agreement on rank 0's status (runtime/checkpoint.py)."""

    def __init__(self, device: torch.device):
        import torch.distributed as dist

        self._dist = dist
        self.device = device
        self.rank, self.size = dist.get_rank(), dist.get_world_size()

    def stop(self, local_stop: Callable[[], bool]) -> Callable[[], bool]:
        """Every poll all-reduces (max) the local flag over the world: a
        stop on any rank stops every rank at the same step."""
        def agreed() -> bool:
            flag = torch.tensor([float(bool(local_stop()))],
                                device=self.device)
            self._dist.all_reduce(flag, op=self._dist.ReduceOp.MAX)
            return bool(flag.item())

        return agreed

    def agree(self, status: int) -> int:
        """Rank 0's status on every rank."""
        t = torch.tensor([float(status)], device=self.device)
        self._dist.broadcast(t, src=0)
        return int(t.item())


class Trainer:
    """Builds the model and optimizer from a TrainConfig, on `device`
    (the active world's device, else cuda unless "cpu" is asked for),
    over `mesh` (default: the collectives backend's mesh of cfg.mesh
    over the process group's world)."""

    def __init__(self, cfg: TrainConfig, device=None, mesh: Mesh | None = None):
        from kubeflow_tpu_torch.parallel import backends as B
        from kubeflow_tpu_torch.parallel import dist as D

        if cfg.task not in TASKS:
            raise ValueError(f"unknown task {cfg.task!r} ({' | '.join(TASKS)})")
        if cfg.task != "lm" and cfg.remat \
                and cfg.remat_policy not in CLASSIFIER_REMAT:
            raise ValueError(
                f"remat_policy {cfg.remat_policy!r} is not supported for "
                f"task={cfg.task!r} (whole-forward remat takes dots|full)")
        if cfg.task == "seq_classification" and cfg.data_path:
            raise ValueError("seq_classification trains on synthetic "
                             "batches: token shards carry no labels")
        self.accum = max(1, cfg.grad_accum_steps)
        if cfg.global_batch % self.accum:
            raise ValueError(
                f"global_batch {cfg.global_batch} not divisible by "
                f"grad_accum_steps {self.accum}")
        self.cfg = cfg
        self.device = resolve_device(
            device if device is not None else D.active_device())
        self.backend = D.active_backend() or B.get_backend()
        self.mesh = mesh if mesh is not None else self.backend.mesh(
            cfg.mesh, self.device.type)
        log.info("trainer mesh: %s", mesh_summary(self.mesh))
        self.dp = self._dp_size()
        local_batch_size(self.mesh, cfg.global_batch)
        if self.accum > 1 and (cfg.global_batch // self.accum) % self.dp:
            raise ValueError(
                f"microbatch {cfg.global_batch // self.accum} not divisible "
                f"by the {self.dp}-way batch sharding (dcn*data*fsdp*expert)")
        sharded = self.mesh.shape[AXIS_FSDP] > 1 or \
            self.mesh.shape[AXIS_MODEL] > 1
        if self.mesh.shape[AXIS_PIPELINE] > 1:
            if cfg.task != "lm":
                raise ValueError("pipeline parallelism (mesh.pipe > 1) is "
                                 "only supported for transformer LM tasks")
            if cfg.global_batch % cfg.pp_microbatches:
                raise ValueError(
                    f"global_batch {cfg.global_batch} not divisible by "
                    f"pp_microbatches {cfg.pp_microbatches}")
        self.seq = axis_group(self.mesh, (AXIS_SEQ,))
        if self.seq is not None and cfg.task != "classification":
            if cfg.seq_len % self.seq.size:
                raise ValueError(f"seq_len {cfg.seq_len} not divisible by "
                                 f"the seq axis {self.seq.size}")
        # every rank draws the same weights from the seed, then keeps its
        # shards of them
        self.model = get_model(cfg.model, device=self.device, seed=cfg.seed,
                               **self._model_kwargs())
        self.n_params = sum(p.numel() for p in self.model.parameters())
        head_dim = getattr(self.model.cfg, "head_dim", None)
        full = {n: tuple(p.shape) for n, p in self.model.named_parameters()}
        self._full_names = list(full)
        self.plan = (S.shard_plan(self.model, self.mesh)
                     if self.mesh.size > 1 else None)
        self._reduce_span = None     # (span, start, end) of the last reduce
        pipe = axis_group(self.mesh, (AXIS_PIPELINE,))
        self.gpipe = None
        if pipe is not None:
            from kubeflow_tpu_torch.parallel import pipeline as PL

            PL.apply_pipeline(self.model, pipe)
            self.gpipe = PL.GPipe(self.model, pipe)
        if sharded:
            S.apply_tensor_parallel(self.model, self.plan, self.mesh)
            S.apply_fsdp(self.model, self.plan, self.mesh)
        self._moe = []
        if cfg.task != "classification":
            S.apply_seq(self.model, self.seq)
        if cfg.task == "lm":
            S.apply_moe(self.model, self.plan, self.mesh)
            self._moe = self.model.moe_blocks()
        # the loss and its valid count sum over every rank that holds a
        # part of the global batch's positions
        self._sum_group = self.mesh.group(BATCH_AXES + (AXIS_SEQ,
                                                        AXIS_PIPELINE))
        if self.dp > 1:
            group = self.mesh.group(BATCH_AXES)
            for mod in self.model.modules():
                if isinstance(mod, BatchNorm):   # global statistics
                    mod.group = group
        named = list(self.model.named_parameters())
        self.opt = make_optimizer(
            cfg, [p for _, p in named],
            layouts=[flax_layout(n, S.unwrap(p).shape, head_dim)
                     for n, p in named],
            shards=[[(d, self.mesh.group((a,))) for d, a in
                     self.plan[n].flax] if self.plan else []
                    for n, _ in named],
            global_shapes=[flax_shape(n, full[n], head_dim)
                           for n, _ in named])
        self.world = _World(self.device) if self.mesh.size > 1 else None
        self.step = 0          # optimizer updates applied so far

    def _dp_size(self) -> int:
        """Ways the batch axis is sharded (dcn * data * fsdp * expert)."""
        return self.mesh.extent(BATCH_AXES)

    def _model_kwargs(self) -> dict:
        """The model's kwargs: the config's, plus what the reference's
        _model_kwargs adds per task."""
        cfg = self.cfg
        kw = dict(cfg.model_kwargs)
        if cfg.task == "lm":
            # the model remats per block (models/transformer.py), as the
            # reference's LM does
            if cfg.remat:
                kw.setdefault("remat", True)
                kw.setdefault("remat_policy", cfg.remat_policy)
            if cfg.flash_block_q:
                kw.setdefault("flash_block_q", cfg.flash_block_q)
            if cfg.flash_block_k:
                kw.setdefault("flash_block_k", cfg.flash_block_k)
            # synthetic targets draw from cfg.vocab_size: the head must
            # match
            kw.setdefault("vocab_size", cfg.vocab_size)
            pipe = self.mesh.shape[AXIS_PIPELINE]
            if pipe > 1:
                kw.setdefault("pipeline_stages", pipe)
                kw.setdefault("pp_microbatches", cfg.pp_microbatches)
            return kw
        # labels draw from cfg.num_classes: a head of another size would
        # see labels out of range
        if kw.get("num_classes", cfg.num_classes) != cfg.num_classes:
            raise ValueError(
                f"model_kwargs.num_classes={kw['num_classes']} conflicts "
                f"with num_classes={cfg.num_classes}; set the top-level "
                "num_classes only")
        kw.setdefault("num_classes", cfg.num_classes)
        return kw

    def data_iter(self, data_path: str | None = None,
                  seed: int | None = None) -> Iterator[dict]:
        """Host batches: KFR1 shards matching `data_path` (default
        cfg.data_path): image shards for classification, token shards
        for the LM (packed shards add segment_ids and -1 targets at
        padding and document boundaries); else the task's synthetic
        batches."""
        cfg = self.cfg
        data_path = data_path if data_path is not None else cfg.data_path
        seed = seed if seed is not None else cfg.seed
        if data_path:
            from kubeflow_tpu_torch.runtime.records import (
                image_batches,
                token_batches,
            )

            paths = sorted(glob.glob(data_path))
            if not paths:
                raise FileNotFoundError(f"no shards match {data_path!r}")
            if cfg.task == "classification":
                return image_batches(paths, cfg.global_batch, cfg.image_size,
                                     shuffle_buffer=cfg.shuffle_buffer,
                                     seed=seed, loop=True)
            return token_batches(paths, cfg.global_batch, cfg.seq_len,
                                 shuffle_buffer=cfg.shuffle_buffer,
                                 seed=seed, loop=True,
                                 segmented=cfg.packed_data)
        if cfg.task == "classification":
            return synthetic_images(cfg.global_batch, cfg.image_size,
                                    cfg.num_classes, seed)
        if cfg.task == "seq_classification":
            return synthetic_token_classes(cfg.global_batch, cfg.seq_len,
                                           cfg.vocab_size, cfg.num_classes,
                                           seed)
        return synthetic_tokens(cfg.global_batch, cfg.seq_len, cfg.vocab_size,
                                seed)

    def eval_data_iter(self) -> Iterator[dict]:
        """Held-out batches: eval_data_path shards when given, else the
        training source at a shifted seed (a smoke eval, not held-out)."""
        cfg = self.cfg
        return self.data_iter(data_path=cfg.eval_data_path or cfg.data_path,
                              seed=cfg.seed + 1)

    def _shard(self, batch: dict) -> dict:
        """This rank's contiguous block of rows of a global host batch
        (its index over the batch axes) and, under a seq group, its block
        of positions of each row of tokens (LM targets are built before
        the cut; a sequence's label and an image replicate over seq)."""
        if self.dp > 1:
            i = self.mesh.index(BATCH_AXES)
            batch = {k: a[i * len(a) // self.dp:(i + 1) * len(a) // self.dp]
                     for k, a in batch.items()}
        if self.seq is not None and self.cfg.task != "classification":
            r, n = self.seq.rank, self.seq.size
            cut = (set(batch) if self.cfg.task == "lm" else {"tokens"})
            batch = {k: a[:, r * a.shape[1] // n:(r + 1) * a.shape[1] // n]
                     if k in cut else a for k, a in batch.items()}
        return batch

    def _sharded(self, it: Iterator[dict]) -> Iterator[dict]:
        try:
            for b in it:
                yield self._shard(b)
        finally:
            if hasattr(it, "close"):
                it.close()       # a native reader's thread

    def _to_device(self, batch: dict) -> dict:
        """This rank's rows of a global host batch, on the device."""
        return {k: torch.from_numpy(np.array(a)).to(self.device)
                for k, a in self._shard(batch).items()}

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

    def _shards(self, name: str, key: str | None = None) -> list:
        """How parameter `name` is split: its ParamShard (of its optimizer
        state `key`: (dim, axis) pairs, as Adafactor's state lives in the
        flax layout, its factored statistics without the reduced dim)."""
        if self.plan is None:
            return []
        sh = self.plan[name]
        if key is None or not isinstance(self.opt, Adafactor):
            return sh
        if key == "v":
            return sh.flax
        gshape = self.opt.global_shapes[dict(
            self.model.named_parameters())[name]]
        d1, d0 = factored_dims(gshape)
        drop = d0 if key == "v_row" else d1
        return [(d - (d > drop), a) for d, a in sh.flax if d != drop]

    @staticmethod
    def _is_state_tensor(key: str, v) -> bool:
        return isinstance(v, torch.Tensor) and key != "step"

    def payload(self) -> dict:
        """The training state as the checkpoint payload (live device
        tensors; runtime/checkpoint.py copies them to the host): the
        update count, the model's parameters, its BatchNorm statistics
        (`batch_stats`: the model's buffers, empty for the LM, ViT and
        BERT), and each parameter's optimizer state by parameter name.
        On a mesh each sharded tensor is gathered whole: a collective,
        so every rank calls this at the same step."""
        def whole(t, shards):
            t = S.unwrap(t.detach())
            return S.gather_full(t, shards, self.mesh) if shards else t

        named = dict(self.model.named_parameters())
        state = {n: {k: whole(v, self._shards(n, k))
                     if self._is_state_tensor(k, v) else v
                     for k, v in self.opt.state[p].items()}
                 for n, p in named.items() if p in self.opt.state}
        params = {n: whole(p, self._shards(n)) for n, p in named.items()}
        if self.gpipe is not None:
            params, state = self._gather_stages(params, state)
        return {"step": self.step, "params": params,
                "batch_stats": {n: b.detach()
                                for n, b in self.model.named_buffers()},
                "opt_state": state}

    def _gather_stages(self, params: dict, state: dict):
        """Every stage's blocks (parameters and optimizer state) on every
        rank of the pipe group, on the host."""
        import torch.distributed as dist

        def own(n):
            return self.plan[n].stage is not None

        mine = ({n: t.cpu() for n, t in params.items() if own(n)},
                {n: {k: v.cpu() if torch.is_tensor(v) else v
                     for k, v in st.items()}
                 for n, st in state.items() if own(n)})
        parts = [None] * self.gpipe.pipe.size
        dist.all_gather_object(parts, mine, group=self.gpipe.pipe.group)
        params, state = dict(params), dict(state)
        for p, st in parts:
            params.update(p)
            state.update(st)
        return params, state

    def load_payload(self, payload: dict) -> None:
        """Load a checkpoint payload (the whole state, from any world)
        into the model and the optimizer (rebuilt from the config: only
        its state is data), each rank cutting its own shards."""
        named = dict(self.model.named_parameters())
        buffers = dict(self.model.named_buffers())
        params, stats = payload["params"], payload.get("batch_stats") or {}
        # a pipeline stage loads its own blocks of the whole model
        want = set(self._full_names) | set(buffers)
        have = set(params) | set(stats)
        if set(params) != set(self._full_names) or set(stats) != set(buffers):
            raise RuntimeError(
                "checkpoint does not match the model: missing "
                f"{sorted(want - have)[:5]}, unexpected "
                f"{sorted(have - want)[:5]}")
        opt_state = payload.get("opt_state") or {}
        unknown = set(opt_state) - set(self._full_names)
        if unknown:
            raise ValueError(f"optimizer state for unknown parameters "
                             f"{sorted(unknown)[:5]}")

        def local(t, shards, like):
            t = S.shard_local(t, shards, self.mesh) if shards else t
            if tuple(t.shape) != tuple(like.shape):
                raise RuntimeError(f"size mismatch: checkpoint {tuple(t.shape)}"
                                   f", model {tuple(like.shape)}")
            return t.to(device=like.device, dtype=like.dtype)

        with torch.no_grad():
            for n, p in named.items():
                dst = S.unwrap(p)
                dst.copy_(local(params[n], self._shards(n), dst))
            for n, b in buffers.items():
                b.copy_(local(stats[n], [], b))
        for n, p in named.items():
            if n not in opt_state:
                continue
            st = {}
            for k, v in opt_state[n].items():
                if self._is_state_tensor(k, v):
                    like = S.unwrap(p)
                    v = S.shard_local(v, self._shards(n, k), self.mesh) \
                        if self.plan else v
                    v = v.to(device=like.device, dtype=like.dtype)
                    if hasattr(p, "device_mesh") and not isinstance(
                            self.opt, Adafactor):
                        from torch.distributed.tensor import DTensor

                        v = DTensor.from_local(v, p.device_mesh, p.placements)
                st[k] = v
            self.opt.state[p] = st
        self.step = int(payload["step"])

    def loss(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """(loss, accuracy) of one batch, differentiable in the loss."""
        cfg = self.cfg
        x, y = _batch_xy(cfg, batch)
        if cfg.task != "lm":
            if cfg.remat and torch.is_grad_enabled():
                from torch.utils.checkpoint import checkpoint

                logits = checkpoint(
                    self.model, x, use_reentrant=False,
                    context_fn=functools.partial(_remat_contexts,
                                                 cfg.remat_policy))
            else:
                logits = self.model(x)
            return _xent_loss(logits, y), _masked_accuracy(logits.argmax(-1), y)
        seg = batch.get("segment_ids")
        if cfg.xent_chunks > 1:
            hidden = self.model(x, segment_ids=seg, return_hidden=True)
            return self.model.lm_head.xent(hidden, y, cfg.xent_chunks)
        logits = self.model(x, segment_ids=seg)
        return _xent_loss(logits, y), _masked_accuracy(logits.argmax(-1), y)

    def _head_loss(self, x: torch.Tensor, y: torch.Tensor):
        """(loss, accuracy) of the LM's last block output x: the final
        norm and the head (chunked under xent_chunks), as `loss`."""
        hidden = self.model.head(x, return_hidden=True)
        if self.cfg.xent_chunks > 1:
            return self.model.lm_head.xent(hidden, y, self.cfg.xent_chunks)
        logits = self.model.lm_head(hidden)
        return _xent_loss(logits, y), _masked_accuracy(logits.argmax(-1), y)

    def _moe_aux(self) -> torch.Tensor:
        """The last forward's load-balancing losses, summed over the MoE
        layers (this rank's parts of them on a world)."""
        return sum(b.stats["aux"] for b in self._moe)

    def _moe_diag(self, counts: list, weights: list) -> dict:
        """moe_fill, moe_drop and moe_sparse_dispatch from each
        microbatch's per-layer (kept, routed, slots) counts: the counts
        sum over the token shards, the ratios average over the layers,
        and the microbatches weigh by `weights` (their valid targets)."""
        c = torch.stack(counts)                       # [micro, layer, 3]
        if self.plan is not None:
            c = self._sum(c)
        fill = (c[..., 0] / c[..., 2].clamp_min(1.0)).mean(1)
        drop = (1.0 - c[..., 0] / c[..., 1].clamp_min(1.0)).mean(1)
        w = torch.stack([torch.as_tensor(x, dtype=torch.float32,
                                         device=c.device) for x in weights])
        n = w.sum().clamp_min(1.0)
        sparse = sum(b.stats["sparse"] for b in self._moe) / len(self._moe)
        return {"moe_fill": (fill * w).sum() / n,
                "moe_drop": (drop * w).sum() / n,
                "moe_sparse_dispatch": torch.tensor(sparse)}

    def train_step(self, batch: dict) -> dict:
        """One update on this rank's rows (`_to_device` of the global
        batch). Returns {"loss", "accuracy"} (and an MoE model's moe_*
        diagnostics) as device scalars, global over the world."""
        self.opt.zero_grad(set_to_none=True)
        diag: dict = {}
        if self.gpipe is not None or self.accum > 1 or self.plan is not None:
            loss, acc, diag = self._accumulate(batch)
        else:
            loss, acc = self.loss(batch)
            if self._moe:
                loss = loss + self.cfg.aux_loss_weight * self._moe_aux()
                diag = self._moe_diag(
                    [torch.stack([b.stats["counts"] for b in self._moe])],
                    [1.0])
            loss.backward()
        lr = warmup_cosine_lr(self.step, self.cfg)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.step += 1
        return {"loss": loss.detach(), "accuracy": acc.detach(),
                **{k: v.detach() for k, v in diag.items()}}

    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict:
        """{"loss", "accuracy"} of one batch (this rank's rows) in eval
        mode (BatchNorm on its running statistics), as device scalars,
        weighted by valid targets over the world; the chunked head when
        training chunks it (a config that only fits because of the
        chunks must not run out of memory at its first eval)."""
        was_training = self.model.training
        self.model.eval()
        try:
            if self.gpipe is not None:
                x, y = _batch_xy(self.cfg, batch)
                logits = self.gpipe.logits(x)
                loss = _xent_loss(logits, y)
                acc = _masked_accuracy(logits.argmax(-1), y)
            else:
                loss, acc = self.loss(batch)
        finally:
            self.model.train(was_training)
        if self._sum_group is not None:
            n = (_batch_xy(self.cfg, batch)[1] >= 0).sum().float()
            if self.gpipe is not None and not self.gpipe.last:
                n = n * 0.0       # every stage holds the logits: count once
            sums = self._sum(torch.stack([loss * n, acc * n, n]))
            n = sums[2].clamp_min(1.0)
            loss, acc = sums[0] / n, sums[1] / n
        return {"loss": loss, "accuracy": acc}

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed (in place) over the ranks that hold parts of the
        global batch: the batch axes, seq and pipe."""
        import torch.distributed as dist

        if self._sum_group is not None:
            dist.all_reduce(x, group=self._sum_group)
        return x

    def _accumulate(self, batch: dict
                    ) -> tuple[torch.Tensor, torch.Tensor, dict]:
        """The gradients of `accum` microbatches in the parameters' .grad,
        as the reference's train_step_accum combines them: row r goes to
        microbatch r % accum (within this rank's rows: each microbatch
        draws from every rank's block); each microbatch's loss is the
        mean over its valid (>= 0) targets and weighs by its valid count
        n_i, so grads = sum(g_i n_i) / max(sum(n_i), 1) with the sums over
        the microbatches and the world: the global batch's token-weighted
        mean however unevenly the targets are masked, never the mean of
        per-rank means. Under pipeline stages each microbatch runs the
        GPipe schedule. Returns the loss and accuracy combined with the
        same weights, and an MoE model's moe_* diagnostics."""
        loss_sum = acc_sum = n_sum = 0.0
        counts, weights = [], []
        for m in range(self.accum):
            micro = {k: v[m::self.accum] for k, v in batch.items()}
            if self.gpipe is not None:
                x, y = _batch_xy(self.cfg, micro)
                ls, asum, n = self.gpipe.step(x, y, self._head_loss)
                loss_sum, acc_sum = loss_sum + ls, acc_sum + asum
                n_sum = n_sum + n
                continue
            loss, acc = self.loss(micro)
            n = (_batch_xy(self.cfg, micro)[1] >= 0).sum().float()
            obj = loss * n
            if self._moe:
                # each rank adds its part of the aux loss, weighted by the
                # microbatch's global valid count: the sums over the world
                # divided by the total count give the reference's
                # sum(n_i (xent_i + w aux_i)) / sum(n_i)
                n_glob = self._sum(n.clone()) if self.plan is not None else n
                obj = obj + self.cfg.aux_loss_weight * self._moe_aux() * n_glob
                counts.append(torch.stack([b.stats["counts"]
                                           for b in self._moe]))
                weights.append(n_glob if self.accum > 1 else 1.0)
            obj.backward()
            loss_sum = loss_sum + obj.detach()
            acc_sum = acc_sum + acc.detach() * n
            n_sum = n_sum + n
        diag = self._moe_diag(counts, weights) if counts else {}
        if self.plan is not None:
            from kubeflow_tpu_torch.obs import trace as obs_trace

            # the span takes the reduce's time on the card, read once the
            # step loop has synchronized (`_close_reduce_span`): the
            # reduce queues behind the backward with no host sync
            self._close_reduce_span()
            span = obs_trace.TRACER.begin("train.grad_reduce", detached=True,
                                          dp=self.dp)
            start = self._mark()
            self._reduce_grads()
            loss_sum, acc_sum, n_sum = self._sum(
                torch.stack([loss_sum, acc_sum, n_sum]))
            self._reduce_span = (span, start, self._mark())
        n = n_sum.clamp_min(1.0)
        for p in self.model.parameters():
            if p.grad is not None:
                if hasattr(p.grad, "to_local"):    # an FSDP2 shard
                    p.grad.div_(float(n))
                else:
                    p.grad = (p.grad / n).to(p.dtype)
        return loss_sum / n, acc_sum / n, diag

    def _reduce_grads(self) -> None:
        """Sum the gradients over the world where they are partial: over
        the model group for the k/v weights whose heads replicate under
        tensor parallelism, then over the batch axes through the
        backend's hierarchical_reduce (fast level: data, and fsdp for a
        parameter FSDP2 left whole; slow level: dcn), one flat buffer per
        group of axes and dtype. FSDP2 reduce-scattered its shards over
        fsdp in the backward already."""
        import torch.distributed as dist

        if self.gpipe is not None:
            # a stage that does not use the embedding or the head holds
            # zeros for them in the sum over pipe
            for p in self.model.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        named = {n: p for n, p in self.model.named_parameters()
                 if p.grad is not None}
        model_group = self.mesh.group((AXIS_MODEL,))
        for n, p in named.items():
            if self.plan[n].partial_model:
                dist.all_reduce(S.unwrap(p.grad), group=model_group)
        for axes, names in S.grad_groups(self.plan, self.mesh, named).items():
            if self.mesh.extent(axes + (AXIS_DCN,)) == 1:
                continue
            by_dtype: dict = {}
            for n in names:
                g = S.unwrap(named[n].grad)
                by_dtype.setdefault(g.dtype, []).append(g)
            for grads in by_dtype.values():
                flat = torch.cat([g.reshape(-1) for g in grads])
                flat = self.backend.hierarchical_reduce(
                    flat, axis=AXIS_DCN, ici_axes=axes, mesh=self.mesh)
                i = 0
                for g in grads:
                    g.copy_(flat[i:i + g.numel()].view_as(g))
                    i += g.numel()

    def flops_per_step(self) -> float:
        """Analytic train-step FLOPs (2 per MAC, train = 3x forward), as
        the reference counts them: a ResNet by `fwd_flops`, a ViT by
        `fwd_flops_per_image`, an LM or BERT by `flops_per_token`."""
        cfg = self.cfg
        if cfg.model.startswith("resnet"):
            from kubeflow_tpu_torch.models.resnet import fwd_flops

            per_image = fwd_flops(
                cfg.model, image_size=cfg.image_size,
                num_classes=cfg.num_classes,
                num_filters=cfg.model_kwargs.get("num_filters", 64),
                stem=cfg.model_kwargs.get("stem", "conv7"))
            return 3.0 * per_image * cfg.global_batch
        if hasattr(self.model, "fwd_flops_per_image"):
            return 3.0 * self.model.fwd_flops_per_image() * cfg.global_batch
        return (self.model.flops_per_token(seq_len=cfg.seq_len)
                * cfg.global_batch * cfg.seq_len)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _mark(self):
        """A point in the stream's time: a recorded CUDA event on the
        card, the host clock on the CPU (where collectives block)."""
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _close_reduce_span(self) -> None:
        """Finish the pending train.grad_reduce span at the time between
        its marks (waiting for the end mark, which a synchronized step
        has passed already)."""
        if self._reduce_span is None:
            return
        from kubeflow_tpu_torch.obs import trace as obs_trace

        span, start, end = self._reduce_span
        self._reduce_span = None
        if isinstance(start, float):
            dt = end - start
        else:
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        obs_trace.TRACER.finish(span, duration=dt)

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
        already) and returns early with summary["preempted"] = True. On a
        world of several processes the flag is agreed over the world
        every step, so the gang stops at one step."""
        from kubeflow_tpu_torch.obs import trace as obs_trace
        from kubeflow_tpu_torch.parallel import dist as D

        cfg = self.cfg
        steps = steps or cfg.total_steps
        if stop is not None and self.world is not None:
            stop = self.world.stop(stop)
        ckpt = None
        if cfg.checkpoint_dir:
            from kubeflow_tpu_torch.runtime.checkpoint import Checkpointer

            world = D.active_world()
            ckpt = Checkpointer(
                cfg.checkpoint_dir, keep=cfg.checkpoint_keep,
                world_size=self.world.size if self.world else 1,
                num_slices=world.num_slices if world else 1,
                rank=self.world.rank if self.world else 0,
                collective=self.world)
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
                                     step_base=start_step + 1,
                                     n_chips=self.mesh.size)
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
            if cfg.task == "lm":
                last_eval["perplexity"] = math.exp(min(last_eval["loss"],
                                                       30.0))
            # without eval_data_path this reads the TRAINING source at a
            # shifted seed: marked so it is not taken for held-out numbers
            smoke = not cfg.eval_data_path
            last_eval["smoke"] = float(smoke)
            what = "training-data smoke eval" if smoke else "held-out eval"
            for k, v in last_eval.items():
                rt_metrics.REGISTRY.gauge(f"jaxrt_eval_{k}", v, f"{what} {k}")
            log.info("%s @ step %d: %s", what, gstep,
                     " ".join(f"{k}={v:.4f}" for k, v in sorted(last_eval.items())))

        from kubeflow_tpu_torch.runtime.profiler import CAPTURES, TraceWindow

        trace = TraceWindow(cfg.profile_dir, cfg.profile_start_step,
                            cfg.profile_steps)
        # the on-demand capture server's windows (JAXRT_PROFILER_PORT)
        # open and close in this loop's step hook
        CAPTURES.begin(cfg.profile_dir)
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
                data = Prefetcher(self._sharded(it), self.device)
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
                CAPTURES.before_step(start_step + i, trace)
                batch = next(data)
                if i == 0:
                    # the first step builds kernels and warms the
                    # allocator: kept out of the meter window
                    t0 = time.perf_counter()
                    with obs_trace.TRACER.span("train.step", step=start_step,
                                               compile=True):
                        m = self.train_step(batch)
                        self._sync()
                        self._close_reduce_span()
                    first_dt = time.perf_counter() - t0
                    log.info("first step (incl. kernel build): %.2fs", first_dt)
                    last = {k: float(v) for k, v in m.items()}
                else:
                    meter.start()
                    m = self.train_step(batch)
                    self._sync()
                    meter.stop()
                    self._close_reduce_span()
                    if (i + 1) % cfg.log_every == 0 or i == steps - start_step - 1:
                        last = {k: float(v) for k, v in m.items()}
                        self._publish(meter, last)
                        mfu = meter.mfu
                        moe = "".join(f" {k}={v:.4f}" for k, v in
                                      sorted(last.items())
                                      if k.startswith("moe_"))
                        log.info("step %d loss=%.4f acc=%.3f %.1f ex/s "
                                 "step=%.1fms%s%s", start_step + i + 1,
                                 last["loss"], last["accuracy"],
                                 meter.throughput(cfg.global_batch),
                                 meter.step_time * 1e3,
                                 "" if mfu is None else f" mfu={mfu * 100:.1f}%",
                                 moe)
                maybe_save(start_step + i + 1)
                maybe_eval(start_step + i + 1)
                if callback:
                    callback(i, m)
            ok = True
        finally:
            try:
                meter.close()  # a step that raised still exports, as ERROR
                CAPTURES.end()
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
        for k, v in sorted(last.items()):
            if k.startswith("moe_"):
                reg.gauge(f"jaxrt_{k}", v, f"MoE dispatch diagnostic {k}")
