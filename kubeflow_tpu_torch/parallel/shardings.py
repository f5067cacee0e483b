"""Parameter placement on a mesh (port of kubeflow_tpu/parallel/shardings.py).

`partition_specs` names, for each parameter, the mesh axes each of its
dims is split over, in the reference's flax layout: the tables copy the
reference's `_part` annotations (kubeflow_tpu/models/transformer.py:
q/k/v (fsdp, model, None) :466-470, o (model, None, fsdp) :691,
gate/up (fsdp, model) and down (model, fsdp) :714-725, the LM head
(fsdp, model) :748, the embedding ((model, fsdp), None) :830; the
encoders' `nn.with_partitioning`, kubeflow_tpu/models/vit.py:59-129 and
bert.py:51-93: qkv (fsdp, None, model, None), o (model, None, fsdp),
fc1 (fsdp, model), fc2 (model, fsdp), ViT's patch embedding and
position table (None, model) and head (fsdp, model), BERT's word
embedding (model, fsdp)), with the reference's drop of an axis that does
not divide its dim (2 KV heads under model 4 replicate) and its FSDP
heuristic for bare leaves (`_fsdp_spec`). The port adds one entry: the
fc1 bias follows fc1's output split, since the port adds it to the
rank's columns (GSPMD slices the replicated bias for the add).

The specs are then applied to the port's modules:
- `model`: Megatron-style tensor parallelism on local weight shards
  (`apply_tensor_parallel`; the encoders of ViT and BERT the same way,
  their qkv split on its heads, their patch, position, word-embedding
  and head weights all-gathered for use): each rank keeps its slice of the
  column-parallel q/k/v, gate and up weights and of the row-parallel o
  and down weights; an identity whose backward all-reduces over the
  model group enters each block half, an all-reduce whose backward is
  the identity leaves it. Attention gets plain local tensors at the
  local head counts, so the flash kernels run per rank unchanged. When
  the k/v heads replicate, each rank picks the kv heads its q heads
  belong to and the k/v weight gradients are summed over the model
  group. The embedding and the LM head keep their vocab shard and
  all-gather it for use (the backward keeps this rank's slice of the
  gradient, which every rank of the group computes whole).
- `fsdp`: FSDP2 `fully_shard` on the annotated dim (`apply_fsdp`), per
  block, the head and the root, gradients reduce-scattered as sums.
- `expert`: the MoE expert weights keep their slice of the experts
  (dim 0; `apply_moe`, which also makes the reference's dispatch choice
  for the mesh); every other weight replicates over it and its gradient
  is summed over it as over the other batch axes.
- `seq`: every weight replicates; the model holds this rank's block of
  positions (`apply_seq`) and gradients are summed over seq.
- `pipe`: each stage holds its own blocks (parallel/pipeline.py); the
  embedding, final norm and head replicate and their gradients are
  summed over pipe.
- `data` / `dcn`: the backend's `hierarchical_reduce` of the gradients
  (runtime/trainer.py), the counterpart of GSPMD's psum over the batch
  axes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Mapping

import torch

from kubeflow_tpu_torch.convert import flax_layout
from kubeflow_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_MODEL,
    AXIS_PIPELINE,
    AXIS_SEQ,
    BATCH_AXES,
    Mesh,
    axis_group,
)

# port parameter name suffix -> the reference's annotation (flax layout)
_ANNOTATED = {
    ("attn", "q", "weight"): (AXIS_FSDP, AXIS_MODEL, None),
    ("attn", "k", "weight"): (AXIS_FSDP, AXIS_MODEL, None),
    ("attn", "v", "weight"): (AXIS_FSDP, AXIS_MODEL, None),
    ("attn", "o", "weight"): (AXIS_MODEL, None, AXIS_FSDP),
    ("mlp", "gate", "weight"): (AXIS_FSDP, AXIS_MODEL),
    ("mlp", "up", "weight"): (AXIS_FSDP, AXIS_MODEL),
    ("mlp", "down", "weight"): (AXIS_MODEL, AXIS_FSDP),
    ("lm_head", "kernel"): (AXIS_FSDP, AXIS_MODEL),
    ("embedding",): ((AXIS_MODEL, AXIS_FSDP), None),
    # kubeflow_tpu/ops/moe.py:60-62, 191-199
    ("moe", "router", "weight"): (AXIS_FSDP, None),
    ("moe", "w_gate"): (AXIS_EXPERT, AXIS_FSDP, AXIS_MODEL),
    ("moe", "w_up"): (AXIS_EXPERT, AXIS_FSDP, AXIS_MODEL),
    ("moe", "w_down"): (AXIS_EXPERT, AXIS_MODEL, AXIS_FSDP),
}

# the encoder blocks of ViT and BERT (models/encoder.py), flax layout
_ENCODER_ANNOTATED = {
    ("qkv", "weight"): (AXIS_FSDP, None, AXIS_MODEL, None),
    ("o", "weight"): (AXIS_MODEL, None, AXIS_FSDP),
    ("fc1", "weight"): (AXIS_FSDP, AXIS_MODEL),
    ("fc1", "bias"): (AXIS_MODEL,),
    ("fc2", "weight"): (AXIS_MODEL, AXIS_FSDP),
}
_VIT_ANNOTATED = {
    **_ENCODER_ANNOTATED,
    ("patch_embed", "weight"): (None, AXIS_MODEL),
    ("pos_embed",): (None, AXIS_MODEL),
    ("head_kernel",): (AXIS_FSDP, AXIS_MODEL),
}
_BERT_ANNOTATED = {
    **_ENCODER_ANNOTATED,
    ("embedding",): (AXIS_MODEL, AXIS_FSDP),
}


def _fsdp_spec(shape: tuple[int, ...], fsdp_size: int,
               min_size: int = 2**14) -> tuple:
    """Shard the largest divisible dim over fsdp (ties to the later dim);
    tensors under min_size elements replicate."""
    if fsdp_size <= 1 or not shape:
        return (None,) * len(shape)
    total = 1
    for d in shape:
        total *= d
    if total < min_size:
        return (None,) * len(shape)
    order = sorted(range(len(shape)), key=lambda i: (shape[i], i), reverse=True)
    for i in order:
        if shape[i] % fsdp_size == 0:
            spec = [None] * len(shape)
            spec[i] = AXIS_FSDP
            return tuple(spec)
    return (None,) * len(shape)


def _sizes(mesh) -> Mapping[str, int]:
    return mesh.shape if hasattr(mesh, "shape") else mesh


def _table(model) -> dict | None:
    from kubeflow_tpu_torch.models.bert import BertEncoder
    from kubeflow_tpu_torch.models.transformer import TransformerLM
    from kubeflow_tpu_torch.models.vit import ViT

    for cls, table in ((TransformerLM, _ANNOTATED), (ViT, _VIT_ANNOTATED),
                       (BertEncoder, _BERT_ANNOTATED)):
        if isinstance(model, cls):
            return table
    return None     # ResNet: no annotations, the fsdp heuristic alone


def _annotation(model, name: str):
    table = _table(model)
    if table is None:
        return None
    parts = tuple(name.split("."))
    for suffix, names in table.items():
        if parts[-len(suffix):] == suffix and (len(suffix) > 1
                                               or parts == suffix):
            return names
    return None


def _head_dim(model) -> int | None:
    return getattr(getattr(model, "cfg", None), "head_dim", None)


def partition_specs(model, mesh, *, fsdp: bool = True) -> dict[str, tuple]:
    """{parameter name: a tuple with the mesh axes (an axis name, a tuple
    of names, or None) of each dim of the parameter's flax shape}.
    `mesh` is a Mesh or a mapping of axis sizes; the model may live on
    the meta device. Batch statistics (buffers) are not parameters."""
    sizes = _sizes(mesh)
    fsdp_size = sizes.get(AXIS_FSDP, 1) if fsdp else 1
    out = {}
    for name, p in model.named_parameters():
        view, perm = flax_layout(name, p.shape, _head_dim(model))
        shape = tuple(view[i] for i in perm)
        names = _annotation(model, name) if (
            sizes.get(AXIS_MODEL, 1) > 1 or fsdp_size > 1
            or sizes.get(AXIS_EXPERT, 1) > 1) else None
        if names is None:
            out[name] = _fsdp_spec(shape, fsdp_size)
            continue

        def size(n):
            ns = n if isinstance(n, tuple) else (n,)
            k = 1
            for a in ns:
                k *= sizes.get(a, 1)
            return k

        out[name] = tuple(n if n is not None and shape[i] % size(n) == 0
                          else None for i, n in enumerate(names))
    return out


# -- from flax-layout specs to port-layout shards ------------------------------


def _view_dims(shape, view) -> list[int]:
    """The port dim each dim of `view` (a reshape of `shape` that only
    splits dims) comes from."""
    out, i, acc = [], 0, 1
    for v in view:
        out.append(i)
        acc *= v
        if acc == shape[i]:
            i, acc = i + 1, 1
    return out


@dataclasses.dataclass
class ParamShard:
    """How one parameter is split: `port` lists (port dim, axis) in the
    order of slicing (model before fsdp: model is the major part of a
    dim both split); `flax` the same in the flax layout; `partial_model`
    marks a weight replicated over the model group whose gradient is a
    per-rank part (the k/v projections when their heads replicate);
    `stage` is set for a block's weight under pipeline stages.

    A split of an inner part of a port dim (an encoder's qkv [3*h*D, d]
    split on h) is sliced in `view`, the port tensor reshaped to its
    flax dims before the permute ([3, h, D, d]): `port` then indexes the
    view's dims and `merge` names the port dim each view dim folds
    into."""

    port: list[tuple[int, str]]
    flax: list[tuple[int, str]]
    partial_model: bool = False
    stage: int | None = None     # the pipeline stage that holds it
    view: tuple[int, ...] | None = None
    merge: list[int] | None = None

    def __bool__(self) -> bool:
        return bool(self.port)

    def dim(self, axis: str) -> int | None:
        """The dim `axis` splits (of the view, when there is one)."""
        return next((d for d, a in self.port if a == axis), None)

    def port_dim(self, axis: str) -> int | None:
        """The port dim `axis` splits."""
        d = self.dim(axis)
        return d if d is None or self.merge is None else self.merge[d]

    def only(self, axes) -> "ParamShard":
        """The same split restricted to `axes`."""
        return dataclasses.replace(
            self, port=[(d, a) for d, a in self.port if a in axes],
            flax=[(d, a) for d, a in self.flax if a in axes])


def shard_plan(model, mesh) -> dict[str, ParamShard]:
    """ParamShard per parameter of `model` (full, unsharded) on `mesh`."""
    sizes = _sizes(mesh)
    specs = partition_specs(model, mesh)
    plan = {}
    for name, p in model.named_parameters():
        spec = specs[name]
        view, perm = flax_layout(name, p.shape, _head_dim(model))
        vdims = _view_dims(tuple(p.shape), view)
        flax = [(fdim, axis) for axis in (AXIS_EXPERT, AXIS_MODEL, AXIS_FSDP)
                if sizes.get(axis, 1) > 1
                for fdim, names in enumerate(spec)
                if axis in (names if isinstance(names, tuple) else (names,))]
        # slice the port tensor itself unless a split falls on an inner
        # part of one of its dims; then slice its view
        inner = any(perm[f] != vdims.index(vdims[perm[f]]) for f, _ in flax)
        if inner:
            plan[name] = ParamShard([(perm[f], a) for f, a in flax], flax,
                                    view=tuple(view), merge=vdims)
        else:
            plan[name] = ParamShard([(vdims[perm[f]], a) for f, a in flax],
                                    flax)
    pp = sizes.get(AXIS_PIPELINE, 1)
    if pp > 1:
        per = model.cfg.n_layers // pp
        for name, sh in plan.items():
            if name.startswith("layer_"):
                sh.stage = int(name.split(".")[0][len("layer_"):]) // per
    # k/v left whole while q is split: each rank uses a part of them
    for name, sh in plan.items():
        if name.endswith(("attn.k.weight", "attn.v.weight")):
            q = plan[name.rsplit(".", 2)[0] + ".q.weight"]
            sh.partial_model = (sh.dim(AXIS_MODEL) is None
                                and q.dim(AXIS_MODEL) is not None)
    return plan


def _folded(shape, merge: list[int]) -> list[int]:
    """A view's shape folded back into the port dims (`merge`)."""
    out = [1] * (max(merge) + 1)
    for n, p in zip(shape, merge):
        out[p] *= n
    return out


def shard_local(full: torch.Tensor, shards, mesh: Mesh) -> torch.Tensor:
    """This rank's block of `full` under `shards`: (dim, axis) pairs in
    slicing order, or a ParamShard (sliced in its view when it has
    one)."""
    view = getattr(shards, "view", None)
    x = full if view is None else full.reshape(view)
    for dim, axis in getattr(shards, "port", shards):
        x = x.chunk(mesh.shape[axis], dim)[mesh.coords[axis]]
    if view is not None:
        x = x.reshape(_folded(x.shape, shards.merge))
    return x.contiguous()


def gather_full(local: torch.Tensor, shards, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every rank's block (a collective over the
    groups of `shards`): the inverse of shard_local."""
    import torch.distributed as dist

    pairs = list(getattr(shards, "port", shards))
    view = getattr(shards, "view", None)
    if view is not None:
        part = list(view)
        for dim, axis in pairs:
            part[dim] //= mesh.shape[axis]
        local = local.reshape(part)
    for dim, axis in reversed(pairs):
        parts = [torch.empty_like(local) for _ in range(mesh.shape[axis])]
        dist.all_gather(parts, local.contiguous(), group=mesh.group((axis,)))
        local = torch.cat(parts, dim)
    if view is not None:
        local = local.reshape(_folded(view, shards.merge))
    return local


# -- tensor parallelism ---------------------------------------------------------


class _Clock:
    """Host seconds this process spent blocked in the forward collectives
    of tensor parallelism and the serving wire (the serving decoder reads
    the share of a tick they take). That is the collectives' time under
    gloo, whose calls return when the data is there; under NCCL a call
    returns once it is enqueued on the stream, and this reads near 0."""

    seconds = 0.0

    def timed(self, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.seconds += time.perf_counter() - t0
        return out


COLLECTIVES = _Clock()


class _Enter(torch.autograd.Function):
    """Identity; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Exit(torch.autograd.Function):
    """Sum over the group; the backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        x = x.contiguous().clone()
        COLLECTIVES.timed(dist.all_reduce, x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along `dim`; the backward keeps this rank's slice (every
    rank of the group computed the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group, dim, n, rank):
        import torch.distributed as dist

        ctx.dim, ctx.n, ctx.rank = dim, n, rank
        parts = [torch.empty_like(x) for _ in range(n)]
        COLLECTIVES.timed(dist.all_gather, parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.chunk(ctx.n, ctx.dim)[ctx.rank].contiguous(), None, None,
                None, None)


def _kv_heads(n_heads: int, n_kv: int, m: int, rank: int) -> list[int]:
    """The kv heads the q heads of `rank` (of `m`) use, one entry per
    local kv head: GQA over the distinct ones when they split the local
    q heads evenly and in order, else one per q head."""
    per = n_heads // m
    group = n_heads // n_kv
    kv = [(rank * per + j) // group for j in range(per)]
    uniq = sorted(set(kv))
    if per % len(uniq) == 0 and kv == [u for u in uniq
                                       for _ in range(per // len(uniq))]:
        return uniq
    return kv


def apply_tensor_parallel(model, plan: dict[str, ParamShard],
                          mesh: Mesh) -> None:
    """Cut each model-split parameter to this rank's slice and wire the
    collectives into the blocks, the embedding and the head (of the LM,
    or of a ViT or BERT encoder)."""
    m = mesh.shape[AXIS_MODEL]
    if m <= 1:
        return
    group, rank = mesh.group((AXIS_MODEL,)), mesh.coords[AXIS_MODEL]
    with torch.no_grad():
        for name, p in model.named_parameters():
            if plan[name].dim(AXIS_MODEL) is not None:
                # a copy: a dim-0 slice is a view that would keep the
                # whole weight alive
                p.data = shard_local(p.data, plan[name].only((AXIS_MODEL,)),
                                     mesh).clone()

    def enter(x):
        return _Enter.apply(x, group)

    def leave(x):
        return _Exit.apply(x, group)

    def gather(dim):
        return lambda w: _Gather.apply(w, group, dim, m, rank)

    if _table(model) is not _ANNOTATED:
        _encoder_tensor_parallel(model, plan, enter, leave, gather)
        return
    cfg = model.cfg
    for i, blk in zip(model.layer_ids, model.blocks()):
        pre = f"layer_{i}."
        if plan[pre + "attn.q.weight"].dim(AXIS_MODEL) is not None:
            blk.attn.tp_in, blk.attn.tp_out = enter, leave
            blk.attn.model_size = m
            if plan[pre + "attn.k.weight"].dim(AXIS_MODEL) is None:
                blk.attn.kv_heads = _kv_heads(cfg.n_heads, cfg.n_kv_heads,
                                              m, rank)
        ffn = pre + ("moe.w_gate" if hasattr(blk, "moe")
                     else "mlp.gate.weight")
        if plan[ffn].dim(AXIS_MODEL) is not None:
            blk.ffn.tp_in, blk.ffn.tp_out = enter, leave
    if plan["embedding"].dim(AXIS_MODEL) is not None:
        model.gather_embedding = lambda w: _Gather.apply(w, group, 0, m, rank)
    if plan["lm_head.kernel"].dim(AXIS_MODEL) is not None:
        model.lm_head.gather = gather(1)


def _encoder_tensor_parallel(model, plan, enter, leave, gather) -> None:
    """A ViT's or BERT's blocks: attention at this rank's heads when qkv
    is split, the MLP at its columns when fc1 is; the split embedding,
    position and head weights all-gathered where they are used."""
    for i, blk in enumerate(model.blocks()):
        pre = f"layer_{i}."
        if plan[pre + "qkv.weight"].dim(AXIS_MODEL) is not None:
            blk.tp_in, blk.tp_out = enter, leave
        if plan[pre + "fc1.weight"].dim(AXIS_MODEL) is not None:
            blk.mlp_tp_in, blk.mlp_tp_out = enter, leave
    for name, sh in plan.items():
        d = sh.port_dim(AXIS_MODEL)
        if d is None or name.startswith("layer_"):
            continue
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        mod.gathers = {**getattr(mod, "gathers", {}), leaf: gather(d)}


def apply_fsdp(model, plan: dict[str, ParamShard], mesh: Mesh) -> None:
    """FSDP2 over the fsdp axis: each parameter whose spec names fsdp is
    sharded on that dim; the rest are left out (replicated, their
    gradients summed with the data axes'). Units: each block, the LM
    head, then the root. Gradients are reduce-scattered as sums: the
    trainer divides by the global count of valid targets."""
    if mesh.shape[AXIS_FSDP] <= 1:
        return
    from torch.distributed.fsdp import (
        fully_shard,
        register_fsdp_forward_method,
    )
    from torch.distributed.tensor import Shard

    dims = {p: plan[n].port_dim(AXIS_FSDP)
            for n, p in model.named_parameters()}
    ignored = {p for p, d in dims.items() if d is None}
    fsdp_mesh = mesh.device_mesh[AXIS_FSDP]
    with torch.no_grad():
        for p in dims:
            if p not in ignored and not p.is_contiguous():
                # FSDP2 shards contiguous tensors only (ResNet keeps its
                # conv weights channels_last)
                p.data = p.data.contiguous()

    def place(p):
        return Shard(dims[p])

    units = [*getattr(model, "blocks", lambda: [])()]
    if hasattr(model, "lm_head"):
        units.append(model.lm_head)
    for unit in [*units, model]:
        fully_shard(unit, mesh=fsdp_mesh, shard_placement_fn=place,
                    ignored_params=ignored)
        # sums, set on every unit (each keeps its own); gloo has no
        # PREMUL_SUM
        unit.set_gradient_divide_factor(1.0)
        unit.set_force_sum_reduction_for_comms(True)
    if hasattr(model, "lm_head"):
        register_fsdp_forward_method(model.lm_head, "xent")


def moe_sparse_ok(cfg, mesh) -> bool:
    """The reference's dispatch choice (`MoEBlock._sparse_ok`) under an
    ambient mesh: sparse unless moe_impl is dense or the mesh has fsdp,
    model, seq or pipe above 1 or experts that do not divide over
    `expert`; forced sparse on such a mesh is refused."""
    if cfg.moe_impl == "dense":
        return False
    ep = mesh.shape[AXIS_EXPERT]
    ok = all(mesh.shape[a] == 1 for a in
             (AXIS_FSDP, AXIS_MODEL, AXIS_SEQ, AXIS_PIPELINE)) \
        and cfg.n_experts % ep == 0
    if cfg.moe_impl == "sparse" and not ok:
        raise ValueError(
            f"moe_impl='sparse' requires fsdp/model/seq/pipe mesh axes "
            f"of size 1 and n_experts % expert_axis == 0; got mesh "
            f"{dict(mesh.shape)} with n_experts={cfg.n_experts}")
    return ok


def apply_moe(model, plan: dict[str, ParamShard] | None, mesh: Mesh) -> None:
    """Place the MoE blocks on `mesh` (the trainer's, so a mesh is
    ambient as in the reference's trainer): the dispatch choice, this
    rank's slice of the experts when `expert` splits them, the group of
    the token shards (batch axes and seq) and the seq group."""
    blocks = model.moe_blocks()
    if not blocks:
        return
    sparse = moe_sparse_ok(model.cfg, mesh)
    tokens = axis_group(mesh, BATCH_AXES + (AXIS_SEQ,))
    seq = axis_group(mesh, (AXIS_SEQ,))
    expert = axis_group(mesh, (AXIS_EXPERT,))
    for i, blk in zip(model.layer_ids, model.blocks()):
        if not hasattr(blk, "moe"):
            continue
        moe = blk.moe
        moe.sparse, moe.tokens, moe.seq = sparse, tokens, seq
        pre = f"layer_{i}.moe."
        if plan is None or plan[pre + "w_gate"].dim(AXIS_EXPERT) is None:
            continue
        moe.expert = expert
        with torch.no_grad():
            for leaf in ("w_gate", "w_up", "w_down"):
                p = getattr(moe, leaf)
                d = plan[pre + leaf].dim(AXIS_EXPERT)
                p.data = p.data.chunk(expert.size, d)[expert.rank].contiguous()


# the attention impls a seq axis takes: the exchanges, and the local
# impls over K/V gathered from every rank (ops/seq_attention.py)
SEQ_IMPLS = ("ring", "ulysses", "auto", "flash", "reference")


def apply_seq(model, seq) -> None:
    """Sequence parallelism over `seq` (the seq axis' AxisGroup, None at
    extent 1): the model (an LM, or BERT) holds this rank's block of the
    sequence and its attention exchanges over the group (ring, ulysses)
    or gathers the keys of every rank (the local impls)."""
    if seq is None:
        return
    impl = model.cfg.attention_impl
    if impl not in SEQ_IMPLS:
        raise ValueError(f"a seq axis of {seq.size} takes attention_impl "
                         f"in {SEQ_IMPLS}, not {impl!r}")
    model.seq = seq
    for blk in model.blocks():
        if hasattr(blk, "attn"):       # BERT's blocks take it per call
            blk.attn.seq = seq


def grad_groups(plan: dict[str, ParamShard], mesh: Mesh, names) -> dict:
    """{reduce axes: [parameter names]}: the axes over which each
    gradient is still to be summed after the backward: the batch axes
    (dcn, data; fsdp for a parameter FSDP does not shard; expert for one
    not split over expert), seq, and pipe for a parameter every stage
    holds."""
    out: dict[tuple, list] = {}
    for n in names:
        sh = plan[n]
        axes = [AXIS_DATA]
        if mesh.shape[AXIS_FSDP] > 1 and sh.dim(AXIS_FSDP) is None:
            axes.append(AXIS_FSDP)
        if mesh.shape[AXIS_EXPERT] > 1 and sh.dim(AXIS_EXPERT) is None:
            axes.append(AXIS_EXPERT)
        if mesh.shape[AXIS_SEQ] > 1:
            axes.append(AXIS_SEQ)
        if mesh.shape[AXIS_PIPELINE] > 1 and sh.stage is None:
            axes.append(AXIS_PIPELINE)
        out.setdefault(tuple(axes), []).append(n)
    return out


def unwrap(t: Any) -> torch.Tensor:
    """The local tensor of a DTensor (FSDP2's parameters, their
    gradients and optimizer states), else t."""
    return t.to_local() if hasattr(t, "to_local") else t

