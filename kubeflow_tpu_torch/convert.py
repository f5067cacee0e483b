"""Flax parameters, batch statistics and optax optimizer states <-> the
port's state_dict and optimizer state, for every model of the registry.

Layouts of the reference trees (kubeflow_tpu/models/):
- TransformerLM: `layer_i/attn/{q,k,v}/kernel` [d, H, D] and
  `o/kernel` [H, D, d]; `layer_i/mlp/{gate,up,down}/kernel` [in, out];
  `layer_i/ln_{attn,mlp}/scale`, `ln_f/scale` [d] f32; `embedding`
  [V, d] f32; `lm_head/kernel` [d, V] f32;
- ViT and BERT: `layer_i/qkv/kernel` [d, 3, h, d_head], `layer_i/o/
  kernel` [h, d_head, d], `fc1`/`fc2` kernels [in, out] and biases,
  `patch_embed` (ViT) and BERT's `head` as Dense kernels [in, out];
  ViT's `pos_embed` and `head_kernel` [d, classes], BERT's `embedding`
  and `pos_embedding`, as they are;
- MoE blocks: `layer_i/moe/router/kernel` [d, e] (a Dense kernel) and
  `layer_i/moe/{w_gate, w_up}` [e, d, f], `w_down` [e, f, d], as they
  are;
- pipeline stages: the reference's stage-stacked tree
  `pipeline/ticks/stages/block_p/...` (each leaf stacked over the
  stages: stage s's block_p is layer s * n/pp + p) maps to and from the
  port's sequential `layer_i` names (`unstack_pipeline`,
  `stack_pipeline`); params and elementwise optimizer states alike;
- ResNet: conv kernels (`conv_init`, `Conv_i`, `conv_proj`) HWIO
  [kh, kw, in, out]; BatchNorm `scale` and `bias` in params, `mean` and
  `var` in the batch_stats collection (the port's buffers of the same
  names: `flax_to_state_dict(batch_stats)` maps them); `head` a Dense.
torch weights are [out, in] (OIHW for a conv), so every projection is
transposed (q/k/v and qkv fold their heads into out, o into in) and
every conv kernel permuted; everything else keeps its layout.
`flax_layout` is the inverse rule: it shows a port parameter in its flax
shape, which is what the optimizer's factoring follows
(runtime/optim.py).

Optimizer states (`opt_state_to_port` / `opt_state_to_flax`), for the
optax chains the reference's make_optimizer builds:
- adamw: `ScaleByAdamState(count, mu, nu)` <-> torch.optim.AdamW's
  per-parameter `step`, `exp_avg`, `exp_avg_sq` (port layout);
- sgdm (add_decayed_weights, then sgd with nesterov momentum):
  `TraceState(trace)` <-> torch.optim.SGD's `momentum_buffer` (port
  layout); SGD keeps no update count, so the optax count comes from the
  checkpoint's step;
- adafactor: `FactoredState(count, v_row, v_col, v)` <-> runtime/optim.py
  Adafactor's `step` and `v` or `v_row`/`v_col`, already in the flax
  layout. optax keeps a shape-(1,) zero for the statistic a parameter
  does not use (`v` of a factored one, `v_row`/`v_col` of the rest); the
  port keeps none.
The schedule's `count` (ScaleByScheduleState) is the update count, the
checkpoint's step. All of it is numpy and torch: a process with JAX
reads an orbax checkpoint with the reference's own restore and hands the
trees to `write_port_checkpoint`.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v, dtype=np.float32)
    return out


def _port_name(path: str) -> str:
    """The port parameter of flax path `path` (the inverse of
    flax_name)."""
    parts = path.split("/")
    if parts[-1] == "kernel" and parts[0] != "lm_head":
        return ".".join(parts[:-1]) + ".weight"
    return ".".join(parts)


def _is_conv(parts: list[str]) -> bool:
    """Whether the module at `parts[:-1]` is a ResNet conv (flax's
    auto-named `Conv_i`, `conv_init`, `conv_proj`)."""
    return len(parts) > 1 and parts[-2].startswith(("Conv_", "conv_"))


def _leaf_to_port(path: str, a: np.ndarray) -> np.ndarray:
    """A flax-layout leaf at `path` in the port's layout: HWIO conv
    kernels become OIHW, [in..., out...] kernels [out, in], q/k/v and qkv
    folding their heads into out and o into in; the rest as they are."""
    parts = path.split("/")
    if parts[-1] == "kernel" and parts[0] != "lm_head":
        if _is_conv(parts):
            return a.transpose(3, 2, 0, 1)
        n_in = 2 if parts[-2] == "o" else 1
        return a.reshape(int(np.prod(a.shape[:n_in])), -1).T
    return a


def unstack_pipeline(tree: Mapping[str, Any]) -> dict:
    """The reference's pipelined tree with its stage-stacked blocks
    (`pipeline/ticks/stages/block_p`, leaves [pp, ...]) as the
    sequential tree (`layer_{s * n/pp + p}`); any other tree as it is."""
    stages = tree.get("pipeline", {}).get("ticks", {}).get("stages") \
        if isinstance(tree.get("pipeline"), Mapping) else None
    if stages is None:
        return dict(tree)
    out = {k: v for k, v in tree.items() if k != "pipeline"}
    lps = len(stages)
    for p, block in stages.items():
        flat = _flatten(block)
        pp = next(iter(flat.values())).shape[0]
        for s in range(pp):
            out[f"layer_{s * lps + int(p[len('block_'):])}"] = _nest(
                {k: a[s] for k, a in flat.items()})
    return out


def stack_pipeline(tree: Mapping[str, Any], stages: int) -> dict:
    """The inverse of unstack_pipeline: `layer_i` subtrees stacked into
    the reference's `pipeline/ticks/stages/block_p` over `stages`."""
    layers = sorted((k for k in tree if k.startswith("layer_")),
                    key=lambda k: int(k[len("layer_"):]))
    lps = len(layers) // stages
    out = {k: v for k, v in tree.items() if not k.startswith("layer_")}
    blocks = {}
    for p in range(lps):
        per = [_flatten(tree[f"layer_{s * lps + p}"]) for s in range(stages)]
        blocks[f"block_{p}"] = _nest({k: np.stack([f[k] for f in per])
                                      for k in per[0]})
    out["pipeline"] = {"ticks": {"stages": blocks}}
    return out


def flax_to_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Map a flax `params` tree (nested dicts of arrays) to the port
    model's state_dict entries of those parameters; every tensor is f32
    on the CPU. A `batch_stats` tree maps the same way, to the
    BatchNorm buffers; a pipelined tree to the sequential names."""
    return {_port_name(path): torch.tensor(np.ascontiguousarray(
                _leaf_to_port(path, a)))
            for path, a in _flatten(unstack_pipeline(params)).items()}


def _to_flax_leaf(name: str, t: torch.Tensor, head_dim: int) -> np.ndarray:
    view, perm = flax_layout(name, t.shape, head_dim)
    return np.ascontiguousarray(
        t.detach().cpu().float().reshape(view).permute(perm).numpy())


def _nest(flat: Mapping[str, Any]) -> dict:
    tree: dict = {}
    for path, a in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = a
    return tree


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor],
                       head_dim: int | None,
                       pipeline_stages: int = 0) -> dict:
    """The inverse of `flax_to_state_dict`: port parameters (or
    BatchNorm buffers) as a nested flax tree of f32 numpy arrays, in the
    flax layout. `head_dim` is the attention head width (None for a
    ResNet); pipeline_stages > 1 stacks the blocks as the reference's
    pipelined model holds them."""
    tree = _nest({flax_name(n): _to_flax_leaf(n, t, head_dim)
                  for n, t in state_dict.items()})
    return stack_pipeline(tree, pipeline_stages) \
        if pipeline_stages > 1 else tree


def flax_layout(name: str, shape, head_dim: int | None
                ) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(view, perm) such that `p.view(view).permute(perm)` is port
    parameter `name` of `shape` in the flax tree's layout: conv weights
    OIHW -> HWIO, q/k/v weights [H*D, d] -> [d, H, D], qkv [3*H*D, d] ->
    [d, 3, H, D], the o weight [d, H*D] -> [H, D, d], the other
    projections [out, in] -> [in, out]; the rest as they are."""
    shape = tuple(shape)
    parts = name.split(".")
    if parts[-1] != "weight":
        return shape, tuple(range(len(shape)))
    if len(shape) == 4:
        return shape, (2, 3, 1, 0)
    n_out, n_in = shape
    if parts[-2] == "qkv":
        return (3, n_out // (3 * head_dim), head_dim, n_in), (3, 0, 1, 2)
    if parts[-3:-1] in (["attn", "q"], ["attn", "k"], ["attn", "v"]):
        return (n_out // head_dim, head_dim, n_in), (2, 0, 1)
    if parts[-2] == "o":
        return (n_out, n_in // head_dim, head_dim), (1, 2, 0)
    return shape, (1, 0)


def flax_shape(name: str, shape, head_dim: int | None) -> tuple[int, ...]:
    """The shape port parameter `name` has in the flax tree."""
    view, perm = flax_layout(name, shape, head_dim)
    return tuple(view[i] for i in perm)


def flax_name(name: str) -> str:
    """The flax path of port parameter `name`: `layer_0.attn.q.weight`
    -> `layer_0/attn/q/kernel`; `lm_head.kernel`, `embedding` and the
    norm scales keep their leaf name."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)


def _to_torch(a) -> torch.Tensor:
    """An array (bf16 from ml_dtypes included) as a CPU tensor of the
    same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def flax_cache_to_port(cache: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A flax decode-cache tree (`cache` of the reference's
    init_cache / init_paged_cache, or of a mutated apply) as the port's
    flat cache dict: `layer_0/attn/cached_key` -> tensor, dtypes kept.
    The layouts are the same ([B, S, Hkv, D] rows, [NP, PS, Hkv, D]
    pools)."""
    out: dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(v, key)
            else:
                out[key] = _to_torch(v)

    walk(cache, "")
    return out


def quantized_to_flax(params: Mapping[str, Any], head_dim: int
                      ) -> dict[str, np.ndarray]:
    """The port's quantized params (serving/quant.py quantize_params) as
    the flat leaves of the reference's quantized tree: a QTensor under
    `<flax path>/int8` or `/int4` (codes) and `/scale`; any other
    parameter under its flax path, in f32. All in the flax layout."""
    out: dict[str, np.ndarray] = {}
    for name, p in params.items():
        path = flax_name(name)
        if hasattr(p, "flax_codes"):
            out[f"{path}/{p.kind}"] = p.flax_codes().cpu().numpy()
            out[f"{path}/scale"] = p.flax_scale().cpu().numpy()
        else:
            view, perm = flax_layout(name, p.shape, head_dim)
            out[path] = p.detach().cpu().float().reshape(view).permute(
                perm).numpy()
    return out


def port_cache_to_flax(cache: Mapping[str, torch.Tensor]) -> dict:
    """The reverse of `flax_cache_to_port`: the port's flat cache dict
    as a nested flax cache tree of numpy arrays, dtypes kept (bf16 as
    ml_dtypes' bfloat16). Dense, rolling ([B, W, Hkv, D] with int8
    scales) and paged caches alike."""
    tree: dict = {}
    for name, t in cache.items():
        *parents, leaf = name.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            node[leaf] = t.float().numpy().astype(ml_dtypes.bfloat16)
        else:
            node[leaf] = t.numpy()
    return tree


# -- optimizer states --------------------------------------------------------

def _states(tree) -> list:
    """Every namedtuple node of an optax state (a chain is a tuple of
    them), depth first."""
    out = []
    if hasattr(tree, "_fields"):
        out.append(tree)
        for v in tree:
            out.extend(_states(v))
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            out.extend(_states(v))
    return out


def _find(tree, *fields: str):
    for node in _states(tree):
        if all(f in node._fields for f in fields):
            return node
    raise ValueError(f"optimizer state has no node with {fields}")


def opt_state_to_port(opt_state, params: Mapping[str, Any], optimizer: str
                      ) -> dict[str, dict]:
    """An optax state of the reference's `optimizer` ("adamw", "sgdm" or
    "adafactor") over flax `params` as the port's optimizer state:
    {port parameter name: that parameter's state}."""
    from kubeflow_tpu_torch.runtime.optim import factored_dims

    if "pipeline" in params and optimizer == "adafactor":
        raise ValueError(_ADAFACTOR_STACKED)
    flat_params = _flatten(unstack_pipeline(params))
    if optimizer == "adamw":
        node = _find(opt_state, "count", "mu", "nu")
        count = float(np.asarray(node.count))
        mu, nu = (_flatten(unstack_pipeline(t)) for t in (node.mu, node.nu))
        return {_port_name(p): {
                    "step": torch.tensor(count, dtype=torch.float32),
                    "exp_avg": torch.tensor(np.ascontiguousarray(
                        _leaf_to_port(p, mu[p]))),
                    "exp_avg_sq": torch.tensor(np.ascontiguousarray(
                        _leaf_to_port(p, nu[p])))}
                for p in flat_params}
    if optimizer == "sgdm":
        trace = _flatten(unstack_pipeline(_find(opt_state, "trace").trace))
        return {_port_name(p): {"momentum_buffer": torch.tensor(
                    np.ascontiguousarray(_leaf_to_port(p, trace[p])))}
                for p in flat_params}
    if optimizer == "adafactor":
        node = _find(opt_state, "count", "v_row", "v_col", "v")
        count = int(np.asarray(node.count))
        v_row, v_col, v = (_flatten(t) for t in (node.v_row, node.v_col,
                                                 node.v))
        out = {}
        for p, a in flat_params.items():
            if factored_dims(a.shape) is None:
                st = {"v": torch.tensor(v[p])}
            else:
                st = {"v_row": torch.tensor(v_row[p]),
                      "v_col": torch.tensor(v_col[p])}
            out[_port_name(p)] = {"step": count, **st}
        return out
    raise ValueError(f"no optax state conversion for optimizer "
                     f"{optimizer!r} (adamw, sgdm, adafactor)")


_ADAFACTOR_STACKED = (
    "adafactor state of a pipelined tree: the reference factors and clips "
    "each stage-stacked tensor as a whole, which no per-layer state holds")


def _port_count(opt_state: Mapping[str, dict]) -> int:
    steps = {int(st["step"]) for st in opt_state.values() if "step" in st}
    if len(steps) > 1:
        raise ValueError(f"parameters at different update counts {steps}")
    if not steps and any(opt_state.values()):
        raise ValueError("this optimizer state keeps no update count "
                         "(torch SGD): pass step=")
    return steps.pop() if steps else 0


def opt_state_to_flax(opt_state: Mapping[str, dict],
                      params: Mapping[str, torch.Tensor], template,
                      head_dim: int | None, step: int | None = None,
                      pipeline_stages: int = 0):
    """The port's optimizer state over `params` (the model's parameters)
    as an optax state shaped like `template` (e.g. `tx.init(params)` of
    the reference's make_optimizer): each node of the template is
    rebuilt with numpy leaves, adam moments and sgd traces in the flax
    layout, the unused adafactor statistics as shape-(1,) zeros. The
    count is `step`, else the state's own (SGD keeps none).
    pipeline_stages > 1 stacks the blocks' states as the pipelined
    model's (adamw, sgdm)."""
    from kubeflow_tpu_torch.runtime.optim import factored_dims

    count = np.asarray(_port_count(opt_state) if step is None else step,
                       np.int32)
    one = np.zeros((1,), np.float32)

    def state(name: str, key: str):
        st = opt_state.get(name, {})
        return st.get(key)

    def tree(fn) -> dict:
        out = _nest({flax_name(n): fn(n, t) for n, t in params.items()})
        return stack_pipeline(out, pipeline_stages) \
            if pipeline_stages > 1 else out

    def layout_leaf(key):
        def f(n, t):
            v = state(n, key)
            return _to_flax_leaf(n, v if v is not None else
                                 torch.zeros_like(t), head_dim)
        return f

    def factored_leaf(key):
        def f(n, t):
            shape = flax_shape(n, t.shape, head_dim)
            dims = factored_dims(shape)
            used = (key == "v") == (dims is None)
            if not used:
                return one.copy()
            v = state(n, key)
            if v is not None:
                return np.asarray(v.detach().cpu().float().numpy())
            if dims is None:
                return np.zeros(shape, np.float32)
            d1, d0 = dims
            drop = d0 if key == "v_row" else d1
            return np.zeros([s for i, s in enumerate(shape) if i != drop],
                            np.float32)
        return f

    def rebuild(node):
        if hasattr(node, "_fields"):
            fields = node._fields
            if {"mu", "nu"} <= set(fields):
                return node._replace(count=count, mu=tree(layout_leaf("exp_avg")),
                                     nu=tree(layout_leaf("exp_avg_sq")))
            if fields == ("trace",):
                return node._replace(trace=tree(layout_leaf("momentum_buffer")))
            if {"v_row", "v_col", "v"} <= set(fields):
                if pipeline_stages > 1:
                    raise ValueError(_ADAFACTOR_STACKED)
                return node._replace(count=count,
                                     v_row=tree(factored_leaf("v_row")),
                                     v_col=tree(factored_leaf("v_col")),
                                     v=tree(factored_leaf("v")))
            if fields == ("count",):
                return node._replace(count=count)
            return type(node)(*(rebuild(v) for v in node))
        if isinstance(node, (tuple, list)):
            return type(node)(rebuild(v) for v in node)
        return node

    return rebuild(template)


def write_port_checkpoint(directory: str, step: int,
                          flax_params: Mapping[str, Any], flax_opt_state,
                          optimizer: str,
                          batch_stats: Mapping[str, Any] | None = None
                          ) -> None:
    """A port checkpoint at `step` from a reference run's numpy trees:
    `flax_params` (TrainState.params), `flax_opt_state`
    (TrainState.opt_state) of the reference's `optimizer` and
    `batch_stats` (TrainState.batch_stats, a ResNet's BatchNorm
    statistics). The port's Trainer with this `checkpoint_dir` resumes
    from it. Steps already in `directory` are left as they are (no
    retention runs), and one at `step` itself is replaced."""
    from kubeflow_tpu_torch.runtime.checkpoint import Checkpointer

    payload = {"step": int(step), "params": flax_to_state_dict(flax_params),
               "batch_stats": flax_to_state_dict(batch_stats or {}),
               "opt_state": opt_state_to_port(flax_opt_state, flax_params,
                                              optimizer)}
    ckpt = Checkpointer(directory, keep=0, world_size=1, num_slices=1)
    try:
        ckpt.save(int(step), payload, force=True)
    finally:
        ckpt.close()
