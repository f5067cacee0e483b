"""Flax TransformerLM parameters -> the port's state_dict.

Layouts of the reference tree (kubeflow_tpu/models/transformer.py):
- `layer_i/attn/{q,k,v}/kernel` [d, H, D] and `o/kernel` [H, D, d];
- `layer_i/mlp/{gate,up,down}/kernel` [in, out];
- `layer_i/ln_{attn,mlp}/scale`, `ln_f/scale` [d] f32;
- `embedding` [V, d] f32; `lm_head/kernel` [d, V] f32.
torch Linear weights are [out, in], so every projection is transposed;
the embedding and the head kernel keep their layout. `flax_layout` is
the inverse rule: it shows a port parameter in its flax shape, which is
what the optimizer's factoring follows (runtime/optim.py).
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


def flax_to_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Map a flax TransformerLM `params` tree (nested dicts of arrays) to a
    `TransformerLM.state_dict()`; every tensor is f32 on the CPU."""
    out: dict[str, torch.Tensor] = {}
    for path, a in _flatten(params).items():
        parts = path.split("/")
        if parts[-1] == "kernel" and parts[0] != "lm_head":
            # [in..., out...] -> [out, in]; q/k/v fold (H, D) into out,
            # o folds (H, D) into in
            n_in = 2 if parts[-2] == "o" else 1
            a = a.reshape(int(np.prod(a.shape[:n_in])), -1).T
            name = ".".join(parts[:-1]) + ".weight"
        else:
            name = ".".join(parts)
        out[name] = torch.tensor(a)
    return out


def flax_layout(name: str, shape, head_dim: int
                ) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(view, perm) such that `p.view(view).permute(perm)` is port
    parameter `name` of `shape` in the flax tree's layout: q/k/v weights
    [H*D, d] -> [d, H, D], the o weight [d, H*D] -> [H, D, d], the other
    projections [out, in] -> [in, out]; the rest as they are."""
    shape = tuple(shape)
    parts = name.split(".")
    if parts[-1] != "weight":
        return shape, tuple(range(len(shape)))
    n_out, n_in = shape
    if parts[-3:-1] in (["attn", "q"], ["attn", "k"], ["attn", "v"]):
        return (n_out // head_dim, head_dim, n_in), (2, 0, 1)
    if parts[-3:-1] == ["attn", "o"]:
        return (n_out, n_in // head_dim, head_dim), (1, 2, 0)
    return shape, (1, 0)


def flax_shape(name: str, shape, head_dim: int) -> tuple[int, ...]:
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
