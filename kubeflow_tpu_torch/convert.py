"""Flax TransformerLM parameters -> the port's state_dict.

Layouts of the reference tree (kubeflow_tpu/models/transformer.py):
- `layer_i/attn/{q,k,v}/kernel` [d, H, D] and `o/kernel` [H, D, d];
- `layer_i/mlp/{gate,up,down}/kernel` [in, out];
- `layer_i/ln_{attn,mlp}/scale`, `ln_f/scale` [d] f32;
- `embedding` [V, d] f32; `lm_head/kernel` [d, V] f32.
torch Linear weights are [out, in], so every projection is transposed;
the embedding and the head kernel keep their layout.
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
