"""The port's twin of `__graft_entry__.entry`: the flagship LM's forward
and its example arguments.

    fn, (params, tokens) = entry()          # on the card
    logits = fn(params, tokens)             # [2, 256, 8192] f32

gpt-125m widths (d 768, 12 q = 12 kv heads of 64, d_ff 3072) cut to 4
layers, vocab 8192, max_seq 512, bf16, attention_impl auto; tokens are
ones [2, 256] and every parameter is zero, as in the reference. On the
card, `auto` sends this forward (L 256, head_dim 64, bf16) to the CUDA
flash kernel, one launch per layer; on the CPU it takes the plain
reference attention. Runs on `cuda` unless `device="cpu"` is given.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.registry import get_model

CONFIG = dict(vocab_size=8192, n_layers=4, max_seq_len=512)
TOKENS_SHAPE = (2, 256)


def entry(device: str | torch.device | None = None):
    """(fn, (params, tokens)): fn(params, tokens) -> f32 logits
    [2, 256, 8192] of the forward with `params` (a name -> tensor dict,
    zeros here) in place of the model's own."""
    # shapes on the meta device, then zeros on the target: nothing is
    # drawn, as the reference zeros the shapes of an eval_shape
    model = get_model("gpt-125m", device="meta", **CONFIG)
    model = model.to_empty(device=resolve_device(device))
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    params = {k: v.detach() for k, v in model.state_dict().items()}
    tokens = torch.ones(TOKENS_SHAPE, dtype=torch.long, device=model.device)

    def fwd(params, tokens):
        with torch.no_grad():
            return model.apply(params, tokens)

    return fwd, (params, tokens)
