"""The bidirectional pre-norm encoder block that ViT and BERT share (the
reference's `ViTBlock`, kubeflow_tpu/models/vit.py, and `EncoderBlock`,
kubeflow_tpu/models/bert.py, are the same computation).

RMSNorm -> qkv -> attention (non-causal, the plain `reference_attention`
as in the reference, with segment ids when given) -> o -> residual;
RMSNorm -> fc1 -> gelu (flax's default: the tanh approximation) -> fc2
-> residual. Parameter names follow the flax tree: `qkv.weight` is the
DenseGeneral kernel [d, 3, h, d_head] as [3*h*d_head, d], `o.weight` the
kernel [h, d_head, d] as [d, h*d_head] (`convert.py`).

Tensor parallelism (parallel/shardings.py): with the qkv weight split
on its heads the block attends at this rank's heads, entering through
`tp_in` and leaving through `tp_out` after o; with fc1 split on its
columns, `mlp_tp_in` / `mlp_tp_out` frame the MLP and fc2's bias is
added once, after the sum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.models.transformer import Dense, RMSNorm, _identity
from kubeflow_tpu_torch.ops.attention import reference_attention


class EncoderBlock(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 dtype: torch.dtype, device):
        super().__init__()
        self.n_heads, self.d_head = n_heads, d_model // n_heads
        inner = n_heads * self.d_head
        self.ln_attn = RMSNorm(d_model, dtype, device)
        self.qkv = Dense(d_model, 3 * inner, dtype, device)
        self.o = Dense(inner, d_model, dtype, device)
        self.ln_mlp = RMSNorm(d_model, dtype, device)
        self.fc1 = Dense(d_model, d_ff, dtype, device, bias=True)
        self.fc2 = Dense(d_ff, d_model, dtype, device, bias=True)
        self.tp_in = self.tp_out = _identity
        self.mlp_tp_in = self.mlp_tp_out = _identity

    def forward(self, x: torch.Tensor,
                segment_ids: torch.Tensor | None = None, ring: bool = False,
                seq=None) -> torch.Tensor:
        """With `seq` (a mesh.AxisGroup; x is then this rank's block of
        positions): the bidirectional ring attention over it when `ring`,
        else the plain attention of this rank's queries over the K/V
        gathered from every rank (ops/seq_attention.py); without one the
        plain attention."""
        b, l, _ = x.shape
        qkv = self.qkv(self.tp_in(self.ln_attn(x))).view(b, l, 3, -1,
                                                         self.d_head)
        q, k, v = qkv.unbind(2)
        if ring:
            from kubeflow_tpu_torch.ops.ring_attention import ring_attention

            att = ring_attention(q, k, v, seq=seq, causal=False,
                                 segment_ids=segment_ids)
        elif seq is not None:
            from kubeflow_tpu_torch.ops.seq_attention import seq_attention

            att = seq_attention(q, k, v, seq=seq, causal=False,
                                impl="reference", segment_ids=segment_ids)
        else:
            att = reference_attention(q, k, v, causal=False,
                                      segment_ids=segment_ids)
        x = x + self.tp_out(self.o(att.reshape(b, l, -1)))
        h = F.gelu(self.fc1(self.mlp_tp_in(self.ln_mlp(x))),
                   approximate="tanh")
        if self.mlp_tp_out is _identity:
            return x + self.fc2(h)
        fc2 = self.fc2
        y = self.mlp_tp_out(F.linear(h.to(fc2.dtype), fc2.weight.to(fc2.dtype)))
        return x + (y + fc2.bias.to(fc2.dtype))


def init_normal(module: nn.Module, gen: torch.Generator,
                std: dict[str, float], default: float = 0.02) -> None:
    """Draw every parameter of `module` from `gen` as the reference's
    initializers do: norm scales stay one, biases zero, a name in `std`
    gets normal(std[name]) (0 keeps it zero), the rest normal(default)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("scale", "bias"):
                continue
            s = std.get(name, default)
            if s:
                p.normal_(0.0, s, generator=gen)
            else:
                p.zero_()
