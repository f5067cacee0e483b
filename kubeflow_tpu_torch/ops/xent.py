"""Chunked LM-head cross-entropy: the loss without the [B, L, V] logits.

Port of kubeflow_tpu/ops/xent.py. Each sequence chunk projects its
hidden states through the head kernel, reduces to loss / hit / count
sums and drops its logits; `torch.utils.checkpoint` recomputes a
chunk's logits in the backward instead of saving them, so peak
vocab-wide memory is O(B.(L/C).V) in both passes.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


class _HeadProduct(torch.autograd.Function):
    """x @ kernel with both operands rounded to a 16-bit type and f32
    logits out (the reference's preferred_element_type=float32), on the
    card's tensor-core GEMM. The gradients round as those of
    `head_logits_plain` do (dx to x's dtype, dkernel to `dtype`, then
    kernel's), with one difference: the f32 cotangent is rounded to
    `dtype` too, since the GEMM takes 16-bit operands. chip_smoke.py and
    tests/test_torch_kernels_cuda.py hold both against each other."""

    @staticmethod
    def forward(ctx, x, kernel, dtype):
        xb, wb = x.to(dtype), kernel.to(dtype)
        ctx.save_for_backward(xb, wb)
        ctx.dtypes = (x.dtype, kernel.dtype)
        return torch.mm(xb, wb, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        gb = g.to(xb.dtype)
        x_dtype, k_dtype = ctx.dtypes
        return (gb @ wb.t()).to(x_dtype), (xb.t() @ gb).to(k_dtype), None


def head_logits_plain(x: torch.Tensor, kernel: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """The exact products of the rounded operands, summed in f32."""
    return x.to(dtype).float() @ kernel.to(dtype).float()


def head_logits(x: torch.Tensor, kernel: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """f32 logits of x [..., d] through kernel [d, V], operands in `dtype`:
    a 16-bit GEMM on the card, `head_logits_plain` elsewhere."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda" and dtype != torch.float32:
        out = _HeadProduct.apply(x2, kernel, dtype)
    else:
        out = head_logits_plain(x2, kernel, dtype)
    return out.reshape(*lead, kernel.shape[-1])


def _chunk(x, kernel, y, dtype):
    logits = head_logits(x, kernel, dtype)                 # [B, c, V] f32
    valid = y >= 0
    lse = torch.logsumexp(logits, dim=-1)
    correct = logits.gather(-1, y.clamp_min(0)[..., None])[..., 0]
    hits = ((logits.argmax(-1) == y) & valid).sum()
    return ((lse - correct) * valid).sum(), hits, valid.sum()


def chunked_lm_xent(hidden: torch.Tensor, kernel: torch.Tensor,
                    labels: torch.Tensor, n_chunks: int,
                    compute_dtype: torch.dtype = torch.bfloat16):
    """Mean cross-entropy and argmax accuracy of an LM head, chunked over
    the sequence.

    hidden [B, L, D], kernel [D, V] (f32), labels [B, L] int; L must be a
    multiple of n_chunks. Negative labels are ignored; the loss is the
    mean over valid positions. Returns (loss, accuracy), f32 scalars."""
    b, l, d = hidden.shape
    if l % n_chunks:
        raise ValueError(f"seq_len {l} not divisible by n_chunks {n_chunks}")
    c = l // n_chunks
    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    hit_sum = n_sum = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for i in range(n_chunks):
        part = slice(i * c, (i + 1) * c)
        ls, hits, n = checkpoint(_chunk, hidden[:, part], kernel,
                                 labels[:, part], compute_dtype,
                                 use_reentrant=False)
        loss_sum = loss_sum + ls
        hit_sum = hit_sum + hits
        n_sum = n_sum + n
    n = n_sum.clamp_min(1).float()
    return loss_sum / n, hit_sum.float() / n
