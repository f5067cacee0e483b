"""Flash attention: CUDA kernels for Hopper, and their plain versions.

Port of kubeflow_tpu/ops/flash_attention.py. The three Pallas TPU
kernels become three hand-written CUDA kernels for sm_90a (TMA and
wgmma: `csrc/flash_fwd.cu`, `csrc/flash_bwd.cu` (dq),
`csrc/flash_bwd_dkv.cu`, built by `_build.py`):

- forward: out and the row logsumexp `lse`, online softmax over k/v tiles;
- backward dq, and backward dk/dv, both recomputing p from `lse`, with
  delta = rowsum(dO * O) computed here in torch, as the JAX code does
  it in XLA outside its kernels.

Tensors stay in the public [B, L, H, D] layout all the way into the
kernels (no [B*H, L, D] transpose), and grouped-query attention reads kv
head h // (H / Hkv) instead of repeating k/v.

On a CPU tensor every entry point runs the plain blockwise version
(`flash_fwd_plain`, `flash_bwd_plain`), which uses the TPU kernels' mask
and block-skip rules at the requested block sizes. On a CUDA tensor it
launches the kernel or raises; nothing falls back. Each kernel tiles at
its own `KERNEL_TILES` entry whatever block sizes are asked: blocking
changes only the output of a row that no key may attend (it averages the
keys of the blocks that ran, as on the TPU), never a row that sees a key.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from kubeflow_tpu_torch.ops import _build

# The plain version's default blocking: that of the reference, so the
# CPU tests compare like with like.
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
KERNEL_HEAD_DIMS = (64, 128)
# (block_q, block_k) of each CUDA kernel by head dim, as its source fixes
# them (FwdTile in csrc/flash_fwd.cu, DqTile in csrc/flash_bwd.cu, DkvTile
# in csrc/flash_bwd_dkv.cu)
KERNEL_TILES = {
    "flash_fwd": {64: (128, 128), 128: (128, 128)},
    "flash_bwd_dq": {64: (128, 128), 128: (128, 64)},
    "flash_bwd_dkv": {64: (64, 128), 128: (64, 128)},
}
ALL_KERNEL_TILES = sorted({t for by_d in KERNEL_TILES.values()
                           for t in by_d.values()})
KERNEL_LENGTH = max(max(t) for t in ALL_KERNEL_TILES)


def kernel_blocks(name: str, head_dim: int) -> dict[str, int]:
    """The plain version's block sizes that match kernel `name`'s tiles at
    `head_dim`."""
    block_q, block_k = KERNEL_TILES[name][head_dim]
    return dict(block_q=block_q, block_k=block_k)


NEG_INF = -1e30

# Launches of each CUDA kernel, counted where the wrapper launches it.
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# --------------------------------------------------------------------------
# mask and block-skip rules (the reference's _block_mask, _block_runs)
# --------------------------------------------------------------------------

def _block_runs(*, causal, block_q, block_k, qi, ki, offset, window=0) -> bool:
    """Whether the (qi, ki) block pair can hold any valid logit."""
    run = True
    if causal:
        run = ki * block_k <= qi * block_q + (block_q - 1) + offset
    if window > 0:
        closest = (qi * block_q + offset) - (ki * block_k + block_k - 1)
        run = run and closest < window
    return run


def _block_mask(*, causal, window, qpos, kpos, offset, qseg=None, kseg=None):
    """Validity of q rows `qpos` [Lq] against keys `kpos` [BK]: causal
    (end-aligned), window (i - window, i], segment equality ([B, Lq] vs
    [B, BK]). Shape broadcastable to [B, H, Lq, BK]; None = all valid."""
    mask = None
    if causal:
        mask = (qpos[:, None] + offset) >= kpos[None, :]
    if window > 0:
        near = (qpos[:, None] + offset - kpos[None, :]) < window
        mask = near if mask is None else mask & near
    if qseg is not None:
        seg = (qseg[:, :, None] == kseg[:, None, :])[:, None]
        mask = seg if mask is None else mask & seg
    return mask


def _rows_run(*, causal, block_q, block_k, ki, offset, window, lq, device):
    """[Lq] bool: the rows whose q block runs against k block `ki`."""
    runs = [_block_runs(causal=causal, block_q=block_q, block_k=block_k,
                        qi=qi, ki=ki, offset=offset, window=window)
            for qi in range(lq // block_q)]
    return torch.tensor(runs, device=device).repeat_interleave(block_q)


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """[B, L, Hkv, D] -> f32 [B, H, L, D], q head i reading kv head
    i // (H / Hkv)."""
    idx = torch.arange(h, device=x.device) // (h // x.shape[2])
    return x.index_select(2, idx).transpose(1, 2).float()


# --------------------------------------------------------------------------
# plain versions (CPU tests; on the card, the kernels' yardstick)
# --------------------------------------------------------------------------

def flash_fwd_plain(q, k, v, qseg=None, kseg=None, *, scale, causal,
                    block_q, block_k, window=0):
    """Blockwise forward in torch. q [B, Lq, H, D], k/v [B, Lk, Hkv, D],
    qseg/kseg int [B, L] or None. Returns (out [B, Lq, H, D] in q's
    dtype, lse [B, H, Lq] f32). Products take operands rounded to the
    input dtype and accumulate in f32, as the kernels do."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    offset = lk - lq
    qf = q.transpose(1, 2).float()
    kf, vf = _heads(k, h), _heads(v, h)
    qpos = torch.arange(lq, device=q.device)
    m = torch.full((b, h, lq), NEG_INF, device=q.device)
    l = torch.zeros((b, h, lq), device=q.device)
    acc = torch.zeros((b, h, lq, d), device=q.device)
    for ki in range(lk // block_k):
        run = _rows_run(causal=causal, block_q=block_q, block_k=block_k,
                        ki=ki, offset=offset, window=window, lq=lq,
                        device=q.device)
        if not bool(run.any()):
            continue
        ks = slice(ki * block_k, (ki + 1) * block_k)
        s = qf @ kf[:, :, ks].transpose(-1, -2) * scale     # [B, H, Lq, BK]
        mask = _block_mask(causal=causal, window=window, qpos=qpos,
                           kpos=torch.arange(lk, device=q.device)[ks],
                           offset=offset, qseg=qseg,
                           kseg=None if kseg is None else kseg[:, ks])
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_new = l * alpha + p.sum(-1)
        acc_new = (acc * alpha[..., None]
                   + p.to(v.dtype).float() @ vf[:, :, ks])
        m = torch.where(run, m_new, m)
        l = torch.where(run, l_new, l)
        acc = torch.where(run[:, None], acc_new, acc)
    l = l.clamp_min(1e-20)
    out = (acc / l[..., None]).to(q.dtype).transpose(1, 2).contiguous()
    return out, m + torch.log(l)


def flash_bwd_plain(q, k, v, out, lse, g, qseg=None, kseg=None, *, scale,
                    causal, block_q, block_k, window=0):
    """Blockwise backward in torch from the forward's lse. Returns
    (dq, dk, dv) in the layouts and dtypes of q, k, v; dk/dv sum over
    each kv head's group of q heads."""
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    offset = lk - lq
    qf, gf = q.transpose(1, 2).float(), g.transpose(1, 2).float()
    kf, vf = _heads(k, h), _heads(v, h)
    delta = flash_delta(out, g)
    qpos = torch.arange(lq, device=q.device)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for ki in range(lk // block_k):
        run = _rows_run(causal=causal, block_q=block_q, block_k=block_k,
                        ki=ki, offset=offset, window=window, lq=lq,
                        device=q.device)[:, None]
        if not bool(run.any()):
            continue
        ks = slice(ki * block_k, (ki + 1) * block_k)
        s = qf @ kf[:, :, ks].transpose(-1, -2) * scale
        mask = _block_mask(causal=causal, window=window, qpos=qpos,
                           kpos=torch.arange(lk, device=q.device)[ks],
                           offset=offset, qseg=qseg,
                           kseg=None if kseg is None else kseg[:, ks])
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - lse[..., None])
        dp = gf @ vf[:, :, ks].transpose(-1, -2)
        ds = p * (dp - delta[..., None]) * scale
        p = torch.where(run, p, 0.0)
        ds = torch.where(run, ds, 0.0)
        dq += ds.to(k.dtype).float() @ kf[:, :, ks]
        dv[:, :, ks] = p.to(g.dtype).float().transpose(-1, -2) @ gf
        dk[:, :, ks] = ds.to(q.dtype).float().transpose(-1, -2) @ qf

    def kv_grad(x, like):
        x = x.reshape(b, hkv, h // hkv, lk, d).sum(2)
        return x.transpose(1, 2).to(like.dtype).contiguous()

    dq = dq.transpose(1, 2).to(q.dtype).contiguous()
    return dq, kv_grad(dk, k), kv_grad(dv, v)


# --------------------------------------------------------------------------
# CUDA kernel wrappers
# --------------------------------------------------------------------------

def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def _check_kernel_inputs(q, k, v, *rest, segs=()):
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    for name, x in (("q", q), ("k", k), ("v", v), *rest):
        if x.device != q.device or not x.is_contiguous():
            raise ValueError(f"flash kernel: {name} must be contiguous on "
                             f"{q.device}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"flash kernel takes bf16, got {name} "
                             f"{x.dtype}")
        if x.data_ptr() % 16:
            raise ValueError(f"flash kernel: {name} is not 16-byte aligned")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {KERNEL_HEAD_DIMS}, "
                         f"got {d}")
    if lq % KERNEL_LENGTH or lk % KERNEL_LENGTH:
        raise ValueError(f"flash kernel needs lengths ({lq}, {lk}) that are "
                         f"multiples of {KERNEL_LENGTH}")
    if h % hkv or v.shape[:3] != k.shape[:3] or k.shape[0] != b:
        raise ValueError(f"flash kernel: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    for x, n in segs:
        if x is not None and (x.dtype != torch.int32 or not x.is_contiguous()
                              or x.device != q.device
                              or tuple(x.shape) != (b, n)
                              or x.data_ptr() % 16):
            raise ValueError("flash kernel: segment ids must be contiguous, "
                             f"16-byte aligned int32 [B, L] on {q.device}")


def flash_fwd_cuda(q, k, v, qseg=None, kseg=None, *, scale, causal,
                   window=0):
    """Forward kernel. Same contract as flash_fwd_plain, bf16 only."""
    _check_kernel_inputs(q, k, v, segs=((qseg, q.shape[1]),
                                        (kseg, k.shape[1])))
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_fwd.cu")
    with torch.cuda.device(q.device):
        err = lib.kft_flash_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(qseg), _ptr(kseg), _ptr(out),
            _ptr(lse), b, h, hkv, lq, lk, d, float(scale), int(causal),
            int(window), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def _bwd_args(q, k, v, g, lse, delta, qseg, kseg):
    return (_ptr(q), _ptr(k), _ptr(v), _ptr(g), _ptr(lse), _ptr(delta),
            _ptr(qseg), _ptr(kseg))


def _check_rows(q, *rows):
    want = (q.shape[0], q.shape[2], q.shape[1])
    for x in rows:
        if (x.dtype != torch.float32 or not x.is_contiguous()
                or x.device != q.device or tuple(x.shape) != want
                or x.data_ptr() % 16):
            raise ValueError(f"flash kernel: lse/delta must be contiguous, "
                             f"16-byte aligned f32 {list(want)} on "
                             f"{q.device}")


def flash_bwd_dq_cuda(q, k, v, g, lse, delta, qseg=None, kseg=None, *,
                      scale, causal, window=0):
    """dq kernel. lse/delta are f32 [B, H, Lq]."""
    _check_kernel_inputs(q, k, v, ("dout", g),
                         segs=((qseg, q.shape[1]), (kseg, k.shape[1])))
    _check_rows(q, lse, delta)
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    lib = _build.library("flash_bwd.cu")
    with torch.cuda.device(q.device):
        err = lib.kft_flash_bwd_dq(
            *_bwd_args(q, k, v, g, lse, delta, qseg, kseg), _ptr(dq),
            b, h, hkv, lq, lk, d, float(scale), int(causal), int(window),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, g, lse, delta, qseg=None, kseg=None, *,
                       scale, causal, window=0):
    """dk/dv kernel, summing over each kv head's group of q heads."""
    _check_kernel_inputs(q, k, v, ("dout", g),
                         segs=((qseg, q.shape[1]), (kseg, k.shape[1])))
    _check_rows(q, lse, delta)
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.library("flash_bwd_dkv.cu")
    with torch.cuda.device(q.device):
        err = lib.kft_flash_bwd_dkv(
            *_bwd_args(q, k, v, g, lse, delta, qseg, kseg), _ptr(dk),
            _ptr(dv), b, h, hkv, lq, lk, d, float(scale), int(causal),
            int(window), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def flash_delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, [B, H, Lq] contiguous."""
    return (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


# --------------------------------------------------------------------------
# the dispatcher ops and the public entry point
# --------------------------------------------------------------------------
#
# The forward and backward are `torch.library` custom ops (`kftpu::
# flash_fwd`, `kftpu::flash_bwd`): the plain version is their CPU kernel
# and the CUDA launch their CUDA kernel, so a CUDA tensor never reaches
# the plain version. As dispatcher ops they are visible to selective
# activation checkpointing, which keys on ops: a remat policy can save
# the forward's (out, lse) as the reference names them `attn_flash`
# (kubeflow_tpu/ops/flash_attention.py, _flash_vjp_fwd), where a kernel
# launched inside an autograd.Function would be invisible to it.


@torch.library.custom_op("kftpu::flash_fwd", mutates_args=(),
                         device_types="cpu")
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              qseg: Optional[torch.Tensor], kseg: Optional[torch.Tensor],
              scale: float, causal: bool, block_q: int, block_k: int,
              window: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of flash attention. block_q / block_k block the plain
    version; the CUDA kernels tile at KERNEL_TILES."""
    return flash_fwd_plain(q, k, v, qseg, kseg, scale=scale, causal=causal,
                           block_q=block_q, block_k=block_k, window=window)


@flash_fwd.register_kernel("cuda")
def _flash_fwd_cuda_op(q, k, v, qseg, kseg, scale, causal, block_q, block_k,
                       window):
    return flash_fwd_cuda(q, k, v, qseg, kseg, scale=scale, causal=causal,
                          window=window)


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, qseg, kseg, scale, causal, block_q, block_k,
                    window):
    b, lq, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, lq), dtype=torch.float32)


@torch.library.custom_op("kftpu::flash_bwd", mutates_args=(),
                         device_types="cpu")
def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
              qseg: Optional[torch.Tensor], kseg: Optional[torch.Tensor],
              scale: float, causal: bool, block_q: int, block_k: int,
              window: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's out and lse and the cotangent g."""
    return flash_bwd_plain(q, k, v, out, lse, g, qseg, kseg, scale=scale,
                           causal=causal, block_q=block_q, block_k=block_k,
                           window=window)


@flash_bwd.register_kernel("cuda")
def _flash_bwd_cuda_op(q, k, v, out, lse, g, qseg, kseg, scale, causal,
                       block_q, block_k, window):
    cfg = dict(scale=scale, causal=causal, window=window)
    delta = flash_delta(out, g)
    dq = flash_bwd_dq_cuda(q, k, v, g, lse, delta, qseg, kseg, **cfg)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, g, lse, delta, qseg, kseg, **cfg)
    return dq, dk, dv


@flash_bwd.register_fake
def _flash_bwd_fake(q, k, v, out, lse, g, qseg, kseg, scale, causal,
                    block_q, block_k, window):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_setup(ctx, inputs, output):
    """Twin of the JAX custom_vjp's residuals (_flash_vjp_fwd): q, k, v,
    out and lse; segment ids take no gradient, nor does lse."""
    q, k, v, qseg, kseg, *args = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse, qseg, kseg)
    ctx.args = args
    ctx.mark_non_differentiable(lse)


def _flash_backward(ctx, g, _g_lse):
    q, k, v, out, lse, qseg, kseg = ctx.saved_tensors
    dq, dk, dv = flash_bwd(q, k, v, out, lse, g.contiguous(), qseg, kseg,
                           *ctx.args)
    return dq, dk, dv, None, None, None, None, None, None, None


flash_fwd.register_autograd(_flash_backward, setup_context=_flash_setup)


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"flash attention runs on cuda or cpu, not {x.device}")


def _fit_block(block: int, length: int) -> int:
    """Clamp to the sequence, then halve until the block divides it (not
    below 128)."""
    block = min(block, length)
    while block > 128 and length % block:
        block //= 2
    return block


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K,
                    segment_ids: torch.Tensor | None = None,
                    kv_segment_ids: torch.Tensor | None = None,
                    window: int = 0) -> torch.Tensor:
    """Fused attention. [B, L, H, D] in and out; GQA via fewer kv heads.
    block_q / block_k block the plain version; on the card each kernel
    tiles at its KERNEL_TILES entry and other sizes are ignored, with a
    warning.

    window > 0 masks keys further than window-1 positions in the past
    (one-sided). segment_ids [B, L] mask attention across packed
    documents; kv_segment_ids defaults to segment_ids."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    if _on_card(q) and (block_q, block_k) not in {
            (DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K), *ALL_KERNEL_TILES}:
        warnings.warn(f"flash attention on {q.device}: block sizes "
                      f"({block_q}, {block_k}) are ignored, the CUDA kernels "
                      f"tile at (block_q, block_k) {KERNEL_TILES}",
                      stacklevel=2)
    if h % k.shape[2]:
        raise ValueError(f"{h} q heads not a multiple of {k.shape[2]} kv heads")
    block_q = _fit_block(block_q, lq)
    block_k = _fit_block(block_k, lk)
    if lq % block_q or lk % block_k:
        raise ValueError(
            f"sequence lengths ({lq}, {lk}) must be multiples of the block "
            f"sizes ({block_q}, {block_k}); pad inputs or pass block sizes")
    if kv_segment_ids is not None and segment_ids is None:
        raise ValueError(
            "kv_segment_ids without segment_ids: key-side masking would be "
            "dropped; pass the query ids too")
    qseg = kseg = None
    if segment_ids is not None:
        if kv_segment_ids is None:
            kv_segment_ids = segment_ids
        qseg = segment_ids.to(torch.int32).contiguous()
        kseg = kv_segment_ids.to(torch.int32).contiguous()
    out, _ = flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(), qseg,
                       kseg, float(scale), bool(causal), block_q, block_k,
                       int(window))
    return out
