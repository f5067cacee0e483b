"""ResNet v1.5 (port of kubeflow_tpu/models/resnet.py): the tf-cnn
benchmark network, registered as resnet18/50/101.

bf16 convolutions and activations, BatchNorm with f32 parameters and
running statistics, an f32 head. The layout is the reference's, kept on
the card's terms:
- inputs arrive NHWC f32 (`runtime/data.py` synthetic_images,
  `runtime/records.py` image_batches); NHWC viewed as NCHW is
  `torch.channels_last`, the layout cuDNN's bf16 convolutions want, so
  the parameters are kept channels_last too;
- flax "SAME" padding is asymmetric for strided windows (lax puts the
  odd pixel at the end): `same_pads` computes lax's pads and a window
  whose pads differ pads explicitly (zeros for a conv, -inf for the
  max-pool) before it runs unpadded;
- `space_to_depth` orders channels (dy, dx, c) as the reference does;
- BatchNorm follows flax's update: momentum 0.9 on the running mean and
  on the *biased* batch variance (`BatchNorm.forward`); eval mode uses
  the running statistics. The last norm of each block starts at zero
  scale.
Module and parameter names follow the flax tree (`BottleneckBlock_3.
Conv_1.weight` is `BottleneckBlock_3/Conv_1/kernel`, `BatchNorm_0.mean`
is the batch_stats leaf `BatchNorm_0/mean`), so `convert.py` maps one
onto the other. Convolutions, norms, pooling and the head are cuDNN,
cuBLAS and torch calls: the reference computes them in XLA, with no
Pallas kernel.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.registry import register_model
from kubeflow_tpu_torch.models.transformer import Dense, as_dtype

BN_MOMENTUM = 0.9          # flax's: running = 0.9 * running + 0.1 * batch
BN_EPS = 1e-5
STEMS = ("conv7", "space_to_depth")


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """lax.padtype_to_pads for "SAME" on one spatial dim: the output is
    ceil(size / stride), the total pad max((out - 1) * stride + k - size,
    0), the smaller half before."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0
              ) -> tuple[torch.Tensor, tuple[int, int]]:
    """x [B, C, H, W] ready for a k x k window at `stride` with flax's
    "SAME" pads: returns the input (padded explicitly when a dim's pads
    differ) and the symmetric padding left for the op itself."""
    (ht, hb), (wl, wr) = (same_pads(x.shape[-2], k, stride),
                          same_pads(x.shape[-1], k, stride))
    if ht == hb and wl == wr:
        return x, (ht, wl)
    return F.pad(x, (wl, wr, ht, hb), value=value), (0, 0)


class Conv(nn.Module):
    """flax nn.Conv(use_bias=False, padding="SAME", dtype=dtype): an f32
    kernel stored OIHW, applied in `dtype`."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 dtype: torch.dtype, device):
        super().__init__()
        self.k, self.stride, self.dtype = k, stride, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, device=device))

    def forward(self, x):
        x, pad = _pad_same(x, self.k, self.stride)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        stride=self.stride, padding=pad)


# Set while a remat replay runs the forward again (`frozen_batch_stats`):
# the running statistics moved in the first pass and must not move twice.
_STATS_FROZEN = False


@contextlib.contextmanager
def frozen_batch_stats():
    """BatchNorm normalizes with the batch's statistics as in training
    but leaves the running ones as they are (whole-forward remat's
    recompute, runtime/trainer.py)."""
    global _STATS_FROZEN
    prev, _STATS_FROZEN = _STATS_FROZEN, True
    try:
        yield
    finally:
        _STATS_FROZEN = prev


class BatchNorm(nn.Module):
    """flax nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=dtype) over the
    channel dim of [B, C, H, W]: f32 `scale` and `bias`, f32 running
    `mean` and `var` buffers (the batch_stats collection), output in
    `dtype`. Training normalizes with the batch's statistics and moves
    the running ones toward them; eval normalizes with the running ones."""

    def __init__(self, c: int, dtype: torch.dtype, device,
                 zero_scale: bool = False):
        super().__init__()
        self.dtype = dtype
        self.zero_scale = zero_scale
        self.scale = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("mean", torch.zeros(c, device=device))
        self.register_buffer("var", torch.ones(c, device=device))
        # the process group of the data-parallel ranks (runtime/trainer.py):
        # training statistics over the global batch
        self.group = None

    def forward(self, x):
        x = x.to(self.dtype)
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                                training=False, eps=BN_EPS)
        if self.group is not None:
            return self._global(x)
        # torch moves the running variance toward the UNBIASED batch
        # variance, flax toward the biased one: let torch update copies
        # (autograd keeps what it was given), then scale the variance's
        # step by (n - 1) / n
        n = x.numel() // x.shape[1]
        mean, var = self.mean.clone(), self.var.clone()
        y = F.batch_norm(x, mean, var, self.scale, self.bias,
                         training=True, momentum=1.0 - BN_MOMENTUM, eps=BN_EPS)
        with torch.no_grad():
            kept = self.var * BN_MOMENTUM
            var = kept + (var - kept) * ((n - 1) / n)
            self._move(mean, var)
        return y

    def _move(self, mean, var) -> None:
        """Running statistics := (mean, var), unless a remat replay runs
        (`frozen_batch_stats`): then the same copies go to the new values
        themselves, so the replay runs the first pass's operations (a
        selective-checkpoint replay must) and the statistics stay."""
        dst = (mean, var) if _STATS_FROZEN else (self.mean, self.var)
        dst[0].copy_(mean)
        dst[1].copy_(var)


    def _global(self, x):
        """Batch statistics over every rank's rows: the per-channel count,
        sum and sum of squares in f32, summed over the group (the
        backward sums too: every rank's output depends on every rank's
        rows), then flax's biased variance E[x^2] - E[x]^2."""
        x32 = x.float()
        stats = torch.cat([x32.sum((0, 2, 3)), x32.square().sum((0, 2, 3)),
                           x32.new_full((1,), x.numel() // x.shape[1])])
        stats = _SumOver.apply(stats, self.group)
        c = x.shape[1]
        n = stats[-1]
        mean = stats[:c] / n
        var = (stats[c:2 * c] / n - mean.square()).clamp_min(0.0)
        with torch.no_grad():
            self._move(self.mean * BN_MOMENTUM + mean * (1.0 - BN_MOMENTUM),
                       self.var * BN_MOMENTUM + var * (1.0 - BN_MOMENTUM))
        shape = (1, c, 1, 1)
        y = (x32 - mean.view(shape)) * torch.rsqrt(var.view(shape) + BN_EPS)
        return (y * self.scale.view(shape) + self.bias.view(shape)).to(
            self.dtype)


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over `group`, in both passes."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class ResNetBlock(nn.Module):
    """Basic residual block (ResNet-18/34)."""

    def __init__(self, cin: int, filters: int, stride: int,
                 dtype: torch.dtype, device):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, 3, stride, dtype, device)
        self.BatchNorm_0 = BatchNorm(filters, dtype, device)
        self.Conv_1 = Conv(filters, filters, 3, 1, dtype, device)
        self.BatchNorm_1 = BatchNorm(filters, dtype, device, zero_scale=True)
        self.proj = stride != 1 or cin != filters
        if self.proj:
            self.conv_proj = Conv(cin, filters, 1, stride, dtype, device)
            self.norm_proj = BatchNorm(filters, dtype, device)
        self.cout = filters

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        if self.proj:
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    """Bottleneck residual block (ResNet-50/101), v1.5: the stride on
    the 3x3."""

    def __init__(self, cin: int, filters: int, stride: int,
                 dtype: torch.dtype, device):
        super().__init__()
        cout = filters * 4
        self.Conv_0 = Conv(cin, filters, 1, 1, dtype, device)
        self.BatchNorm_0 = BatchNorm(filters, dtype, device)
        self.Conv_1 = Conv(filters, filters, 3, stride, dtype, device)
        self.BatchNorm_1 = BatchNorm(filters, dtype, device)
        self.Conv_2 = Conv(filters, cout, 1, 1, dtype, device)
        self.BatchNorm_2 = BatchNorm(cout, dtype, device, zero_scale=True)
        self.proj = stride != 1 or cin != cout
        if self.proj:
            self.conv_proj = Conv(cin, cout, 1, stride, dtype, device)
            self.norm_proj = BatchNorm(cout, dtype, device)
        self.cout = cout

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        if self.proj:
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/b, W/b, b*b*C], channels in (dy, dx, c)
    order (the reference's; F.pixel_unshuffle would give (c, dy, dx))."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        b, h // block, w // block, block * block * c)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """The reference ResNet's fields, plus `in_channels`: flax reads the
    input's channels at init, a torch module needs them up front."""

    stage_sizes: tuple[int, ...]
    block: str                      # "basic" | "bottleneck"
    num_classes: int = 1000
    num_filters: int = 64
    dtype: Any = torch.bfloat16
    stem: str = "conv7"
    in_channels: int = 3

    def __post_init__(self) -> None:
        object.__setattr__(self, "dtype", as_dtype(self.dtype))
        object.__setattr__(self, "stage_sizes", tuple(self.stage_sizes))
        if self.stem not in STEMS:
            raise ValueError(f"unknown stem {self.stem!r}: "
                             "expected 'conv7' or 'space_to_depth'")


class ResNet(nn.Module):
    """images [B, H, W, C] f32 (NHWC) -> f32 logits [B, num_classes].
    Built on `device` (cuda unless "cpu" is asked for), weights drawn
    from `seed` by the reference's initializers (lecun-normal kernels,
    unit norm scales but the zero-init last norm of each block)."""

    def __init__(self, cfg: ResNetConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        dt, f = cfg.dtype, cfg.num_filters
        if cfg.stem == "space_to_depth":
            self.conv_init = Conv(4 * cfg.in_channels, f, 4, 1, dt, dev)
        else:
            self.conv_init = Conv(cfg.in_channels, f, 7, 2, dt, dev)
        self.bn_init = BatchNorm(f, dt, dev)
        block_cls = BottleneckBlock if cfg.block == "bottleneck" \
            else ResNetBlock
        # flax's auto-names: BottleneckBlock_0, BottleneckBlock_1, ...
        self.block_names, cin = [], f
        for i, size in enumerate(cfg.stage_sizes):
            for j in range(size):
                stride = 2 if i > 0 and j == 0 else 1
                blk = block_cls(cin, f * 2 ** i, stride, dt, dev)
                self.block_names.append(
                    f"{block_cls.__name__}_{len(self.block_names)}")
                self.add_module(self.block_names[-1], blk)
                cin = blk.cout
        # flax nn.Dense(dtype=float32): the classifier head in f32
        self.head = Dense(cin, cfg.num_classes, torch.float32, dev, bias=True)
        if dev.type != "meta":
            self._init_weights(torch.Generator(device=dev).manual_seed(seed))
        # NHWC viewed as NCHW: the convolutions' layout on the card
        self.to(memory_format=torch.channels_last)

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        # lecun_normal: a normal truncated at 2 std, scaled so the
        # variance is 1 / fan_in
        for m in self.modules():
            if isinstance(m, (Conv, Dense)):
                w = m.weight
                fan_in = math.prod(w.shape[1:])
                std = (1.0 / fan_in) ** 0.5 / .87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
            if isinstance(m, BatchNorm) and m.zero_scale:
                m.scale.zero_()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = images.to(cfg.dtype)
        if cfg.stem == "space_to_depth":
            x = space_to_depth(x, 2)
        x = x.permute(0, 3, 1, 2)          # NHWC memory, NCHW shape
        x = F.relu(self.bn_init(self.conv_init(x)))
        x, pad = _pad_same(x, 3, 2, value=-math.inf)
        x = F.max_pool2d(x, 3, 2, padding=pad)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.head(x.mean(dim=(2, 3)))


def _build(stage_sizes, block, device=None, seed: int = 0, **kw) -> ResNet:
    fields = {f.name for f in dataclasses.fields(ResNetConfig)}
    unknown = set(kw) - fields
    if unknown:
        raise ValueError(f"unknown resnet kwargs {sorted(unknown)}")
    return ResNet(ResNetConfig(stage_sizes, block, **kw), device=device,
                  seed=seed)


@register_model("resnet18")
def resnet18(device=None, seed: int = 0, **kw) -> ResNet:
    return _build((2, 2, 2, 2), "basic", device, seed, **kw)


@register_model("resnet50")
def resnet50(device=None, seed: int = 0, **kw) -> ResNet:
    return _build((3, 4, 6, 3), "bottleneck", device, seed, **kw)


@register_model("resnet101")
def resnet101(device=None, seed: int = 0, **kw) -> ResNet:
    return _build((3, 4, 23, 3), "bottleneck", device, seed, **kw)


_STAGES = {
    "resnet18": ([2, 2, 2, 2], "basic"),
    "resnet50": ([3, 4, 6, 3], "bottleneck"),
    "resnet101": ([3, 4, 23, 3], "bottleneck"),
}


def fwd_flops(model: str, image_size: int = 224, num_classes: int = 1000,
              num_filters: int = 64, stem: str = "conv7") -> float:
    """Forward FLOPs per image, 2 per MAC, convs and the head (BN, relu
    and pooling excluded): the reference's count, copied."""
    if model not in _STAGES:
        raise ValueError(f"unknown resnet variant {model!r}")
    stage_sizes, kind = _STAGES[model]
    flops = 0.0

    def conv(h, w, cin, cout, k, stride=1):
        nonlocal flops
        ho, wo = -(-h // stride), -(-w // stride)   # SAME padding
        flops += 2.0 * ho * wo * k * k * cin * cout
        return ho, wo

    h = w = image_size
    if stem == "space_to_depth":
        h, w = h // 2, w // 2
        h, w = conv(h, w, 12, num_filters, 4, 1)
    else:
        h, w = conv(h, w, 3, num_filters, 7, 2)
    h, w = -(-h // 2), -(-w // 2)                   # 3x3/s2 max-pool
    cin = num_filters
    for i, n_blocks in enumerate(stage_sizes):
        f = num_filters * 2 ** i
        out_ch = f * 4 if kind == "bottleneck" else f
        for j in range(n_blocks):
            stride = 2 if i > 0 and j == 0 else 1
            if kind == "bottleneck":
                conv(h, w, cin, f, 1)
                h, w = conv(h, w, f, f, 3, stride)
                conv(h, w, f, out_ch, 1)
            else:
                h, w = conv(h, w, cin, f, 3, stride)
                conv(h, w, f, f, 3)
            if cin != out_ch or stride != 1:        # projection shortcut
                flops += 2.0 * h * w * cin * out_ch
            cin = out_ch
    flops += 2.0 * cin * num_classes                # head
    return flops
