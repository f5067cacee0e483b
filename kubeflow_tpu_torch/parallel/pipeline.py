"""Pipeline parallelism over the `pipe` mesh axis: the GPipe schedule
(port of kubeflow_tpu/parallel/pipeline.py).

The reference stacks every stage's blocks on a leading stage dim
sharded over `pipe` and runs n_microbatches + n_stages - 1 ticks of
one SPMD program, shifting the activation buffer one stage per tick.
Here each rank of a pipe group is one stage and holds only its blocks
(`apply_pipeline`: stage s runs layers s*n/pp .. (s+1)*n/pp - 1 and
drops the rest; the embedding, the final norm and the head stay on
every stage, used on the first and the last). `GPipe.step` runs the
same schedule as processes do: the batch is cut into n_mb contiguous
microbatches; in the forward, stage s receives microbatch j's
activation from stage s-1, runs its blocks and sends the result to
s+1 (microbatch j leaves stage s at tick j + s, so the run takes
n_mb + pp - 1 ticks); the last stage applies the head and the loss.
The backward runs the microbatches back through the stages, each
stage receiving the gradient of its output from the next and sending
the gradient of its input to the previous. The function is the
sequential model's: only the parameter placement and the schedule
differ.

`dcn_pipeline_levels` is the reference's axes -> levels map that lays
`pipe` over the slow level (whole stages per node; only the stage
handoff crosses nodes), for `CollectivesBackend.mesh(levels=...)`.
"""

from __future__ import annotations

from typing import Callable

import torch

from kubeflow_tpu_torch.parallel.mesh import AXIS_DCN, AXIS_PIPELINE


def dcn_pipeline_levels() -> dict[str, str]:
    """{dcn: dcn, pipe: dcn}: the stages across nodes, everything else on
    the fast level."""
    from kubeflow_tpu_torch.parallel import backends as B

    return {AXIS_DCN: B.LEVEL_DCN, AXIS_PIPELINE: B.LEVEL_DCN}


def stage_layers(n_layers: int, n_stages: int, stage: int) -> list[int]:
    """The layers of `stage`: n_layers / n_stages consecutive ones."""
    per = n_layers // n_stages
    return list(range(stage * per, (stage + 1) * per))


def apply_pipeline(model, pipe) -> None:
    """Keep the blocks of stage pipe.rank (a mesh.AxisGroup of the pipe
    axis) and drop the others from `model`."""
    cfg = model.cfg
    if cfg.n_layers % pipe.size:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by "
                         f"pipeline_stages={pipe.size}")
    keep = stage_layers(cfg.n_layers, pipe.size, pipe.rank)
    for i in model.layer_ids:
        if i not in keep:
            delattr(model, f"layer_{i}")
    model.layer_ids = keep


class GPipe:
    """The GPipe schedule of `model` (this rank's stage, `apply_pipeline`)
    over `pipe` (the pipe axis' AxisGroup)."""

    def __init__(self, model, pipe):
        self.model, self.pipe = model, pipe
        ranks = pipe.ranks
        self.first, self.last = pipe.rank == 0, pipe.rank == pipe.size - 1
        self.prev = None if self.first else ranks[pipe.rank - 1]
        self.next = None if self.last else ranks[pipe.rank + 1]
        self.last_rank = ranks[-1]

    def _send(self, x: torch.Tensor, to: int) -> None:
        import torch.distributed as dist

        dist.send(x.contiguous(), to, group=self.pipe.group)

    def _recv(self, shape, dtype, device, frm: int) -> torch.Tensor:
        import torch.distributed as dist

        x = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(x, frm, group=self.pipe.group)
        return x

    def _forward(self, tokens: torch.Tensor, n_mb: int, grad: bool):
        """Each microbatch through this stage: (inputs, outputs), the
        inputs received from the previous stage (leaves that take a
        gradient) and this stage's outputs (sent on unless last)."""
        model = self.model
        cfg = model.cfg
        mb = tokens.shape[0] // n_mb
        ins, outs = [], []
        for j in range(n_mb):
            tok = tokens[j * mb:(j + 1) * mb]
            if self.first:
                x = model.embed(tok)
            else:
                x = self._recv((mb, tok.shape[1], cfg.d_model), cfg.dtype,
                               tok.device, self.prev)
                x.requires_grad_(grad)
            ins.append(x)
            y = model.run_blocks(x, model.positions(tok))
            if not self.last:
                self._send(y.detach(), self.next)
            outs.append(y)
        return ins, outs

    def step(self, tokens: torch.Tensor, targets: torch.Tensor,
             loss_fn: Callable) -> tuple[torch.Tensor, ...]:
        """Forward and backward of one batch: loss_fn(x, targets) ->
        (mean loss, accuracy) of the last block's output x over its valid
        targets. Each microbatch's loss weighs by its valid count, so
        the gradients in .grad are those of the sum; returns (loss sum,
        accuracy sum, valid count), nonzero on the last stage only."""
        n_mb = self.model.check_pipeline(tokens.shape[0])
        mb = tokens.shape[0] // n_mb
        ins, outs = self._forward(tokens, n_mb, grad=True)
        zero = torch.zeros((), device=tokens.device)
        loss_sum = acc_sum = n_sum = zero
        for j in range(n_mb):
            if self.last:
                y = targets[j * mb:(j + 1) * mb]
                loss, acc = loss_fn(outs[j], y)
                n = (y >= 0).sum().float()
                (loss * n).backward()
                loss_sum = loss_sum + loss.detach() * n
                acc_sum = acc_sum + acc.detach() * n
                n_sum = n_sum + n
            else:
                g = self._recv(outs[j].shape, outs[j].dtype, tokens.device,
                               self.next)
                outs[j].backward(g)
            if not self.first:
                self._send(ins[j].grad, self.prev)
        return loss_sum, acc_sum, n_sum

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """The model's f32 logits for `tokens`, on every stage of the
        group (the last stage computes them and broadcasts)."""
        import torch.distributed as dist

        model = self.model
        n_mb = model.check_pipeline(tokens.shape[0])
        _, outs = self._forward(tokens, n_mb, grad=False)
        if self.last:
            out = torch.cat([model.head(y) for y in outs])
        else:
            out = torch.empty(*tokens.shape, model.cfg.vocab_size,
                              device=tokens.device)
        dist.broadcast(out, self.last_rank, group=self.pipe.group)
        return out
