"""Windowed profiler trace capture over a training loop (port of
kubeflow_tpu/runtime/profiler.py's TraceWindow, over torch.profiler).

TrainConfig.profile_dir arms a capture of steps [profile_start_step,
profile_start_step + profile_steps) inside Trainer.fit: host ops and,
on a CUDA device, every kernel the process launches (the port's own
kernels included: they are CUDA launches like any other). The window
is written as a Chrome trace, `<profile_dir>/trace_<pid>_<start>.json`,
readable in Perfetto and chrome://tracing.

Default start step 2: step 0 pays the kernel builds and the allocator's
warm-up; the window should show steady state. The reference's
on-demand capture server (JAXRT_PROFILER_PORT) has no counterpart here.
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger("kubeflow_tpu_torch.profiler")


class TraceWindow:
    """Arms a [start, start+steps) trace window over a training loop.

    Call .step(global_step) once per step *before* running it; the window
    starts and stops itself, once. Safe to call .stop() again (fit's
    finally path): a trace is never left open on an exception."""

    def __init__(self, trace_dir: str | None, start_step: int = 2,
                 num_steps: int = 3):
        self.trace_dir = trace_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof = None
        self._started_at: int | None = None
        self.captured = False
        self.path: str | None = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    @property
    def enabled(self) -> bool:
        return bool(self.trace_dir) and not self.captured

    def step(self, global_step: int) -> None:
        if not self.enabled:
            return
        if (self._prof is None
                and self.start_step <= global_step < self.stop_step):
            import torch
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(self.trace_dir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
            self._started_at = global_step
            log.info("profiler: tracing steps [%d, %d) -> %s",
                     global_step, self.stop_step, self.trace_dir)
        elif self._prof is not None and global_step >= self.stop_step:
            self.stop()

    def stop(self) -> None:
        if self._prof is None:
            return
        import torch

        prof, self._prof = self._prof, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        self.captured = True
        self.path = os.path.join(
            self.trace_dir, f"trace_{os.getpid()}_{self._started_at}.json")
        prof.export_chrome_trace(self.path)
        log.info("profiler: trace written to %s", self.path)
