"""Windowed profiler trace capture over a training loop (port of
kubeflow_tpu/runtime/profiler.py's TraceWindow, over torch.profiler).

TrainConfig.profile_dir arms a capture of steps [profile_start_step,
profile_start_step + profile_steps) inside Trainer.fit: host ops and,
on a CUDA device, every kernel the process launches (the port's own
kernels included: they are CUDA launches like any other). The window
is written as a Chrome trace, `<profile_dir>/trace_<pid>_<start>.json`,
readable in Perfetto and chrome://tracing.

Default start step 2: step 0 pays the kernel builds and the allocator's
warm-up; the window should show steady state.

On-demand capture: with JAXRT_PROFILER_PORT set, the launcher's
`--config` path starts a small HTTP server on that port (0 picks a free
one; the bound port is logged, "profiler capture server on :<port>").
`GET /capture?steps=N` (default 3, TraceWindow's num_steps; `timeout=S`,
default 60) arms a window over the next N steps of the running
Trainer.fit and answers with its Chrome trace as the body (the
`X-Capture-Steps` header names the global steps it holds). It answers
409 while a window is open or armed (one armed by another request or
by profile_dir: torch.profiler windows cannot nest), 504 when no step
hook of fit ran within the timeout, 503 when fit ended before the window
opened. The trace is written under profile_dir when fit has one, else
to a temporary directory that goes once the answer is sent. The
reference's variable starts xprof's collection server, which
TensorBoard's "Capture profile" drives over xprof's gRPC; nothing
installed gives the port that protocol, so this trigger is its
counterpart: the same variable and the same result, a trace of the live
job's next steps. The profiler is started and stopped on the training
thread, from fit's step hook, never from the HTTP thread. With
`--nproc-per-node` local worker r listens on the port + r.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import threading

log = logging.getLogger("kubeflow_tpu_torch.profiler")

ENV_PROFILER_PORT = "JAXRT_PROFILER_PORT"
CAPTURE_STEPS = 3            # TraceWindow's num_steps
CAPTURE_TIMEOUT_S = 60.0     # the longest a request waits on a step hook


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


class CaptureError(Exception):
    """A capture that gave no trace: `status` is the HTTP answer."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class Capture:
    """One on-demand request: its window once fit opens it, and the
    trace file once the window is closed."""

    def __init__(self, steps: int, trace_dir: str | None):
        self.steps = steps
        self.temporary = trace_dir is None
        self.trace_dir = trace_dir or tempfile.mkdtemp(prefix="kftpu-capture-")
        self.window: TraceWindow | None = None
        self.first = self.last = None   # the global steps it holds
        self.error: CaptureError | None = None
        self.abandoned = False          # its request gave up waiting
        self.done = False

    def discard(self) -> None:
        if self.temporary:
            shutil.rmtree(self.trace_dir, ignore_errors=True)


class CaptureBroker:
    """The on-demand capture's two ends. The HTTP thread arms a capture
    (`request`) and waits for it; fit's step hook (`before_step`, on the
    training thread) opens an armed capture's window, closes it after
    its steps and lets the configured window (profile_dir) step while
    no on-demand window is open; `end` (fit's finally) closes an open
    window and fails an armed one."""

    def __init__(self):
        self._cond = threading.Condition()
        self._armed: Capture | None = None
        self._open: Capture | None = None
        self._configured_open = False
        self._profile_dir: str | None = None
        self._hooks = 0               # step hooks so far
        self._step: int | None = None   # the step the last hook began

    # -- the HTTP thread ------------------------------------------------

    def request(self, steps: int = CAPTURE_STEPS,
                timeout_s: float = CAPTURE_TIMEOUT_S) -> Capture:
        """Arm a capture of the next `steps` steps and wait until it is
        written; raises CaptureError (409 while a window is open or
        armed; 504 when no step hook ran for `timeout_s`; 503 when fit
        ended before the window opened)."""
        with self._cond:
            if self._armed or self._open or self._configured_open:
                raise CaptureError(409, "a profiler window is open or armed "
                                   "already: torch.profiler windows cannot "
                                   "nest")
            cap = self._armed = Capture(steps, self._profile_dir)
            seen = self._hooks
            while not cap.done:
                self._cond.wait(timeout_s)
                if cap.done:
                    break
                if self._hooks == seen:
                    if self._armed is cap:
                        self._armed = None
                        cap.discard()
                    else:
                        cap.abandoned = True   # closed at fit's next hook
                    raise CaptureError(504, f"no training step began within "
                                       f"{timeout_s:g} s")
                seen = self._hooks
        if cap.error is not None:
            cap.discard()
            raise cap.error
        return cap

    # -- the training thread --------------------------------------------

    def begin(self, profile_dir: str | None) -> None:
        """fit starts: on-demand traces go to its profile_dir, if set."""
        with self._cond:
            self._profile_dir = profile_dir

    def before_step(self, global_step: int, configured: TraceWindow) -> None:
        """fit's hook before each step."""
        with self._cond:
            cap = self._open
            if cap is not None and global_step >= cap.window.stop_step:
                self._close(cap, global_step - 1)
            if self._open is None:
                configured.step(global_step)
            self._configured_open = configured.active
            cap = self._armed
            if cap is not None:
                self._armed = None
                if configured.active:
                    cap.error = CaptureError(409, "the profile_dir window "
                                             "opened first")
                    self._finish(cap)
                else:
                    cap.window = TraceWindow(cap.trace_dir, global_step,
                                             cap.steps)
                    cap.first = global_step
                    try:
                        cap.window.step(global_step)
                        self._open = cap
                    except Exception as e:   # the answer says so
                        log.exception("profiler: on-demand capture failed")
                        cap.error = CaptureError(500, f"capture failed: {e}")
                        self._finish(cap)
            self._hooks += 1
            self._step = global_step
            self._cond.notify_all()

    def end(self) -> None:
        """fit ends (or unwinds): the open window is closed with the
        steps it has; an armed capture fails."""
        with self._cond:
            if self._open is not None:
                self._close(self._open, self._step)
            if self._armed is not None:
                cap, self._armed = self._armed, None
                cap.error = CaptureError(503, "training ended before the "
                                         "window opened")
                self._finish(cap)
            self._configured_open = False
            self._profile_dir = self._step = None
            self._cond.notify_all()

    def _close(self, cap: Capture, last: int) -> None:
        """Stop `cap`'s window after global step `last`."""
        self._open = None
        cap.last = last
        try:
            cap.window.stop()
        except Exception as e:   # the answer says so; training goes on
            log.exception("profiler: on-demand capture failed")
            cap.error = CaptureError(500, f"capture failed: {e}")
        self._finish(cap)

    def _finish(self, cap: Capture) -> None:
        cap.done = True
        if cap.abandoned:
            cap.discard()
        self._cond.notify_all()


# the process's broker: the capture server's requests meet fit here
CAPTURES = CaptureBroker()


def start_server_from_env(env: dict[str, str] | None = None,
                          broker: CaptureBroker = CAPTURES):
    """Start the on-demand capture server when JAXRT_PROFILER_PORT is
    set; returns the HttpService (its `.port` is the bound one) or
    None."""
    env = dict(os.environ) if env is None else env
    port_s = env.get(ENV_PROFILER_PORT)
    if not port_s:
        return None
    from kubeflow_tpu_torch.utils import httpd

    def capture(req: httpd.HttpReq) -> httpd.HttpResp:
        try:
            steps = int(req.q1("steps", str(CAPTURE_STEPS)))
            timeout_s = float(req.q1("timeout", str(CAPTURE_TIMEOUT_S)))
        except ValueError as e:
            raise httpd.ApiHttpError(400, f"bad query: {e}")
        if steps < 1 or not timeout_s > 0:
            raise httpd.ApiHttpError(400, "steps >= 1 and timeout > 0")
        try:
            cap = broker.request(steps, timeout_s)
        except CaptureError as e:
            raise httpd.ApiHttpError(e.status, str(e))
        try:
            with open(cap.window.path, "rb") as f:
                body = f.read()
        finally:
            cap.discard()
        return httpd.HttpResp(body=body, headers={
            "X-Capture-Steps": f"{cap.first}-{cap.last}",
            "X-Trace-Path": "" if cap.temporary else cap.window.path})

    router = httpd.Router("profiler")
    router.route("GET", "/capture", capture)
    httpd.add_health_routes(router)
    server = httpd.HttpService(router, "0.0.0.0", int(port_s))
    server.serve_background()
    log.info("profiler capture server on :%d (GET /capture?steps=N)",
             server.port)
    return server
