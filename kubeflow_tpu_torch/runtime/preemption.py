"""Graceful preemption/maintenance handling (the port's copy of
kubeflow_tpu/runtime/preemption.py).

When the platform warns a worker (SIGTERM from the kubelet on pod
eviction or ahead of node maintenance), the trainer finishes the
in-flight step, saves a checkpoint, and exits EX_TEMPFAIL — the JAXJob
controller then gang-restarts the job, which resumes from that
checkpoint instead of losing the interval since the last periodic save.

The notice also records a *grace deadline*: the kubelet enforces
terminationGracePeriodSeconds after SIGTERM, and ``remaining_grace()``
says how much wall time is left before SIGKILL. Nothing in the port
reads it yet: the elastic coordinator that would waits for the port's
distributed runtime (ROADMAP Queue 1 item 16), and the checkpointer
always makes its one kind of save.

Usage (wired by the launcher):
    notice = PreemptionNotice().install()
    summary = trainer.fit(stop=notice)
    if summary.get("preempted"):
        sys.exit(EX_TEMPFAIL)
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time

log = logging.getLogger("kubeflow_tpu_torch.preemption")

# A preempted worker must NOT exit 0 (the controller would count it
# Succeeded) nor look like a crash-only failure: EX_TEMPFAIL is the
# conventional "transient, retry me" exit status.
EX_TEMPFAIL = 75

# Kubernetes' terminationGracePeriodSeconds default: the window between
# SIGTERM and SIGKILL. The JAXJob controller does not override it, so
# 30s is the honest default when the env var is absent.
DEFAULT_GRACE_S = 30.0
ENV_GRACE = "JAXJOB_TERMINATION_GRACE_S"


class PreemptionNotice:
    """Callable flag set by SIGTERM (and available for tests/manual
    triggering via .trigger()), carrying the grace wall-deadline.

    ``grace_s`` defaults from $JAXJOB_TERMINATION_GRACE_S (the pod's
    terminationGracePeriodSeconds, when the template projects it) else
    the kube default of 30s. ``clock`` is injectable (monotonic
    seconds) so the deadline math is testable without sleeping."""

    def __init__(self, grace_s: float | None = None, clock=time.monotonic):
        self._event = threading.Event()
        self._prev_handler = None
        self._signum: int | None = None
        self._clock = clock
        if grace_s is None:
            try:
                grace_s = float(os.environ.get(ENV_GRACE, ""))
            except ValueError:
                grace_s = DEFAULT_GRACE_S
        self.grace_s = grace_s
        self._deadline: float | None = None

    def install(self, signum: int = signal.SIGTERM) -> "PreemptionNotice":
        """Install the signal handler (main thread only — launcher entry).
        Chains to any previously installed handler. Idempotent: a second
        install() of the same signal is a no-op — naive re-chaining
        would make the handler its own "previous" and fire it twice per
        signal (and uninstall() could never reach the original)."""
        if self._signum is not None:
            if signum != self._signum:
                raise ValueError(
                    f"already installed on signal {self._signum}; "
                    f"uninstall() before moving to signal {signum}")
            return self
        prev = signal.getsignal(signum)

        def handler(sig, frame):
            log.warning("preemption notice (signal %d): will checkpoint "
                        "and exit after the current step", sig)
            self.trigger()
            if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
                prev(sig, frame)

        self._prev_handler = prev
        self._signum = signum
        signal.signal(signum, handler)
        return self

    def uninstall(self) -> "PreemptionNotice":
        """Restore the handler that was active before install() — a
        library embedding the trainer (a notebook kernel, a test
        harness) gets its own SIGTERM behavior back on teardown.
        Idempotent; keeps the notice's triggered state."""
        if self._signum is not None:
            signal.signal(self._signum, self._prev_handler
                          if self._prev_handler is not None
                          else signal.SIG_DFL)
            self._prev_handler = None
            self._signum = None
        return self

    @property
    def installed(self) -> bool:
        return self._signum is not None

    def trigger(self) -> None:
        """Mark the notice and stamp the grace deadline. The FIRST
        trigger wins the deadline: the kubelet's SIGKILL timer started
        at the first SIGTERM, so a repeated signal must not push the
        recorded deadline out past the real one."""
        if self._deadline is None:
            self._deadline = self._clock() + self.grace_s
        self._event.set()

    @property
    def deadline(self) -> float | None:
        """Clock value (monotonic) at which the grace period expires;
        None before any trigger."""
        return self._deadline

    def remaining_grace(self) -> float | None:
        """Seconds of termination grace left (>= 0.0), or None when no
        notice has fired. Nothing in the port reads it yet (see the
        module docstring)."""
        if self._deadline is None:
            return None
        return max(self._deadline - self._clock(), 0.0)

    def __call__(self) -> bool:
        return self._event.is_set()
