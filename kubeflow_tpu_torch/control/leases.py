"""Lease-based leader election for controllers.

The reference's controllers run under controller-runtime managers with
`--enable-leader-election` ("ensure there is only one active controller
manager", notebook-controller/main.go:51-62; profile-controller
main.go:52) backed by coordination.k8s.io Leases. Same mechanism here:
a `Lease` object holds {holderIdentity, leaseDurationSeconds,
renewTime, leaseTransitions}; candidates acquire it when absent or
expired, renew while holding it, and optimistic-concurrency (409 on
stale resourceVersion) arbitrates races — the loser simply stays on
standby. Controllers wrapped with `with_leader_election` keep watching
but skip reconciles until they hold the lease, so a standby replica
takes over within one lease duration of the leader dying.

Port of `kubeflow_tpu/control/leases.py`: the same code over the port's
own modules.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
import threading
import time
import uuid
from typing import Callable

from kubeflow_tpu_torch.control.k8s import objects as ob

log = logging.getLogger("kubeflow_tpu_torch.leases")

API_VERSION = "coordination.k8s.io/v1"
KIND = "Lease"


def _to_micro_time(epoch: float) -> str:
    """LeaseSpec renewTime/acquireTime are MicroTime RFC3339 strings on a
    real apiserver — epoch floats would be rejected with 400/422."""
    return datetime.datetime.fromtimestamp(
        epoch, datetime.timezone.utc).isoformat(timespec="microseconds")


def _from_micro_time(value) -> float | None:
    if value is None:
        return None
    if isinstance(value, (int, float)):
        return float(value)
    return datetime.datetime.fromisoformat(
        str(value).replace("Z", "+00:00")).timestamp()


def default_identity() -> str:
    """pod-name/uuid identity (controller-runtime uses hostname_uuid)."""
    return f"{os.environ.get('POD_NAME', socket.gethostname())}_{uuid.uuid4().hex[:8]}"


class LeaderElector:
    """Acquire/renew a named Lease; thread-compatible with the
    controller's single-threaded run_until_idle loop (each poll is one
    try_acquire call)."""

    def __init__(self, client, name: str, namespace: str = "kubeflow",
                 identity: str | None = None,
                 lease_seconds: float = 15.0,
                 clock: Callable[[], float] = time.time):
        # clock MUST be wall-clock (default) in production: renewTime is
        # compared across processes, and monotonic epochs differ per
        # process. Injectable for deterministic tests.
        self.client = client
        self.name = name
        self.namespace = namespace
        self.identity = identity or default_identity()
        self.lease_seconds = lease_seconds
        self.clock = clock
        self._held = False
        self._last_renew = 0.0
        # one elector is shared by all worker threads of a controller:
        # serialize rounds so workers don't 409 against each other and
        # flap the held flag
        self._lock = threading.Lock()

    # -- helpers ------------------------------------------------------------

    def _spec(self, lease: dict) -> dict:
        return lease.setdefault("spec", {})

    def _expired(self, lease: dict) -> bool:
        spec = lease.get("spec") or {}
        renew = _from_micro_time(spec.get("renewTime"))
        dur = spec.get("leaseDurationSeconds", self.lease_seconds)
        if renew is None:
            return True
        return self.clock() - renew > float(dur)

    # -- protocol -----------------------------------------------------------

    def try_acquire(self) -> bool:
        """One election round: create the lease, renew it if held by us,
        or take it over if expired. Returns whether we are the leader.
        Held leadership is cached for lease_seconds/3 (controller-runtime
        retryPeriod shape), so the reconcile hot path is a local
        timestamp check, not an apiserver round-trip per item."""
        with self._lock:
            now = self.clock()
            if self._held and now - self._last_renew < self.lease_seconds / 3:
                return True
            return self._round(now)

    def _round(self, now: float) -> bool:
        try:
            lease = self.client.get_or_none(
                API_VERSION, KIND, self.name, self.namespace)
            if lease is None:
                lease = ob.new_object(API_VERSION, KIND, self.name,
                                      self.namespace)
                self._spec(lease).update(
                    holderIdentity=self.identity,
                    leaseDurationSeconds=int(self.lease_seconds),
                    acquireTime=_to_micro_time(now),
                    renewTime=_to_micro_time(now),
                    leaseTransitions=0)
                self.client.create(lease)
                return self._became(True, now)
            spec = self._spec(lease)
            if spec.get("holderIdentity") == self.identity:
                spec["renewTime"] = _to_micro_time(now)
                self.client.update(lease)
                return self._became(True, now)
            if self._expired(lease):
                spec.update(
                    holderIdentity=self.identity,
                    acquireTime=_to_micro_time(now),
                    renewTime=_to_micro_time(now),
                    leaseTransitions=spec.get("leaseTransitions", 0) + 1)
                self.client.update(lease)  # 409 if another standby won
                return self._became(True, now)
        except ob.Conflict:
            pass
        except ob.ApiError as e:
            log.warning("leader election for %s errored: %s", self.name, e)
            if self._held and now - self._last_renew < self.lease_seconds:
                # transient apiserver error on a RENEW: the Lease still
                # names us and has not expired, so dropping to standby
                # now would flap leadership on every blip. Stay leader —
                # WITHOUT advancing _last_renew (no real renewal
                # happened): if errors persist past the lease duration,
                # this guard stops holding exactly when a standby may
                # legitimately take over.
                return True
        return self._became(False, now)

    def release(self) -> None:
        """Voluntary hand-off on clean shutdown: zero the renewTime so a
        standby takes over immediately instead of after expiry. Runs
        regardless of the cached held flag — the lease may still name us
        even if the last round lost a 409 race."""
        with self._lock:
            try:
                lease = self.client.get_or_none(
                    API_VERSION, KIND, self.name, self.namespace)
                if lease and self._spec(lease).get("holderIdentity") == self.identity:
                    self._spec(lease)["renewTime"] = None
                    self.client.update(lease)
            except ob.ApiError:
                pass
            self._held = False

    def _became(self, leader: bool, now: float) -> bool:
        if leader and not self._held:
            log.info("%s: became leader for %s", self.identity, self.name)
        elif not leader and self._held:
            log.warning("%s: lost leadership for %s", self.identity, self.name)
        self._held = leader
        if leader:
            self._last_renew = now
        return leader

    @property
    def is_leader(self) -> bool:
        return self._held
