"""EventRecorder — the client-go ``record.EventRecorder`` analogue.

Writes real corev1 ``Event`` objects through the k8s client (so
``run_until_idle`` tests can assert them and the dashboard activities
feed surfaces them) with the aggregator's count-dedup: re-recording an
identical event bumps ``count`` and ``lastTimestamp`` on the existing
object instead of minting a new one per occurrence — a gang backing
off every 0.5s must not write a fresh Event per retry.

The dedup key is (involvedObject identity, reason, message, type,
component); the key→name map is a bounded LRU per recorder, so a
long-lived controller process cannot grow it forever. Both
``FakeCluster.record_event`` and ``RestClient.record_event`` route
through this class — controllers keep calling ``client.record_event``
and get dedup for free on either backend.

Port of `kubeflow_tpu/obs/events.py`: the same code over the port's own modules.
"""

from __future__ import annotations

import logging
import threading
import uuid
from collections import OrderedDict

from kubeflow_tpu_torch.control.k8s import objects as ob

log = logging.getLogger("kubeflow_tpu_torch.events")


class EventRecorder:
    def __init__(self, client, component: str = "kubeflow-tpu",
                 max_keys: int = 1024):
        self.client = client
        self.component = component
        self._max_keys = max_keys
        self._lock = threading.Lock()
        self._seen: OrderedDict[tuple, tuple[str, str]] = OrderedDict()

    def event(self, involved: dict, reason: str, message: str,
              etype: str = "Normal", component: str | None = None) -> dict:
        """Record one occurrence; returns the created/updated Event.

        The whole lookup→create/bump→remember sequence runs under the
        recorder lock: releasing it mid-flight lets two threads both
        miss the key and create duplicate Events, or both read count=N
        and lose an increment — the exact dedup this class exists for.
        Event recording is low-rate; serializing it is the same trade
        client-go's single recorder goroutine makes. (Lock order is
        recorder→client only — never taken the other way around.)

        Fire-and-forget: a transient apiserver error here DROPS the
        occurrence (returned unsent, logged) rather than raising —
        client-go's recorder makes the same call, because failing a
        reconcile over its own telemetry inverts the priority of the
        two writes."""
        comp = component or self.component
        m = ob.meta(involved)
        ns = m.get("namespace") or "default"
        key = (involved.get("apiVersion"), involved.get("kind"), ns,
               m["name"], m.get("uid", ""), reason, message, etype, comp)
        with self._lock:
            hit = self._seen.get(key)
            if hit is not None:
                self._seen.move_to_end(key)
                try:
                    bumped = self._bump(hit[0], hit[1])
                except ob.ApiError as e:
                    log.warning("event %s/%s %s dropped (count bump "
                                "failed): %s", ns, m["name"], reason, e)
                    return {"reason": reason, "message": message,
                            "type": etype, "count": 0}
                if bumped is not None:
                    return bumped
                self._seen.pop(key, None)  # Event GC'd/expired: recreate
            ev = {
                "apiVersion": "v1",
                "kind": "Event",
                "metadata": {
                    "name": f"{m['name']}.{uuid.uuid4().hex[:10]}",  # apiserver object-name suffix (client-go idiom), never a decision input
                    "namespace": ns,
                },
                "involvedObject": {
                    "apiVersion": involved.get("apiVersion"),
                    "kind": involved.get("kind"),
                    "name": m["name"],
                    "namespace": ns,
                    "uid": m.get("uid", ""),
                },
                "reason": reason,
                "message": message,
                "type": etype,
                "source": {"component": comp},
                "firstTimestamp": ob.now_iso(),  # Event timestamps are apiserver metadata, excluded from decision fingerprints
                "lastTimestamp": ob.now_iso(),  # Event timestamps are apiserver metadata, excluded from decision fingerprints
                "count": 1,
            }
            try:
                created = self.client.create(ev)
            except ob.ApiError as e:
                log.warning("event %s/%s %s dropped (create failed): %s",
                            ns, m["name"], reason, e)
                return ev
            self._seen[key] = (ob.meta(created)["name"], ns)
            while len(self._seen) > self._max_keys:
                self._seen.popitem(last=False)
            return created

    def _bump(self, name: str, namespace: str) -> dict | None:
        """count+1 on the existing Event; None when it no longer exists
        (apiserver Events expire — the caller recreates)."""
        cur = self.client.get_or_none("v1", "Event", name, namespace)
        if cur is None:
            return None
        try:
            return self.client.patch(
                "v1", "Event", name,
                {"count": cur.get("count", 1) + 1,
                 "lastTimestamp": ob.now_iso()},  # Event timestamps are apiserver metadata, excluded from decision fingerprints
                namespace)
        except ob.NotFound:
            return None
