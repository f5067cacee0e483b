"""Observability (port of `kubeflow_tpu/obs/`): spans, events, the
exposition parser, goodput, and the fleet observability plane.

- ``trace``    — span API, bounded collector, ``traceparent``
  propagation, Perfetto/JSONL exporters.
- ``events``   — the control plane's dedup'd k8s Event recorder.
- ``expofmt``  — the one Prometheus text-exposition parser (the
  router's ``RegistrySignals`` and the scraper).
- ``goodput``  — GPU-seconds accounting from the span stream, and the
  serving SLO from a registry (``from_registry``) or the fleet TSDB
  (``from_store``).
- ``tsdb``     — bounded ring store and ``ScrapeLoop`` over in-process
  registries, HTTP ``/metrics`` and JAXService replica endpoints, with
  staleness markers on target loss.
- ``rules``    — PromQL-lite, recording rules, alerting with a
  pending -> firing -> resolved machine, the rule packs and the canary
  gate.
- ``persist``  — snapshot and segment persistence of the store, and
  remote write.
- ``remediate`` — alert-driven actions (the JAXService scale-up nudge,
  the cache relist, cordon and drain) behind guards and an audit ring.
- ``plane``    — ``FleetPlane``: the store, scraper, rule engine,
  remediation, routes and silences behind one handle.

Nothing is imported here: ``import kubeflow_tpu_torch.obs`` loads no
submodule, and none of them imports torch.
"""
