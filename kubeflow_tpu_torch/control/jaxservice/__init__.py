"""kubeflow_tpu_torch.control.jaxservice — the serving plane CRD on GPUs.

Port of `kubeflow_tpu/control/jaxservice/`. A JAXService runs N
interchangeable model-server replicas (the port's server, one GPU each
by default) behind the token-aware router (``serving/router.py``),
autoscaled on router queue depth and tokens/sec between
``spec.replicas.min`` and ``.max``, with drain-before-delete scale-down.

- ``types``      — CRD spec/validation, the endpoints annotation
  re-export, condition vocabulary.
- ``controller`` — the Reconciler: provisioning through the gang
  scheduler, readiness tracking, endpoints publication, hysteretic
  autoscaling, the cordon → drain → delete state machine.
"""

from __future__ import annotations


def watch_endpoints(apiserver: str, namespace: str, name: str,
                    router,
                    frontend=None,
                    sleep=None,
                    stop=None,
                    transport_factory=None,
                    ) -> None:
    """Router-side membership feed: watch ONE JAXService and apply its
    endpoints annotation to the router on every event (plus an initial
    read). When a ``RouterFrontend`` is passed, the spec's resilience
    defaults (band/deadline/hedge) are adopted per event too, so a spec
    edit retunes the request path without a router restart. Stream
    death resubscribes (the control/runtime watch discipline).

    Runs until ``stop`` (a ``threading.Event``) is set; without one,
    forever. ``transport_factory`` maps an endpoint entry to its
    transport (default: ``HttpTransport`` on the entry's address).
    Both are seams, as ``sleep`` is: the JAX package's function has the
    injectable ``sleep`` alone."""
    import logging
    import threading

    from kubeflow_tpu_torch.control.jaxservice import types as T
    from kubeflow_tpu_torch.control.k8s.rest import RestClient
    from kubeflow_tpu_torch.serving.router import HttpTransport

    log = logging.getLogger("kubeflow_tpu_torch.jaxservice")
    stop = stop if stop is not None else threading.Event()
    # injectable resubscribe backoff (DET603): a reference, not a call,
    # so the stop-aware wait stays the default outside tests
    sleep = sleep if sleep is not None else stop.wait
    client = RestClient(base_url=apiserver or None)
    factory = transport_factory if transport_factory is not None \
        else (lambda ep: HttpTransport(ep["addr"]))
    stream = None

    def apply(obj: dict) -> None:
        router.sync_from_object(obj, transport_factory=factory)
        if frontend is not None:
            frontend.apply_spec(obj)

    def stop_stream() -> None:
        stop.wait()
        if stream is not None:
            stream.stop()

    # a blocked watch read ends when stop is set, not at its timeout
    threading.Thread(target=stop_stream, daemon=True,
                     name="endpoints-watch-stop").start()
    while not stop.is_set():
        try:
            obj = client.get_or_none(T.API_VERSION, T.KIND, name, namespace)
            if obj is not None:
                apply(obj)
            stream = client.watch(T.API_VERSION, T.KIND)
            if stop.is_set():
                break
            for ev in stream:
                m = (ev.object.get("metadata") or {})
                if m.get("name") == name \
                        and (m.get("namespace") or "default") == namespace:
                    apply(ev.object)
        except Exception:
            if stop.is_set():
                break
            log.exception("endpoints watch failed; resubscribing")
        sleep(0.5)
    if stream is not None:
        stream.stop()
