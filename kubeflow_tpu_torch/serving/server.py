"""Model server: the TF-Serving REST surface over the port's classifiers
and its decode path (port of kubeflow_tpu/serving/server.py).

Endpoints:
- GET  /v1/models                              -> inventory
- GET  /v1/models/{model}                      -> version status
- GET  /v1/models/{model}/metadata             -> signature metadata
- POST /v1/models/{model}:predict              -> {"predictions": [...]}
- POST /v1/models/{model}/versions/{v}:predict
- GET  /healthz, /readyz, /metrics

`serve_flax_classifier` serves a registry classifier (ResNet, ViT,
BERT) as softmax rows over its f32 logits, in eval mode (BatchNorm on
its running statistics); weights from the latest step of a port training
checkpoint (`checkpoint_dir`, params and batch_stats), else random from
`seed`. The CLI's default, with neither `--model` nor `--lm`, is the
reference's: `mnist=resnet18` with 10 classes.

`serve_lm_generator` serves a registry LM: prompts are left-padded or
trimmed to `prompt_len` and decoded for `max_new_tokens` by generate()
(optionally micro-batched, batches padded to a power of two) or by the
continuous SlotDecoder (dense, paged or rolling cache). With
`draft_model` a draft LM speeds greedy decode up: batch-1 rounds per row
(runtime/speculative.py), or lockstep rounds over the slots under
continuous batching; the tokens equal plain greedy decode. Weights come
from the latest step of a port training checkpoint (`checkpoint_dir`,
`draft_checkpoint_dir`: runtime/checkpoint.py restore_variables, params
only; a missing or empty directory fails at registration), else random
from `seed` (the draft's from `seed + 1`), on the device (cuda unless
device="cpu"), then cast or quantized per `param_dtype`.

With `mesh` (a dict or MeshSpec; the CLI's `--mesh model=2,fsdp=2`)
both entry points serve over a device mesh (serving/mesh.py): one process
per rank, rank 0 holding HTTP, batching, the slots and sampling, every
rank keeping only its shards of the weights (tensor parallelism by the
reference's annotations, FSDP2, the fsdp heuristic for the rest) and
running each forward rank 0 broadcasts. The world comes from the
JAXJOB_* env (the port launcher's `--nproc-per-node` sets it); with no
world in the env, the CLI starts one itself: a process per rank of the
mesh, one per GPU, ranks sharing a card over gloo where there are fewer
GPUs than ranks. Under a mesh the paged cache, a speculative draft and
int8/int4 weights are refused, as in the reference; the data axes'
product must be a power of two; `signature_def["mesh"]` names the mesh.

Usage:
    python -m kubeflow_tpu_torch.serving [--device cpu]    # mnist=resnet18
    python -m kubeflow_tpu_torch.serving --lm chat=llama-1b --mesh model=2 \
        --continuous-batching            # two ranks, HTTP on rank 0
    python -m kubeflow_tpu_torch.serving --model cls=resnet18@ckpt/
    python -m kubeflow_tpu_torch.serving --lm chat=gpt-350m \\
        --prompt-len 512 --max-new-tokens 64 --param-dtype int8 \\
        --continuous-batching --decode-slots 16 [--device cpu]
        [--draft-model gpt-125m --draft-k 4]
        [--attention-window 256 --rolling-kv-cache]
        [--checkpoint-dir ckpt/ | --lm chat=llama-1b@ckpt/]
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures as cf
import contextvars
import itertools
import json
import logging
import math
import os
import queue
import signal
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from kubeflow_tpu_torch.runtime.metrics import REGISTRY as METRICS_REGISTRY
from kubeflow_tpu_torch.serving.mesh import MeshLost
from kubeflow_tpu_torch.serving.router import (
    HEADER_DEADLINE,
    DeadlineExceeded,
    _retry_after_headers,
)
from kubeflow_tpu_torch.utils import httpd
from kubeflow_tpu_torch.utils.httpd import ApiHttpError, HttpReq, Router

log = logging.getLogger("kubeflow_tpu_torch.serving")

# the request's absolute time.monotonic deadline, set by the HTTP handler
# from the x-request-deadline-s header and read by predict closures on
# the same thread (the micro-batch worker does not see it)
_REQUEST_DEADLINE: contextvars.ContextVar[float | None] = \
    contextvars.ContextVar("request_deadline", default=None)

_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)
_LATENCY_BUCKETS = (.005, .01, .025, .05, .1, .25, .5, 1, 2.5, 5, 10)


def request_deadline() -> float | None:
    """Absolute monotonic deadline of the request on this thread, or
    None."""
    return _REQUEST_DEADLINE.get()


class _ReplicaMeter:
    """Replica-side serving signals in the port's registry: queue depth
    (requests inside predict), instances per call, tokens generated; and
    the completion times behind the Retry-After of the overload 429."""

    def __init__(self, registry=METRICS_REGISTRY):
        self.registry = registry
        self._lock = threading.Lock()
        self._inflight: dict[str, int] = {}
        self._done: dict[str, collections.deque] = {}

    def _publish_locked(self, model: str) -> None:
        self.registry.gauge(
            "serving_queue_depth", self._inflight.get(model, 0),
            help_="requests inside predict (queued + decoding)", model=model)

    def enter(self, model: str, n_requests: int) -> None:
        with self._lock:
            self._inflight[model] = self._inflight.get(model, 0) + 1
            self._publish_locked(model)
        self.registry.histogram(
            "serving_request_instances", n_requests,
            help_="instances per predict call", buckets=_SIZE_BUCKETS,
            model=model)

    def exit(self, model: str) -> None:
        with self._lock:
            self._inflight[model] = max(0, self._inflight.get(model, 0) - 1)
            done = self._done.setdefault(model, collections.deque(maxlen=64))
            done.append(time.perf_counter())
            self._publish_locked(model)

    def depth(self, model: str) -> int:
        with self._lock:
            return self._inflight.get(model, 0)

    def retry_after(self, model: str) -> float:
        """Seconds until the queue should have drained at the observed
        completion rate; 1 s before there is any history."""
        with self._lock:
            done = self._done.get(model)
            depth = self._inflight.get(model, 0)
            if not done or len(done) < 2:
                return 1.0
            span = done[-1] - done[0]
            if span <= 0:
                return 1.0
            rate = (len(done) - 1) / span
            return float(min(max(math.ceil((depth + 1) / rate), 1.0), 120.0))

    def tokens(self, model: str, n: int) -> None:
        if n <= 0:
            return
        self.registry.counter_inc(
            "serving_tokens_generated_total", by=float(n),
            help_="new tokens generated (rate = this replica's "
                  "tokens/sec, the autoscaler signal)", model=model)


REPLICA_METER = _ReplicaMeter()


def speculative_counters(registry=METRICS_REGISTRY):
    """(drafted, accepted): each adds n to its counter for a model, the
    batch-1 speculative path's acceptance signal."""

    def drafted(model: str, n: int) -> None:
        registry.counter_inc("serving_speculative_drafted_total",
                             by=float(n), help_="draft tokens proposed",
                             model=model)

    def accepted(model: str, n: int) -> None:
        registry.counter_inc(
            "serving_speculative_accepted_total", by=float(n),
            help_="draft tokens accepted by the target (accepted/drafted "
                  "= acceptance rate; low rates mean the draft is "
                  "wasting rounds)", model=model)

    return drafted, accepted


def _generated_tokens(result: list, signature: dict) -> int:
    if signature.get("method_name") != "generate":
        return 0
    return sum(len(row) for row in result or [] if hasattr(row, "__len__"))


@dataclass
class ServedModel:
    """One versioned model: predict_fn maps a batched numpy array (or
    dict of arrays) to predictions. batch_window_ms > 0 coalesces
    concurrent predict calls within the window into one padded call;
    max_inflight > 0 answers calls past that many in flight with 429
    and Retry-After."""

    name: str
    predict_fn: Callable[[Any], Any]
    version: int = 1
    signature: dict = field(default_factory=dict)
    pad_batches: bool = True
    batch_window_ms: float = 0.0
    max_batch: int = 64
    pad_multiple: int = 1
    max_inflight: int = 0
    # False once the model can serve no more (a lost serving mesh)
    healthy: Callable[[], bool] | None = None
    _batcher: "MicroBatcher | None" = field(default=None, repr=False)

    def _predict_now(self, instances: list) -> list:
        batch = _stack(instances)
        n = _batch_size(batch)
        METRICS_REGISTRY.histogram(
            "serving_device_batch_size", n,
            help_="instances per device call after micro-batch coalescing",
            buckets=_SIZE_BUCKETS, model=self.name)
        if self.pad_batches:
            padded = _pad_batch(batch, _next_pow2(max(n, self.pad_multiple)))
        else:
            padded = batch
        return _unstack(self.predict_fn(padded), n)

    def __post_init__(self):
        # built now, not lazily, so concurrent first requests cannot race
        if self.batch_window_ms > 0:
            self._batcher = MicroBatcher(
                self._predict_now, max_batch=self.max_batch,
                max_wait_ms=self.batch_window_ms)

    def predict(self, instances: list) -> list:
        if not instances:
            raise ApiHttpError(400, "instances must be non-empty")
        if self.max_inflight > 0 \
                and REPLICA_METER.depth(self.name) >= self.max_inflight:
            raise ApiHttpError(
                429, f"replica overloaded ({self.max_inflight} in flight)",
                headers=_retry_after_headers(
                    REPLICA_METER.retry_after(self.name)))
        REPLICA_METER.enter(self.name, len(instances))
        try:
            if self._batcher is not None:
                result = self._batcher.submit(instances)
            else:
                result = self._predict_now(instances)
        finally:
            REPLICA_METER.exit(self.name)
        REPLICA_METER.tokens(self.name,
                             _generated_tokens(result, self.signature))
        return result

    def close(self) -> None:
        if self._batcher is not None:
            self._batcher.close()


class _Pending:
    __slots__ = ("instances", "event", "result", "error")

    def __init__(self, instances: list):
        self.instances = instances
        self.event = threading.Event()
        self.result: list | None = None
        self.error: BaseException | None = None


class MicroBatcher:
    """Coalesces concurrent predict calls: a worker thread takes the
    first pending call, gathers arrivals until max_wait_ms passes or
    max_batch instances are queued, makes one `fn(instances)` call and
    hands each caller its slice. An error from fn goes to every caller
    of that batch."""

    def __init__(self, fn: Callable[[list], list], max_batch: int = 64,
                 max_wait_ms: float = 5.0):
        self.fn = fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._q: "queue.Queue[_Pending | None]" = queue.Queue()
        self._lock = threading.Lock()
        self._closed = False
        self._carry: _Pending | None = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serving-microbatch")
        self._thread.start()

    def submit(self, instances: list) -> list:
        p = _Pending(instances)
        # enqueued under close()'s lock: every pending lands before the
        # shutdown sentinel
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._q.put(p)
        p.event.wait()    # the worker sets it on every outcome
        if p.error is not None:
            raise p.error
        return p.result  # type: ignore[return-value]

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._thread.join(timeout=5)

    def _run(self) -> None:
        while True:
            head = self._carry or self._q.get()
            self._carry = None
            if head is None:
                return
            group = [head]
            total = len(head.instances)
            deadline = time.monotonic() + self.max_wait
            stop = False
            while total < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                if total + len(nxt.instances) > self.max_batch:
                    self._carry = nxt     # starts the next group
                    break
                group.append(nxt)
                total += len(nxt.instances)
            self._dispatch(group)
            if stop:
                if self._carry is not None:
                    self._dispatch([self._carry])
                    self._carry = None
                return

    def _dispatch(self, group: list[_Pending]) -> None:
        flat = [inst for p in group for inst in p.instances]
        try:
            results = self.fn(flat)
        except BaseException as e:  # noqa: BLE001 - propagate to callers
            for p in group:
                p.error = e
                p.event.set()
            return
        off = 0
        for p in group:
            p.result = results[off:off + len(p.instances)]
            off += len(p.instances)
            p.event.set()


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _ragged_ok_asarray(rows: list) -> np.ndarray:
    """np.asarray, or an object array for ragged rows (prompts of
    different lengths, padded later)."""
    try:
        return np.asarray(rows)
    except ValueError:
        arr = np.empty(len(rows), dtype=object)
        for i, r in enumerate(rows):
            arr[i] = r
        return arr


def _stack(instances: list) -> Any:
    if not instances:
        raise ApiHttpError(400, "instances must be non-empty")
    if isinstance(instances[0], dict):
        return {k: _ragged_ok_asarray([inst[k] for inst in instances])
                for k in instances[0]}
    return _ragged_ok_asarray(instances)


def _batch_size(batch: Any) -> int:
    if isinstance(batch, dict):
        return len(next(iter(batch.values())))
    return len(batch)


def _pad_batch(batch: Any, to: int) -> Any:
    def pad(a: np.ndarray) -> np.ndarray:
        if len(a) == to:
            return a
        return np.concatenate([a, np.repeat(a[-1:], to - len(a), axis=0)],
                              axis=0)

    if isinstance(batch, dict):
        return {k: pad(v) for k, v in batch.items()}
    return pad(batch)


def _unstack(out: Any, n: int) -> list:
    if isinstance(out, dict):
        arrs = {k: np.asarray(v)[:n] for k, v in out.items()}
        return [{k: arrs[k][i].tolist() for k in arrs} for i in range(n)]
    if isinstance(out, list):
        return [list(r) for r in out[:n]]    # ragged rows (mixed budgets)
    return np.asarray(out)[:n].tolist()


class ModelServer:
    def __init__(self):
        self._models: dict[str, dict[int, ServedModel]] = {}
        self._lock = threading.Lock()

    def register(self, model: ServedModel) -> None:
        with self._lock:
            versions = self._models.setdefault(model.name, {})
            old = versions.get(model.version)
            versions[model.version] = model
        if old is not None:
            old.close()       # hot swap: release the replaced worker

    def close(self) -> None:
        """Close every model; over a serving mesh rank 0 then tells the
        other ranks to stop."""
        from kubeflow_tpu_torch.serving import mesh as serving_mesh

        with self._lock:
            models = [m for vs in self._models.values() for m in vs.values()]
        for m in models:
            m.close()
        serving_mesh.stop()

    def ready(self) -> bool:
        with self._lock:
            models = [m for vs in self._models.values() for m in vs.values()]
        return all(m.healthy is None or m.healthy() for m in models)

    def readyz(self, req: HttpReq):
        if not self.ready():
            return 503, {"status": "unready",
                         "error": "a model's serving mesh is lost"}
        return {"status": "ok"}

    def _get(self, name: str, version: int | None = None) -> ServedModel:
        versions = self._models.get(name)
        if not versions:
            raise ApiHttpError(404, f"model {name!r} not found")
        if version is None:
            return versions[max(versions)]
        if version not in versions:
            raise ApiHttpError(404,
                               f"model {name!r} version {version} not found")
        return versions[version]

    def list_models(self, req: HttpReq):
        with self._lock:
            out = []
            for name, versions in sorted(self._models.items()):
                latest = versions[max(versions)]
                out.append({
                    "name": name,
                    "versions": sorted(versions),
                    "method": latest.signature.get("method_name", "predict"),
                    "micro_batching": latest.batch_window_ms > 0,
                })
        return {"models": out}

    def status(self, req: HttpReq):
        name = req.params["model"]
        versions = self._models.get(name)
        if not versions:
            raise ApiHttpError(404, f"model {name!r} not found")
        return {"model_version_status": [
            {"version": str(v), "state": "AVAILABLE",
             "status": {"error_code": "OK", "error_message": ""}}
            for v in sorted(versions)]}

    def metadata(self, req: HttpReq):
        m = self._get(req.params["model"])
        return {"model_spec": {"name": m.name, "version": str(m.version)},
                "metadata": {"signature_def": m.signature}}

    def predict(self, req: HttpReq):
        name = req.params["model"]
        version = (int(req.params["version"]) if "version" in req.params
                   else None)
        body = req.json() or {}
        instances = body.get("instances")
        if instances is None:
            raise ApiHttpError(400, 'request body must contain "instances"')
        model = self._get(name, version)
        # the header carries the REMAINING seconds
        deadline = None
        raw = req.headers.get(HEADER_DEADLINE)
        if raw:
            try:
                remaining = float(raw)
            except ValueError:
                raise ApiHttpError(400, f"bad {HEADER_DEADLINE} header: "
                                        f"{raw!r}")
            if remaining <= 0:
                raise ApiHttpError(504, "deadline exceeded")
            deadline = time.monotonic() + remaining
        token = _REQUEST_DEADLINE.set(deadline)
        t0 = time.perf_counter()
        try:
            preds = model.predict(instances)
        except ApiHttpError:
            self._error(name)
            raise
        except DeadlineExceeded as e:
            self._error(name)
            raise ApiHttpError(504, f"deadline exceeded: {e}")
        except MeshLost as e:
            self._error(name)
            raise ApiHttpError(503, f"serving mesh lost: {e}")
        except Exception as e:
            self._error(name)
            log.exception("predict failed for %s", name)
            raise ApiHttpError(400, f"prediction failed: {e}")
        finally:
            _REQUEST_DEADLINE.reset(token)
        METRICS_REGISTRY.histogram(
            "serving_predict_seconds", time.perf_counter() - t0,
            help_="end-to-end predict handler latency",
            buckets=_LATENCY_BUCKETS, model=name)
        return {"predictions": preds}

    @staticmethod
    def _error(name: str) -> None:
        METRICS_REGISTRY.counter_inc("serving_predict_errors_total",
                                     help_="failed predict requests",
                                     model=name)

    def router(self) -> Router:
        r = Router("serving")
        r.route("POST", "/v1/models/{model}:predict", self.predict)
        r.route("POST", "/v1/models/{model}/versions/{version}:predict",
                self.predict)
        r.route("GET", "/v1/models/{model}/metadata", self.metadata)
        r.route("GET", "/v1/models/{model}", self.status)
        r.route("GET", "/v1/models", self.list_models)
        r.route("GET", "/readyz", self.readyz)    # before the static one
        httpd.add_health_routes(r)
        httpd.add_metrics_route(r)
        return r

    def serve(self, host: str = "0.0.0.0", port: int = 8500
              ) -> httpd.HttpService:
        return httpd.HttpService(self.router(), host, port)


# ---------------------------------------------------------------------------
# model builders


def serve_flax_classifier(name: str, model_name: str,
                          input_key: str | None = None, seed: int = 0,
                          checkpoint_dir: str | None = None,
                          mesh: Any | None = None,
                          device: str | torch.device | None = None,
                          state_dict: dict[str, torch.Tensor] | None = None,
                          **model_kwargs) -> ServedModel:
    """A registry classifier as a ServedModel: each predict returns the
    softmax over the f32 logits, one row per instance. Instances are
    arrays (images [H, W, C] for ResNet and ViT, token ids for BERT), or
    dicts holding one under `input_key`.

    With `checkpoint_dir` the model is built here and loads the latest
    step of a port training checkpoint, params and batch_stats (a
    missing or empty directory raises here, at registration). Without
    it the weights are random from `seed` and the model is built at the
    first predict, a ResNet with that batch's channel count (flax
    infers it from the input at init), as the reference's does.
    `state_dict` (params and batch statistics) is a test seam: weights
    to load in place of the random ones.

    With `mesh` the model is built at registration on every rank (a
    ResNet for RGB input unless `in_channels` says otherwise), each rank
    keeps its shards, and each predict broadcasts the padded batch; the
    softmax rows are rank 0's."""
    from kubeflow_tpu_torch.device import resolve_device
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.runtime.checkpoint import restore_variables

    mesh_signature = None
    if mesh is not None:
        from kubeflow_tpu_torch.serving import mesh as serving_mesh

        mesh_signature, world, _ = serving_mesh.check(mesh, checkpoint_dir)
        if world > 1:
            return _meshed_classifier(name, model_name, input_key, seed,
                                      checkpoint_dir, mesh, device,
                                      state_dict, model_kwargs)
    dev = resolve_device(device)
    built: list = []
    lock = threading.Lock()

    def build(channels: int | None):
        kw = dict(model_kwargs)
        if channels is not None and model_name.startswith("resnet"):
            kw.setdefault("in_channels", channels)
        model = get_model(model_name, device=dev, seed=seed, **kw)
        model.eval()
        return model

    if checkpoint_dir:
        variables, step = restore_variables(checkpoint_dir)
        model = build(None)
        model.load_state_dict({**variables["params"],
                               **variables.get("batch_stats", {})},
                              strict=True)
        built.append(model)
        log.info("model %s: restored variables from %s step %d", name,
                 checkpoint_dir, step)
    elif state_dict is not None:
        model = build(None)
        model.load_state_dict(state_dict, strict=True)
        built.append(model)

    @torch.no_grad()
    def predict(batch):
        x = batch[input_key] if input_key and isinstance(batch, dict) \
            else batch
        x = torch.from_numpy(np.asarray(x)).to(dev)
        if not built:
            with lock:
                if not built:
                    built.append(build(x.shape[-1] if x.ndim == 4 else None))
        model = built[0]
        x = x.float() if x.is_floating_point() else x.long()
        return torch.softmax(model(x).float(), dim=-1).cpu().numpy()

    return ServedModel(name=name, predict_fn=predict,
                       signature={"inputs": input_key or "array",
                                  "method_name": "predict",
                                  **({"mesh": mesh_signature}
                                     if mesh is not None else {})})


def _meshed_classifier(name, model_name, input_key, seed, checkpoint_dir,
                       mesh, device, state_dict, model_kwargs) -> ServedModel:
    """serve_flax_classifier over a serving mesh: built whole on every
    rank (on the host when the weights are loaded), cut to its shards,
    each predict one meshed op."""
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.runtime.checkpoint import restore_variables
    from kubeflow_tpu_torch.serving.mesh import ServingMesh

    sm = ServingMesh(mesh, seed, checkpoint_dir, device=device)
    if checkpoint_dir:
        variables, step = restore_variables(checkpoint_dir)
        state_dict = {**variables["params"],
                      **variables.get("batch_stats", {})}
        log.info("model %s: restored variables from %s step %d (mesh %s)",
                 name, checkpoint_dir, step, sm.signature)
    model = get_model(model_name, seed=seed, device=(
        "cpu" if state_dict is not None else sm.device), **model_kwargs)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    sm.place(model)

    def execute(op, words, tensors):
        x = tensors[0].to(sm.device)
        x = x.float() if x.is_floating_point() else x.long()
        return torch.softmax(model(x).float(), dim=-1).cpu().numpy()

    model_id = sm.register(execute)

    def predict(batch):
        x = batch[input_key] if input_key and isinstance(batch, dict) \
            else batch
        return sm.call(model_id, 0, (), [np.asarray(x)])

    return ServedModel(name=name, predict_fn=predict,
                       pad_multiple=sm.pad_multiple, healthy=sm.healthy,
                       signature={"inputs": input_key or "array",
                                  "method_name": "predict",
                                  "mesh": sm.signature})


def cast_params(params: dict[str, torch.Tensor], dtype
                ) -> dict[str, torch.Tensor]:
    """Every floating parameter cast to `dtype` (a floating dtype or its
    name); other tensors as they are. Serving casts f32 weights to bf16:
    decode streams every weight each token, so half the bytes is the
    biggest single lever."""
    from kubeflow_tpu_torch.models.transformer import as_dtype

    dt = as_dtype(dtype)
    if not dt.is_floating_point:
        raise ValueError(
            f"cast_params target must be floating, got {dtype!r} "
            "(use param_dtype='int8' via _prepare_serving_params)")
    return {k: v.to(dt) if v.is_floating_point() else v
            for k, v in params.items()}


def _prepare_serving_params(params: dict[str, torch.Tensor], param_dtype,
                            head_dim: int):
    """'int8'/'int4': weight-only quantization (serving/quant.py); any
    other dtype: a cast; None: as they are."""
    if param_dtype in ("int8", "int4"):
        from kubeflow_tpu_torch.serving.quant import quantize_params

        return quantize_params(params, head_dim,
                               bits=4 if param_dtype == "int4" else 8)
    return cast_params(params, param_dtype) if param_dtype else params


def serve_lm_generator(name: str, model_name: str, *, prompt_len: int = 128,
                       max_new_tokens: int = 32, temperature: float = 0.0,
                       top_k: int = 0, seed: int = 0,
                       checkpoint_dir: str | None = None,
                       batch_window_ms: float = 0.0, max_batch: int = 64,
                       mesh: Any | None = None,
                       continuous_batching: bool = False,
                       decode_slots: int = 8,
                       kv_pages: int = 0, kv_page_size: int = 0,
                       prefix_cache: bool = True,
                       param_dtype: str | None = None,
                       draft_model: str | None = None,
                       draft_checkpoint_dir: str | None = None,
                       draft_k: int = 4,
                       max_inflight: int = 0,
                       device: str | torch.device | None = None,
                       state_dict: dict[str, torch.Tensor] | None = None,
                       draft_state_dict: dict[str, torch.Tensor] | None = None,
                       **model_kwargs) -> ServedModel:
    """A generative ServedModel over a registry LM. Instances are
    `{"tokens": [int, ...]}` (optionally with `"max_new_tokens"`, on all
    instances or none); each prompt is left-padded or trimmed to its
    last `prompt_len` tokens, and the response holds the new tokens
    only. A token out of [0, vocab) or a budget out of
    [1, max_new_tokens] is a 400.

    `checkpoint_dir` and `draft_checkpoint_dir` load the latest step of
    a port training checkpoint; a missing or empty directory raises
    here, at registration, not at the first request. `state_dict` and
    `draft_state_dict` are test seams: weights to load in place of the
    random ones (e.g. a flax tree through `convert.flax_to_state_dict`).
    The draft is the registry config with the target's max_seq_len and
    vocab_size, on the target's device, cast or quantized like the
    target."""
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.runtime.checkpoint import (
        list_steps, restore_variables)
    from kubeflow_tpu_torch.runtime.generate import generate

    if checkpoint_dir:
        if state_dict is not None:
            raise ValueError("pass checkpoint_dir or state_dict, not both")
        variables, step = restore_variables(checkpoint_dir)
        state_dict = variables["params"]
        log.info("model %s: restored params from %s step %d", name,
                 checkpoint_dir, step)
    if draft_checkpoint_dir and not list_steps(draft_checkpoint_dir):
        # the draft loads on first use: probe now so an empty directory
        # fails registration (readiness), not every speculative request
        raise FileNotFoundError(
            f"no checkpoint under {draft_checkpoint_dir}")
    # the verify chunk writes up to draft_k positions past the last token
    seq_budget = prompt_len + max_new_tokens + (draft_k if draft_model else 0)
    if kv_pages and not continuous_batching:
        raise ValueError("kv_pages (the paged KV cache) requires "
                         "continuous_batching: the page pool is shared "
                         "across decode slots")
    if kv_pages and mesh is not None:
        raise ValueError("the paged KV cache is single-chip for now "
                         "(no mesh)")
    if draft_model and mesh is not None:
        raise ValueError("speculative decoding is single-chip for now "
                         "(no mesh)")
    quantized = param_dtype in ("int8", "int4")
    if quantized and mesh is not None:
        raise ValueError(f"param_dtype={param_dtype!r} serving is "
                         "single-chip for now (mesh-sharded weights stay "
                         "floating)")
    sm = mesh_signature = None
    if mesh is not None:
        from kubeflow_tpu_torch.serving import mesh as serving_mesh

        # a mesh of one rank: the one-process path, its signature kept
        mesh_signature, world, _ = serving_mesh.check(mesh, checkpoint_dir)
        if world > 1:
            sm = serving_mesh.ServingMesh(mesh, seed, checkpoint_dir,
                                          param_dtype=param_dtype,
                                          device=device)
    if kv_pages and not kv_page_size:
        raise ValueError("kv_pages requires kv_page_size > 0")
    if kv_pages:
        model_kwargs = dict(model_kwargs, kv_pages=kv_pages,
                            kv_page_size=kv_page_size)
    # a meshed model given its weights is built on the host: each rank
    # moves only its shards to the device
    base = get_model(model_name, seed=seed, max_seq_len=seq_budget,
                     device=("cpu" if sm is not None and state_dict
                             is not None else device), **model_kwargs)
    if state_dict is not None:
        base.load_state_dict(state_dict, strict=True)
    rolling = base.cfg.rolling_kv_cache
    if draft_model:
        if temperature > 0:
            raise ValueError("speculative decoding is greedy-only "
                             "(temperature must be 0)")
        if rolling:
            # refused at registration: the per-request guard would fail
            # every decode on a server that reported healthy
            raise ValueError("speculative decoding requires the full KV "
                             "cache (rolling_kv_cache evicts positions a "
                             "rejected draft must rewind over)")
    if kv_pages and rolling:
        raise ValueError("the paged KV cache is exclusive with "
                         "rolling_kv_cache")
    model = base
    if sm is not None:
        # the float cast before the cut; the model runs on its own
        # (sharded) parameters
        sm.place(base)
        params = None
    elif quantized:
        from kubeflow_tpu_torch.serving.quant import QuantizedModel

        model = QuantizedModel(base)
    if sm is None:
        with torch.no_grad():
            params = _prepare_serving_params(
                {k: v.detach() for k, v in base.state_dict().items()},
                param_dtype, base.cfg.head_dim)
    dev = base.device
    vocab = base.cfg.vocab_size
    # temperature > 0: a fresh seed per request; greedy keeps the seed
    request_seed = itertools.count(seed).__next__
    decoder_box: list = []       # the SlotDecoder, built on first use
    decoder_lock = threading.Lock()
    draft_box: list = []         # (draft model, its params), on first use
    draft_lock = threading.Lock()

    def draft():
        """The draft model and its params, built once: from
        draft_checkpoint_dir (or draft_state_dict), else random from
        seed + 1; cast or quantized like the target's."""
        with draft_lock:
            if not draft_box:
                # the draft shares the target's vocabulary: its
                # proposals are fed to the target's embedding (the
                # reference's gather clamps a foreign id, torch raises)
                dbase = get_model(draft_model, device=dev, seed=seed + 1,
                                  max_seq_len=seq_budget, vocab_size=vocab)
                dstate = draft_state_dict
                if draft_checkpoint_dir:
                    dstate = restore_variables(draft_checkpoint_dir)[0][
                        "params"]
                if dstate is not None:
                    dbase.load_state_dict(dstate, strict=True)
                dm = dbase
                if quantized:
                    from kubeflow_tpu_torch.serving.quant import QuantizedModel

                    dm = QuantizedModel(dbase)
                with torch.no_grad():
                    dparams = _prepare_serving_params(
                        {k: v.detach() for k, v in dbase.state_dict().items()},
                        param_dtype, dbase.cfg.head_dim)
                draft_box.extend([dm, dparams])
            return draft_box[0], draft_box[1]

    def validated_rows(toks):
        rows, pad_lens = [], []
        for row in np.asarray(toks, dtype=object):
            row = [int(t) for t in (row if hasattr(row, "__len__")
                                    else [row])]
            bad = [t for t in row if not 0 <= t < vocab]
            if bad:
                raise ApiHttpError(
                    400, f"token ids out of range [0, {vocab}): {bad[:5]}")
            row = row[-prompt_len:]
            pad_lens.append(prompt_len - len(row))
            rows.append([0] * (prompt_len - len(row)) + row)
        return rows, pad_lens

    def validated_max_news(batch, n):
        caps = batch.get("max_new_tokens") if isinstance(batch, dict) \
            else None
        if caps is None:
            return [None] * n
        flat = np.asarray(caps, dtype=object).reshape(-1)
        if len(flat) != n:
            raise ApiHttpError(
                400, f"max_new_tokens must be one value per instance "
                     f"(got {len(flat)} for {n} instances)")
        out = []
        for c in flat:
            c = int(c)
            if not 1 <= c <= max_new_tokens:
                raise ApiHttpError(
                    400, f"max_new_tokens must be in 1..{max_new_tokens}, "
                         f"got {c}")
            out.append(c)
        return out

    def capped_rows(out_rows, maxnews):
        if all(c is None for c in maxnews):
            return out_rows
        return [[int(t) for t in row[:c if c is not None else len(row)]]
                for row, c in zip(out_rows, maxnews)]

    def decoder():
        from kubeflow_tpu_torch.serving.continuous import SlotDecoder

        with decoder_lock:      # concurrent first requests: one decoder
            if not decoder_box:
                dm, dparams = draft() if draft_model else (None, None)
                decoder_box.append(SlotDecoder(
                    model, params, slots=decode_slots,
                    prompt_len=prompt_len, max_new_tokens=max_new_tokens,
                    temperature=temperature, top_k=top_k, seed=seed,
                    mesh=sm, prefix_cache=prefix_cache, draft_model=dm,
                    draft_variables=dparams, draft_k=draft_k,
                    metrics_name=name))
            return decoder_box[0]

    def generate_rows(rows, pad_lens, row_seed: int):
        """The generate path on this rank: [B, new] tokens."""
        out = generate(
            model, params, torch.as_tensor(np.asarray(rows), dtype=torch.long,
                                           device=dev),
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, seed=row_seed,
            pad_len=torch.as_tensor(np.asarray(pad_lens), dtype=torch.long,
                                    device=dev),
            share=sm.share if sm is not None and temperature > 0 else None)
        return out[:, prompt_len:].cpu().numpy()

    generate_id = None
    if sm is not None:
        generate_id = sm.register(
            lambda op, words, tensors: generate_rows(*tensors, words[0]))
        if continuous_batching:
            decoder()      # every rank holds its replica from the start

    def predict(batch):
        toks = batch["tokens"] if isinstance(batch, dict) else batch
        rows, pad_lens = validated_rows(toks)
        maxnews = validated_max_news(batch, len(rows))
        if continuous_batching:
            dec = decoder()
            dl = request_deadline()   # pool threads do not inherit it
            if len(rows) == 1:
                outs = [dec.submit_padded(rows[0], pad_lens[0], maxnews[0],
                                          dl)]
            else:
                with cf.ThreadPoolExecutor(max_workers=len(rows)) as pool:
                    outs = list(pool.map(dec.submit_padded, rows, pad_lens,
                                         maxnews, [dl] * len(rows)))
            if len({len(o) for o in outs}) > 1:
                return [list(o) for o in outs]
            return np.asarray(outs, dtype=np.int64)
        if draft_model:
            # batch-1 rounds per row (accept lengths are data-dependent);
            # concurrency comes from the micro-batcher
            from kubeflow_tpu_torch.runtime.speculative import (
                speculative_generate)

            dm, dparams = draft()
            count_drafted, count_accepted = speculative_counters()
            outs = []
            for r, pad in zip(rows, pad_lens):
                toks, stats = speculative_generate(
                    model, params, dm, dparams,
                    torch.tensor([r], dtype=torch.long, device=dev),
                    max_new_tokens=max_new_tokens, k=draft_k,
                    pad_len=torch.tensor([pad], dtype=torch.long,
                                         device=dev))
                count_drafted(name, stats["drafted"])
                count_accepted(name, stats["accepted"])
                outs.append(toks[0, prompt_len:].cpu().numpy())
            return capped_rows(np.stack(outs), maxnews)
        row_seed = request_seed() if temperature > 0 else seed
        if sm is not None:
            out = sm.call(generate_id, 0, (row_seed,),
                          [np.asarray(rows, np.int64),
                           np.asarray(pad_lens, np.int64)])
        else:
            out = generate_rows(rows, pad_lens, row_seed)
        return capped_rows(out, maxnews)

    served = ServedModel(
        name=name, predict_fn=predict,
        # the slot decoder takes ragged batches as they are, and the
        # speculative path decodes row by row: pow2 padding would only
        # decode phantom rows
        pad_batches=not (continuous_batching or draft_model),
        batch_window_ms=batch_window_ms, max_batch=max_batch,
        max_inflight=max_inflight,
        pad_multiple=sm.pad_multiple if sm is not None else 1,
        healthy=sm.healthy if sm is not None else None,
        signature={"inputs": "tokens", "method_name": "generate",
                   "prompt_len": prompt_len,
                   "max_new_tokens": max_new_tokens,
                   **({"continuous_batching": True,
                       "decode_slots": decode_slots}
                      if continuous_batching else {}),
                   **({"kv_pages": kv_pages, "kv_page_size": kv_page_size,
                       "prefix_cache": prefix_cache} if kv_pages else {}),
                   **({"param_dtype": param_dtype} if param_dtype else {}),
                   **({"draft_model": draft_model, "draft_k": draft_k}
                      if draft_model else {}),
                   **({"mesh": mesh_signature} if mesh is not None
                      else {})})
    served.decoder = lambda: decoder_box[0] if decoder_box else None
    orig_close = served.close

    def close():
        if decoder_box:
            decoder_box[0].close()
        orig_close()

    served.close = close  # type: ignore[method-assign]
    return served


# seconds rank 0 answers /readyz with 503 after losing its mesh, before
# it stops serving and exits nonzero
LOST_GRACE_S = 2.0


def _rank_device(device: str | None) -> str:
    """This rank's device: the CPU when asked for, else cuda:<local
    rank> (ranks past the GPU count share the cards round robin)."""
    from kubeflow_tpu_torch.parallel import dist as D

    if device == "cpu":
        return "cpu"
    local = int(os.environ.get(D.ENV_LOCAL_RANK) or 0)
    return f"cuda:{local % max(1, torch.cuda.device_count())}"


def _peak_bytes(device) -> int | None:
    """The device's peak allocated bytes since the last call (the peak
    is reset); None off a GPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda":
        return None
    peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return int(peak)


def _start_world(argv: list[str], n: int, device: str | None) -> int:
    """The serving world of a mesh when the env forms none: n copies of
    this command, rank r with the JAXJOB_* env of a local world (the
    launcher's local workers), sharing the cards over gloo (the loopback
    backend) when there are fewer GPUs than ranks."""
    from kubeflow_tpu_torch.parallel import backends as B
    from kubeflow_tpu_torch.parallel import dist as D
    from kubeflow_tpu_torch.runtime.launcher import run_local_workers

    port = D.free_port()
    env = {**os.environ, D.ENV_COORD: f"127.0.0.1:{port}", D.ENV_NPROC: "1",
           D.ENV_PID: "0"}
    if device != "cpu" and torch.cuda.device_count() < n:
        env.setdefault(B.ENV_BACKEND, B.BACKEND_LOOPBACK)
    log.info("starting a serving world of %d ranks", n)
    return run_local_workers(argv, n, module="kubeflow_tpu_torch.serving",
                             base_env=env)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser("kubeflow-tpu-torch-serving")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--model", action="append", default=[],
                   help="name=zoo_model[@ckpt_dir] classifier, e.g. "
                        "mnist=resnet18 (the default when neither --model "
                        "nor --lm is given)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="port training checkpoint to serve from (its "
                        "latest step): the one --model's, else the LMs'; "
                        "`name=model@dir` per model")
    p.add_argument("--lm", action="append", default=[],
                   help="generative LM entry: name=zoo_model, e.g. "
                        "chat=gpt-350m")
    p.add_argument("--prompt-len", type=int, default=128)
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--param-dtype", default=None,
                   choices=["bfloat16", "float32", "int8", "int4"])
    p.add_argument("--attention-window", type=int, default=0,
                   help="sliding-window attention width (0: full causal)")
    p.add_argument("--rolling-kv-cache", action="store_true",
                   help="bound the decode KV cache to the attention window "
                        "(slot = position %% window); needs "
                        "--attention-window")
    p.add_argument("--kv-cache-dtype", default=None, choices=["auto", "int8"])
    p.add_argument("--draft-model", default=None,
                   help="registry LM that drafts k tokens per round for "
                        "speculative decoding (greedy only; its weights "
                        "are random from seed + 1 without "
                        "--draft-checkpoint-dir)")
    p.add_argument("--draft-k", type=int, default=4)
    p.add_argument("--draft-checkpoint-dir", default=None,
                   help="port training checkpoint of the draft model")
    p.add_argument("--max-inflight", type=int, default=0)
    p.add_argument("--continuous-batching", action="store_true")
    p.add_argument("--decode-slots", type=int, default=8)
    p.add_argument("--kv-pages", type=int, default=0)
    p.add_argument("--kv-page-size", type=int, default=0)
    p.add_argument("--no-prefix-cache", action="store_true")
    p.add_argument("--mesh", default=None,
                   help="serve over a device mesh, e.g. 'model=2' or "
                        "'model=4,fsdp=2': one process per rank, HTTP on "
                        "rank 0 (started here unless the JAXJOB_* env, "
                        "e.g. the launcher's --nproc-per-node, forms the "
                        "world)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights (without a checkpoint)")
    p.add_argument("--dtype", default=None,
                   help="the models' compute dtype (their configs' "
                        "default: bfloat16)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    mesh_spec = None
    if args.mesh:
        try:
            mesh_spec = {k.strip(): int(v) for k, v in
                         (kv.split("=", 1) for kv in args.mesh.split(","))}
        except ValueError:
            p.error(f"--mesh must be axis=int[,axis=int...], got {args.mesh!r}")
    # the default classifier only when nothing at all was asked for
    models = args.model or ([] if args.lm else ["mnist=resnet18"])
    if args.checkpoint_dir and len(models) > 1:
        p.error("--checkpoint-dir applies to exactly one --model; use "
                "name=zoo@ckpt_dir for several")
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.parallel import dist as D
    from kubeflow_tpu_torch.serving import mesh as serving_mesh

    device = args.device
    if mesh_spec is not None:
        n = serving_mesh.world_of(mesh_spec)
        if (n > 1 and D.DistConfig.from_env().num_processes == 1
                and D.ENV_LOCAL_RANK not in os.environ):
            return _start_world(list(sys.argv[1:] if argv is None else argv),
                                n, args.device)
        device = _rank_device(args.device)
    server = ModelServer()
    lost = threading.Event()
    placed = None
    try:
        for spec in models:
            name, _, zoo = spec.partition("=")
            zoo, _, ckpt = zoo.partition("@")
            server.register(serve_flax_classifier(
                name, zoo or "resnet18", num_classes=10, mesh=mesh_spec,
                checkpoint_dir=ckpt or args.checkpoint_dir, seed=args.seed,
                device=device,
                **({"dtype": args.dtype} if args.dtype else {})))
        for spec in args.lm:
            name, _, zoo = spec.partition("=")
            zoo, _, ckpt = zoo.partition("@")
            server.register(serve_lm_generator(
                name, zoo or "gpt-125m", prompt_len=args.prompt_len,
                max_new_tokens=args.max_new_tokens, mesh=mesh_spec,
                continuous_batching=args.continuous_batching,
                decode_slots=args.decode_slots, kv_pages=args.kv_pages,
                kv_page_size=args.kv_page_size,
                prefix_cache=not args.no_prefix_cache,
                param_dtype=args.param_dtype,
                max_inflight=args.max_inflight, seed=args.seed,
                checkpoint_dir=ckpt or (None if models
                                        else args.checkpoint_dir),
                draft_model=args.draft_model, draft_k=args.draft_k,
                draft_checkpoint_dir=args.draft_checkpoint_dir,
                device=device,
                **({"dtype": args.dtype} if args.dtype else {}),
                **({"kv_cache_dtype": args.kv_cache_dtype}
                   if args.kv_cache_dtype else {}),
                **({"attention_window": args.attention_window}
                   if args.attention_window else {}),
                **({"rolling_kv_cache": True}
                   if args.rolling_kv_cache else {})))
        rt = serving_mesh.active()
        placed = _peak_bytes(device)
        fa.reset_launches()      # the launches while serving, on this rank
        if rt is not None and rt.rank > 0:
            log.info("rank %d of the serving mesh: following rank 0",
                     rt.rank)
            # a follower stops on rank 0's word (or when rank 0 is gone),
            # not on the SIGTERM a local world's starter forwards
            signal.signal(signal.SIGTERM, signal.SIG_IGN)
            rt.follow()
            return 0
        svc = server.serve(host=args.host, port=args.port)
        if rt is not None:
            def on_lost(err):   # unready at once; stop serving soon after
                lost.set()
                threading.Timer(LOST_GRACE_S, svc._server.shutdown).start()

            rt.on_lost.append(on_lost)
        # SIGTERM: an orderly stop (over a mesh the other ranks stop too)
        signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
            target=svc._server.shutdown, daemon=True).start())
        log.info("serving on :%d", svc.port)
        svc.serve_forever()
        return 1 if lost.is_set() else 0
    finally:
        rt = serving_mesh.active()
        if rt is not None:
            # device memory: the peak while the weights were placed, then
            # while serving
            print(json.dumps({"serving_rank": rt.rank, "world": rt.world,
                              "placed_peak_bytes": placed,
                              "peak_bytes": _peak_bytes(device),
                              "launches": dict(fa.LAUNCHES)}),
                  flush=True)
        server.close()
        D.shutdown()
