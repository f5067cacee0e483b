"""LM model server: the TF-Serving REST surface over the port's decode
path (port of kubeflow_tpu/serving/server.py, the LM generator).

Endpoints:
- GET  /v1/models                              -> inventory
- GET  /v1/models/{model}                      -> version status
- GET  /v1/models/{model}/metadata             -> signature metadata
- POST /v1/models/{model}:predict              -> {"predictions": [...]}
- POST /v1/models/{model}/versions/{v}:predict
- GET  /healthz, /readyz, /metrics

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
device="cpu"), then cast or quantized per `param_dtype`. Not ported
yet, each raising NotImplementedError with its ROADMAP item: the
classifier server (`--model`, slice 5) and mesh serving (slice 4).

Usage:
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
import logging
import math
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from kubeflow_tpu_torch.runtime.metrics import REGISTRY as METRICS_REGISTRY
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
        with self._lock:
            models = [m for vs in self._models.values() for m in vs.values()]
        for m in models:
            m.close()

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
        httpd.add_health_routes(r)
        httpd.add_metrics_route(r)
        return r

    def serve(self, host: str = "0.0.0.0", port: int = 8500
              ) -> httpd.HttpService:
        return httpd.HttpService(self.router(), host, port)


# ---------------------------------------------------------------------------
# model builders


def serve_flax_classifier(*args, **kwargs) -> ServedModel:
    raise NotImplementedError(
        "the classifier server needs ResNet, which is not ported yet "
        "(ROADMAP Queue 1, slice 5)")


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
    if mesh is not None:
        raise NotImplementedError(
            "mesh serving is not ported yet (ROADMAP Queue 1, slice 4)")
    # the verify chunk writes up to draft_k positions past the last token
    seq_budget = prompt_len + max_new_tokens + (draft_k if draft_model else 0)
    if kv_pages and not continuous_batching:
        raise ValueError("kv_pages (the paged KV cache) requires "
                         "continuous_batching: the page pool is shared "
                         "across decode slots")
    if kv_pages and not kv_page_size:
        raise ValueError("kv_pages requires kv_page_size > 0")
    if kv_pages:
        model_kwargs = dict(model_kwargs, kv_pages=kv_pages,
                            kv_page_size=kv_page_size)
    base = get_model(model_name, device=device, seed=seed,
                     max_seq_len=seq_budget, **model_kwargs)
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
    quantized = param_dtype in ("int8", "int4")
    if quantized:
        from kubeflow_tpu_torch.serving.quant import QuantizedModel

        model = QuantizedModel(base)
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
                    prefix_cache=prefix_cache, draft_model=dm,
                    draft_variables=dparams, draft_k=draft_k,
                    metrics_name=name))
            return decoder_box[0]

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
        out = generate(
            model, params, torch.as_tensor(rows, dtype=torch.long,
                                           device=dev),
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, seed=request_seed() if temperature > 0 else seed,
            pad_len=torch.as_tensor(pad_lens, dtype=torch.long, device=dev))
        return capped_rows(out[:, prompt_len:].cpu().numpy(), maxnews)

    served = ServedModel(
        name=name, predict_fn=predict,
        # the slot decoder takes ragged batches as they are, and the
        # speculative path decodes row by row: pow2 padding would only
        # decode phantom rows
        pad_batches=not (continuous_batching or draft_model),
        batch_window_ms=batch_window_ms, max_batch=max_batch,
        max_inflight=max_inflight,
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
                      if draft_model else {})})
    served.decoder = lambda: decoder_box[0] if decoder_box else None
    orig_close = served.close

    def close():
        if decoder_box:
            decoder_box[0].close()
        orig_close()

    served.close = close  # type: ignore[method-assign]
    return served


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser("kubeflow-tpu-torch-serving")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--model", action="append", default=[],
                   help="name=zoo_model classifier (not ported yet)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="port training checkpoint to serve the LM from "
                        "(its latest step; `--lm name=model@dir` per model)")
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
    p.add_argument("--mesh", default=None, help="not ported yet")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.model or not args.lm:
        serve_flax_classifier()
    if args.mesh:
        raise NotImplementedError(
            "mesh serving is not ported yet (ROADMAP Queue 1, slice 4)")
    server = ModelServer()
    try:
        for spec in args.lm:
            name, _, zoo = spec.partition("=")
            zoo, _, ckpt = zoo.partition("@")
            server.register(serve_lm_generator(
                name, zoo or "gpt-125m", prompt_len=args.prompt_len,
                max_new_tokens=args.max_new_tokens,
                continuous_batching=args.continuous_batching,
                decode_slots=args.decode_slots, kv_pages=args.kv_pages,
                kv_page_size=args.kv_page_size,
                prefix_cache=not args.no_prefix_cache,
                param_dtype=args.param_dtype,
                max_inflight=args.max_inflight,
                checkpoint_dir=ckpt or args.checkpoint_dir,
                draft_model=args.draft_model, draft_k=args.draft_k,
                draft_checkpoint_dir=args.draft_checkpoint_dir,
                device=args.device,
                **({"kv_cache_dtype": args.kv_cache_dtype}
                   if args.kv_cache_dtype else {}),
                **({"attention_window": args.attention_window}
                   if args.attention_window else {}),
                **({"rolling_kv_cache": True}
                   if args.rolling_kv_cache else {})))
        svc = server.serve(host=args.host, port=args.port)
        log.info("serving on :%d", svc.port)
        svc.serve_forever()
    finally:
        server.close()
    return 0
