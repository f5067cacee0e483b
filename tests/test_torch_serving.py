"""The port's LM server (serving/server.py) on device="cpu" against the
JAX package's server on the same weights: the TF-Serving REST contract
(predict, versions, status, metadata, inventory, metrics), the same
predictions on every decode path (generate, micro-batched, continuous
dense and paged, int8 weights), pow2 padding, the overload 429 with
Retry-After, the 400s and the CLI. Models are f32: in bf16 a near-tie
can round either way in either framework."""

import json
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from kubeflow_tpu.models.registry import get_model as jax_get_model
from kubeflow_tpu.serving.server import serve_lm_generator as jax_serve
from kubeflow_tpu_torch.convert import flax_to_state_dict
from kubeflow_tpu_torch.serving import server as S
from kubeflow_tpu_torch.utils.httpd import ApiHttpError

P, N, VOCAB = 8, 4, 64
LM = dict(prompt_len=P, max_new_tokens=N, vocab_size=VOCAB)
INSTANCES = [{"tokens": [1, 2, 3]}, {"tokens": list(range(1, 12))},
             {"tokens": [9]}]


@pytest.fixture(scope="module")
def weights():
    jm = jax_get_model("transformer-test", vocab_size=VOCAB,
                       max_seq_len=P + N, dtype=jnp.float32)
    params = meta.unbox(jm.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 1), jnp.int32),
                                train=False)["params"])
    return flax_to_state_dict(jax.device_get(params))


_JAX: dict = {}


def jax_predictions(param_dtype=None):
    """The JAX server's predictions for INSTANCES (its weights come from
    PRNGKey(0), the ones `weights` converts)."""
    if param_dtype not in _JAX:
        served = jax_serve("x", "transformer-test", dtype=jnp.float32,
                           param_dtype=param_dtype, **LM)
        try:
            _JAX[param_dtype] = served.predict(INSTANCES)
        finally:
            served.close()
    return _JAX[param_dtype]


def port(weights, **kw):
    return S.serve_lm_generator("x", "transformer-test", device="cpu",
                                state_dict=weights, dtype="float32",
                                **{**LM, **kw})


class _Http:
    def __init__(self, *served):
        self.server = S.ModelServer()
        for m in served:
            self.server.register(m)
        self.svc = self.server.serve(host="127.0.0.1", port=0)
        self.svc.serve_background()
        self.base = f"http://127.0.0.1:{self.svc.port}"

    def call(self, method, path, body=None, headers=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(self.base + path, data=data,
                                     method=method, headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                raw = resp.read()
                return resp.status, dict(resp.headers), raw
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()

    def json(self, method, path, body=None, headers=None):
        status, _, raw = self.call(method, path, body, headers)
        return status, json.loads(raw)

    def close(self):
        self.svc.shutdown()
        self.server.close()


@pytest.mark.parametrize("kw", [
    {}, {"batch_window_ms": 5.0},
    {"continuous_batching": True, "decode_slots": 2},
    {"continuous_batching": True, "decode_slots": 2, "kv_pages": 9,
     "kv_page_size": 4},
], ids=["generate", "micro", "continuous", "paged"])
def test_predict_equals_jax_server(weights, kw):
    http = _Http(port(weights, **kw))
    try:
        status, body = http.json("POST", "/v1/models/x:predict",
                                 {"instances": INSTANCES})
        assert status == 200
        assert body["predictions"] == jax_predictions()
        status, body = http.json("POST", "/v1/models/x/versions/1:predict",
                                 {"instances": INSTANCES[:1]})
        assert status == 200 and body["predictions"] == jax_predictions()[:1]
    finally:
        http.close()


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_quantized_predict_equals_jax_server(weights, dtype):
    served = port(weights, param_dtype=dtype)
    try:
        assert served.predict(INSTANCES) == jax_predictions(dtype)
        assert served.signature["param_dtype"] == dtype
    finally:
        served.close()


def test_status_metadata_inventory_metrics_and_404(weights):
    served = port(weights, continuous_batching=True, decode_slots=2)
    http = _Http(served)
    try:
        assert http.json("GET", "/v1/models/x")[1] == {
            "model_version_status": [{"version": "1", "state": "AVAILABLE",
                                      "status": {"error_code": "OK",
                                                 "error_message": ""}}]}
        sig = http.json("GET", "/v1/models/x/metadata")[1]["metadata"][
            "signature_def"]
        assert sig["method_name"] == "generate" and sig["prompt_len"] == P
        assert sig["continuous_batching"] is True
        assert http.json("GET", "/v1/models")[1]["models"][0]["method"] == \
            "generate"
        assert http.json("GET", "/v1/models/nope")[0] == 404
        assert http.json("POST", "/v1/models/nope:predict",
                         {"instances": INSTANCES})[0] == 404
        assert http.json("GET", "/healthz") == (200, {"status": "ok"})
        http.json("POST", "/v1/models/x:predict", {"instances": INSTANCES})
        status, _, raw = http.call("GET", "/metrics")
        text = raw.decode()
        assert status == 200
        assert 'serving_tokens_generated_total{model="x"}' in text
        assert "serving_predict_seconds_bucket" in text
    finally:
        http.close()


def test_bad_requests_are_400_and_deadlines_504(weights):
    http = _Http(port(weights))
    try:
        post = lambda body, **kw: http.json(  # noqa: E731
            "POST", "/v1/models/x:predict", body, **kw)
        status, body = post({"instances": [{"tokens": [1, VOCAB]}]})
        assert status == 400 and "out of range" in body["error"]
        status, body = post({"instances": [{"tokens": [1],
                                            "max_new_tokens": N + 1}]})
        assert status == 400 and "max_new_tokens" in body["error"]
        status, body = post({"instances": [
            {"tokens": [1], "max_new_tokens": 2}, {"tokens": [2]}]})
        assert status == 400
        assert post({"nope": []})[0] == 400
        assert post({"instances": []})[0] == 400
        assert post({"instances": INSTANCES[:1]},
                    headers={"x-request-deadline-s": "0"})[0] == 504
        assert post({"instances": INSTANCES[:1]},
                    headers={"x-request-deadline-s": "soon"})[0] == 400
        # budgets: ragged rows, each a prefix of the full continuation
        status, body = post({"instances": [
            {"tokens": [1, 2, 3], "max_new_tokens": 2},
            {"tokens": [1, 2, 3], "max_new_tokens": N}]})
        assert status == 200
        full = jax_predictions()[0]
        assert body["predictions"] == [full[:2], full]
    finally:
        http.close()


def test_pow2_padding_and_unstack():
    seen = []

    def fn(batch):
        seen.append(len(batch))
        return np.asarray(batch) * 2

    m = S.ServedModel(name="pad", predict_fn=fn)
    assert m.predict([[1], [2], [3]]) == [[2], [4], [6]]
    assert seen == [4]
    assert S._next_pow2(5) == 8 and S._next_pow2(1) == 1
    with pytest.raises(ApiHttpError):
        m.predict([])


def test_overload_is_429_with_retry_after():
    gate, entered = threading.Event(), threading.Event()

    def slow(batch):
        entered.set()
        gate.wait(timeout=30)
        return np.asarray(batch)

    http = _Http(S.ServedModel(name="busy", predict_fn=slow, max_inflight=1))
    try:
        first = threading.Thread(target=http.call, args=(
            "POST", "/v1/models/busy:predict", {"instances": [[1]]}))
        first.start()
        assert entered.wait(timeout=30)
        status, headers, _ = http.call("POST", "/v1/models/busy:predict",
                                       {"instances": [[1]]})
        assert status == 429
        assert int(headers["Retry-After"]) >= 1
        gate.set()
        first.join(timeout=30)
        assert not first.is_alive()
    finally:
        gate.set()
        http.close()


def test_micro_batcher_coalesces_concurrent_calls():
    calls = []

    def fn(instances):
        calls.append(len(instances))
        return [i * 10 for i in instances]

    mb = S.MicroBatcher(fn, max_batch=8, max_wait_ms=1000)
    try:
        out: dict = {}
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, mb.submit([i]))) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert out == {i: [i * 10] for i in range(4)}
        assert sum(calls) == 4 and len(calls) < 4
    finally:
        mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit([1])


def test_cast_params_and_unported_options(weights):
    cast = S.cast_params({"a": torch.ones(2), "i": torch.ones(2,
                                                              dtype=torch.int32)},
                         "bfloat16")
    assert cast["a"].dtype == torch.bfloat16 and cast["i"].dtype == torch.int32
    with pytest.raises(ValueError, match="floating"):
        S.cast_params({}, "int8")
    with pytest.raises(NotImplementedError, match="mesh"):
        port(weights, mesh={"model": 2})
    # checkpoint restore is ported: a missing checkpoint fails at
    # registration, as the reference's does
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        S.serve_lm_generator("x", "transformer-test", device="cpu",
                             dtype="float32", checkpoint_dir="/nonexistent",
                             **LM)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        port(weights, draft_model="transformer-test",
             draft_checkpoint_dir="/nonexistent")
    # speculative decoding and the rolling cache are ported: what the
    # reference refuses at registration, the port refuses the same way
    for kw, match in ((dict(draft_model="transformer-test",
                            rolling_kv_cache=True, attention_window=4),
                       "full KV cache"),
                      (dict(draft_model="transformer-test", temperature=0.7),
                       "greedy-only"),
                      (dict(rolling_kv_cache=True, attention_window=4,
                            continuous_batching=True, kv_pages=8,
                            kv_page_size=4), "exclusive")):
        with pytest.raises(ValueError, match=match):
            port(weights, **kw)
    with pytest.raises(ValueError, match="continuous_batching"):
        port(weights, kv_pages=8, kv_page_size=4)
    with pytest.raises(NotImplementedError, match="ResNet"):
        S.main(["--model", "mnist=resnet18", "--device", "cpu"])


def test_cli_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.main(["--lm", "x=transformer-test"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serves_predict_on_the_cpu(tmp_path):
    port_ = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.serving", "--lm",
         "x=transformer-test", "--device", "cpu", "--host", "127.0.0.1",
         "--port", str(port_), "--prompt-len", "8", "--max-new-tokens", "4",
         "--continuous-batching", "--decode-slots", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        url = f"http://127.0.0.1:{port_}"
        deadline = time.monotonic() + 90
        while True:
            try:
                with urllib.request.urlopen(url + "/v1/models/x", timeout=5):
                    break
            except OSError:
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(proc.stdout.read().decode())
                time.sleep(0.2)
        req = urllib.request.Request(
            url + "/v1/models/x:predict",
            data=json.dumps({"instances": [{"tokens": [1, 2, 3]}]}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            preds = json.loads(resp.read())["predictions"]
        assert len(preds) == 1 and len(preds[0]) == 4
        assert all(0 <= t < 256 for t in preds[0])
    finally:
        proc.terminate()
        proc.wait(timeout=30)
