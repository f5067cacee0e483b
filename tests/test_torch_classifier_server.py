"""The port's classifier server (`serve_flax_classifier` and the CLI's
default `mnist=resnet18`) against the reference's REST contract
(tests/test_serving.py) and against the reference's server itself: both
serve one orbax training checkpoint (the port through
`convert.write_port_checkpoint`, params and batch_stats), in f32 on the
CPU, and their softmax rows agree within 1e-5.
"""

import json
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.runtime import checkpoint as jckpt
from kubeflow_tpu.runtime import trainer as jtrainer
from kubeflow_tpu.serving import server as jserver
from kubeflow_tpu_torch import convert
from kubeflow_tpu_torch.serving import server as S

PROB_TOL = 1e-5


def _post(base: str, path: str, body) -> tuple[int, dict]:
    req = urllib.request.Request(f"{base}{path}",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, {}


def _get(base: str, path: str) -> dict:
    with urllib.request.urlopen(f"{base}{path}", timeout=30) as r:
        return json.loads(r.read())


@pytest.fixture
def served():
    srv = S.ModelServer()
    svc = srv.serve(host="127.0.0.1", port=0).serve_background()
    yield srv, f"http://127.0.0.1:{svc.port}"
    svc.shutdown()
    srv.close()


def test_rest_contract_of_the_reference(served):
    """test_serving.py's resnet18 digits case and its contract checks."""
    srv, base = served
    srv.register(S.serve_flax_classifier("digits", "resnet18",
                                         num_classes=10, device="cpu"))
    x = np.random.default_rng(2).random((2, 28, 28, 1)).tolist()
    status, out = _post(base, "/v1/models/digits:predict", {"instances": x})
    assert status == 200
    preds = np.asarray(out["predictions"])
    assert preds.shape == (2, 10)
    np.testing.assert_allclose(preds.sum(axis=-1), 1.0, atol=1e-4)
    # golden determinism: the same input gives the same rows
    _, again = _post(base, "/v1/models/digits:predict", {"instances": x})
    np.testing.assert_allclose(np.asarray(again["predictions"]), preds,
                               atol=1e-6)
    st = _get(base, "/v1/models/digits")["model_version_status"][0]
    assert st["state"] == "AVAILABLE" and st["status"]["error_code"] == "OK"
    meta = _get(base, "/v1/models/digits/metadata")
    assert meta["model_spec"]["name"] == "digits"
    assert _post(base, "/v1/models/nope:predict",
                 {"instances": [[1]]})[0] == 404
    assert _post(base, "/v1/models/digits:predict", {"inputs": [1]})[0] == 400


def test_padding_and_input_key(served):
    """Rows are independent in eval mode: three instances (padded to a
    batch of four) equal each served alone; dict instances read
    `input_key`."""
    srv, base = served
    srv.register(S.serve_flax_classifier("img", "resnet18", input_key="image",
                                         num_classes=10, device="cpu",
                                         num_filters=8, dtype="float32"))
    x = np.random.default_rng(0).random((3, 16, 16, 3)).astype(np.float32)
    _, out = _post(base, "/v1/models/img:predict",
                   {"instances": [{"image": r.tolist()} for r in x]})
    batched = np.asarray(out["predictions"])
    for i, r in enumerate(x):
        _, one = _post(base, "/v1/models/img:predict",
                       {"instances": [{"image": r.tolist()}]})
        np.testing.assert_allclose(np.asarray(one["predictions"][0]),
                                   batched[i], atol=1e-6)


def test_serves_an_orbax_checkpoint_as_the_reference_server_does(tmp_path):
    cfg = dict(model="resnet18", task="classification", global_batch=8,
               image_size=16, num_classes=10, optimizer="sgdm",
               learning_rate=0.1, warmup_steps=0, total_steps=2,
               model_kwargs={"num_filters": 8, "dtype": "float32"})
    jd, pd = str(tmp_path / "orbax"), str(tmp_path / "port")
    jt = jtrainer.Trainer(jtrainer.TrainConfig.from_dict(
        {**cfg, "checkpoint_dir": jd}))
    jt.fit(steps=2)
    jck = jckpt.Checkpointer(jd)
    state = jax.device_get(jck.restore_latest(jt.init_state()))
    jck.close()
    convert.write_port_checkpoint(
        pd, int(state.step), state.params, state.opt_state, "sgdm",
        batch_stats=state.batch_stats)
    x = np.random.default_rng(1).standard_normal((4, 16, 16, 3)).astype(
        np.float32)
    ref = jserver.serve_flax_classifier("r", "resnet18", num_classes=10,
                                        num_filters=8, dtype=jnp.float32,
                                        checkpoint_dir=jd)
    mine = S.serve_flax_classifier("p", "resnet18", num_classes=10,
                                   num_filters=8, dtype="float32",
                                   checkpoint_dir=pd, device="cpu")
    want = np.asarray(ref.predict(list(x)))
    got = np.asarray(mine.predict(list(x)))
    assert got.shape == (4, 10)
    np.testing.assert_allclose(got, want, atol=PROB_TOL, rtol=PROB_TOL)
    # eval mode on the checkpoint's statistics, not on the batch's: a
    # row served alone is the same row
    np.testing.assert_allclose(np.asarray(mine.predict(list(x[:1])))[0],
                               got[0], atol=1e-6)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        S.serve_flax_classifier("bad", "resnet18", device="cpu",
                                checkpoint_dir=str(tmp_path / "empty"))
    # mesh serving is ported (tests/test_torch_mesh_classifier.py): a
    # mesh wider than the world is refused at registration
    with pytest.raises(ValueError, match="device count 1"):
        S.serve_flax_classifier("m", "resnet18", device="cpu",
                                mesh={"model": 2})


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_default_is_mnist_resnet18():
    port_ = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.serving", "--device", "cpu",
         "--host", "127.0.0.1", "--port", str(port_)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port_}"
    try:
        deadline = time.monotonic() + 90
        while True:
            try:
                models = _get(base, "/v1/models")
                break
            except OSError:
                if time.monotonic() > deadline or proc.poll() is not None:
                    raise
                time.sleep(0.5)
        assert [m["name"] for m in models["models"]] == ["mnist"]
        x = np.random.default_rng(0).random((1, 28, 28, 1)).tolist()
        status, out = _post(base, "/v1/models/mnist:predict",
                            {"instances": x})
        assert status == 200
        preds = np.asarray(out["predictions"])
        assert preds.shape == (1, 10)
        np.testing.assert_allclose(preds.sum(-1), 1.0, atol=1e-4)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
