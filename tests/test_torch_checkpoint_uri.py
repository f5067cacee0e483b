"""The port's checkpoints in a directory given as a URI
(kubeflow_tpu_torch/runtime/checkpoint.py through fsspec), on fsspec's
in-process `memory://` filesystem and on `file://`.

An object store has no rename, so a step is written in place and counts
only once its commit marker, written last, is there: save, keep N, the
manifest (the reference's schema), restore_latest, restore_variables,
and a step whose marker is missing (a writer killed part-way) are held
here; a Trainer.fit stopped at step 2 and resumed to step 4 equals 4
straight steps (params within 1e-6: f32 on the CPU, the same ops in the
same order); a scheme fsspec has no implementation for, and fsspec
missing altogether, raise a ValueError that names what is missing. A
URI resolves as the reference's `_normalize_dir` leaves it (passed
through), a local path as it makes it (absolute), for the Checkpointer
and restore_variables alike. The gang's resume through a `file://` URI
is in tests/test_torch_gang.py.
"""

import json
import os
import sys
import uuid

import fsspec
import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.runtime import checkpoint as ckpt
from kubeflow_tpu_torch.runtime import trainer as ttrainer

BASE = dict(model="transformer-test", task="lm", global_batch=8, seq_len=32,
            vocab_size=256, optimizer="adamw", learning_rate=1e-2,
            weight_decay=1e-4, warmup_steps=1, total_steps=4, log_every=1,
            model_kwargs={"dtype": "float32"})


def port(**kw) -> ttrainer.Trainer:
    return ttrainer.Trainer(ttrainer.TrainConfig.from_dict({**BASE, **kw}),
                            device="cpu")


@pytest.fixture
def uri():
    """A fresh directory on the process's memory filesystem."""
    name = f"ckpt-{uuid.uuid4().hex}"
    yield f"memory://{name}"
    fs = fsspec.filesystem("memory")
    if fs.exists(f"/{name}"):
        fs.rm(f"/{name}", recursive=True)


def payload(step: int) -> dict:
    return {"step": step, "params": {"w": torch.full((3,), float(step))},
            "batch_stats": {}, "opt_state": {"w": {"m": torch.ones(2) * step}}}


class Target:
    def load_payload(self, p):
        self.payload = p


def test_save_keep_manifest_and_restore_through_a_uri(uri):
    ck = ckpt.Checkpointer(uri, keep=2, world_size=1, num_slices=1)
    for step in (1, 2, 3):
        assert ck.save(step, payload(step))
    ck.close()
    fs, root = fsspec.core.url_to_fs(uri)
    assert ck.all_steps() == ckpt.list_steps(uri) == [2, 3]
    assert sorted(p.rsplit("/", 1)[1] for p in fs.ls(root, detail=False)) \
        == ["2", "3", "manifest.json"]
    for step in (2, 3):
        assert fs.exists(f"{root}/{step}/{ckpt.COMMIT_FILE}")
    assert json.loads(fs.cat(f"{root}/manifest.json")) == {
        "latest_step": 3, "steps": [2, 3], "world_sizes": {"2": 1, "3": 1},
        "slice_counts": {"2": 1, "3": 1}}
    t = Target()
    got = ckpt.Checkpointer(uri).restore_latest(t)
    assert got["step"] == 3 and t.payload is got
    assert torch.equal(got["opt_state"]["w"]["m"], torch.ones(2) * 3)
    variables, step = ckpt.restore_variables(uri + "/")
    assert step == 3 and set(variables) == {"params"}
    assert torch.equal(variables["params"]["w"], torch.full((3,), 3.0))
    params, step = ckpt.restore_params(uri, step=2)
    assert step == 2 and torch.equal(params["w"], torch.full((3,), 2.0))
    # an existing step is skipped unless forced
    assert ck.save(3, payload(30)) is False
    assert ck.save(3, payload(30), force=True)
    ck.close()
    assert ck.restore(3)["params"]["w"][0] == 30.0


def test_a_step_without_its_marker_is_never_restored(uri):
    ck = ckpt.Checkpointer(uri, keep=0)
    for step in (1, 2):
        ck.save(step, payload(step))
    ck.close()
    fs, root = fsspec.core.url_to_fs(uri)
    # a writer killed part-way: step 2's marker gone, step 5's files
    # written and its marker never
    fs.rm(f"{root}/2/{ckpt.COMMIT_FILE}")
    fs.makedirs(f"{root}/5", exist_ok=True)
    with fs.open(f"{root}/5/{ckpt.PARAMS_FILE}", "wb") as f:
        torch.save({"step": 5, "params": {}}, f)
    assert ckpt.list_steps(uri) == [1]
    assert ckpt.Checkpointer(uri).restore_latest(Target())["step"] == 1
    assert ckpt.restore_variables(uri)[1] == 1
    with pytest.raises(FileNotFoundError, match="commit marker"):
        ckpt.Checkpointer(uri).restore(2)
    # a later save over a marker-less step replaces it; once a newer
    # step commits, the marker-less ones below it go
    ck = ckpt.Checkpointer(uri, keep=0)
    ck.save(2, payload(2))
    ck.save(6, payload(6))
    ck.close()
    assert ckpt.list_steps(uri) == [1, 2, 6]
    assert not fs.exists(f"{root}/5")


def test_fit_resumes_through_a_uri_as_a_straight_run(uri):
    straight = port()
    straight.fit(steps=4)
    first = port(checkpoint_dir=uri, checkpoint_every=2)
    assert first.fit(steps=2)["start_step"] == 0
    assert ckpt.list_steps(uri) == [2]
    second = port(checkpoint_dir=uri, checkpoint_every=2)
    assert second.fit(steps=4)["start_step"] == 2
    assert ckpt.list_steps(uri) == [2, 4]
    want = dict(straight.model.named_parameters())
    for name, p in second.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name].detach().numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)


def test_file_uri_writes_a_local_directory(tmp_path):
    d = tmp_path / "ck"
    ck = ckpt.Checkpointer(f"file://{d}", keep=1)
    ck.save(4, payload(4))
    ck.close()
    assert sorted(os.listdir(d)) == ["4", "manifest.json"]
    assert sorted(os.listdir(d / "4")) == sorted(
        [ckpt.COMMIT_FILE, ckpt.PARAMS_FILE, ckpt.OPT_FILE])
    assert ckpt.restore_params(f"file://{d}")[1] == 4


def test_a_scheme_fsspec_lacks_is_refused_by_name(monkeypatch):
    with pytest.raises(ValueError, match="no implementation.*nosuchfs"):
        ckpt.Checkpointer("nosuchfs://bucket/run")
    # a scheme fsspec knows whose package is not installed
    fsspec.register_implementation("kftpumissing", "kftpu_no_such_pkg.FS",
                                   errtxt="install kftpu_no_such_pkg",
                                   clobber=True)
    with pytest.raises(ValueError, match="install kftpu_no_such_pkg"):
        ckpt.restore_variables("kftpumissing://bucket/run")
    with pytest.raises(ValueError, match="install kftpu_no_such_pkg"):
        ckpt.list_steps("kftpumissing://bucket/run")
    # fsspec itself missing
    monkeypatch.setitem(sys.modules, "fsspec", None)
    with pytest.raises(ValueError, match="fsspec, which does not import"):
        ckpt.Checkpointer("memory://anything")


@pytest.mark.parametrize("directory", ["gs://bucket/run", "s3://b/r/",
                                       "relative/ckpt", "/abs/ckpt"])
def test_directories_resolve_as_the_reference_normalises(directory,
                                                         monkeypatch):
    from kubeflow_tpu.runtime import checkpoint as jckpt

    # the reference's creates a local directory; only its answer is compared
    monkeypatch.setattr(os, "makedirs", lambda *a, **k: None)
    monkeypatch.setattr(ckpt, "_remote", lambda d: None)
    assert ckpt._resolve(directory) == jckpt._normalize_dir(
        directory).rstrip("/")
