"""Whole-forward remat for the classifier tasks (runtime/trainer.py, the
reference's `jax.checkpoint` of the whole forward with dots|full,
kubeflow_tpu/runtime/trainer.py) on the CPU, f32.

ResNet-18 with BatchNorm (the smallest size: 8 filters, 32px) under
`full` and `dots`: one step against the reference's remat step on the
same converted weights (loss 1e-5 relative, params and batch_stats 1e-5,
tests/test_torch_classification.py's STEP_TOL), and against the port's
no-remat step (the replay recomputes the same operations: 1e-6). The
running statistics move exactly once a step: after one and after two
steps they equal no-remat's, and the same check with the recompute's
freeze taken out (the statistics then move twice) fails. vit-test under
dots equals no remat, and the dots policy saves plain GEMM outputs
only.
"""

import contextlib

import numpy as np
import pytest
import torch

from test_torch_classification import RESNET, aligned, port, port_state, state_of

from kubeflow_tpu_torch.models import resnet as tresnet
from kubeflow_tpu_torch.runtime import trainer as ttrainer

STEP_TOL = 1e-5
SAME_TOL = 1e-6


def _stats(t) -> dict:
    return {n: b.detach().clone() for n, b in t.model.named_buffers()}


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_step_matches_the_reference_remat_step(policy):
    jt, state, t = aligned(RESNET, remat=True, remat_policy=policy)
    batch = next(jt.data_iter())
    state, m = jt.train_step(state, batch)
    got = t.train_step(t._to_device(batch))
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]),
                               rtol=STEP_TOL)
    want = state_of(state)
    have = port_state(t)
    assert set(have) == set(want)
    for name in sorted(want):
        np.testing.assert_allclose(have[name], want[name], rtol=STEP_TOL,
                                   atol=STEP_TOL, err_msg=name)


def _two_steps(cfg: dict, **kw):
    """(loss, state, running statistics) after one and after two steps."""
    t = port(cfg, **kw)
    local = t._to_device(next(t.data_iter()))
    out = []
    for _ in range(2):
        loss = float(t.train_step(local)["loss"])
        out.append((loss, port_state(t), _stats(t)))
    return out


def _assert_same(got, want, what: str) -> None:
    for i, ((gl, gs, _), (wl, ws, _)) in enumerate(zip(got, want)):
        assert abs(gl - wl) <= SAME_TOL * abs(wl), (what, i, gl, wl)
        for name, w in ws.items():
            np.testing.assert_allclose(gs[name], w, rtol=SAME_TOL,
                                       atol=SAME_TOL,
                                       err_msg=f"{what} step {i} {name}")


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_equals_no_remat_and_moves_statistics_once(policy):
    plain = _two_steps(RESNET)
    remat = _two_steps(RESNET, remat=True, remat_policy=policy)
    _assert_same(remat, plain, policy)
    # the statistics moved at each step: a second update shows
    first, second = plain[0][2], plain[1][2]
    assert any(not torch.equal(first[n], second[n]) for n in first)


def test_statistics_would_move_twice_without_the_freeze(monkeypatch):
    """The control: the recompute without frozen_batch_stats moves the
    running statistics a second time, and the check above sees it."""
    monkeypatch.setattr(tresnet, "frozen_batch_stats", contextlib.nullcontext)
    plain = _two_steps(RESNET)
    remat = _two_steps(RESNET, remat=True, remat_policy="full")
    with pytest.raises(AssertionError):
        _assert_same(remat, plain, "unfrozen")
    # the parameters are the same; only the running statistics moved twice
    for name in plain[0][1]:
        if name.endswith((".mean", ".var")):
            continue
        np.testing.assert_allclose(remat[0][1][name], plain[0][1][name],
                                   rtol=SAME_TOL, atol=SAME_TOL)


def test_vit_dots_equals_no_remat():
    cfg = {**RESNET, "model": "vit-test", "model_kwargs": {"dtype": "float32"}}
    _assert_same(_two_steps(cfg, remat=True, remat_policy="dots"),
                 _two_steps(cfg), "vit dots")


def test_dots_saves_plain_gemms_only():
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    save = {f: ttrainer._save_dots(None, f) for f in (
        aten.mm.default, aten.addmm.default, aten.bmm.default,
        aten.convolution.default, aten.add.Tensor)}
    assert save[aten.mm.default] == save[aten.addmm.default] == \
        CheckpointPolicy.MUST_SAVE
    for f in (aten.bmm.default, aten.convolution.default, aten.add.Tensor):
        assert save[f] == CheckpointPolicy.PREFER_RECOMPUTE
