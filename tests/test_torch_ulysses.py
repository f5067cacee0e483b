"""The port's Ulysses attention (kubeflow_tpu_torch/ops/ulysses.py) in gloo
worlds of 2 and 4 CPU processes, against the JAX package's Ulysses on a
seq mesh of virtual CPU devices.

Op level, f32 (tests/test_torch_ring.py's inputs and cases): output and
the q/k/v gradients for causal, GQA (k/v repeated to the q heads before
the exchange), windowed, packed (segment ids all-gathered) and
bidirectional attention, at the reference's 2e-5; the reference's error
when the heads per rank do not divide over seq. Trainer level, the SPMD
witness protocol: transformer-test with Ulysses at seq 2, seq 4 and
model 2 x seq 2, each equal to one process (where Ulysses is the local
attention over the whole sequence).
"""

import numpy as np
import pytest
import torch

from test_torch_ring import (
    _assert_parity,
    _lm,
    assert_ops,
    inputs,
    jax_op_reference,
    lm_init,
    merged,
    single_runs,
    spawn,
    world_run,
)

LAYOUTS = {
    2: {"sp": _lm("ulysses", {"data": 1, "seq": 2})},
    4: {"sp4": _lm("ulysses", {"data": 1, "seq": 4}),
        "tp_sp": _lm("ulysses", {"data": 1, "model": 2, "seq": 2})},
}


def ulysses_worker(rank, n, out_dir):
    from kubeflow_tpu_torch.ops.ulysses import ulysses_attention

    world_run(rank, n, out_dir, ulysses_attention, LAYOUTS[n])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("ulysses")
    data = inputs(seed=1)
    np.savez(root / "inputs.npz", **data)
    return root, data, lm_init(root)


def _world(setup, n):
    return spawn(setup[0], n, "test_torch_ulysses:ulysses_worker",
                 ("inputs.npz", "init.pt"))


@pytest.fixture(scope="module")
def world2(setup):
    return _world(setup, 2)


@pytest.fixture(scope="module")
def world4(setup):
    return _world(setup, 4)


@pytest.fixture(scope="module")
def single(setup):
    return single_runs({**LAYOUTS[2], **LAYOUTS[4]}, setup[2])


@pytest.mark.parametrize("sp", [2, 4])
def test_ulysses_ops_equal_the_reference(sp, setup, world2, world4):
    got = world2 if sp == 2 else world4
    assert_ops(got, jax_op_reference("ulysses", sp, setup[1]))


@pytest.mark.parametrize("name", ["sp", "sp4", "tp_sp"])
def test_ulysses_layout_equals_one_process(name, world2, world4, single):
    outs = world2 if name in LAYOUTS[2] else world4
    got = [o[name] for o in outs]
    assert len({tuple(o["losses"]) for o in got}) == 1
    _assert_parity(name, merged(got), single[name])


def test_heads_that_do_not_divide_raise_the_reference_error():
    """3 q heads per rank over a seq group of 2: refused before any
    exchange, with the reference's message."""
    from kubeflow_tpu_torch.ops.ulysses import ulysses_attention
    from kubeflow_tpu_torch.parallel.mesh import AxisGroup

    q = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError, match="heads-per-device 3 divisible by "
                                         "seq-axis size 2"):
        ulysses_attention(q, q, q, seq=AxisGroup(None, 0, 2))


def test_ulysses_without_a_seq_group_is_the_local_dispatch(setup):
    from kubeflow_tpu_torch.ops.attention import attention
    from kubeflow_tpu_torch.ops.ulysses import ulysses_attention

    data = setup[1]
    q, k, v = (torch.tensor(data[key]) for key in ("q", "k2", "v2"))
    seg = torch.tensor(data["seg"])
    torch.testing.assert_close(
        ulysses_attention(q, k, v, segment_ids=seg, window=7),
        attention(q, k, v, segment_ids=seg, window=7), rtol=0, atol=0)
