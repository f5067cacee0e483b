"""The port's collectives backends (kubeflow_tpu_torch/parallel/backends.py)
against the reference's parallel/backends.py: selection (explicit name,
then the caller's env, then the process env, then `single`; unknown
names, `tpu` among them, refused), the mesh-axes -> levels map, the rank
layout of a level-mapped mesh against the device ids of the reference's
mesh on the 8 virtual CPU devices, the loopback TCP barrier, and the
hierarchical reduce on 4 gloo ranks (dcn 2 x data 2): equal to the flat
sum, on its tiled path and on its untileable fallback. Integer-valued
floats make every sum exact, so the checks are bitwise.
"""

import json
import os
import threading
import types

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.parallel import backends as B
from kubeflow_tpu_torch.parallel import dist as D
from kubeflow_tpu_torch.parallel import mesh as M
from test_torch_dist import free_port, run_world


@pytest.fixture(autouse=True)
def clean_world(monkeypatch):
    monkeypatch.delenv(B.ENV_BACKEND, raising=False)
    monkeypatch.delenv(B.ENV_DCN_AXES, raising=False)
    yield
    D.shutdown()


# -- selection ---------------------------------------------------------------------


def test_default_is_single_and_a_singleton():
    bk = B.get_backend()
    assert isinstance(bk, B.SingleBackend) and bk.name == B.BACKEND_SINGLE
    assert B.get_backend() is bk


@pytest.mark.parametrize("name,cls", [(B.BACKEND_SINGLE, B.SingleBackend),
                                      (B.BACKEND_LOOPBACK, B.LoopbackBackend),
                                      (B.BACKEND_GPU, B.GpuNodeBackend)])
def test_every_name_resolves(name, cls):
    assert isinstance(B.get_backend(name), cls)
    assert B.get_backend(name).name == name


def test_precedence(monkeypatch):
    monkeypatch.setenv(B.ENV_BACKEND, B.BACKEND_LOOPBACK)
    assert isinstance(B.get_backend(), B.LoopbackBackend)
    assert isinstance(B.get_backend(env={B.ENV_BACKEND: B.BACKEND_GPU}),
                      B.GpuNodeBackend)
    monkeypatch.setenv(B.ENV_BACKEND, B.BACKEND_GPU)
    assert isinstance(B.get_backend(
        B.BACKEND_SINGLE, env={B.ENV_BACKEND: B.BACKEND_LOOPBACK}),
        B.SingleBackend)


@pytest.mark.parametrize("name", ["nccl", "tpu", ""])
def test_unknown_backend_refused_like_the_reference(name):
    from kubeflow_tpu.parallel import backends as RB

    with pytest.raises(ValueError, match="unknown collectives backend") as e:
        B.get_backend(name or "none")
    assert "known: ['gpu', 'loopback', 'single']" in str(e.value)
    if name != "tpu":
        with pytest.raises(ValueError, match="unknown collectives backend"):
            RB.get_backend(name or "none")


# -- levels and layouts, against the reference ---------------------------------------


@pytest.mark.parametrize("env", [{}, {B.ENV_DCN_AXES: ""},
                                 {B.ENV_DCN_AXES: " pipe ,expert"},
                                 {B.ENV_DCN_AXES: "pipe, seq"}])
def test_level_map_and_dcn_axes_match_reference(env):
    from kubeflow_tpu.parallel import backends as RB

    assert B.dcn_axes_from_env(env) == RB.dcn_axes_from_env(env)
    assert B.get_backend().level_map(env) == RB.get_backend().level_map(env)
    assert (B.LEVEL_ICI, B.LEVEL_DCN) == (RB.LEVEL_ICI, RB.LEVEL_DCN)


# the specs and level maps of the reference's tests/test_backends.py:90-160
LAYOUTS = [
    ({"dcn": 2, "data": 4}, None),
    ({"data": 2, "pipe": 2, "model": 2}, {"pipe": "dcn"}),
    ({"dcn": 2, "data": 2, "pipe": 2}, {"pipe": "dcn"}),
    ({"data": 4, "pipe": 2}, {"pipe": "dcn"}),
    ({"dcn": 2, "data": 2, "model": 2}, None),
    ({"data": 2, "fsdp": 2, "model": 2}, {"fsdp": "dcn"}),
    ({"data": -1}, None),
    ({"dcn": 2, "fsdp": 2, "model": 2}, {"model": "dcn"}),
]


@pytest.mark.parametrize("spec,levels", LAYOUTS)
def test_rank_layout_matches_reference_device_ids(spec, levels, devices8):
    from kubeflow_tpu.parallel import backends as RB
    from kubeflow_tpu.parallel import mesh as RM

    want = RB.build_level_mesh(RM.MeshSpec(**spec), devices8, levels=levels)
    got = B.level_layout(M.MeshSpec(**spec), 8, levels)
    np.testing.assert_array_equal(
        got, np.vectorize(lambda d: d.id)(want.devices))
    assert got.shape == tuple(want.shape[a] for a in M.AXIS_NAMES)
    assert M.AXIS_NAMES == RM.AXIS_NAMES and M.BATCH_AXES == RM.BATCH_AXES


def test_single_process_mesh_and_refusals():
    m = B.get_backend().mesh({"data": -1}, "cpu")
    assert m.size == 1 and m.group(M.BATCH_AXES) is None
    assert M.mesh_summary(m) == "Mesh(single-device) on 1x cpu"
    assert M.local_batch_size(m, 8) == 8
    with pytest.raises(ValueError, match="needs 2 devices"):
        B.get_backend().mesh({"data": 2}, "cpu")
    for axis in ("seq", "expert", "pipe"):    # ported: they lay out
        assert M.MeshSpec(**{axis: 2}).resolve(4).data == 2
        with pytest.raises(ValueError, match="not divisible"):
            M.MeshSpec(**{axis: 2}).resolve(3)
    assert M.MeshSpec.from_dict({"fsdp": 4, "model": 2}).model == 2
    assert M.pad_to_multiple(10, 4) == 12


def test_mesh_groups_are_the_rank_sets_of_an_axis():
    arr = M.rank_layout(M.MeshSpec(dcn=2, data=2, model=2), 8)
    m = M.Mesh.__new__(M.Mesh)      # the arithmetic alone, no world
    m.ranks, m.shape = arr, dict(zip(M.AXIS_NAMES, arr.shape))
    assert m.group_ranks(("model",)) == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert m.group_ranks(("dcn", "data")) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert m.group_ranks(M.BATCH_AXES) == [[0, 2, 4, 6], [1, 3, 5, 7]]


# -- the loopback barrier ---------------------------------------------------------------


def test_loopback_barrier_forms_a_three_rank_world(monkeypatch):
    """Rank 0 releases nobody until every peer checked in (a readiness
    probe is not a peer); leave() is idempotent."""
    monkeypatch.setenv(B.ENV_LOOPBACK_JOIN_TIMEOUT, "10")
    port = free_port()
    backends = [B.LoopbackBackend() for _ in range(3)]
    cfgs = [D.DistConfig(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=3, process_id=i) for i in range(3)]
    done, errors = {}, []

    def join(rank):
        try:
            backends[rank].barrier(cfgs[rank])
            done[rank] = True
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=join, args=(r,), daemon=True)
               for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=15)
    assert not errors, errors
    assert done == {0: True, 1: True, 2: True}
    for bk in backends:
        bk.leave()
        bk.leave()


def test_loopback_barrier_times_out_without_peers(monkeypatch):
    monkeypatch.setenv(B.ENV_LOOPBACK_JOIN_TIMEOUT, "0.6")
    cfg = D.DistConfig(coordinator_address=f"127.0.0.1:{free_port()}",
                       num_processes=2, process_id=0)
    with pytest.raises(TimeoutError, match="peers"):
        B.LoopbackBackend().join(cfg, device=torch.device("cpu"))
    assert not B.LoopbackBackend().join(
        D.DistConfig(None, 1, 0, num_slices=2), device=None)


@pytest.mark.parametrize("is_cuda", [False, True])
def test_loopback_tiles_only_what_gloo_can_scatter(is_cuda):
    """gloo reduce-scatters CPU tensors only: the loopback backend sums
    card tensors (ranks sharing a card) flat; the gpu backend (NCCL)
    tiles either."""
    x = types.SimpleNamespace(is_cuda=is_cuda)
    assert B.LoopbackBackend._can_scatter(x) is not is_cuda
    assert B.GpuNodeBackend._can_scatter(x) is True


# -- hierarchical reduce on 4 gloo ranks ------------------------------------------------


def reduce_worker(rank, n, out_dir):
    """A loopback world of 4 gloo ranks (barrier, then the group), a
    dcn 2 x data 2 mesh; every backend's reduce of rank-dependent
    integer tensors against the flat sum."""
    import torch.distributed as dist

    lb = B.get_backend(B.BACKEND_LOOPBACK)
    mesh = lb.form(spec={"dcn": 2, "data": 2}, device="cpu")
    assert D.active_backend() is lb and mesh.size == n
    assert mesh.coords[M.AXIS_DCN] == rank // 2
    out = {}
    for tag, shape in (("tiled", (4, 3)), ("fallback", (3, 5)),
                       ("scalar", ())):
        x = torch.arange(float(np.prod(shape) or 1)).reshape(shape) * \
            (rank + 1)
        flat = x.clone()
        dist.all_reduce(flat)
        for name in (B.BACKEND_GPU, B.BACKEND_LOOPBACK, B.BACKEND_SINGLE):
            got = B.get_backend(name).hierarchical_reduce(
                {"g": [x.clone()]}, mesh=mesh)["g"][0]
            out[f"{tag}/{name}"] = bool(torch.equal(got, flat))
    # the fast level alone: the data pairs (0,1) and (2,3)
    y = torch.full((2,), float(rank))
    B.get_backend(B.BACKEND_GPU).hierarchical_reduce(
        y, axis=M.AXIS_DATA, ici_axes=(), mesh=mesh)
    out["data_only"] = y.tolist()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    lb.teardown()
    assert not dist.is_initialized() and D.active_world() is None


def test_hierarchical_reduce_equals_flat_sum_on_four_ranks(tmp_path):
    run_world(4, "test_torch_backends:reduce_worker", tmp_path,
              env={B.ENV_LOOPBACK_JOIN_TIMEOUT: "60"}, timeout=180)
    for r in range(4):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert got.pop("data_only") == [float(2 * (r // 2) + 0 + 2 * (r // 2)
                                              + 1)] * 2
        assert all(got.values()), got
