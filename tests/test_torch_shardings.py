"""The port's parameter placement (kubeflow_tpu_torch/parallel/shardings.py)
against the reference's `partition_specs`: for transformer-test and
gpt-125m (abstract on both sides: `jax.eval_shape` of the flax init, the
port's model on the meta device), under fsdp 4 x model 2, under model 4
(transformer-test's 2 KV heads replicate) and under fsdp 2 alone, leaf by
leaf, matched through convert.py's names; and the plan that applies the
specs to the port's [out, in] weights.
"""

import types

import pytest

from kubeflow_tpu_torch.convert import flax_name
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.parallel import shardings as S

MESHES = {"fsdp4_model2": {"fsdp": 4, "model": 2},
          "model4": {"model": 4},
          "fsdp2": {"fsdp": 2}}


def _reference_specs(name: str, sizes: dict) -> dict:
    import jax
    import jax.numpy as jnp

    from kubeflow_tpu.models.registry import get_model as ref_model
    from kubeflow_tpu.parallel.shardings import partition_specs

    model = ref_model(name)
    abstract = jax.eval_shape(
        lambda r: model.init(r, jnp.zeros((1, 8), jnp.int32)),
        jax.random.PRNGKey(0))
    mesh = types.SimpleNamespace(shape={"dcn": 1, "data": 1, "fsdp": 1,
                                        "pipe": 1, "expert": 1, "seq": 1,
                                        "model": 1, **sizes})
    specs = partition_specs(abstract, mesh)["params"]
    out = {}
    for path, spec in jax.tree_util.tree_leaves_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)):
        key = "/".join(p.key for p in path)
        out[key] = tuple(spec)
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("model", ["transformer-test", "gpt-125m"])
def test_partition_specs_match_reference(model, mesh):
    sizes = MESHES[mesh]
    want = _reference_specs(model, sizes)
    port = get_model(model, device="meta")
    got = {flax_name(n): spec
           for n, spec in S.partition_specs(port, sizes).items()}
    assert set(got) == set(want)
    for k, spec in want.items():
        # a PartitionSpec may be shorter than the rank: trailing dims None
        full = spec + (None,) * (len(got[k]) - len(spec))
        assert got[k] == full, (k, got[k], spec)


def test_kv_heads_replicate_under_model4():
    port = get_model("transformer-test", device="meta")
    plan = S.shard_plan(port, {"model": 4})
    assert plan["layer_0.attn.q.weight"].port == [(0, "model")]
    assert plan["layer_0.attn.k.weight"].port == []
    assert plan["layer_0.attn.k.weight"].partial_model
    assert plan["layer_0.attn.o.weight"].port == [(1, "model")]
    # each rank's q head belongs to kv head rank // 2
    assert [S._kv_heads(4, 2, 4, r) for r in range(4)] == [[0], [0], [1], [1]]
    # 6 local q heads over 4-head groups split unevenly: one kv per q head
    assert S._kv_heads(12, 3, 2, 1) == [1, 1, 2, 2, 2, 2]
    assert S._kv_heads(8, 4, 2, 1) == [2, 3]


def test_plan_maps_flax_dims_to_port_dims():
    port = get_model("gpt-125m", device="meta")
    plan = S.shard_plan(port, {"fsdp": 4, "model": 2})
    # q: flax (d, H, D) <- port [H*D, d]: model on H*D, fsdp on d
    assert plan["layer_0.attn.q.weight"].port == [(0, "model"), (1, "fsdp")]
    assert plan["layer_0.attn.q.weight"].flax == [(1, "model"), (0, "fsdp")]
    # o: flax (H, D, d) <- port [d, H*D]
    assert plan["layer_0.attn.o.weight"].port == [(1, "model"), (0, "fsdp")]
    # down: flax (ff, d) <- port [d, ff]
    assert plan["layer_0.mlp.down.weight"].port == [(1, "model"), (0, "fsdp")]
    # the embedding's vocab dim splits over (model, fsdp), model major
    assert plan["embedding"].port == [(0, "model"), (0, "fsdp")]
    assert plan["lm_head.kernel"].port == [(1, "model"), (0, "fsdp")]
    assert plan["ln_f.scale"].port == []
    for sh in plan.values():
        assert not sh.partial_model      # 12 kv heads split over model 2


def test_fsdp_heuristic_matches_reference():
    from kubeflow_tpu.parallel.shardings import _fsdp_spec

    for shape in [(), (64,), (128, 128), (4096, 1000), (1000, 4096),
                  (3, 3, 64, 256), (7, 9), (2**14,), (2**14 + 1,)]:
        for n in (1, 2, 4, 3):
            want = tuple(_fsdp_spec(shape, n))
            want += (None,) * (len(shape) - len(want))
            assert S._fsdp_spec(shape, n) == want, (shape, n)
