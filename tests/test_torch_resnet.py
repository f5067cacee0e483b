"""The port's ResNet (kubeflow_tpu_torch/models/resnet.py) against the JAX
package's on the same numpy inputs and the same weights (flax params and
batch_stats through `convert.py`), in f32 on the CPU.

Tolerances: logits 1e-4; batch_stats after a train-mode forward 1e-5
relative to each vector's largest value. The two frameworks sum in
another order (~1e-6 relative); flax computes the batch variance as
E[x^2] - E[x]^2 and torch by a two-pass sum, which differ by a few f32
roundings of the variance.

Each trap of the port has a case that fails without its fix: flax's
asymmetric "SAME" pads (odd and even sizes, both stems), the (dy, dx, c)
order of space_to_depth, flax's BatchNorm momentum and biased running
variance, the zero-init last norm of each block, HWIO kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from kubeflow_tpu.models import resnet as jresnet
from kubeflow_tpu.models.registry import get_model as jax_model
from kubeflow_tpu_torch import convert
from kubeflow_tpu_torch.models import resnet
from kubeflow_tpu_torch.models.registry import get_model, list_models

LOGIT_TOL = 1e-4
STATS_TOL = 1e-5
FILTERS = 8


def _pair(name, stem, size, batch=4, seed=0, classes=10, channels=3):
    """The flax model's variables on a seeded input, and the port model
    loaded with them."""
    x = np.random.default_rng(seed).standard_normal(
        (batch, size, size, channels)).astype(np.float32)
    jm = jax_model(name, num_filters=FILTERS, num_classes=classes,
                   dtype=jnp.float32, stem=stem)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(seed), x,
                                       train=True))
    # move the norms off their init (unit scale, zero bias, zero mean,
    # unit variance) so that eval mode and the zero-init scales matter
    rng = np.random.default_rng(seed + 1)
    bump = lambda t: jax.tree.map(  # noqa: E731
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(
            np.float32), t)
    params = _bump_norms(variables["params"], rng)
    stats = {k: {n: (np.abs(v) + 0.5 if n == "var" else v)
                 for n, v in bump(s).items()}
             for k, s in _norms(variables["batch_stats"]).items()}
    variables = {"params": params,
                 "batch_stats": _unflatten(stats)}
    tm = get_model(name, device="cpu", num_filters=FILTERS,
                   num_classes=classes, dtype="float32", stem=stem,
                   in_channels=channels)
    tm.load_state_dict({**convert.flax_to_state_dict(variables["params"]),
                        **convert.flax_to_state_dict(
                            variables["batch_stats"])}, strict=True)
    return jm, variables, tm, x


def _bump_norms(tree, rng):
    """The params tree with every norm scale and bias moved by noise."""
    return {k: (_bump_norms(v, rng) if isinstance(v, dict) else
                (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
                if k in ("scale", "bias") and np.ndim(v) == 1 else v)
            for k, v in tree.items()}


def _norms(tree, prefix=""):
    """{path of a BatchNorm: its {mean, var}}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if set(v) == {"mean", "var"}:
            out[path] = dict(v)
        else:
            out.update(_norms(v, path))
    return out


def _unflatten(flat):
    tree = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


CASES = [("resnet18", "conv7", 32), ("resnet18", "conv7", 33),
         ("resnet18", "space_to_depth", 34),
         ("resnet50", "conv7", 35), ("resnet50", "space_to_depth", 32),
         ("resnet50", "space_to_depth", 38)]


@pytest.mark.parametrize("name,stem,size", CASES,
                         ids=[f"{n}-{s}-{z}" for n, s, z in CASES])
def test_train_mode_logits_and_batch_stats(name, stem, size):
    jm, variables, tm, x = _pair(name, stem, size)
    want, new = jm.apply(variables, x, train=True, mutable=["batch_stats"])
    tm.train()
    got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    stats = convert.flax_to_state_dict(jax.device_get(new["batch_stats"]))
    sd = tm.state_dict()
    assert set(stats) == {n for n, _ in tm.named_buffers()}
    for n, w in stats.items():
        np.testing.assert_allclose(sd[n].numpy(), w.numpy(), rtol=0,
                                   atol=STATS_TOL * float(w.abs().max()),
                                   err_msg=n)


@pytest.mark.parametrize("name,stem,size", CASES[:4],
                         ids=[f"{n}-{s}-{z}" for n, s, z in CASES[:4]])
def test_eval_mode_uses_the_running_statistics(name, stem, size):
    jm, variables, tm, x = _pair(name, stem, size, seed=3)
    want = jm.apply(variables, x, train=False)
    tm.eval()
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # eval moves no statistic, and differs from train mode
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    tm.train()
    with torch.no_grad():
        train = tm(torch.from_numpy(x))
    assert not np.allclose(train.numpy(), got.numpy(), atol=1e-2)


def test_one_channel_input_as_the_server_sends():
    jm, variables, tm, x = _pair("resnet18", "conv7", 28, batch=2,
                                 channels=1)
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jm.apply(variables, x,
                                                   train=False)),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2),
                                      (4, 1), (7, 2)])
def test_same_pads_are_lax_pads(k, stride):
    for size in range(1, 70):
        want = lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0]
        assert resnet.same_pads(size, k, stride) == tuple(want), size


def test_strided_pads_are_asymmetric():
    # the cases torch's padding=1 (or 3 for the 7x7) would shift
    assert resnet.same_pads(56, 3, 2) == (0, 1)
    assert resnet.same_pads(112, 3, 2) == (0, 1)       # the stem's pool
    assert resnet.same_pads(112, 4, 1) == (1, 2)       # space_to_depth
    assert resnet.same_pads(224, 7, 2) == (2, 3)


def test_space_to_depth_channel_order():
    x = np.random.default_rng(0).standard_normal((2, 8, 6, 3)).astype(
        np.float32)
    want = np.asarray(jresnet.space_to_depth(jnp.asarray(x), 2))
    got = resnet.space_to_depth(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, want)
    # not pixel_unshuffle's (c, dy, dx) order
    unshuffled = torch.nn.functional.pixel_unshuffle(
        torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    assert not np.array_equal(unshuffled.numpy(), want)


def test_batchnorm_update_is_flax_s():
    """momentum 0.9 on the mean and on the BIASED variance, at a batch
    small enough that the unbiased one would differ by n / (n - 1)."""
    import flax.linen as fnn

    x = np.random.default_rng(0).standard_normal((2, 3, 2, 5)).astype(
        np.float32) * 3 + 1
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), x)
    y, new = bn.apply(v, x, mutable=["batch_stats"])
    m = resnet.BatchNorm(5, torch.float32, "cpu")
    got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.mean.numpy(),
                               np.asarray(new["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(m.var.numpy(),
                               np.asarray(new["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)


def test_zero_init_last_norm_and_layouts():
    tm = get_model("resnet50", device="cpu", num_filters=FILTERS,
                   stem="space_to_depth")
    assert tm.block_names == [f"BottleneckBlock_{i}" for i in range(16)]
    for name in tm.block_names:
        blk = getattr(tm, name)
        assert float(blk.BatchNorm_2.scale.detach().abs().max()) == 0.0
        assert float(blk.BatchNorm_0.scale.detach().min()) == 1.0
    assert tm.conv_init.weight.shape == (FILTERS, 12, 4, 4)
    assert tm.conv_init.weight.is_contiguous(
        memory_format=torch.channels_last)
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    assert {b.dtype for b in tm.buffers()} == {torch.float32}
    x = torch.zeros(2, 32, 32, 3)
    assert tm(x).dtype == torch.float32           # the f32 head
    # flax's init tree, name for name and shape for shape
    jm = jax_model("resnet50", num_filters=FILTERS, stem="space_to_depth")
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 32, 32, 3)),
                                       train=True))
    params = {n: p for n, p in tm.named_parameters()}
    flat = {convert.flax_name(n): convert.flax_shape(n, p.shape, None)
            for n, p in params.items()}
    want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(a.shape)
            for path, a in jax.tree_util.tree_flatten_with_path(
                v["params"])[0]}
    assert flat == want
    buffers = {convert.flax_name(n): tuple(b.shape)
               for n, b in tm.named_buffers()}
    want_stats = {"/".join(str(getattr(k, "key", k)) for k in path):
                  tuple(a.shape) for path, a in
                  jax.tree_util.tree_flatten_with_path(
                      v["batch_stats"])[0]}
    assert buffers == want_stats


@pytest.mark.parametrize("name", ["resnet18", "resnet50", "resnet101"])
@pytest.mark.parametrize("stem,size", [("conv7", 224), ("space_to_depth",
                                                        224),
                                       ("conv7", 97)])
def test_fwd_flops_is_the_reference_count(name, stem, size):
    assert resnet.fwd_flops(name, size, 1000, 64, stem) == \
        jresnet.fwd_flops(name, size, 1000, 64, stem)


def test_registry_names_and_weights_from_the_seed():
    names = list_models()
    for n in ("resnet18", "resnet50", "resnet101"):
        assert n in names
    a = get_model("resnet18", device="cpu", num_filters=FILTERS, seed=3)
    b = get_model("resnet18", device="cpu", num_filters=FILTERS, seed=3)
    c = get_model("resnet18", device="cpu", num_filters=FILTERS, seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["conv_init.weight"], sc["conv_init.weight"])
    # lecun-normal, truncated at 2 std
    w = sa["ResNetBlock_3.Conv_0.weight"]
    std = (1.0 / (w.shape[1] * 9)) ** 0.5 / .87962566103423978
    assert float(w.abs().max()) <= 2 * std + 1e-6
    with pytest.raises(ValueError, match="unknown stem"):
        get_model("resnet18", device="cpu", stem="conv3")
    with pytest.raises(ValueError, match="unknown resnet kwargs"):
        get_model("resnet18", device="cpu", filters=8)
