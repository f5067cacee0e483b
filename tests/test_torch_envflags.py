"""The port's boolean env knobs against the JAX package's.

Every knob of `kubeflow_tpu/control/` reads
``os.environ.get(name, default).lower() == "true"``; the port reads them
through `kubeflow_tpu_torch/utils/envflags.py` `env_flag`, because its
control plane lower-cases no string itself
(tests/test_torch_control_scheduler.py
`test_single_spelling_of_the_pool_key`). Each knob is read by both
packages under the same environment, for each value below and unset,
and the answers must be equal:
- ENABLE_CULLING: `culler.enabled`;
- USE_ISTIO: the notebook controller's `use_istio`;
- ADD_FSGROUP: the pod template's securityContext that the notebook
  reconciler's `generate_statefulset` writes;
- ENABLE_LEADER_ELECTION: `run_controller`'s `--enable-leader-election`
  on an empty argv (read through its `extra_args` hook, which stops the
  main before it connects anywhere);
- USE_ISTIO: whether the Tensorboard reconciler makes a VirtualService.
"""

import pytest

from kubeflow_tpu.control import mains as RM
from kubeflow_tpu.control.k8s.fake import FakeCluster as RCluster
from kubeflow_tpu.control.notebook import controller as RNC
from kubeflow_tpu.control.notebook import culler as RCull
from kubeflow_tpu.control.notebook import types as RNT
from kubeflow_tpu.control.runtime import seed_controller as r_seed
from kubeflow_tpu.control.tensorboard import controller as RTB
from kubeflow_tpu_torch.control import mains as PM
from kubeflow_tpu_torch.control.k8s.fake import FakeCluster as PCluster
from kubeflow_tpu_torch.control.notebook import controller as PNC
from kubeflow_tpu_torch.control.notebook import culler as PCull
from kubeflow_tpu_torch.control.notebook import types as PNT
from kubeflow_tpu_torch.control.runtime import seed_controller as p_seed
from kubeflow_tpu_torch.control.tensorboard import controller as PTB
from kubeflow_tpu_torch.utils.envflags import env_flag

VALUES = ("true", "TRUE", "tRuE", "false", "yes", "", None)   # None: unset


def _set(monkeypatch, name: str, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)


class _Parsed(Exception):
    pass


def _leader_election(run_controller, **kw) -> bool:
    """run_controller's parsed --enable-leader-election on an empty argv:
    its extra_args hook parses the parser it is handed and stops the
    main there, before any client, signal handler or thread."""
    def hook(p):
        raise _Parsed(p.parse_args([]).enable_leader_election)

    with pytest.raises(_Parsed) as got:
        run_controller("knob", lambda client, args: None, extra_args=hook,
                       **kw)
    return got.value.args[0]


def _fsgroup(controller, types, side: str):
    if side == "jax":
        nb = types.new_notebook("nb", "default", tpu_chips=1)
    else:
        nb = types.new_notebook("nb", "default", gpus=1)
    sts = controller.NotebookReconciler().generate_statefulset(nb)
    return sts["spec"]["template"]["spec"].get("securityContext")


def _tensorboard_vs(controller, cluster_cls, seed) -> list[str]:
    cluster = cluster_cls()
    ctl = seed(controller.build_controller(cluster))
    cluster.create(controller.new_tensorboard("tb", logspath="gs://b/r"))
    ctl.run_until_idle(advance_delayed=True)
    return [o["metadata"]["name"] for o in cluster.list(
        "networking.istio.io/v1alpha3", "VirtualService", namespace="default")]


@pytest.mark.parametrize("value", VALUES)
def test_enable_culling(monkeypatch, value):
    _set(monkeypatch, "ENABLE_CULLING", value)
    assert PCull.enabled() == RCull.enabled()


@pytest.mark.parametrize("value", VALUES)
def test_notebook_use_istio(monkeypatch, value):
    _set(monkeypatch, "USE_ISTIO", value)
    assert PNC.use_istio() == RNC.use_istio()


@pytest.mark.parametrize("value", VALUES)
def test_notebook_add_fsgroup(monkeypatch, value):
    _set(monkeypatch, "ADD_FSGROUP", value)
    assert _fsgroup(PNC, PNT, "port") == _fsgroup(RNC, RNT, "jax")


@pytest.mark.parametrize("value", VALUES)
def test_controller_leader_election_default(monkeypatch, value):
    _set(monkeypatch, "ENABLE_LEADER_ELECTION", value)
    monkeypatch.setattr("sys.argv", ["knob"])
    assert _leader_election(PM.run_controller, argv=[]) == \
        _leader_election(RM.run_controller)


@pytest.mark.parametrize("value", VALUES)
def test_tensorboard_virtual_service(monkeypatch, value):
    _set(monkeypatch, "USE_ISTIO", value)
    assert _tensorboard_vs(PTB, PCluster, p_seed) == \
        _tensorboard_vs(RTB, RCluster, r_seed)


def test_the_reported_input_and_the_helper(monkeypatch):
    """The smallest diverging input before the repair: ENABLE_CULLING=tRUE
    reads True in both packages now; env_flag's default is read the same
    way when the knob is unset."""
    monkeypatch.setenv("ENABLE_CULLING", "tRUE")
    assert RCull.enabled() is True and PCull.enabled() is True
    monkeypatch.delenv("KFTPU_SOME_KNOB", raising=False)
    assert env_flag("KFTPU_SOME_KNOB", "True") is True
    assert env_flag("KFTPU_SOME_KNOB") is False
    assert not hasattr(PCull, "TRUE")
