"""TpuDef, the declarative deployment config (the KfDef analogue).

Port of `kubeflow_tpu/tpctl/tpudef.py`. The reference treats a KfDef
YAML as the single source of truth for a deployment (written and loaded
kfctlServer.go:108-133, versioned v1alpha1/v1beta1); status conditions
appended at :320-327 make re-apply idempotent (tested by
testing/kfctl/kfctl_second_apply.py). The port keeps the kind, its
group and that contract; its platform describes a GKE GPU node pool
where the JAX package's describes a TPU slice:

- ``platform.kind``: ``existing`` or ``gke-gpu`` (the JAX package's
  ``gke-tpu``);
- ``platform.accelerator``: GKE's GPU product label, e.g.
  ``nvidia-h100-80gb`` (the value of ``cloud.google.com/gke-accelerator``
  that the port's scheduler matches, `control/jaxjob/types.py`
  NODESELECTOR_ACCEL), for the TPU accelerator type;
- ``platform.gpus``: the pool's GPU count (`pool_gpus()`), for the TPU
  topology and its chip count (`slice_chips()`).

YAML goes through the port's `utils/yaml_lite`.
"""

from __future__ import annotations

import dataclasses

from kubeflow_tpu_torch.control.k8s import objects as ob
from kubeflow_tpu_torch.utils import yaml_lite

API_VERSION = "tpctl.kubeflow.org/v1alpha1"
KIND = "TpuDef"

COND_AVAILABLE = "TpuDefAvailable"   # KfAvailable analogue
COND_DEGRADED = "TpuDefDegraded"     # KfDegraded analogue

DEFAULT_PRODUCT = "nvidia-h100-80gb"
DEFAULT_GPUS = 8                     # one a3-highgpu-8g node
IMAGE_PREFIX = "kubeflow-tpu-torch"

# component names known to the manifest renderer; the `applications` list
# in a TpuDef selects a subset (default: all)
ALL_COMPONENTS = (
    "crds",
    "namespace",
    "rbac",
    "jaxjob-controller",
    "gang-scheduler",
    "jaxservice-controller",
    "notebook-controller",
    "profile-controller",
    "tensorboard-controller",
    "poddefault-webhook",
    "kfam",
    "gatekeeper",
    "centraldashboard",
    "jupyter-web-app",
    "tensorboards-web-app",
    "serving",
    "metric-collector",
)


@dataclasses.dataclass
class TpuDef:
    name: str = "kubeflow-tpu"
    namespace: str = "kubeflow"
    platform: str = "existing"          # existing | gke-gpu
    project: str = ""                   # gcp project (gke-gpu)
    zone: str = ""
    accelerator: str = DEFAULT_PRODUCT  # GKE's GPU product label
    gpus: int = DEFAULT_GPUS            # the node pool's GPU count
    applications: tuple[str, ...] = ALL_COMPONENTS
    image_prefix: str = IMAGE_PREFIX
    use_istio: bool = True
    # HA control plane: 2 replicas per controller + leader election
    ha_controllers: bool = False
    overlays: list[dict] = dataclasses.field(default_factory=list)
    raw: dict = dataclasses.field(default_factory=dict, repr=False)

    def pool_gpus(self) -> int:
        """The node pool's GPU count (the JAX package's `slice_chips`):
        a positive integer, else ValueError."""
        if isinstance(self.gpus, bool) or not isinstance(self.gpus, int) \
                or self.gpus < 1:
            raise ValueError(f"platform.gpus must be a positive integer, "
                             f"got {self.gpus!r}")
        return self.gpus

    @classmethod
    def from_dict(cls, d: dict) -> "TpuDef":
        meta = d.get("metadata") or {}
        spec = d.get("spec") or {}
        apps = spec.get("applications")
        if apps is not None:
            names = [a if isinstance(a, str) else a.get("name") for a in apps]
            unknown = sorted(set(names) - set(ALL_COMPONENTS))
            if unknown:
                raise ValueError(f"unknown applications {unknown}; "
                                 f"valid: {sorted(ALL_COMPONENTS)}")
            apps = tuple(names)
        plat = spec.get("platform") or {}
        return cls(
            name=meta.get("name", "kubeflow-tpu"),
            namespace=spec.get("namespace", "kubeflow"),
            platform=plat.get("kind", "existing"),
            project=plat.get("project", ""),
            zone=plat.get("zone", ""),
            accelerator=plat.get("accelerator", DEFAULT_PRODUCT),
            gpus=plat.get("gpus", DEFAULT_GPUS),
            applications=apps or ALL_COMPONENTS,
            image_prefix=spec.get("imagePrefix", IMAGE_PREFIX),
            use_istio=bool(spec.get("useIstio", True)),
            ha_controllers=bool(spec.get("haControllers", False)),
            overlays=list(spec.get("overlays") or []),
            raw=d,
        )

    @classmethod
    def load(cls, path_or_stream) -> "TpuDef":
        if hasattr(path_or_stream, "read"):
            d = yaml_lite.loads(path_or_stream.read())
        else:
            d = yaml_lite.load(path_or_stream)
        if not isinstance(d, dict):
            raise ValueError("TpuDef YAML must be a mapping")
        if d.get("kind") not in (KIND, None):
            raise ValueError(f"expected kind {KIND}, got {d.get('kind')!r}")
        return cls.from_dict(d)

    def to_object(self) -> dict:
        """The cluster-stored form (status conditions live here)."""
        obj = ob.new_object(API_VERSION, KIND, self.name)
        obj["spec"] = {
            "namespace": self.namespace,
            "platform": {
                "kind": self.platform,
                "project": self.project,
                "zone": self.zone,
                "accelerator": self.accelerator,
                "gpus": self.gpus,
            },
            "applications": list(self.applications),
            "imagePrefix": self.image_prefix,
            "useIstio": self.use_istio,
            "haControllers": self.ha_controllers,
            "overlays": self.overlays,
        }
        return obj

    def dump(self) -> str:
        return yaml_lite.dumps(self.to_object())


def example_yaml() -> str:
    return """\
apiVersion: tpctl.kubeflow.org/v1alpha1
kind: TpuDef
metadata:
  name: kubeflow-tpu
spec:
  namespace: kubeflow
  platform:
    kind: existing          # or gke-gpu (provisions a GPU node pool via gcloud)
    # project: my-project   # gke-gpu only
    # zone: us-central1-a
    accelerator: nvidia-h100-80gb   # GKE's GPU product label
    gpus: 8                 # the node pool's GPUs (8 a node on a3-highgpu-8g)
  useIstio: true
  # applications: [crds, namespace, jaxjob-controller]   # default: all
  # overlays:               # kustomize-style strategic patches
  # - target: {kind: Deployment, name: jaxjob-controller}
  #   patch: {spec: {replicas: 2}}
"""
