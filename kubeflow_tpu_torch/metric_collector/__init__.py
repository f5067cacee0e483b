"""Platform availability prober (port of `kubeflow_tpu/metric_collector/`;
reference: metric-collector/)."""

from kubeflow_tpu_torch.metric_collector.prober import AvailabilityProber  # noqa: F401
