"""`python -m kubeflow_tpu_torch.metric_collector`: the availability
prober's main (`prober.main`)."""

from kubeflow_tpu_torch.metric_collector.prober import main

if __name__ == "__main__":
    raise SystemExit(main())
