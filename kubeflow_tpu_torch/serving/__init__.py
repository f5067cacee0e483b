"""LM serving on one GPU (port of kubeflow_tpu/serving): the TF-Serving
REST server, the continuous slot decoder (dense, paged, rolling and
speculative), weight-only quantization and the token router in front of
replicas. `python -m kubeflow_tpu_torch.serving --lm name=gpt-350m ...`
starts a server; `python -m kubeflow_tpu_torch.serving.router
--endpoints ...` a router."""
