"""LM serving on one GPU (port of kubeflow_tpu/serving): the TF-Serving
REST server, the continuous slot decoder and weight-only quantization.
`python -m kubeflow_tpu_torch.serving --lm name=gpt-350m ...` starts it."""
