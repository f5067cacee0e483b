"""Model registry keyed by name (port of kubeflow_tpu/models/registry.py):
the same names, so a TrainConfig's `model` selects the same model."""

from __future__ import annotations

from typing import Any, Callable

_REGISTRY: dict[str, Callable[..., Any]] = {}


def register_model(name: str):
    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"model {name!r} already registered")
        _REGISTRY[name] = fn
        return fn

    return deco


def _load_zoo() -> None:
    """Import the builtin model modules (registration side effect)."""
    import kubeflow_tpu_torch.models.bert  # noqa: F401
    import kubeflow_tpu_torch.models.resnet  # noqa: F401
    import kubeflow_tpu_torch.models.transformer  # noqa: F401
    import kubeflow_tpu_torch.models.vit  # noqa: F401


def get_model(name: str, **kwargs) -> Any:
    """Build a model by registry name."""
    if name not in _REGISTRY:
        _load_zoo()
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def list_models() -> list[str]:
    _load_zoo()
    return sorted(_REGISTRY)
