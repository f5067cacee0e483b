"""YAML loading shim (the port's own copy of kubeflow_tpu/utils/yaml_lite.py):
PyYAML's safe loader behind one module."""

from __future__ import annotations

from typing import Any

import yaml


def loads(text: str) -> Any:
    return yaml.safe_load(text)


def load(path: str) -> Any:
    with open(path) as f:
        return yaml.safe_load(f)


def dumps(obj: Any) -> str:
    return yaml.safe_dump(obj, sort_keys=False)


def dump_all(docs: list[Any]) -> str:
    """Documents as one multi-document YAML stream (`tpctl generate`)."""
    return yaml.safe_dump_all(docs, sort_keys=False)
