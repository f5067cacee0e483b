"""The pool key of a GPU gang — ONE spelling for the package.

Port of `kubeflow_tpu/control/scheduler/topology.py`. There a gang's
slice stays in one (accelerator, topology) pool, and ``"2x4"`` names
the slice's chip grid, which the workers must tile. A GPU node pool
has no shape to tile: its nodes share one fabric, and the gang's slice
stays in one (product, node pool) pool, the node pool named by GKE's
``cloud.google.com/gke-nodepool`` label. What this module keeps is the
single-spelling rule: node labels, pod selectors and the scheduler's
buckets match exactly, so a pool name reaches each of them through
``normalize_pool`` alone ("Pool-A " and "pool-a" are one pool), and
tests/test_torch_control_scheduler.py AST-pins that no other module of
the port's control plane normalises it itself.
"""

from __future__ import annotations


def normalize_pool(name: str) -> str:
    """A node-pool name in its one spelling: stripped, lower case (GKE
    node-pool names are lower case). Raises ValueError on an empty
    name, which can never match a node label."""
    pool = (name or "").strip().lower()
    if not pool:
        raise ValueError(f"node pool {name!r} is empty")
    return pool
