"""Machine-readable API spec for the tpctl REST plane.

Port of `kubeflow_tpu/tpctl/apispec.py`: the same document, its platform
schema the port's GPU pool (accelerator: GKE's GPU product, gpus: the
pool's GPU count) where the JAX package's holds a TPU topology.

The reference ships a swagger file for its deployment API
(bootstrap/api/swagger.yaml:1-30, basePath /kfctl/v1); the tpctl plane's
contract was previously only in code + docs/platform.md. This module is
the single source of truth: the spec is generated (so schema constants
like valid platforms stay in sync with TpuDef), served by the server at
GET /tpctl/apps/v1/openapi.json, and a test asserts every route the
server registers is documented.
"""

from __future__ import annotations

from kubeflow_tpu_torch.tpctl.tpudef import ALL_COMPONENTS, TpuDef

TITLE = "Kubeflow TPU Deployment API (GPU port)"
VERSION = "1.0.0"
BASE = "/tpctl/apps/v1"


def _tpudef_schema() -> dict:
    from kubeflow_tpu_torch.tpctl.apply import PROVIDERS

    defaults = TpuDef()
    return {
        "type": "object",
        "description": "Declarative deployment config (the KfDef analogue).",
        "properties": {
            "apiVersion": {"type": "string", "example": "tpctl.kubeflow.org/v1"},
            "kind": {"type": "string", "example": "TpuDef"},
            "metadata": {
                "type": "object",
                "properties": {"name": {"type": "string",
                                        "default": defaults.name}},
            },
            "spec": {
                "type": "object",
                "properties": {
                    "namespace": {"type": "string", "default": defaults.namespace},
                    "platform": {
                        "type": "object",
                        "properties": {
                            "kind": {"type": "string",
                                     "enum": sorted(PROVIDERS),
                                     "default": defaults.platform},
                            "project": {"type": "string"},
                            "zone": {"type": "string"},
                            "accelerator": {"type": "string",
                                            "description": "GKE's GPU "
                                            "product label",
                                            "default": defaults.accelerator},
                            "gpus": {"type": "integer", "minimum": 1,
                                     "description": "the node pool's GPUs",
                                     "default": defaults.gpus},
                        },
                    },
                    "applications": {
                        "type": "array",
                        "items": {"type": "string", "enum": sorted(ALL_COMPONENTS)},
                    },
                    "imagePrefix": {"type": "string",
                                    "default": defaults.image_prefix},
                    "useIstio": {"type": "boolean", "default": defaults.use_istio},
                    "overlays": {"type": "array", "items": {"type": "object"}},
                },
            },
        },
    }


def _condition_schema() -> dict:
    return {
        "type": "object",
        "description": "KfAvailable/KfDegraded-style status condition "
                       "(kfctlServer.go:320-327 analogue).",
        "properties": {
            "type": {"type": "string", "enum": ["Available", "Degraded"]},
            "status": {"type": "string", "enum": ["True", "False", "Unknown"]},
            "reason": {"type": "string"},
            "message": {"type": "string"},
            "lastTransitionTime": {"type": "string", "format": "date-time"},
        },
    }


def openapi() -> dict:
    """The OpenAPI 3.0 document for the tpctl REST plane."""
    err = {"description": "error",
           "content": {"application/json": {"schema": {
               "type": "object",
               "properties": {"error": {"type": "string"}}}}}}
    status_resp = {
        "type": "object",
        "properties": {
            "name": {"type": "string"},
            "conditions": {"type": "array", "items": _condition_schema()},
            "error": {"type": "string", "nullable": True},
        },
    }
    get_op = {
        "tags": ["deployment"],
        "summary": "Poll deployment status (kfctlServer.go:373-384 analogue)",
        "operationId": "getDeployment",
        "responses": {
            "200": {"description": "deployment status",
                    "content": {"application/json": {"schema": status_resp}}},
            "400": err, "404": err,
        },
    }
    return {
        "openapi": "3.0.3",
        "info": {
            "title": TITLE,
            "version": VERSION,
            "description": "Deployment API for the Kubeflow build on "
                           "GPU clusters (reference contract: bootstrap/"
                           "api/swagger.yaml, /kfctl/v1).",
            "license": {"name": "Apache 2.0",
                        "url": "http://www.apache.org/licenses/LICENSE-2.0.html"},
        },
        "servers": [{"url": "/"}],
        "tags": [{"name": "deployment",
                  "description": "A Kubeflow deployment on a GPU cluster"}],
        "paths": {
            f"{BASE}/create": {
                "post": {
                    "tags": ["deployment"],
                    "summary": "Create or re-apply a deployment",
                    "operationId": "createDeployment",
                    "requestBody": {
                        "required": True,
                        "content": {"application/json": {
                            "schema": {"$ref": "#/components/schemas/TpuDef"}}},
                    },
                    "responses": {
                        "200": {"description": "enqueued",
                                "content": {"application/json": {"schema": {
                                    "type": "object",
                                    "properties": {
                                        "name": {"type": "string"},
                                        "status": {"type": "string",
                                                   "enum": ["enqueued"]},
                                    }}}}},
                        "400": err,
                        "409": {**err, "description":
                                "name exists with a different spec "
                                "(isMatch guard, kfctlServer.go:531)"},
                    },
                }
            },
            f"{BASE}/get": {
                "post": {**get_op,
                         "requestBody": {"required": True, "content": {
                             "application/json": {"schema": {
                                 "type": "object",
                                 "required": ["name"],
                                 "properties": {"name": {"type": "string"}}}}}}},
                "get": {**get_op, "operationId": "getDeploymentByQuery",
                        "parameters": [{"name": "name", "in": "query",
                                        "required": True,
                                        "schema": {"type": "string"}}]},
            },
            f"{BASE}/openapi.json": {
                "get": {
                    "tags": ["deployment"],
                    "summary": "This document",
                    "operationId": "getOpenApi",
                    "responses": {"200": {"description": "OpenAPI 3.0 spec"}},
                }
            },
            "/healthz": {"get": {
                "summary": "liveness", "operationId": "healthz",
                "responses": {"200": {"description": "ok"}}}},
            "/readyz": {"get": {
                "summary": "readiness", "operationId": "readyz",
                "responses": {"200": {"description": "ok"}}}},
            "/metrics": {"get": {
                "summary": "Prometheus metrics", "operationId": "metrics",
                "responses": {"200": {"description": "text exposition"}}}},
        },
        "components": {"schemas": {
            "TpuDef": _tpudef_schema(),
            "Condition": _condition_schema(),
        }},
    }
