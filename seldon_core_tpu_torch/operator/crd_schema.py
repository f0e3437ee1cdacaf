"""CRD structural validation schema for SeldonDeployment (port of
``seldon_core_tpu/operator/crd_schema.py``).

The apiserver rejects a malformed resource before the operator sees it.
The schema is generated from the enums of ``graph/spec.py``, the parser's
own tables, so the two never disagree; apiextensions v1 structural schemas
cannot recurse, so the graph nests :data:`GRAPH_DEPTH` levels and leaves
deeper levels open via ``x-kubernetes-preserve-unknown-fields``.
"""

from __future__ import annotations

from seldon_core_tpu_torch.graph.spec import (
    BUILTIN_IMPLEMENTATIONS,
    PARAM_TYPES,
    UNIT_TYPES,
)

GRAPH_DEPTH = 6  # deepest validated nesting of PredictiveUnit children

_TYPES = list(UNIT_TYPES)
_IMPLS = list(BUILTIN_IMPLEMENTATIONS)
_PARAM_TYPES = list(PARAM_TYPES)


def _parameter_schema() -> dict:
    return {
        "type": "object",
        "required": ["name"],
        "properties": {
            "name": {"type": "string"},
            "value": {"type": "string"},
            "type": {"type": "string", "enum": _PARAM_TYPES},
        },
    }


def _endpoint_schema() -> dict:
    return {
        "type": "object",
        "properties": {
            # both naming styles the parser accepts: a structural schema
            # prunes unlisted fields
            "service_host": {"type": "string"},
            "service_port": {"type": "integer"},
            "serviceHost": {"type": "string"},
            "servicePort": {"type": "integer"},
            "type": {"type": "string", "enum": ["REST", "GRPC", "LOCAL"]},
        },
    }


def _unit_schema(depth: int) -> dict:
    schema: dict = {
        "type": "object",
        "required": ["name"],
        "properties": {
            "name": {"type": "string"},
            "type": {"type": "string", "enum": _TYPES},
            "implementation": {"type": "string", "enum": _IMPLS},
            "methods": {"type": "array", "items": {"type": "string"}},
            "endpoint": _endpoint_schema(),
            "parameters": {"type": "array", "items": _parameter_schema()},
            # placement hint (graph/spec.py slice_group): listed, or the
            # apiserver prunes it
            "sliceGroup": {"type": "string"},
        },
    }
    if depth > 0:
        schema["properties"]["children"] = {
            "type": "array",
            "items": _unit_schema(depth - 1),
        }
    else:
        # beyond the validated depth: accept anything (validate_deployment
        # still checks the whole tree)
        schema["properties"]["children"] = {
            "type": "array",
            "items": {"type": "object",
                      "x-kubernetes-preserve-unknown-fields": True},
        }
    return schema


def validation_schema() -> dict:
    """openAPIV3Schema for the CRD version entry."""
    return {
        "type": "object",
        "properties": {
            "spec": {
                "type": "object",
                "required": ["predictors"],
                "properties": {
                    "name": {"type": "string"},
                    "oauth_key": {"type": "string"},
                    "oauth_secret": {"type": "string"},
                    "annotations": {
                        "type": "object",
                        "additionalProperties": {"type": "string"},
                    },
                    "predictors": {
                        "type": "array",
                        "minItems": 1,
                        "items": {
                            "type": "object",
                            "required": ["name", "graph"],
                            "properties": {
                                "name": {"type": "string"},
                                "replicas": {"type": "integer", "minimum": 0},
                                "traffic": {"type": "integer", "minimum": 0},
                                "graph": _unit_schema(GRAPH_DEPTH),
                                "annotations": {
                                    "type": "object",
                                    "additionalProperties": {"type": "string"},
                                },
                                "labels": {
                                    "type": "object",
                                    "additionalProperties": {"type": "string"},
                                },
                                "componentSpecs": {
                                    "type": "array",
                                    "items": {
                                        "type": "object",
                                        "x-kubernetes-preserve-unknown-fields":
                                            True,
                                    },
                                },
                            },
                        },
                    },
                },
            },
            "status": {
                "type": "object",
                "x-kubernetes-preserve-unknown-fields": True,
            },
        },
    }
