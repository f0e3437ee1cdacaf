"""OpenAPI (OAS3) specs for the three HTTP surfaces (port of
``seldon_core_tpu/serving/openapi.py``, with the port's own version).

Reference: ``openapi/create_openapis.py`` + ``openapi/{apife,engine,
wrapper}.oas3.json`` (hand-maintained JSON, served at ``/seldon.json`` by
the wrappers).  Here the specs are generated from shared schema components
— and the reference's tests assert every route is documented, so the spec cannot
drift from the server (the reference had no such check).

Surfaces:
- :func:`gateway_spec`   — external API (apife parity: OAuth2 + predict/feedback)
- :func:`engine_spec`    — per-deployment engine (predictions/feedback + ops)
- :func:`component_spec` — internal microservice API (predict/route/…)
"""

from __future__ import annotations

from typing import Any

from seldon_core_tpu_torch import __version__

OAS_VERSION = "3.0.3"


# ---------------------------------------------------------------------------
# shared schema components (SeldonMessage and friends)
# ---------------------------------------------------------------------------


def _schemas() -> dict:
    return {
        "SeldonMessage": {
            "type": "object",
            "properties": {
                "status": {"$ref": "#/components/schemas/Status"},
                "meta": {"$ref": "#/components/schemas/Meta"},
                "data": {"$ref": "#/components/schemas/DefaultData"},
                "binData": {"type": "string", "format": "byte"},
                "strData": {"type": "string"},
                "jsonData": {},
            },
        },
        "DefaultData": {
            "type": "object",
            "properties": {
                "names": {"type": "array", "items": {"type": "string"}},
                "tensor": {"$ref": "#/components/schemas/LegacyTensor"},
                "ndarray": {"type": "array", "items": {}},
                "binTensor": {"$ref": "#/components/schemas/Tensor"},
            },
        },
        "LegacyTensor": {
            "type": "object",
            "description": "Reference wire parity: {shape, values} doubles "
                           "(reference prediction.proto:31-34)",
            "properties": {
                "shape": {"type": "array", "items": {"type": "integer"}},
                "values": {"type": "array", "items": {"type": "number"}},
            },
        },
        "Tensor": {
            "type": "object",
            "description": "dtype-rich tensor: raw little-endian buffer + "
                           "numpy dtype name",
            "properties": {
                "dtype": {"type": "string"},
                "shape": {"type": "array", "items": {"type": "integer"}},
                "raw": {"type": "string", "format": "byte"},
            },
        },
        "Meta": {
            "type": "object",
            "properties": {
                "puid": {"type": "string"},
                "tags": {"type": "object", "additionalProperties": True},
                "routing": {
                    "type": "object",
                    "additionalProperties": {"type": "integer"},
                },
                "requestPath": {
                    "type": "object",
                    "additionalProperties": {"type": "string"},
                },
                "metrics": {
                    "type": "array",
                    "items": {"$ref": "#/components/schemas/Metric"},
                },
            },
        },
        "Metric": {
            "type": "object",
            "properties": {
                "key": {"type": "string"},
                "type": {"type": "string",
                         "enum": ["COUNTER", "GAUGE", "TIMER"]},
                "value": {"type": "number"},
            },
        },
        "Status": {
            "type": "object",
            "properties": {
                "code": {"type": "integer"},
                "info": {"type": "string"},
                "reason": {"type": "string"},
                "status": {"type": "string",
                           "enum": ["SUCCESS", "FAILURE"]},
            },
        },
        "Feedback": {
            "type": "object",
            "properties": {
                "request": {"$ref": "#/components/schemas/SeldonMessage"},
                "response": {"$ref": "#/components/schemas/SeldonMessage"},
                "truth": {"$ref": "#/components/schemas/SeldonMessage"},
                "reward": {"type": "number"},
            },
        },
        "SeldonMessageList": {
            "type": "object",
            "properties": {
                "seldonMessages": {
                    "type": "array",
                    "items": {"$ref": "#/components/schemas/SeldonMessage"},
                },
            },
        },
    }


def _msg_op(summary: str, body_schema: str = "SeldonMessage",
            tags: list | None = None) -> dict:
    return {
        "summary": summary,
        "tags": tags or [],
        "requestBody": {
            "required": True,
            "content": {"application/json": {"schema": {
                "$ref": f"#/components/schemas/{body_schema}"}}},
        },
        "responses": {
            "200": {
                "description": "SeldonMessage response",
                "content": {"application/json": {"schema": {
                    "$ref": "#/components/schemas/SeldonMessage"}}},
            },
            "400": {"description": "malformed request (FAILURE status)"},
        },
    }


def _stream_op(summary: str, secured: bool = False) -> dict:
    """SSE streaming path object (shared by gateway/engine/component
    specs so the stream contract cannot drift between surfaces)."""
    op = {
        "summary": summary,
        "tags": ["predict"],
        "requestBody": _msg_op("", tags=[])["requestBody"],
        "responses": {
            "200": {"description": "text/event-stream of JSON events; "
                                   "final event has done=true",
                    "content": {"text/event-stream": {}}},
            "501": {"description": "graph is not streamable"},
        },
    }
    if secured:
        op["security"] = [{"bearerAuth": []}]
    return op


def _ops_paths() -> dict:
    text_ok = {"200": {"description": "OK", "content": {"text/plain": {}}}}
    return {
        "/ready": {"get": {"summary": "readiness probe",
                           "tags": ["ops"], "responses": dict(text_ok)}},
        "/live": {"get": {"summary": "liveness probe",
                          "tags": ["ops"], "responses": dict(text_ok)}},
        "/metrics": {"get": {"summary": "prometheus exposition",
                             "tags": ["ops"], "responses": dict(text_ok)}},
    }


def _health_paths() -> dict:
    """The health-plane admin surface — identical on gateway and engine
    (docs/observability.md#health-plane)."""
    disabled = {"404": {"description": "health plane disabled"}}
    bad_num = {"400": {"description": "non-numeric query parameter"}}
    return {
        "/admin/health": {
            "get": {
                "summary": "SLO burn-rate verdict fused with live QoS "
                           "posture",
                "tags": ["ops"],
                "parameters": [
                    {"name": "verbose", "in": "query",
                     "schema": {"type": "boolean"},
                     "description": "inline the latest introspection "
                                    "sample + flight-recorder stats"},
                ],
                "responses": {
                    "200": {"description":
                            "verdict ok|warn|critical + burn rates"},
                    **disabled,
                },
            }
        },
        "/admin/introspect": {
            "get": {
                "summary": "bounded runtime-introspection timeline",
                "tags": ["ops"],
                "parameters": [
                    {"name": "n", "in": "query",
                     "schema": {"type": "integer"}},
                    {"name": "probe", "in": "query",
                     "schema": {"type": "string"}},
                    {"name": "stats", "in": "query",
                     "schema": {"type": "boolean"},
                     "description": "sampler counters only"},
                ],
                "responses": {
                    "200": {"description": "samples + sampler stats"},
                    **bad_num, **disabled,
                },
            }
        },
        "/admin/flightrecorder": {
            "get": {
                "summary": "per-request flight records (every request, "
                           "independent of trace sampling)",
                "tags": ["ops"],
                "parameters": [
                    {"name": "deployment", "in": "query",
                     "schema": {"type": "string"}},
                    {"name": "status", "in": "query",
                     "schema": {"type": "integer"}},
                    {"name": "puid", "in": "query",
                     "schema": {"type": "string"}},
                    {"name": "min_ms", "in": "query",
                     "schema": {"type": "number"}},
                    {"name": "errors_only", "in": "query",
                     "schema": {"type": "boolean"}},
                    {"name": "replica", "in": "query",
                     "schema": {"type": "string"},
                     "description": "only records stamped by this fleet "
                                    "replica (e.g. r0)"},
                    {"name": "n", "in": "query",
                     "schema": {"type": "integer", "default": 50}},
                    {"name": "stats", "in": "query",
                     "schema": {"type": "boolean"},
                     "description": "ring counters only"},
                ],
                "responses": {
                    "200": {"description": "matching records + ring stats"},
                    **bad_num, **disabled,
                },
            }
        },
    }


def _profile_paths() -> dict:
    """The profiling-plane admin surface — identical on gateway and engine
    (docs/observability.md#continuous-profiling-plane)."""
    disabled = {"404": {"description": "profiling plane disabled"}}
    bad_num = {"400": {"description": "non-numeric query parameter"}}
    return {
        "/admin/profile": {
            "get": {
                "summary": "always-on host-profiler posture + collapsed "
                           "flamegraph (render with tools/profview)",
                "tags": ["ops"],
                "parameters": [
                    {"name": "n", "in": "query",
                     "schema": {"type": "integer"},
                     "description": "cap the folded stacks returned"},
                    {"name": "reset", "in": "query",
                     "schema": {"type": "boolean"},
                     "description": "clear the folded table after reading"},
                ],
                "responses": {
                    "200": {"description": "stats + collapsed profile"},
                    **bad_num, **disabled,
                },
            }
        },
        "/admin/profile/capture": {
            "get": {
                "summary": "baseline-diff capture window: open with "
                           "?seconds, poll/finalize with ?id[&stop]",
                "tags": ["ops"],
                "parameters": [
                    {"name": "seconds", "in": "query",
                     "schema": {"type": "number", "default": 5.0}},
                    {"name": "device", "in": "query",
                     "schema": {"type": "string"},
                     "description": "directory for an xla_profile device "
                                    "trace spanning the window"},
                    {"name": "id", "in": "query",
                     "schema": {"type": "string"}},
                    {"name": "stop", "in": "query",
                     "schema": {"type": "boolean"},
                     "description": "finalize the window now (one-shot)"},
                ],
                "responses": {
                    "200": {"description": "window handle or diffed "
                                           "profile"},
                    "400": {"description": "bad seconds / past "
                                           "seldon.io/profile-window-s"},
                    "404": {"description": "unknown window id, or "
                                           "profiling plane disabled"},
                    "429": {"description": "too many concurrent capture "
                                           "windows"},
                },
            }
        },
        "/admin/profile/compile": {
            "get": {
                "summary": "per-segment XLA compile ledger: wall time, "
                           "per-bucket cost analysis, recompile storms",
                "tags": ["ops"],
                "responses": {
                    "200": {"description": "compile telemetry snapshot"},
                    **disabled,
                },
            }
        },
        "/admin/profile/capacity": {
            "get": {
                "summary": "attributed FLOP demand vs device peak → "
                           "achievable-RPS headroom",
                "tags": ["ops"],
                "responses": {
                    "200": {"description": "capacity estimate"},
                    **disabled,
                },
            }
        },
    }


def _placement_paths() -> dict:
    """The placement-plane admin surface — identical on gateway and
    engine (docs/sharding.md)."""
    return {
        "/admin/placement": {
            "get": {
                "summary": "device mesh, segment->device assignments, "
                           "per-device HBM loads, sharded-dispatch "
                           "counters",
                "tags": ["ops"],
                "parameters": [
                    {"name": "meshes", "in": "query",
                     "schema": {"type": "boolean"},
                     "description": "return only the process-wide mesh "
                                    "registry"},
                ],
                "responses": {
                    "200": {"description": "placement plan + mesh "
                                           "registry"},
                    "404": {"description": "placement plane disabled"},
                },
            }
        },
    }


def _artifact_paths() -> dict:
    """The artifact-plane admin surface — identical on gateway and
    engine (docs/artifacts.md)."""
    return {
        "/admin/artifacts": {
            "get": {
                "summary": "AOT artifact store posture: per-segment "
                           "hydrated vs live-compiled buckets, store "
                           "entries/bytes, parity failures, warm-start "
                           "coverage",
                "tags": ["ops"],
                "parameters": [
                    {"name": "coverage", "in": "query",
                     "schema": {"type": "boolean"},
                     "description": "return only the warm-start coverage "
                                    "summary"},
                ],
                "responses": {
                    "200": {"description": "artifact plane snapshot"},
                    "404": {"description": "artifact plane disabled"},
                },
            }
        },
    }


def _fleet_paths() -> dict:
    """The fleet-plane admin surface — identical on gateway and engine
    (docs/scale-out.md): per-replica health/load, the consistent-hash
    ring, session bindings."""
    return {
        "/admin/fleet": {
            "get": {
                "summary": "replica pool membership: per-replica health "
                           "state, in-flight load, forwards/ejections, "
                           "hash ring, session affinity bindings",
                "tags": ["ops"],
                "parameters": [
                    {"name": "deployment", "in": "query",
                     "schema": {"type": "string"},
                     "description": "narrow the gateway's view to one "
                                    "deployment's pool"},
                ],
                "responses": {
                    "200": {"description": "fleet snapshot"},
                    "404": {"description": "fleet plane disabled or "
                                           "unknown deployment"},
                },
            }
        },
        **_fleet_obs_paths(),
    }


def _fleet_obs_paths() -> dict:
    """The fleet-observability surface — identical on gateway and engine
    (docs/observability.md#fleet-observability): scatter-gather
    aggregation over the replicas' own admin endpoints, plus the
    decision audit ring."""
    dep_param = {"name": "deployment", "in": "query",
                 "schema": {"type": "string"},
                 "description": "which deployment's fleet to scrape "
                                "(defaults to the only one)"}
    replica_param = {"name": "replica", "in": "query",
                     "schema": {"type": "string"},
                     "description": "narrow to one replica id (e.g. r0)"}
    n_param = {"name": "n", "in": "query",
               "schema": {"type": "integer", "default": 20}}
    disabled = {"404": {"description": "no fleet to observe"}}
    bad_num = {"400": {"description": "non-numeric query parameter"}}

    def scrape_op(summary: str, extra: list) -> dict:
        return {
            "get": {
                "summary": summary,
                "tags": ["ops"],
                "parameters": [dep_param, *extra],
                "responses": {
                    "200": {"description":
                            "per-replica payloads keyed by replica id; "
                            "partial: true + unreachable entries when a "
                            "replica is down (a scrape never 500s)"},
                    **bad_num, **disabled,
                },
            }
        }

    return {
        "/admin/fleet/health": scrape_op(
            "fleet health verdict: per-replica health fused with "
            "MAD-based latency/error/compile skew — stragglers and "
            "compile-skewed replicas named in signals",
            [{"name": "refresh", "in": "query",
              "schema": {"type": "boolean"},
              "description": "bypass the scrape cache"}],
        ),
        "/admin/fleet/traces": scrape_op(
            "cross-replica trace query; with trace_id, stitches the "
            "gateway's hop spans together with each replica's server "
            "spans into one tree",
            [{"name": "trace_id", "in": "query",
              "schema": {"type": "string"}}, replica_param, n_param],
        ),
        "/admin/fleet/flightrecorder": scrape_op(
            "flight records aggregated across the fleet, each stamped "
            "with its replica id",
            [{"name": "status", "in": "query",
              "schema": {"type": "integer"}},
             {"name": "puid", "in": "query",
              "schema": {"type": "string"}},
             {"name": "min_ms", "in": "query",
              "schema": {"type": "number"}},
             {"name": "errors_only", "in": "query",
              "schema": {"type": "boolean"}},
             replica_param, n_param],
        ),
        "/admin/fleet/profile": scrape_op(
            "per-replica folded flamegraph stacks, diffable with "
            "profview fleet.json#r0 fleet.json#r1",
            [n_param],
        ),
        "/admin/fleet/capacity": scrape_op(
            "per-replica capacity estimates + the fleet-total sum",
            [],
        ),
        "/admin/fleet/decisions": {
            "get": {
                "summary": "bounded audit ring of fleet control "
                           "decisions: autoscale patches, ejections, "
                           "readmissions — why the fleet is shaped the "
                           "way it is",
                "tags": ["ops"],
                "parameters": [
                    {"name": "kind", "in": "query",
                     "schema": {"type": "string"},
                     "description": "autoscale | eject | readmit"},
                    dep_param, replica_param,
                    {"name": "n", "in": "query",
                     "schema": {"type": "integer", "default": 50}},
                ],
                "responses": {
                    "200": {"description": "decision records + ring stats"},
                    **bad_num,
                },
            }
        },
    }


def gateway_spec() -> dict:
    """External API (reference apife.oas3.json)."""
    paths = {
        "/oauth/token": {
            "post": {
                "summary": "OAuth2 client-credentials token endpoint",
                "tags": ["auth"],
                "security": [{"basicAuth": []}],
                "requestBody": {
                    "content": {"application/x-www-form-urlencoded": {
                        "schema": {"type": "object", "properties": {
                            "grant_type": {"type": "string",
                                           "enum": ["client_credentials"]},
                        }}}},
                },
                "responses": {
                    "200": {"description": "access token"},
                    "401": {"description": "bad client credentials"},
                },
            }
        },
        "/api/v0.1/predictions": {
            "post": {**_msg_op("predict via deployment routed by principal",
                               tags=["predict"]),
                     "security": [{"bearerAuth": []}]},
        },
        "/api/v0.1/feedback": {
            "post": {**_msg_op("send reward feedback", "Feedback",
                               tags=["predict"]),
                     "security": [{"bearerAuth": []}]},
        },
        "/api/v0.1/stream": {
            "post": _stream_op(
                "SSE token streaming proxied to the deployment "
                "(501 when the graph is not streamable)",
                secured=True,
            )
        },
        "/admin/traces": {
            "get": {
                "summary": "query collected traces (docs/observability.md)",
                "tags": ["ops"],
                "parameters": [
                    {"name": "deployment", "in": "query",
                     "schema": {"type": "string"}},
                    {"name": "status", "in": "query",
                     "schema": {"type": "string", "enum": ["ok", "error"]}},
                    {"name": "min_ms", "in": "query",
                     "schema": {"type": "number"}},
                    {"name": "drill", "in": "query",
                     "schema": {"type": "string"}},
                    {"name": "trace_id", "in": "query",
                     "schema": {"type": "string"},
                     "description": "exact trace id (stitch one request "
                                    "across retry hops)"},
                    {"name": "replica", "in": "query",
                     "schema": {"type": "string"},
                     "description": "only traces whose hop spans touched "
                                    "this replica"},
                    {"name": "n", "in": "query",
                     "schema": {"type": "integer", "default": 50}},
                    {"name": "stats", "in": "query",
                     "schema": {"type": "boolean"},
                     "description": "collector counters only"},
                ],
                "responses": {
                    "200": {"description": "matching trace records + stats"},
                    "400": {"description": "non-numeric min_ms / n"},
                    "404": {"description": "tracing disabled"},
                },
            }
        },
        **_health_paths(),
        **_profile_paths(),
        **_placement_paths(),
        **_artifact_paths(),
        **_fleet_paths(),
        **_ops_paths(),
    }
    return {
        "openapi": OAS_VERSION,
        "info": {"title": "seldon-core-tpu external API (gateway)",
                 "version": __version__},
        "paths": paths,
        "components": {
            "schemas": _schemas(),
            "securitySchemes": {
                "bearerAuth": {"type": "http", "scheme": "bearer"},
                "basicAuth": {"type": "http", "scheme": "basic"},
            },
        },
    }


def engine_spec() -> dict:
    """Per-deployment engine API (reference engine.oas3.json)."""
    paths = {
        "/api/v0.1/predictions": {
            "post": _msg_op("run the predictor graph", tags=["predict"])},
        "/api/v1.0/predictions": {
            "post": _msg_op("run the predictor graph (alias)",
                            tags=["predict"])},
        "/api/v0.1/feedback": {
            "post": _msg_op("propagate reward feedback down the graph",
                            "Feedback", tags=["predict"])},
        "/api/v0.1/stream": {
            "post": _stream_op(
                "SSE token streaming (graphs whose root is a single "
                "streaming node; 501 otherwise)"
            )},
        "/pause": {"get": {"summary": "stop accepting (pre-drain)",
                           "tags": ["ops"],
                           "responses": {"200": {"description": "paused"}}}},
        "/unpause": {"get": {"summary": "resume accepting", "tags": ["ops"],
                             "responses": {"200": {"description": "ok"}}}},
        "/trace": {"get": {"summary": "recent request trace spans",
                           "tags": ["ops"],
                           "parameters": [
                               {"name": "puid", "in": "query",
                                "schema": {"type": "string"}},
                               {"name": "trace_id", "in": "query",
                                "schema": {"type": "string"}},
                               {"name": "replica", "in": "query",
                                "schema": {"type": "string"},
                                "description": "only spans stamped by "
                                               "this fleet replica"},
                               {"name": "n", "in": "query",
                                "schema": {"type": "integer"}},
                           ],
                           "responses": {"200": {"description": "traces"}}}},
        **_health_paths(),
        **_profile_paths(),
        **_placement_paths(),
        **_artifact_paths(),
        **_fleet_paths(),
        **_ops_paths(),
    }
    return {
        "openapi": OAS_VERSION,
        "info": {"title": "seldon-core-tpu engine API", "version": __version__},
        "paths": paths,
        "components": {"schemas": _schemas()},
    }


def component_spec(stream: bool = False) -> dict:
    """Internal microservice API (reference wrapper.oas3.json +
    docs/reference/internal-api.md)."""
    paths = {
        "/predict": {"post": _msg_op("MODEL predict", tags=["component"])},
        "/transform-input": {
            "post": _msg_op("TRANSFORMER input transform",
                            tags=["component"])},
        "/transform-output": {
            "post": _msg_op("OUTPUT_TRANSFORMER output transform",
                            tags=["component"])},
        "/route": {"post": _msg_op("ROUTER branch choice (1x1 tensor)",
                                   tags=["component"])},
        "/aggregate": {
            "post": _msg_op("COMBINER aggregation", "SeldonMessageList",
                            tags=["component"])},
        "/send-feedback": {
            "post": _msg_op("reward feedback", "Feedback",
                            tags=["component"])},
        "/health/status": {
            "get": {"summary": "component health", "tags": ["ops"],
                    "responses": {"200": {"description": "healthy"}}}},
        "/metrics": {"get": {"summary": "prometheus exposition",
                             "tags": ["ops"],
                             "responses": {"200": {"description": "OK"}}}},
    }
    if stream:
        # only components exposing an async stream(msg) register the route
        # (rest.py ComponentServer.register) — advertise it only for them
        paths["/stream"] = {
            "post": {
                "summary": "server-sent-events token streaming "
                           "(e.g. runtime.llm.LLMComponent)",
                "tags": ["component"],
                "requestBody": _msg_op("", tags=[])["requestBody"],
                "responses": {"200": {
                    "description": "text/event-stream of JSON events; "
                                   "final event has done=true",
                    "content": {"text/event-stream": {}},
                }},
            }}
    return {
        "openapi": OAS_VERSION,
        "info": {"title": "seldon-core-tpu internal component API",
                 "version": __version__},
        "paths": paths,
        "components": {"schemas": _schemas()},
    }


def main(argv=None) -> None:
    import argparse
    import json

    ap = argparse.ArgumentParser(description="emit OAS3 specs")
    ap.add_argument("which", choices=["gateway", "engine", "component"])
    args = ap.parse_args(argv)
    spec = {"gateway": gateway_spec, "engine": engine_spec,
            "component": component_spec}[args.which]()
    print(json.dumps(spec, indent=2))


if __name__ == "__main__":
    main()
