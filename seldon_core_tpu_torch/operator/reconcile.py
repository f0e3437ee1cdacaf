"""Control-plane reconcile loop: watch SeldonDeployment CRs, drive the
cluster to the compiled manifest set, write status back (port of
``seldon_core_tpu/operator/reconcile.py``; standard library only).

Behaviour of the reference's cluster-manager reproduced:

- watch loop with periodic re-list + resourceVersion tracking —
  ``SeldonDeploymentWatcher.java:122-197`` (``@Scheduled(fixedDelay=5000)``
  at :194);
- validate → default → createResources → create/update → prune orphans —
  ``SeldonDeploymentControllerImpl.java:261`` (createOrReplace),
  ``SeldonDeploymentOperatorImpl.java:469,375,580``;
- validation failure → ``status.state=FAILED`` + reason written to the CR —
  ``SeldonDeploymentWatcher.java:86-117`` (failDeployment);
- owned-workload replica availability → ``PredictorStatus`` in the CR
  ``/status`` subresource — ``k8s/DeploymentWatcher.java:60-146``,
  ``SeldonDeploymentStatusUpdateImpl.java:36-103``;
- CRD registration at boot — ``CRDCreator.java:31-140``;
- owner references on created resources so cluster GC reclaims them when
  the CR disappears — ``SeldonDeploymentOperatorImpl.java:491-499``.

Design: the controller is pure logic over a tiny ``KubeApi`` protocol.
Tests run the full loop against :class:`FakeKubeApi`; in-cluster
deployments use :class:`HttpKubeApi`, a client over the apiserver REST API
on ``urllib`` and ``ssl``.  ``python -m
seldon_core_tpu_torch.operator.reconcile`` registers the CRD and reconciles
forever (:func:`main`).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Any, Iterable, Optional, Protocol

from seldon_core_tpu_torch.operator.compile import compile_deployment
from seldon_core_tpu_torch.operator.crd_schema import validation_schema
from seldon_core_tpu_torch.operator.spec import (
    API_VERSION,
    KIND,
    SeldonDeployment,
)

logger = logging.getLogger(__name__)

__all__ = [
    "KubeApi",
    "FakeKubeApi",
    "HttpKubeApi",
    "SeldonDeploymentController",
    "SeldonDeploymentWatcher",
    "crd_manifest",
    "ensure_crd",
    "OWNED_KINDS",
]

GROUP = API_VERSION.split("/")[0]
VERSION = API_VERSION.split("/")[1]
PLURAL = "seldondeployments"
OWNER_LABEL = "seldon-deployment-id"
PREDICTOR_LABEL = "seldon-predictor-id"
# dirty-check marker: hash of the compiled manifest.  Comparing whole
# objects against the live copy would always differ against a real
# apiserver (defaulted fields, clusterIP, revision annotations...), making
# every sweep PUT immutable fields back.  The annotation pins exactly what
# the operator last applied.
HASH_ANNOTATION = "seldon.io/spec-hash"
# workload kinds the compiler can emit for a predictor graph
OWNED_KINDS = ("Deployment", "StatefulSet", "Service")
WORKLOAD_KINDS = ("Deployment", "StatefulSet")


# ---------------------------------------------------------------------------
# CRD manifest (reference CRDCreator.java:31-140)
# ---------------------------------------------------------------------------

def crd_manifest() -> dict:
    """The SeldonDeployment CustomResourceDefinition (apiextensions v1)."""
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{PLURAL}.{GROUP}"},
        "spec": {
            "group": GROUP,
            "names": {
                "kind": KIND,
                "listKind": f"{KIND}List",
                "plural": PLURAL,
                "singular": "seldondeployment",
                "shortNames": ["sdep"],
            },
            "scope": "Namespaced",
            "versions": [
                {
                    "name": VERSION,
                    "served": True,
                    "storage": True,
                    # status is a subresource so controller status writes
                    # never clobber (or race) the user's spec
                    "subresources": {"status": {}},
                    # structural validation schema generated from code
                    # (operator/crd_schema.py; reference parity:
                    # util/custom-resource-definitions/expand-validation.py)
                    "schema": {"openAPIV3Schema": validation_schema()},
                }
            ],
        },
    }


def ensure_crd(api: "KubeApi") -> bool:
    """Register the CRD if absent; True if it was created."""
    name = f"{PLURAL}.{GROUP}"
    if api.get("CustomResourceDefinition", "", name) is not None:
        return False
    api.create(crd_manifest())
    return True


# ---------------------------------------------------------------------------
# KubeApi protocol + fake
# ---------------------------------------------------------------------------

class KubeApi(Protocol):
    """Minimal typed surface over the Kubernetes REST API."""

    def list(
        self, kind: str, namespace: str, label_selector: Optional[dict] = None
    ) -> list[dict]: ...

    def get(self, kind: str, namespace: str, name: str) -> Optional[dict]: ...

    def create(self, obj: dict) -> dict: ...

    def update(self, obj: dict) -> dict: ...

    def delete(self, kind: str, namespace: str, name: str) -> bool: ...

    def patch_status(
        self, kind: str, namespace: str, name: str, status: dict
    ) -> Optional[dict]: ...


def _strip_server_fields(obj: dict) -> dict:
    out = json.loads(json.dumps(obj))  # deep copy
    meta = out.get("metadata", {})
    for f in ("resourceVersion", "uid", "creationTimestamp", "generation",
              "ownerReferences", "managedFields"):
        meta.pop(f, None)
    out.pop("status", None)
    return out


def _manifest_hash(m: dict) -> str:
    import hashlib

    canon = json.dumps(_strip_server_fields(m), sort_keys=True)
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


class FakeKubeApi:
    """In-memory apiserver: objects keyed by (kind, namespace, name) with
    resourceVersion bumping and label-selector list.  Tests drive the whole
    reconcile loop against this; ``set_workload_available`` plays kubelet.
    """

    def __init__(self):
        self._objs: dict[tuple, dict] = {}
        self._rv = 0
        self._uid = 0
        self.actions: list[tuple[str, str, str]] = []  # (verb, kind, name)

    # -- helpers ---------------------------------------------------------
    def _key(self, kind: str, ns: str, name: str) -> tuple:
        return (kind, ns or "", name)

    def _bump(self, obj: dict) -> dict:
        self._rv += 1
        obj.setdefault("metadata", {})["resourceVersion"] = str(self._rv)
        return obj

    # -- KubeApi ---------------------------------------------------------
    def list(self, kind, namespace, label_selector=None):
        out = []
        for (k, ns, _), obj in sorted(self._objs.items()):
            if k != kind or (namespace and ns != namespace):
                continue
            labels = obj.get("metadata", {}).get("labels", {}) or {}
            if label_selector and any(
                labels.get(lk) != lv for lk, lv in label_selector.items()
            ):
                continue
            out.append(json.loads(json.dumps(obj)))
        return out

    def get(self, kind, namespace, name):
        obj = self._objs.get(self._key(kind, namespace, name))
        return json.loads(json.dumps(obj)) if obj is not None else None

    def create(self, obj):
        kind = obj["kind"]
        ns = obj.get("metadata", {}).get("namespace", "")
        name = obj["metadata"]["name"]
        key = self._key(kind, ns, name)
        if key in self._objs:
            raise ValueError(f"{kind} {ns}/{name} already exists")
        stored = json.loads(json.dumps(obj))
        self._uid += 1
        stored.setdefault("metadata", {})["uid"] = f"uid-{self._uid}"
        self._objs[key] = self._bump(stored)
        self.actions.append(("create", kind, name))
        return self.get(kind, ns, name)

    def update(self, obj):
        kind = obj["kind"]
        ns = obj.get("metadata", {}).get("namespace", "")
        name = obj["metadata"]["name"]
        key = self._key(kind, ns, name)
        if key not in self._objs:
            raise KeyError(f"{kind} {ns}/{name} not found")
        prev = self._objs[key]
        stored = json.loads(json.dumps(obj))
        meta = stored.setdefault("metadata", {})
        meta["uid"] = prev["metadata"].get("uid")
        if "status" in prev and "status" not in stored:
            stored["status"] = prev["status"]
        self._objs[key] = self._bump(stored)
        self.actions.append(("update", kind, name))
        return self.get(kind, ns, name)

    def delete(self, kind, namespace, name):
        key = self._key(kind, namespace, name)
        if key in self._objs:
            del self._objs[key]
            self.actions.append(("delete", kind, name))
            return True
        return False

    def patch_status(self, kind, namespace, name, status):
        key = self._key(kind, namespace, name)
        obj = self._objs.get(key)
        if obj is None:
            return None
        obj["status"] = json.loads(json.dumps(status))
        self._bump(obj)
        self.actions.append(("patch_status", kind, name))
        return self.get(kind, namespace, name)

    # -- test helpers ----------------------------------------------------
    def set_workload_available(
        self, namespace: str, name: str, available: int
    ) -> None:
        """Simulate kubelet bringing replicas up on an owned workload."""
        for kind in WORKLOAD_KINDS:
            obj = self._objs.get(self._key(kind, namespace, name))
            if obj is not None:
                desired = int(obj.get("spec", {}).get("replicas", 1))
                obj["status"] = {
                    "replicas": desired,
                    "availableReplicas": available,
                    "readyReplicas": available,
                }
                self._bump(obj)
                return
        raise KeyError(f"no workload {namespace}/{name}")


# ---------------------------------------------------------------------------
# Controller
# ---------------------------------------------------------------------------

class SeldonDeploymentController:
    """createOrReplace + prune + status for one SeldonDeployment CR.

    Pure logic over KubeApi — no threads, no timers; the watcher owns
    scheduling."""

    def __init__(self, api: KubeApi):
        self.api = api
        # fleet autoscale loop state: "owner/predictor" → (FleetConfig,
        # Autoscaler) so cooldown clocks survive across sweeps and a
        # config change rebuilds the scaler (docs/scale-out.md)
        self._autoscalers: dict[str, tuple] = {}

    # -- public ----------------------------------------------------------
    def reconcile(self, cr: dict) -> dict:
        """Drive owned resources to the compiled set; returns the status
        written to the CR."""
        ns = cr.get("metadata", {}).get("namespace", "default")
        name = cr.get("metadata", {}).get("name", "")
        try:
            dep = SeldonDeployment.from_dict(cr)
            dep.namespace = ns
            manifests = compile_deployment(dep)
        except Exception as e:
            # reference failDeployment (SeldonDeploymentWatcher.java:86-117)
            status = {
                "state": "Failed",
                "description": f"{type(e).__name__}: {e}",
            }
            # graphlint rejection: surface the structured findings (code,
            # severity, unit path, message) on the CR status so clients
            # can pinpoint the offending node without parsing the message
            findings = getattr(e, "findings", None)
            if findings:
                status["analysis"] = [f.to_dict() for f in findings]
            self._write_status(ns, name, status, prev=cr.get("status"))
            return status

        owner_ref = self._owner_ref(cr)
        desired: dict[tuple, dict] = {}
        for m in manifests:
            m.setdefault("metadata", {}).setdefault("namespace", ns)
            m["metadata"].setdefault("labels", {})[OWNER_LABEL] = name
            if owner_ref is not None:
                m["metadata"]["ownerReferences"] = [owner_ref]
            # hash BEFORE stamping the annotation so it never feeds itself
            spec_hash = _manifest_hash(m)
            m["metadata"].setdefault("annotations", {})[
                HASH_ANNOTATION
            ] = spec_hash
            desired[(m["kind"], m["metadata"]["name"])] = m

        existing: dict[tuple, dict] = {}
        for kind in OWNED_KINDS:
            for obj in self.api.list(kind, ns, {OWNER_LABEL: name}):
                existing[(kind, obj["metadata"]["name"])] = obj

        for key, m in desired.items():
            cur = existing.get(key)
            if cur is None:
                self.api.create(m)
                continue
            live_hash = (
                cur.get("metadata", {}).get("annotations", {}) or {}
            ).get(HASH_ANNOTATION)
            if live_hash == m["metadata"]["annotations"][HASH_ANNOTATION]:
                continue  # what we applied last time — leave it alone
            # preserve the live resourceVersion for optimistic concurrency
            rv = cur.get("metadata", {}).get("resourceVersion")
            if rv is not None:
                m["metadata"]["resourceVersion"] = rv
            if m["kind"] == "Service":
                # apiserver-populated immutable fields must round-trip
                live_spec = cur.get("spec", {}) or {}
                for f in ("clusterIP", "clusterIPs", "ipFamilies",
                          "ipFamilyPolicy"):
                    if f in live_spec and f not in m.get("spec", {}):
                        m.setdefault("spec", {})[f] = live_spec[f]
            self.api.update(m)
        # prune orphans: owned resources not in the desired set
        # (SeldonDeploymentControllerImpl removeDeployments/removeServices)
        for key in set(existing) - set(desired):
            kind, obj_name = key
            self.api.delete(kind, ns, obj_name)

        status = self.compute_status(dep, ns, owner=name)
        self._write_status(ns, name, status, prev=cr.get("status"))
        return status

    def prune(self, namespace: str, name: str) -> int:
        """Delete every resource owned by a (deleted) CR; returns count.
        In-cluster the ownerReferences make GC do this; the explicit path
        covers apiservers/tests without GC."""
        n = 0
        for kind in OWNED_KINDS:
            for obj in self.api.list(kind, namespace, {OWNER_LABEL: name}):
                if self.api.delete(kind, namespace, obj["metadata"]["name"]):
                    n += 1
        return n

    def compute_status(
        self, dep: SeldonDeployment, ns: str, owner: Optional[str] = None
    ) -> dict:
        """Aggregate owned-workload availability into PredictorStatus
        (reference SeldonDeploymentStatusUpdateImpl.java:36-103).

        Workloads are found by label, not name, so every compiled layout is
        covered — single-host Deployments, multi-host StatefulSets (named
        ``<dep>-<pred>-r<i>``), and the distributed per-component layout.
        ``replicas`` counts pods across the predictor's workloads."""
        owner = owner or dep.name
        predictor_status = []
        all_available = True
        for p in dep.predictors:
            sel = {OWNER_LABEL: owner, PREDICTOR_LABEL: p.name}
            want = 0
            avail = 0
            found = False
            for kind in WORKLOAD_KINDS:
                for obj in self.api.list(kind, ns, sel):
                    found = True
                    w = int(obj.get("spec", {}).get("replicas", 1))
                    a = int(
                        (obj.get("status") or {}).get("availableReplicas", 0)
                        or 0
                    )
                    want += w
                    avail += min(a, w)
            if not found:
                want = p.replicas
            predictor_status.append(
                {
                    "name": p.name,
                    "replicas": want,
                    "replicasAvailable": avail,
                }
            )
            if avail < want or not found:
                all_available = False
        status = {
            "state": "Available" if all_available else "Creating",
            "predictorStatus": predictor_status,
        }
        # QoS posture (docs/qos.md): current concurrency limit, shed
        # level, and open breakers, refreshed on the same reconcile tick
        # as replica availability.  The process-local registry
        # (qos/registry.py) serves it when an engine runtime lives in
        # this process (dev harness / colocated operator); otherwise the
        # block is omitted, never invented.
        from seldon_core_tpu_torch.qos import snapshot as qos_snapshot

        qos = qos_snapshot(owner)
        if qos is not None:
            status["qos"] = qos
        # Health verdict (docs/observability.md): SLO burn state, sampler
        # and flight-recorder stats, published by the same process-local
        # pattern (health/registry.py) — status.health beside status.qos.
        from seldon_core_tpu_torch.health import snapshot as health_snapshot

        health = health_snapshot(owner)
        if health is not None:
            status["health"] = health
        # Placement posture (docs/sharding.md): mesh shape and
        # segment→device assignments, published by the same process-local
        # pattern (placement/registry.py) — status.placement beside
        # status.qos/status.health.
        from seldon_core_tpu_torch.placement import (
            snapshot as placement_snapshot,
        )

        placement = placement_snapshot(owner)
        if placement is not None:
            status["placement"] = placement
        # Artifact posture (docs/artifacts.md): warm-start coverage per
        # segment — hydrated vs live-compiled buckets, store size, parity
        # failures — published by the same process-local pattern
        # (artifacts/registry.py).  Operators read this to confirm a
        # scale-up came up warm (coverage 1.0, zero live compiles).
        from seldon_core_tpu_torch.artifacts import (
            snapshot as artifacts_snapshot,
        )

        artifacts = artifacts_snapshot(owner)
        if artifacts is not None:
            status["artifacts"] = artifacts
        # Fleet posture (docs/scale-out.md): replica membership/health,
        # routing policy, and autoscale signals, published by the same
        # process-local pattern (fleet/registry.py).  When the CR opts in
        # to autoscale this is also where the loop RUNS — both reconcile()
        # and the watcher's availability refresh funnel through here, so
        # scaling reacts on every sweep, not only on spec edits.
        from seldon_core_tpu_torch.fleet import snapshot as fleet_snapshot

        fleet = fleet_snapshot(owner)
        if fleet is not None:
            decisions = self.maybe_autoscale(dep, ns, owner, fleet)
            if decisions:
                fleet = {**fleet, "autoscale": decisions}
            status["fleet"] = fleet
        return status

    def maybe_autoscale(
        self, dep: SeldonDeployment, ns: str, owner: str, fleet: dict
    ) -> dict:
        """Operator autoscale loop: the fleet registry's demand/capacity/
        burn signals drive one Autoscaler per fleet-enabled predictor
        (cooldown + min/max bounds live in the scaler).  A changed
        decision patches the owned workload's ``spec.replicas`` DIRECTLY —
        the spec-hash annotation is untouched, so the hash-guarded
        reconcile path will not revert the scale (the same mechanism that
        lets a human ``kubectl scale`` an owned workload).  Returns
        {predictor: decision dict} for ``status.fleet.autoscale``;
        decisions carry no timestamps so the status prev-guard stays
        stable across idle sweeps."""
        from seldon_core_tpu_torch.fleet import (
            Autoscaler,
            fleet_config_from_annotations,
        )

        sig = fleet.get("signals") or {}
        decisions: dict[str, dict] = {}
        for p in dep.predictors:
            ann = {**dep.annotations, **p.annotations}
            try:
                cfg = fleet_config_from_annotations(ann, f"{owner}/{p.name}")
            except ValueError:
                continue  # admission (GL1301) already surfaced it
            if cfg is None or not cfg.enabled or not cfg.autoscale:
                continue
            key = f"{owner}/{p.name}"
            entry = self._autoscalers.get(key)
            if entry is None or entry[0] != cfg:
                entry = (cfg, Autoscaler(cfg))
                self._autoscalers[key] = entry
            scaler = entry[1]
            sel = {OWNER_LABEL: owner, PREDICTOR_LABEL: p.name}
            workloads = [
                obj
                for kind in WORKLOAD_KINDS
                for obj in self.api.list(kind, ns, sel)
            ]
            current = sum(
                int(obj.get("spec", {}).get("replicas", 1))
                for obj in workloads
            ) or p.replicas
            decision = scaler.decide(
                current=current,
                demand_rps=sig.get("demandRps"),
                capacity_rps=sig.get("capacityRps"),
                burn_critical=bool(sig.get("burnCritical")),
                burn_warn=bool(sig.get("burnWarn")),
            )
            decisions[p.name] = decision.to_dict()
            if decision.changed and workloads:
                obj = workloads[0]
                obj.setdefault("spec", {})["replicas"] = decision.desired
                try:
                    self.api.update(obj)
                except Exception:
                    logger.exception("autoscale patch failed for %s", key)
                else:
                    # decision audit (docs/observability.md#fleet-
                    # observability): every spec.replicas patch is
                    # explainable after the fact from
                    # /admin/fleet/decisions
                    from seldon_core_tpu_torch.fleet.observe import (
                        record_decision,
                    )

                    record_decision(
                        "autoscale", deployment=owner,
                        reason=decision.reason, predictor=p.name,
                        current=decision.current,
                        desired=decision.desired,
                    )
        return decisions

    # -- internals -------------------------------------------------------
    def _owner_ref(self, cr: dict) -> Optional[dict]:
        uid = cr.get("metadata", {}).get("uid")
        if not uid:
            return None
        return {
            "apiVersion": API_VERSION,
            "kind": KIND,
            "name": cr["metadata"]["name"],
            "uid": uid,
            "controller": True,
            "blockOwnerDeletion": True,
        }

    def _write_status(
        self, ns: str, name: str, status: dict, prev: Optional[dict] = None
    ) -> None:
        # Skip no-op writes: an unconditional patch bumps resourceVersion
        # every sweep, which the watcher would read as "CR changed" and
        # re-reconcile forever.
        if prev is not None and prev == status:
            return
        out = self.api.patch_status(KIND, ns, name, status)
        if out is None:
            logger.warning("status write failed: %s/%s not found", ns, name)


# ---------------------------------------------------------------------------
# Watcher
# ---------------------------------------------------------------------------

class SeldonDeploymentWatcher:
    """Periodic re-list of SeldonDeployment CRs with resourceVersion
    tracking; reconciles added/modified CRs, prunes deleted ones, and
    refreshes replica status (the reference splits this across
    SeldonDeploymentWatcher + DeploymentWatcher, both @Scheduled 5s)."""

    def __init__(
        self,
        api: KubeApi,
        namespace: str = "default",
        interval: float = 5.0,
    ):
        self.api = api
        self.namespace = namespace
        self.interval = interval
        self.controller = SeldonDeploymentController(api)
        self._seen: dict[str, str] = {}  # name -> last reconciled rv
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def run_once(self) -> dict[str, str]:
        """One reconcile sweep; returns {name: action} for observability."""
        actions: dict[str, str] = {}
        crs = {
            cr["metadata"]["name"]: cr
            for cr in self.api.list(KIND, self.namespace)
        }
        # additions / modifications
        for name, cr in crs.items():
            rv = cr.get("metadata", {}).get("resourceVersion", "")
            if self._seen.get(name) == rv:
                # spec unchanged — still refresh replica availability, which
                # changes without touching the CR (DeploymentWatcher.java)
                self._refresh_status(cr)
                continue
            # Per-CR isolation: an API failure against one CR (e.g. a 409 on
            # a pre-existing unowned Deployment) must not starve the CRs
            # after it in the sweep, and must surface on the CR's status.
            try:
                self.controller.reconcile(cr)
            except Exception as e:
                logger.exception("reconcile of %s failed", name)
                actions[name] = f"error: {type(e).__name__}"
                try:
                    # prev guard: a persistently failing CR would otherwise
                    # get an identical Failed patch (and rv bump) every sweep
                    self.controller._write_status(
                        self.namespace, name,
                        {"state": "Failed",
                         "description": f"{type(e).__name__}: {e}"},
                        prev=cr.get("status"),
                    )
                except Exception:
                    pass
                # leave _seen untouched so the next sweep retries
                continue
            # Record the rv we RECONCILED (read before the sweep), not the
            # post-status-write rv: a user spec edit landing between
            # reconcile() and a re-read would otherwise be marked seen and
            # silently dropped.  The status write bumps the rv, so the next
            # sweep re-reconciles once more and converges (reconcile is
            # idempotent — hash-guarded update path).
            self._seen[name] = rv
            actions[name] = "reconciled"
        # deletions
        for name in list(self._seen):
            if name not in crs:
                self.controller.prune(self.namespace, name)
                del self._seen[name]
                actions[name] = "pruned"
        return actions

    def _refresh_status(self, cr: dict) -> None:
        name = cr["metadata"]["name"]
        if (cr.get("status") or {}).get("state") == "Failed":
            return  # reconcile wrote the failure reason; don't mask it
        try:
            dep = SeldonDeployment.from_dict(cr)
        except Exception:
            return
        status = self.controller.compute_status(
            dep, self.namespace, owner=name
        )
        prev = cr.get("status")
        if prev != status:
            self.api.patch_status(KIND, self.namespace, name, status)
            # Deliberately do NOT adopt the post-write resourceVersion as
            # "reconciled": a user spec edit landing between the sweep's
            # list and a re-read here would be marked seen and silently
            # dropped (same race run_once documents).  Our own rv bump just
            # triggers one extra idempotent reconcile next sweep.

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "SeldonDeploymentWatcher":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.run_once()
                except Exception:
                    logger.exception("reconcile sweep failed")

        self._thread = threading.Thread(
            target=loop, daemon=True, name="sdep-watcher"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 5)
            self._thread = None


# ---------------------------------------------------------------------------
# In-cluster HTTP client (no external deps)
# ---------------------------------------------------------------------------

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

_KIND_PATHS = {
    "Deployment": ("apis/apps/v1", "deployments"),
    "StatefulSet": ("apis/apps/v1", "statefulsets"),
    "Service": ("api/v1", "services"),
    KIND: (f"apis/{GROUP}/{VERSION}", PLURAL),
    "CustomResourceDefinition": (
        "apis/apiextensions.k8s.io/v1",
        "customresourcedefinitions",
    ),
}

_CLUSTER_SCOPED = {"CustomResourceDefinition"}


class HttpKubeApi:
    """KubeApi over the apiserver REST API using in-cluster service-account
    credentials (or an explicit base URL + token for dev clusters)."""

    def __init__(
        self,
        base_url: Optional[str] = None,
        token: Optional[str] = None,
        verify: Optional[str] = None,
    ):
        import os

        if base_url is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            base_url = f"https://{host}:{port}"
        self.base_url = base_url.rstrip("/")
        if token is None:
            try:
                with open(f"{_SA_DIR}/token") as f:
                    token = f.read().strip()
            except OSError:
                token = ""
        self.token = token
        self.verify = verify if verify is not None else (
            f"{_SA_DIR}/ca.crt" if os.path.exists(f"{_SA_DIR}/ca.crt") else None
        )

    # -- plumbing --------------------------------------------------------
    def _url(self, kind: str, ns: str, name: str = "", subresource: str = "") -> str:
        prefix, plural = _KIND_PATHS[kind]
        if kind in _CLUSTER_SCOPED or not ns:
            path = f"{self.base_url}/{prefix}/{plural}"
        else:
            path = f"{self.base_url}/{prefix}/namespaces/{ns}/{plural}"
        if name:
            path += f"/{name}"
        if subresource:
            path += f"/{subresource}"
        return path

    def _request(
        self,
        method: str,
        url: str,
        body: Optional[dict] = None,
        content_type: str = "application/json",
    ) -> Optional[dict]:
        import ssl
        import urllib.error
        import urllib.request

        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", content_type)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        ctx = ssl.create_default_context(cafile=self.verify) if url.startswith("https") else None
        try:
            with urllib.request.urlopen(req, context=ctx, timeout=30) as resp:
                payload = resp.read()
                return json.loads(payload) if payload else None
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    # -- KubeApi ---------------------------------------------------------
    def list(self, kind, namespace, label_selector=None):
        url = self._url(kind, namespace)
        if label_selector:
            sel = ",".join(f"{k}={v}" for k, v in label_selector.items())
            url += f"?labelSelector={sel}"
        out = self._request("GET", url)
        return (out or {}).get("items", [])

    def get(self, kind, namespace, name):
        return self._request("GET", self._url(kind, namespace, name))

    def create(self, obj):
        kind = obj["kind"]
        ns = obj.get("metadata", {}).get("namespace", "")
        return self._request("POST", self._url(kind, ns), obj)

    def update(self, obj):
        kind = obj["kind"]
        ns = obj.get("metadata", {}).get("namespace", "")
        name = obj["metadata"]["name"]
        return self._request("PUT", self._url(kind, ns, name), obj)

    def delete(self, kind, namespace, name):
        return (
            self._request("DELETE", self._url(kind, namespace, name))
            is not None
        )

    def patch_status(self, kind, namespace, name, status):
        return self._request(
            "PATCH",
            self._url(kind, namespace, name, "status"),
            {"status": status},
            content_type="application/merge-patch+json",
        )


def _start_health_server(port: int, watcher: "SeldonDeploymentWatcher"):
    """Tiny /ready // /live endpoint for the operator pod's probes (the
    chart's readinessProbe targets it; reference operator exposes Spring
    actuator health the same way).  Returns the server, or None if port=0."""
    if not port:
        return None
    import http.server
    import json as _json

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
            if self.path in ("/ready", "/live", "/healthz"):
                alive = watcher._thread is not None and watcher._thread.is_alive()
                body = _json.dumps({"ready": alive}).encode()
                self.send_response(200 if alive else 503)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_response(404)
                self.end_headers()

        def log_message(self, *a):  # quiet probes
            pass

    srv = http.server.ThreadingHTTPServer(("0.0.0.0", port), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="operator-health")
    t.start()
    return srv


def main(argv: Optional[list[str]] = None) -> None:
    """Operator entry point: register the CRD and reconcile forever.

    Env fallbacks mirror the chart's values (charts/seldon-core-tpu):
    ``SELDON_NAMESPACE``, ``SELDON_RECONCILE_INTERVAL``,
    ``SELDON_HEALTH_PORT``, and ``SELDON_ENGINE_IMAGE`` (consumed by
    operator/compile.py when building engine pods)."""
    import argparse
    import os

    ap = argparse.ArgumentParser(description="seldon-core-tpu operator")
    ap.add_argument("--namespace",
                    default=os.environ.get("SELDON_NAMESPACE", "default"))
    ap.add_argument("--interval", type=float,
                    default=float(os.environ.get("SELDON_RECONCILE_INTERVAL",
                                                 "5.0")))
    ap.add_argument("--kube-url", default=None)
    ap.add_argument("--health-port", type=int,
                    default=int(os.environ.get("SELDON_HEALTH_PORT", "8081")),
                    help="probe endpoint port (0 disables)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    api = HttpKubeApi(base_url=args.kube_url)
    ensure_crd(api)
    watcher = SeldonDeploymentWatcher(
        api, namespace=args.namespace, interval=args.interval
    )
    logger.info("operator watching %s every %.1fs", args.namespace, args.interval)
    watcher.start()
    health = _start_health_server(args.health_port, watcher)
    try:
        while True:
            time.sleep(60)
    except KeyboardInterrupt:
        watcher.stop()
        if health is not None:
            health.shutdown()


if __name__ == "__main__":
    main()
