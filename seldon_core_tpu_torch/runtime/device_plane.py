"""Device-resident tensor plane (port of
``seldon_core_tpu/runtime/device_plane.py``): keep tensors on the card
across the graph's interpreter-boundary edges.

- **Cache edges** keep a CUDA tensor as the entry (``graph/engine.py``
  ``_promote_device``; never a downcast copy), and chain edges hand it on
  without a host copy.
- **Remote edges** negotiate ``deviceRef`` per peer: in-process loopback
  rides a :mod:`~seldon_core_tpu_torch.runtime.device_registry` ref (zero
  copies), same-host cross-process rides shared memory (one D2H and one
  H2D), and a true transport boundary downgrades to bytes, counted.
- **Meta-only routers** (``ModelSignature.routes_on == "meta"``) route on
  a message with the tensor stripped: no D2H at all.

Gated by ``seldon.io/device-plane`` (refused at load in ``graph/spec.py``
when malformed).  Every avoided transfer and every downgrade is counted
here (``seldon_device_plane_*``).  "HBM handle" in the tier names below
means a CUDA tensor.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

__all__ = [
    "DEVICE_PLANE_ANNOTATION",
    "DEVICE_PLANE_PREFIX",
    "DEVICE_PLANE_REMOTE_ANNOTATION",
    "REMOTE_MODES",
    "RESIDENCY_TIERS",
    "TIER_HOST_BYTES",
    "TIER_SHM_LANE",
    "TIER_LOOPBACK_REF",
    "TIER_HBM_HANDLE",
    "DevicePlaneConfig",
    "device_plane_config_from_annotations",
    "negotiated_remote_tier",
    "tier_transfers",
    "DevicePlane",
    "device_plane_probe",
]

DEVICE_PLANE_ANNOTATION = "seldon.io/device-plane"
#: every family knob but the master switch starts with this prefix
DEVICE_PLANE_PREFIX = "seldon.io/device-plane-"
DEVICE_PLANE_REMOTE_ANNOTATION = "seldon.io/device-plane-remote"

#: remote fast-path posture: ``auto`` negotiates per peer (loopback →
#: registry ref, same host → shm, else bytes); ``loopback``/``shm`` cap
#: the negotiation at that tier; ``off`` keeps remote edges on bytes
#: while in-process edges still ride the plane.
REMOTE_MODES = ("auto", "loopback", "shm", "off")

# -- pure residency model ----------------------------------------------------
# The tiers a graph edge's payload can live in, ordered worst → best.
# The runtime fast paths (serving/framed.py, serving/client.py,
# proto/convert.py) realize these tiers, and ``GraphPlan.residency_map``
# predicts them from the spec; both read this table.

TIER_HOST_BYTES = "host-bytes"      # serialized onto the byte wire
TIER_SHM_LANE = "shm-lane"          # staged: one D2H + one H2D, no bytes
TIER_LOOPBACK_REF = "loopback-ref"  # in-process registry ref, zero copies
TIER_HBM_HANDLE = "hbm-handle"      # the CUDA tensor itself stays on the card

RESIDENCY_TIERS = (TIER_HOST_BYTES, TIER_SHM_LANE,
                   TIER_LOOPBACK_REF, TIER_HBM_HANDLE)


def negotiated_remote_tier(config: "DevicePlaneConfig",
                           transport: str) -> str:
    """The best residency tier a remote edge can STRUCTURALLY negotiate.

    Pure function of the plane posture and the edge's transport: device
    refs ride the proto/framed codecs only (``GRPC``), so a ``REST``
    edge can never carry one — with the plane on, every request on such
    an edge pays the byte downgrade.  ``auto`` answers the best tier the
    runtime may reach (loopback when the peer turns out in-process); the
    runtime negotiates DOWN from here per peer, never up."""
    if not config.enabled or config.remote == "off":
        return TIER_HOST_BYTES
    if str(transport).upper() != "GRPC":
        return TIER_HOST_BYTES
    if config.remote == "shm":
        return TIER_SHM_LANE
    return TIER_LOOPBACK_REF  # loopback or auto


def tier_transfers(tier: str) -> tuple:
    """Host↔device transfers one payload pays to cross an edge at this
    tier.  Ref tiers move nothing; shm stages exactly one D2H
    + one H2D; the byte wire pays the same two hops plus serialization
    (billed as a second pair by the serialize/parse round trip)."""
    if tier == TIER_HOST_BYTES:
        return ("d2h", "serialize", "parse", "h2d")
    if tier == TIER_SHM_LANE:
        return ("d2h", "h2d")
    return ()

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


def _parse_bool(ann: dict, key: str, where: str, default: bool) -> bool:
    raw = ann.get(key)
    if raw is None:
        return default
    v = str(raw).strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise ValueError(
        f"{where}: annotation {key} must be a boolean "
        f"(true/false), got {raw!r}"
    )


@dataclass(frozen=True)
class DevicePlaneConfig:
    """Validated device-plane posture for one predictor."""

    enabled: bool = False
    #: remote fast-path cap — one of :data:`REMOTE_MODES`
    remote: str = "auto"


def device_plane_config_from_annotations(
        ann: dict, where: str) -> Optional[DevicePlaneConfig]:
    """``seldon.io/device-plane*`` → validated :class:`DevicePlaneConfig`.

    Returns None when the family is entirely absent (the plane is not in
    play); raises ``ValueError`` with a path-prefixed message on any
    malformed value — same parser contract as ``artifacts/config.py``,
    re-raised by ``graph/spec.py`` as the load-time refusal.
    """
    keys = [k for k in ann
            if k == DEVICE_PLANE_ANNOTATION
            or k.startswith(DEVICE_PLANE_PREFIX)]
    if not keys:
        return None
    on = _parse_bool(ann, DEVICE_PLANE_ANNOTATION, where, default=True)
    remote = str(
        ann.get(DEVICE_PLANE_REMOTE_ANNOTATION, "auto") or "auto"
    ).strip().lower()
    if remote not in REMOTE_MODES:
        raise ValueError(
            f"{where}: annotation {DEVICE_PLANE_REMOTE_ANNOTATION} must be "
            f"one of {'/'.join(REMOTE_MODES)}, got "
            f"{ann.get(DEVICE_PLANE_REMOTE_ANNOTATION)!r}"
        )
    return DevicePlaneConfig(enabled=on, remote=remote)


class DevicePlane:
    """Per-engine accounting + policy for the device-resident plane.

    The plane itself is pure bookkeeping — the fast paths live in the
    engine, the serving clients, and the registry; they consult
    ``config`` for policy and bill every avoided transfer, minted remote
    ref, donation, and downgrade here so the win is measurable
    (``seldon_device_plane_*`` counters) and the downgrade path is
    auditable (a silent downgrade would look exactly like a plane that
    does not work).
    """

    def __init__(self, config: Optional[DevicePlaneConfig] = None,
                 metrics=None):
        self.config = config or DevicePlaneConfig(enabled=True)
        self.metrics = metrics
        self._lock = threading.Lock()
        #: kind → count of host transfers skipped (d2h | h2d | copy)
        self._avoided: dict = {}
        #: kind → bytes those transfers would have moved
        self._avoided_bytes: dict = {}
        #: mode → remote refs minted (loopback | shm)
        self._remote_refs: dict = {}
        #: reason → remote downgrades to the byte wire
        self._downgrades: dict = {}
        self._donations = 0

    @property
    def enabled(self) -> bool:
        return bool(self.config.enabled)

    # -- billing ---------------------------------------------------------
    def _counter(self, name: str, labels: dict, n: float = 1.0) -> None:
        if self.metrics is None:
            return
        try:
            self.metrics.counter_inc(name, labels, n)
        except Exception:
            pass

    def note_avoided(self, kind: str, nbytes: int = 0) -> None:
        """A host transfer (``d2h``/``h2d``) or defensive host ``copy``
        that the plane skipped, with the bytes it would have moved."""
        with self._lock:
            self._avoided[kind] = self._avoided.get(kind, 0) + 1
            self._avoided_bytes[kind] = \
                self._avoided_bytes.get(kind, 0) + int(nbytes)
        self._counter(
            "seldon_device_plane_transfers_avoided_total", {"kind": kind})
        if nbytes:
            self._counter(
                "seldon_device_plane_bytes_avoided_total", {"kind": kind},
                int(nbytes))

    def note_remote_ref(self, mode: str) -> None:
        """A remote edge rode a device ref (``loopback`` or ``shm``)."""
        with self._lock:
            self._remote_refs[mode] = self._remote_refs.get(mode, 0) + 1
        self._counter(
            "seldon_device_plane_remote_refs_total", {"mode": mode})

    def note_downgrade(self, reason: str) -> None:
        """A remote edge fell back to the byte wire (``foreign-process``,
        ``negotiation``, ``resolve-failed``, ``dtype``, ``policy``)."""
        with self._lock:
            self._downgrades[reason] = self._downgrades.get(reason, 0) + 1
        self._counter(
            "seldon_device_plane_downgrades_total", {"reason": reason})

    def note_donation(self) -> None:
        """A one-shot ref was consumed, freeing the producer's buffer."""
        with self._lock:
            self._donations += 1
        self._counter("seldon_device_plane_donations_total", {})

    # -- surfaces --------------------------------------------------------
    def snapshot(self) -> dict:
        """Machine-readable state (tests, chip runs)."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "remote": self.config.remote,
                "transfersAvoided": dict(self._avoided),
                "bytesAvoided": dict(self._avoided_bytes),
                "remoteRefs": dict(self._remote_refs),
                "downgrades": dict(self._downgrades),
                "donations": self._donations,
            }

    def counts(self) -> dict:
        """Flat numeric rollup (the probe's payload)."""
        with self._lock:
            return {
                "device_plane_transfers_avoided":
                    float(sum(self._avoided.values())),
                "device_plane_bytes_avoided":
                    float(sum(self._avoided_bytes.values())),
                "device_plane_remote_refs":
                    float(sum(self._remote_refs.values())),
                "device_plane_downgrades":
                    float(sum(self._downgrades.values())),
                "device_plane_donations": float(self._donations),
            }


def device_plane_probe(plane: DevicePlane):
    """A probe over the plane's rollup counters, for the health plane's
    introspection sampler (``operator/local.py`` adds it)."""

    def probe() -> dict:
        return plane.counts()

    return probe
