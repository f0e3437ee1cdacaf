"""Contract-driven request generation (port of
``seldon_core_tpu/tools/contract.py``: under one ``np.random.Generator``
seed the draws and requests are the reference's).

A *contract* declares the input/output data shape of a deployed component so
test traffic can be generated without the real model's training data —
reference semantics: ``wrappers/testing/tester.py`` (generate_batch,
unfold_contract, gen_REST_request) and ``util/api_tester/api-tester.py:26-60``.

Contract JSON layout (wire-compatible with reference contract.json files)::

    {
      "features": [
        {"name": "x", "ftype": "continuous", "dtype": "FLOAT",
         "range": [0, 1], "shape": [4]},
        {"name": "c", "ftype": "categorical", "values": ["a", "b"]},
        {"name": "r", "ftype": "continuous", "dtype": "INT", "repeat": 3}
      ],
      "targets": [ ...same schema... ]
    }

- ``range`` bounds may be the string ``"inf"`` (unbounded side → reference
  uses normal/lognormal sampling; preserved here).
- ``repeat: N`` expands one declaration into N scalar features named
  ``name1..nameN`` (reference ``unfold_contract``).
- ``dtype: INT`` rounds to whole numbers (kept as float64 on the wire, like
  the reference's ``reconciliate_cont_type``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence

import numpy as np


@dataclass
class FeatureDef:
    name: str
    ftype: str = "continuous"  # continuous | categorical
    dtype: str = "FLOAT"  # FLOAT | INT
    range: Optional[Sequence[Any]] = None  # [lo, hi], "inf" allowed
    shape: Optional[List[int]] = None
    values: Optional[List[Any]] = None  # categorical values

    @classmethod
    def from_dict(cls, d: dict) -> "FeatureDef":
        return cls(
            name=d.get("name", "f"),
            ftype=d.get("ftype", "continuous"),
            dtype=d.get("dtype", "FLOAT"),
            range=d.get("range"),
            shape=list(d["shape"]) if d.get("shape") else None,
            values=d.get("values"),
        )

    @property
    def width(self) -> int:
        """Columns this feature contributes to a (n, width) batch."""
        if self.ftype == "categorical":
            return 1
        if self.shape:
            return int(np.prod(self.shape))
        return 1

    def feature_names(self) -> List[str]:
        if self.width == 1:
            return [self.name]
        return [f"{self.name}_{i}" for i in range(self.width)]

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Return an (n, width) float64 column block."""
        if self.ftype == "categorical":
            if not self.values:
                raise ValueError(f"categorical feature {self.name!r} has no values")
            idx = rng.integers(0, len(self.values), size=n)
            vals = np.asarray(self.values)[idx]
            # reference api-tester casts categorical to float; keep object
            # dtype only when values are non-numeric (tester.py keeps strings)
            try:
                return vals.astype(np.float64).reshape(n, 1)
            except ValueError:
                return vals.reshape(n, 1)
        lo, hi = (self.range or ["inf", "inf"])[:2]
        size = (n, self.width)
        if lo == "inf" and hi == "inf":
            batch = rng.normal(size=size)
        elif lo == "inf":
            batch = float(hi) - rng.lognormal(size=size)
        elif hi == "inf":
            batch = float(lo) + rng.lognormal(size=size)
        else:
            batch = rng.uniform(float(lo), float(hi), size=size)
        batch = np.around(batch, decimals=3)
        if self.dtype == "INT":
            batch = np.floor(batch + 0.5)  # reference reconciliate_cont_type
            if lo != "inf":
                batch = np.maximum(batch, float(lo))
            if hi != "inf":
                batch = np.minimum(batch, float(hi))
        return batch


@dataclass
class Contract:
    features: List[FeatureDef] = field(default_factory=list)
    targets: List[FeatureDef] = field(default_factory=list)
    # "tensor" (default): responses must carry tensor data matching the
    # targets.  "json": the component legitimately answers with
    # jsonData/strData/binData (e.g. LLM token output) — declared
    # explicitly so a tensor deployment that wrongly returns jsonData
    # still FAILS validation.
    response_type: str = "tensor"

    @classmethod
    def from_dict(cls, d: dict) -> "Contract":
        return cls(
            features=[FeatureDef.from_dict(f) for f in _expand(d.get("features", []))],
            targets=[FeatureDef.from_dict(f) for f in _expand(d.get("targets", []))],
            response_type=d.get("response_type", "tensor"),
        )

    @classmethod
    def load(cls, path: str) -> "Contract":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # ---- generation ----------------------------------------------------
    def feature_names(self) -> List[str]:
        out: List[str] = []
        for f in self.features:
            out.extend(f.feature_names())
        return out

    def target_names(self) -> List[str]:
        out: List[str] = []
        for t in self.targets:
            out.extend(t.feature_names())
        return out

    def generate_batch(
        self, n: int, field_name: str = "features", rng: Optional[np.random.Generator] = None
    ) -> np.ndarray:
        """(n, total_width) batch over all declared features — the
        reference's flat layout (``generate_batch``).  A contract with
        exactly ONE multi-dim shaped feature (e.g. an image ``shape:
        [224, 224, 3]``) keeps its true shape as ``(n, *shape)`` instead;
        the reference tester predates image servers and had no answer
        here."""
        rng = rng or np.random.default_rng()
        defs = self.features if field_name == "features" else self.targets
        if not defs:
            raise ValueError(f"contract has no {field_name}")
        multi = [f for f in defs if f.shape is not None and len(f.shape) > 1]
        if multi:
            if len(defs) > 1:
                raise ValueError(
                    f"feature {multi[0].name!r} has a multi-dim shape "
                    f"{multi[0].shape}; it cannot be concatenated with other "
                    "features into the flat (n, width) layout — declare it "
                    "as the contract's only feature"
                )
            flat = defs[0].sample(rng, n)
            return flat.reshape(n, *defs[0].shape)
        blocks = [f.sample(rng, n) for f in defs]
        if any(b.dtype == object for b in blocks):
            return np.concatenate([b.astype(object) for b in blocks], axis=1)
        return np.concatenate(blocks, axis=1)

    # ---- request builders ----------------------------------------------
    def rest_request(
        self,
        n: int = 1,
        tensor: bool = True,
        rng: Optional[np.random.Generator] = None,
    ) -> dict:
        """SeldonMessage dict (reference ``gen_REST_request``)."""
        batch = self.generate_batch(n, rng=rng)
        if batch.ndim > 2:
            # single multi-dim feature (image): ONE name for the tensor —
            # per-element names would be megabytes of meaningless strings
            names = [self.features[0].name]
        else:
            names = self.feature_names()
        if tensor and batch.dtype != object:
            datadef = {
                "names": names,
                "tensor": {
                    "shape": list(batch.shape),
                    "values": batch.ravel().tolist(),
                },
            }
        else:
            datadef = {"names": names, "ndarray": batch.tolist()}
        return {"meta": {}, "data": datadef}

    def feedback_request(
        self, n: int = 1, reward: float = 1.0, rng: Optional[np.random.Generator] = None
    ) -> dict:
        """Feedback dict: generated request + generated target response
        (reference api-tester ``--endpoint feedback`` path)."""
        rng = rng or np.random.default_rng()
        req = self.rest_request(n, rng=rng)
        resp_batch = self.generate_batch(n, "targets", rng=rng)
        response = {
            "meta": {},
            "data": {
                "names": self.target_names(),
                "ndarray": resp_batch.tolist(),
            },
        }
        return {"request": req, "response": response, "reward": reward}

    def proto_request(self, n: int = 1, tensor: bool = True, rng=None):
        """SeldonMessage protobuf (reference ``gen_GRPC_request``)."""
        from seldon_core_tpu_torch.messages import SeldonMessage

        d = self.rest_request(n, tensor=tensor, rng=rng)
        from seldon_core_tpu_torch.proto.convert import message_to_proto

        return message_to_proto(SeldonMessage.from_dict(d))


def _expand(defs: list) -> list:
    """``repeat: N`` expansion (reference ``unfold_contract``)."""
    out = []
    for d in defs:
        rep = d.get("repeat")
        if rep:
            for i in range(int(rep)):
                nd = dict(d)
                nd.pop("repeat")
                nd["name"] = f"{d.get('name', 'f')}{i + 1}"
                out.append(nd)
        else:
            out.append(d)
    return out


def validate_response(contract: Contract, response: dict) -> List[str]:
    """Check a prediction response against the contract's targets.

    Returns a list of problems (empty = pass).  The reference testers only
    eyeball-print responses; actually asserting shape/names is the natural
    strengthening."""
    problems: List[str] = []
    data = response.get("data")
    if data is None:
        # only contracts that DECLARE a json response accept non-tensor
        # payloads — a tensor deployment wrongly returning jsonData fails
        if contract.response_type == "json" and any(
            k in response for k in ("jsonData", "strData", "binData")
        ):
            return problems
        st = response.get("status") or {}
        problems.append(
            f"no data in response (status={st.get('status')}: {st.get('info')})"
        )
        return problems
    arr = data.get("ndarray")
    if arr is None and "tensor" in data:
        t = data["tensor"]
        try:
            arr = np.asarray(t["values"]).reshape(t["shape"]).tolist()
        except Exception as e:
            problems.append(f"bad tensor payload: {e}")
            return problems
    if arr is None and "binTensor" in data:
        return problems  # opaque device payload — nothing to check
    if arr is None:
        problems.append("response data has neither ndarray, tensor, nor binTensor")
        return problems
    width = len(contract.target_names())
    a = np.asarray(arr)
    if width and a.ndim >= 2 and a.shape[-1] != width:
        problems.append(
            f"response width {a.shape[-1]} != contract targets width {width}"
        )
    return problems
