"""Encoding profiles and zone rules (the port of
``chunky_bits_tpu/cluster/profile.py``).

Mirrors src/cluster/profile.rs: a profile is ``{chunk_size (log2),
data_chunks, parity_chunks, zone_rules}`` (:77-90) with serde aliases
``data``/``parity`` and ``zone``/``zones``/``rules``; ``ClusterProfiles``
holds a required ``default`` plus custom profiles that **inherit from
default** field-by-field (the "hollow" merge, :133-250) — a zone rule set to
null in a custom profile removes the inherited rule.  The name "default"
is reserved case-insensitively (:65-74).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from chunky_bits_tpu_torch.cluster import sized_int
from chunky_bits_tpu_torch.errors import SerdeError


@dataclass
class ZoneRule:
    """i8 budgets (profile.rs:124-131): ``minimum`` writes required in the
    zone, ``maximum`` allowed (None = unlimited), ``ideal`` preferred."""

    minimum: int = 0
    maximum: Optional[int] = None
    ideal: int = 0

    @classmethod
    def from_obj(cls, obj) -> "ZoneRule":
        if obj is None:
            return cls()
        maximum = obj.get("maximum")
        return cls(
            minimum=int(obj.get("minimum", 0) or 0),
            maximum=int(maximum) if maximum is not None else None,
            ideal=int(obj.get("ideal", 0) or 0),
        )

    def to_obj(self) -> dict:
        return {
            "minimum": self.minimum,
            "maximum": self.maximum,
            "ideal": self.ideal,
        }

    def copy(self) -> "ZoneRule":
        return ZoneRule(self.minimum, self.maximum, self.ideal)


@dataclass
class ClusterProfile:
    chunk_size: int = sized_int.CHUNK_SIZE_DEFAULT  # log2
    data_chunks: int = sized_int.DATA_DEFAULT
    parity_chunks: int = sized_int.PARITY_DEFAULT
    zone_rules: dict[str, ZoneRule] = field(default_factory=dict)
    #: erasure code for parts written under this profile: "rs" /
    #: "pm-msr" when pinned in YAML (validated against the geometry at
    #: parse time), or None = unset — ``get_code`` then resolves the
    #: ``$CHUNKY_BITS_TORCH_CODE`` env default, honored only when this
    #: profile's geometry supports it (an env default must tune, never
    #: break, a fleet of mixed profiles)
    code: Optional[str] = None

    def get_chunk_size(self) -> int:
        return 1 << self.chunk_size

    def get_data_chunks(self) -> int:
        return self.data_chunks

    def get_parity_chunks(self) -> int:
        return self.parity_chunks

    def get_code(self) -> str:
        if self.code is not None:
            return self.code
        from chunky_bits_tpu_torch.cluster import tunables

        want = tunables.erasure_code(default="rs")
        if want != "rs" and _code_geometry_error(want, self) is not None:
            return "rs"
        return want

    @classmethod
    def from_obj(cls, obj: dict) -> "ClusterProfile":
        if not isinstance(obj, dict):
            raise SerdeError("profile must be a mapping")
        out = cls()
        if "chunk_size" in obj:
            out.chunk_size = sized_int.chunk_size(obj["chunk_size"])
        data = obj.get("data_chunks", obj.get("data"))
        if data is None:
            raise SerdeError("profile missing data chunk count")
        out.data_chunks = sized_int.data_chunk_count(data)
        parity = obj.get("parity_chunks", obj.get("parity"))
        if parity is None:
            raise SerdeError("profile missing parity chunk count")
        out.parity_chunks = sized_int.parity_chunk_count(parity)
        rules = _zone_rules_obj(obj)
        if rules:
            out.zone_rules = {
                zone: ZoneRule.from_obj(rule) for zone, rule in rules.items()
            }
        if "code" in obj and obj["code"] is not None:
            out.code = _validated_code(obj["code"], out)
        return out

    def to_obj(self) -> dict:
        out = {
            "chunk_size": self.chunk_size,
            "data_chunks": self.data_chunks,
            "parity_chunks": self.parity_chunks,
            "rules": {z: r.to_obj() for z, r in self.zone_rules.items()},
        }
        if self.code is not None:
            out["code"] = self.code
        return out

    def copy(self) -> "ClusterProfile":
        return ClusterProfile(
            chunk_size=self.chunk_size,
            data_chunks=self.data_chunks,
            parity_chunks=self.parity_chunks,
            zone_rules={z: r.copy() for z, r in self.zone_rules.items()},
            code=self.code,
        )


def _zone_rules_obj(obj: dict):
    for key in ("zone_rules", "rules", "zones", "zone"):
        if key in obj and obj[key] is not None:
            return obj[key]
    return None


def _code_geometry_error(code: str, profile: "ClusterProfile"):
    """Why ``profile``'s geometry cannot run ``code``, or None."""
    if code == "rs":
        return None
    from chunky_bits_tpu_torch.ops.pm_msr import geometry_error

    return geometry_error(profile.get_data_chunks(),
                          profile.get_parity_chunks(),
                          profile.get_chunk_size())


def _validated_code(value: object, profile: "ClusterProfile") -> str:
    """An explicit YAML ``code:`` must be a shipped code AND fit the
    profile's geometry — config typos and impossible geometries fail at
    cluster load, not at the first write."""
    from chunky_bits_tpu_torch.ops.backend import KNOWN_CODES

    if value not in KNOWN_CODES:
        raise SerdeError(
            f"profile code must be one of "
            f"{', '.join(repr(c) for c in KNOWN_CODES)}, got {value!r}")
    err = _code_geometry_error(str(value), profile)
    if err is not None:
        raise SerdeError(f"profile cannot use code {value!r}: {err}")
    return str(value)


class ClusterProfiles:
    def __init__(self, default: ClusterProfile,
                 custom: Optional[dict[str, ClusterProfile]] = None):
        self.default = default
        self.custom = dict(custom or {})

    def get_default(self) -> ClusterProfile:
        return self.default

    def get(self, name: Optional[str]) -> Optional[ClusterProfile]:
        if name is None or name.lower() == "default":
            return self.default
        return self.custom.get(name)

    def insert(self, name: Optional[str], profile: ClusterProfile
               ) -> Optional[ClusterProfile]:
        if name is None or name.lower() == "default":
            old, self.default = self.default, profile
            return old
        old = self.custom.get(name)
        self.custom[name] = profile
        return old

    @classmethod
    def from_obj(cls, obj: dict) -> "ClusterProfiles":
        if not isinstance(obj, dict):
            raise SerdeError("profiles must be a mapping")
        default_obj = None
        customs: dict[str, dict] = {}
        for key, value in obj.items():
            if key.lower() == "default":
                if default_obj is not None:
                    raise SerdeError("duplicate field `default`")
                default_obj = value
            else:
                customs[key] = value
        if default_obj is None:
            raise SerdeError("profiles missing field `default`")
        default = ClusterProfile.from_obj(default_obj)
        custom = {}
        for name, hollow in customs.items():
            custom[name] = _merge_with_default(hollow, default)
        return cls(default, custom)

    def to_obj(self) -> dict:
        out = {"default": self.default.to_obj()}
        for name, profile in self.custom.items():
            out[name] = profile.to_obj()
        return out


def _merge_with_default(hollow: dict, default: ClusterProfile
                        ) -> ClusterProfile:
    """Partial custom profile over the default (profile.rs:220-248)."""
    if not isinstance(hollow, dict):
        raise SerdeError("profile must be a mapping")
    out = default.copy()
    if "chunk_size" in hollow and hollow["chunk_size"] is not None:
        out.chunk_size = sized_int.chunk_size(hollow["chunk_size"])
    data = hollow.get("data_chunks", hollow.get("data"))
    if data is not None:
        out.data_chunks = sized_int.data_chunk_count(data)
    parity = hollow.get("parity_chunks", hollow.get("parity"))
    if parity is not None:
        out.parity_chunks = sized_int.parity_chunk_count(parity)
    rules = _zone_rules_obj(hollow)
    if rules:
        for zone, rule in rules.items():
            if rule is None:
                out.zone_rules.pop(zone, None)
            else:
                out.zone_rules[zone] = ZoneRule.from_obj(rule)
    if "code" in hollow:
        # null removes the inherited pin (back to the env default),
        # mirroring the zone-rule null semantics
        out.code = (None if hollow["code"] is None
                    else _validated_code(hollow["code"], out))
    elif out.code is not None:
        # an inherited explicit code must still fit the merged
        # geometry — a custom profile that widens data past the
        # default's pm-msr parity budget is a config error, not a
        # silent fallback (explicit pins are guarantees)
        err = _code_geometry_error(out.code, out)
        if err is not None:
            raise SerdeError(
                f"profile inherits code {out.code!r} but its geometry "
                f"cannot run it: {err}")
    return out
