"""Caps (capabilities) — typed stream descriptions with negotiation.

The reference rides GStreamer's GstCaps: media types ``other/tensor(s)``,
``video/x-raw``, ``audio/x-raw``, ``text/x-raw``, ``application/octet-stream``
with per-field values that may be concrete, lists of alternatives, or ranges
(GST_TENSORS_CAP_MAKE, tensor_typedef.h:59-132). We own the pipeline core, so
we implement the same negotiation semantics directly: a ``Caps`` is a list of
``Structure``s (media type + fields); fields hold a concrete value, a list of
alternatives, an ``IntRange``, or are absent (= unrestricted). ``intersect``
narrows, ``fixate`` picks concrete values, and elements negotiate by
intersecting their pad templates with upstream's proposal — the same model as
GstBaseTransform's transform_caps/fixate_caps used by tensor_filter
(tensor_filter.c:1151,1274).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from nnstreamer_tpu_torch.types import (
    TensorFormat,
    TensorsConfig,
    TensorsInfo,
    dimension_compatible,
    parse_dimension,
)

# media types (tensor_typedef.h:59-60 + media caps handled by tensor_converter)
MT_TENSOR = "other/tensor"
MT_TENSORS = "other/tensors"
MT_VIDEO = "video/x-raw"
MT_AUDIO = "audio/x-raw"
MT_TEXT = "text/x-raw"
MT_OCTET = "application/octet-stream"
MT_ANY = "ANY"

#: the device-residency caps feature (GstCapsFeatures "memory:NVMM"-style
#: analogue): a structure carrying it describes a stream whose buffers are
#: device-resident tensors, stamped by the residency planner on
#: negotiated device edges. Feature-less caps are residency-agnostic (they
#: intersect with anything — host consumers materialize implicitly).
FEATURE_MEMORY_HBM = "memory:HBM"


@dataclass(frozen=True)
class IntRange:
    lo: int
    hi: int  # inclusive

    def intersect(self, other: "IntRange") -> Optional["IntRange"]:
        lo, hi = max(self.lo, other.lo), min(self.hi, other.hi)
        return IntRange(lo, hi) if lo <= hi else None

    def contains(self, v: int) -> bool:
        return self.lo <= v <= self.hi

    def fixate(self, target: Optional[int] = None) -> int:
        if target is not None:
            return min(max(target, self.lo), self.hi)
        return self.lo


FieldValue = Union[int, str, Fraction, IntRange, Tuple[Any, ...], List[Any]]


def _as_alternatives(v: FieldValue) -> Optional[List[Any]]:
    if isinstance(v, (list, tuple)):
        return list(v)
    return None


def _value_intersect(a: FieldValue, b: FieldValue) -> Tuple[bool, Optional[FieldValue]]:
    """Returns (ok, narrowed). Handles concrete / list / IntRange combos."""
    la, lb = _as_alternatives(a), _as_alternatives(b)
    if isinstance(a, IntRange) and isinstance(b, IntRange):
        r = a.intersect(b)
        return (r is not None, r)
    if isinstance(a, IntRange):
        if lb is not None:
            vals = [v for v in lb if isinstance(v, int) and a.contains(v)]
            return _collapse(vals)
        return (isinstance(b, int) and a.contains(b), b)
    if isinstance(b, IntRange):
        return _value_intersect(b, a)
    if la is not None and lb is not None:
        vals = [v for v in la if v in lb]
        return _collapse(vals)
    if la is not None:
        return (b in la, b)
    if lb is not None:
        return (a in lb, a)
    return (a == b, a)


def _collapse(vals: List[Any]) -> Tuple[bool, Optional[FieldValue]]:
    if not vals:
        return (False, None)
    if len(vals) == 1:
        return (True, vals[0])
    return (True, vals)


@dataclass
class Structure:
    """One caps alternative: a media type plus constrained fields, plus an
    optional caps-feature set (``other/tensors(memory:HBM)`` grammar —
    GstCapsFeatures parity). An empty feature set is lenient: it
    intersects with any featured structure and adopts its features."""

    media_type: str
    fields: Dict[str, FieldValue] = field(default_factory=dict)
    features: Tuple[str, ...] = ()

    def intersect(self, other: "Structure") -> Optional["Structure"]:
        if self.media_type != other.media_type:
            if MT_ANY not in (self.media_type, other.media_type):
                # other/tensor is a 1-tensor other/tensors in practice
                pair = {self.media_type, other.media_type}
                if pair != {MT_TENSOR, MT_TENSORS}:
                    return None
            mt = self.media_type if other.media_type == MT_ANY else other.media_type
            if MT_TENSORS in (self.media_type, other.media_type) and MT_ANY not in (
                self.media_type,
                other.media_type,
            ):
                mt = MT_TENSORS
        else:
            mt = self.media_type
        if self.features and other.features:
            feats = tuple(f for f in self.features if f in other.features)
            if not feats:
                return None
        else:
            feats = self.features or other.features
        out: Dict[str, FieldValue] = {}
        keys = set(self.fields) | set(other.fields)
        for k in keys:
            if k in self.fields and k in other.fields:
                if k == "dimensions":
                    ok, v = _dims_field_intersect(self.fields[k], other.fields[k])
                else:
                    ok, v = _value_intersect(self.fields[k], other.fields[k])
                if not ok:
                    return None
                out[k] = v
            else:
                out[k] = self.fields.get(k, other.fields.get(k))
        return Structure(mt, out, feats)

    def is_fixed(self) -> bool:
        if self.media_type == MT_ANY:
            return False
        for k, v in self.fields.items():
            if isinstance(v, (IntRange, list, tuple)):
                return False
            if k == "dimensions" and isinstance(v, str) and _dims_has_wildcard(v):
                return False
        return True

    def fixate(self) -> "Structure":
        out = {}
        for k, v in self.fields.items():
            if isinstance(v, IntRange):
                out[k] = v.fixate()
            elif isinstance(v, (list, tuple)):
                out[k] = v[0]
            else:
                out[k] = v
        return Structure(self.media_type, out, self.features)

    def __str__(self) -> str:
        mt = self.media_type
        if self.features:
            mt = f"{mt}({','.join(self.features)})"
        if not self.fields:
            return mt
        fs = ",".join(f"{k}={_value_to_string(v)}" for k, v in sorted(self.fields.items()))
        return f"{mt},{fs}"


def _dims_has_wildcard(dims_str: str) -> bool:
    return any(0 in parse_dimension(d) for d in dims_str.split(".") if d.strip())


def _dims_field_intersect(a: FieldValue, b: FieldValue) -> Tuple[bool, Optional[FieldValue]]:
    """'dimensions' strings support 0-wildcards per component."""
    if isinstance(a, str) and isinstance(b, str):
        pa, pb = a.split("."), b.split(".")
        if len(pa) != len(pb):
            return (False, None)
        out = []
        for da, db in zip(pa, pb):
            ta, tb = parse_dimension(da), parse_dimension(db)
            if not dimension_compatible(ta, tb):
                return (False, None)
            n = max(len(ta), len(tb))
            ta = tuple(ta) + (1,) * (n - len(ta))
            tb = tuple(tb) + (1,) * (n - len(tb))
            merged = tuple(x if x > 0 else y for x, y in zip(ta, tb))
            out.append(":".join(str(d) for d in merged))
        return (True, ".".join(out))
    return _value_intersect(a, b)


class Caps:
    """An ordered list of Structure alternatives (preference order)."""

    def __init__(self, structures: Union[str, Structure, Sequence[Structure], None] = None):
        if structures is None:
            self.structures: List[Structure] = []
        elif isinstance(structures, str):
            self.structures = Caps.from_string(structures).structures
        elif isinstance(structures, Structure):
            self.structures = [structures]
        else:
            self.structures = list(structures)

    # -- constructors ------------------------------------------------------
    @staticmethod
    def any_() -> "Caps":
        return Caps(Structure(MT_ANY))

    @staticmethod
    def new_empty() -> "Caps":
        return Caps()

    @staticmethod
    def from_string(s: str) -> "Caps":
        """Parse ``media/type,k=v,k=v;media/type2,...``. Values: int, fraction
        ``n/d``, ``[lo,hi]`` int range, ``{a,b,c}`` list, else string."""
        structs = []
        for part in s.split(";"):
            part = part.strip()
            if not part:
                continue
            if part == MT_ANY:
                structs.append(Structure(MT_ANY))
                continue
            toks = _split_top(part, ",")
            mt = toks[0].strip()
            feats: Tuple[str, ...] = ()
            if mt.endswith(")") and "(" in mt:
                mt, _, ftok = mt.partition("(")
                feats = tuple(
                    f.strip() for f in ftok[:-1].split(",") if f.strip())
            fields: Dict[str, FieldValue] = {}
            for tok in toks[1:]:
                if "=" not in tok:
                    continue
                k, v = tok.split("=", 1)
                k = k.strip()
                # string-grammar fields must not be numerically coerced
                # ("dimensions=4" is the dim string "4", not the int 4)
                if k in ("dimensions", "types", "names"):
                    fields[k] = v.strip()
                else:
                    fields[k] = _parse_value(v.strip())
            structs.append(Structure(mt, fields, feats))
        return Caps(structs)

    @staticmethod
    def from_config(config: TensorsConfig) -> "Caps":
        """TensorsConfig → other/tensors caps
        (gst_tensor_pad_caps_from_config in nnstreamer_plugin_api_impl.c)."""
        info = config.info
        fields: Dict[str, FieldValue] = {"format": info.format.value}
        if info.format == TensorFormat.STATIC and info.num_tensors > 0:
            fields["num_tensors"] = info.num_tensors
            fields["dimensions"] = info.dimensions_string()
            fields["types"] = info.types_string()
        if config.rate_n >= 0 and config.rate_d > 0:
            fields["framerate"] = Fraction(config.rate_n, config.rate_d)
        elif config.rate_n == 0:
            fields["framerate"] = Fraction(0, 1)
        return Caps(Structure(MT_TENSORS, fields))

    def to_config(self) -> TensorsConfig:
        """Fixed other/tensors caps → TensorsConfig
        (gst_tensors_config_from_caps in nnstreamer_plugin_api_impl.c)."""
        if not self.structures:
            raise ValueError("empty caps")
        s = self.structures[0]
        if s.media_type not in (MT_TENSOR, MT_TENSORS):
            raise ValueError(f"not tensor caps: {s.media_type}")
        fmt = TensorFormat(s.fields.get("format", "static"))
        if fmt == TensorFormat.STATIC and "dimensions" in s.fields:
            if "types" not in s.fields:
                raise ValueError(f"static caps carry dimensions but no types: {s}")
            info = TensorsInfo.from_strings(
                s.fields["dimensions"], s.fields["types"], s.fields.get("names"),
                format=fmt,
            )
        else:
            info = TensorsInfo(format=fmt)
        rate = s.fields.get("framerate")
        if isinstance(rate, Fraction):
            rate_n, rate_d = rate.numerator, rate.denominator
            if rate_n == 0:
                rate_d = 1
        elif rate is None:
            rate_n, rate_d = -1, -1
        else:
            rate_n, rate_d = int(rate), 1
        return TensorsConfig(info=info, rate_n=rate_n, rate_d=rate_d)

    # -- algebra -----------------------------------------------------------
    def intersect(self, other: "Caps") -> "Caps":
        out: List[Structure] = []
        for a in self.structures:
            for b in other.structures:
                r = a.intersect(b)
                if r is not None:
                    out.append(r)
        return Caps(out)

    def is_empty(self) -> bool:
        return not self.structures

    def is_any(self) -> bool:
        return any(s.media_type == MT_ANY and not s.fields for s in self.structures)

    def is_fixed(self) -> bool:
        return len(self.structures) == 1 and self.structures[0].is_fixed()

    def can_intersect(self, other: "Caps") -> bool:
        return not self.intersect(other).is_empty()

    def fixate(self) -> "Caps":
        if not self.structures:
            return self
        return Caps(self.structures[0].fixate())

    # -- caps features (residency lane) -------------------------------------
    def with_feature(self, feature: str) -> "Caps":
        """New Caps with ``feature`` added to every structure (the planner
        stamps negotiated device edges with :data:`FEATURE_MEMORY_HBM`)."""
        return Caps([
            Structure(s.media_type, dict(s.fields),
                      s.features if feature in s.features
                      else s.features + (feature,))
            for s in self.structures
        ])

    def has_feature(self, feature: str) -> bool:
        return any(feature in s.features for s in self.structures)

    def is_device_resident(self) -> bool:
        """True when these caps describe an HBM-resident stream."""
        return self.has_feature(FEATURE_MEMORY_HBM)

    def __str__(self) -> str:
        if not self.structures:
            return "EMPTY"
        return ";".join(str(s) for s in self.structures)

    def __repr__(self) -> str:
        return f"Caps({str(self)!r})"

    def __eq__(self, other) -> bool:
        if not isinstance(other, Caps):
            return NotImplemented
        return str(self) == str(other)


def _value_to_string(v: FieldValue) -> str:
    """Render a field value so Caps.from_string can reparse it."""
    if isinstance(v, IntRange):
        return f"[{v.lo},{v.hi}]"
    if isinstance(v, (list, tuple)):
        return "{" + ",".join(_value_to_string(x) for x in v) + "}"
    if isinstance(v, Fraction):
        return f"{v.numerator}/{v.denominator}"
    return str(v)


def _split_top(s: str, sep: str) -> List[str]:
    """Split on sep, ignoring separators inside {} or []."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch in "{[(":
            depth += 1
        elif ch in "}])":
            depth -= 1
        if ch == sep and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out


def _parse_value(v: str) -> FieldValue:
    if v.startswith("{") and v.endswith("}"):
        return [_parse_value(x.strip()) for x in _split_top(v[1:-1], ",")]
    if v.startswith("[") and v.endswith("]"):
        lo, hi = v[1:-1].split(",")
        return IntRange(int(lo), int(hi))
    if "/" in v:
        try:
            n, d = v.split("/")
            return Fraction(int(n), int(d))
        except ValueError:
            pass
    # strip gst-style type annotations like (string)x
    if v.startswith("(") and ")" in v:
        v = v[v.index(")") + 1:]
    try:
        return int(v)
    except ValueError:
        return v
