"""Property schemas: every element declares what it understands.

Each element class carries a ``PROPERTY_SCHEMA`` dict mapping normalized
property names (underscores, as stored in ``Element.properties``) to a
:class:`Prop` spec. Schemas merge over the MRO, so the :class:`Element`
base contributes the common properties (``on-error``, ``config-file``, …)
once and subclasses only add their own.

The schema is consumed in two places: ``pipeline/parse.py`` checks each
``key=value`` token at parse time (a typo'd ``feed-dept=2`` becomes an
``NNST100`` diagnostic instead of a silent no-op), and the analyzer's
properties pass re-checks a constructed pipeline whatever API built it.

Deliberately import-light: dataclasses + difflib only, so element modules
can import it without cycles.
"""

from __future__ import annotations

import difflib
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

#: value kinds the checker understands. 'str' accepts any scalar (many
#: reference properties are stringly-typed grammars); 'number' is int or
#: float; 'caps' accepts a caps string or a Caps object; 'any' is a hole.
KINDS = ("str", "int", "float", "number", "bool", "enum", "caps", "any")


@dataclass(frozen=True)
class Prop:
    """Schema entry for one element property."""

    kind: str = "str"
    enum: Tuple[str, ...] = ()
    required: bool = False
    #: value → error message (or None); for grammar-valued properties
    #: (``on-error=retry:<N>`` etc.) that a kind check can't cover
    validate: Optional[Callable] = None
    doc: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown Prop kind {self.kind!r}")


def schema_for(cls) -> dict:
    """Merged schema over the class MRO (subclass entries win)."""
    out: dict = {}
    for c in reversed(cls.__mro__):
        own = c.__dict__.get("PROPERTY_SCHEMA")
        if own:
            out.update(own)
    return out


def check_value(spec: Prop, value) -> Optional[Tuple[str, str]]:
    """Check one coerced property value against its spec. Returns
    ``(code, message)`` — NNST101 mistyped / NNST102 bad enum / NNST103
    validator-rejected — or None when the value is fine."""
    k = spec.kind
    if k == "enum":
        allowed = {e.lower() for e in spec.enum}
        if isinstance(value, bool):
            # parse-time coercion may have eaten an enum literal that
            # doubles as a boolean ('no' → False, 'true' → True): accept
            # when an allowed literal has the same boolean sense
            sense = {"1", "true", "yes", "on"} if value \
                else {"0", "false", "no", "off"}
            if not allowed & sense:
                return ("NNST102",
                        f"invalid value {value!r} "
                        f"(one of: {', '.join(spec.enum)})")
        elif str(value).strip().lower() not in allowed:
            return ("NNST102",
                    f"invalid value {value!r} (one of: {', '.join(spec.enum)})")
    elif k == "int":
        if isinstance(value, float) or not isinstance(value, (int, bool)):
            return ("NNST101", f"expected an integer, got {value!r}")
    elif k in ("float", "number"):
        if not isinstance(value, (int, float, bool)):
            return ("NNST101", f"expected a number, got {value!r}")
    elif k == "bool":
        if not (isinstance(value, (bool, int))
                or str(value).strip().lower() in (
                    "true", "false", "yes", "no", "0", "1")):
            return ("NNST101", f"expected a boolean, got {value!r}")
    elif k == "caps":
        if not (isinstance(value, str) or hasattr(value, "structures")):
            return ("NNST101", f"expected caps, got {value!r}")
    # 'str' / 'any': every scalar is acceptable
    if spec.validate is not None:
        err = spec.validate(value)
        if err:
            return ("NNST103", err)
    return None


def closest_key(key: str, schema: dict) -> Optional[str]:
    """did-you-mean candidate for an unknown property name."""
    hits = difflib.get_close_matches(key, list(schema), n=1, cutoff=0.6)
    return hits[0] if hits else None
