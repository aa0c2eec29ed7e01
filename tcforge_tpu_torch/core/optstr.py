# Copied from tcforge_tpu/core/optstr.py; only the package name in its imports differs.
"""Module option-string parsing and self-describing parameter metadata.

Re-implementation of ``libtcutil/optstr.[ch]`` semantics:

- an option string is ``name=value`` pairs separated by ``:``
  (e.g. ``luma=4.0:chroma=3.0:pre=1``); bare names act as boolean flags
  (``optstr_lookup``);
- modules describe their parameters with typed metadata
  (``optstr_param``, ``optstr.h:75-206``) which powers runtime
  introspection (the socket ``parameters <filter>`` command,
  ``src/socket.c``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union


class OptStrError(ValueError):
    pass


def parse_optstr(options: Optional[str]) -> Dict[str, str]:
    """Split ``a=1:b=2:flag`` into {'a': '1', 'b': '2', 'flag': ''}.

    Values may contain '=' after the first one.  Empty segments are
    ignored.  Order is preserved (dicts are ordered).
    """
    out: Dict[str, str] = {}
    if not options:
        return out
    for seg in options.split(":"):
        seg = seg.strip()
        if not seg:
            continue
        if "=" in seg:
            k, v = seg.split("=", 1)
            out[k.strip()] = v.strip()
        else:
            out[seg] = ""
    return out


def lookup(options: Optional[str], name: str) -> bool:
    """optstr_lookup: is `name` present (as flag or key)?"""
    return name in parse_optstr(options)


_PAIR_RE = re.compile(r"^(-?\d+)\s*[xX]\s*(-?\d+)$")
_QUAD_RE = re.compile(r"^(-?\d+)\s*,\s*(-?\d+)\s*,\s*(-?\d+)\s*,\s*(-?\d+)$")
_RANGE_RE = re.compile(r"^(\d+)\s*-\s*(\d+|oo)$")


def get_value(options: Optional[str], name: str, typ: str = "s",
              default: Any = None) -> Any:
    """optstr_get analogue with a type letter instead of scanf format:

    's' str | 'd' int | 'f' float | 'b' bool | 'dxd' int pair |
    '4d' 4 comma-separated ints | 'd-d' frame range "start-end"
    (end may be "oo" for unbounded, optstr.h range params).
    Returns `default` when absent or unparsable (the reference leaves the
    output variable untouched in that case).
    """
    opts = parse_optstr(options)
    if name not in opts:
        return default
    raw = opts[name]
    try:
        if typ == "s":
            return raw
        if typ == "d":
            return int(raw, 0)
        if typ == "f":
            return float(raw)
        if typ == "b":
            if raw in ("", "1", "yes", "on", "true"):
                return True
            if raw in ("0", "no", "off", "false"):
                return False
            return default
        if typ == "dxd":
            m = _PAIR_RE.match(raw)
            if not m:
                return default
            return (int(m.group(1)), int(m.group(2)))
        if typ == "4d":
            m = _QUAD_RE.match(raw)
            if not m:
                return default
            return tuple(int(g) for g in m.groups())
        if typ == "d-d":
            m = _RANGE_RE.match(raw)
            if not m:
                return default
            end = m.group(2)
            return (int(m.group(1)),
                    (1 << 30) if end == "oo" else int(end))
        if typ == "d-d/d":
            # "start-end/step" ("%u-%u/%d" range params, e.g.
            # filter_barrel.c:190); step optional, end may be "oo"
            body, _, step = raw.partition("/")
            m = _RANGE_RE.match(body)
            if not m:
                return default
            end = m.group(2)
            return (int(m.group(1)),
                    (1 << 30) if end == "oo" else int(end),
                    int(step) if step else 1)
        if typ == "d/d":
            # "x/y" pair (e.g. filter_barrel.c center)
            a, sep, b = raw.partition("/")
            if not sep:
                return default
            return (int(a), int(b))
    except (TypeError, ValueError):
        return default
    raise OptStrError(f"unknown optstr type {typ!r}")


def format_optstr(values: Dict[str, Any]) -> str:
    """Inverse of parse_optstr (pairs joined by ':')."""
    parts = []
    for k, v in values.items():
        if v is None or v == "":
            parts.append(str(k))
        elif isinstance(v, tuple):
            parts.append(f"{k}={'x'.join(str(x) for x in v)}")
        elif isinstance(v, bool):
            parts.append(f"{k}={int(v)}")
        else:
            parts.append(f"{k}={v}")
    return ":".join(parts)


# --------------------------------------------------------------------- #
# Self-describing parameter metadata (optstr_param analogue)


@dataclass(frozen=True)
class ParamSpec:
    """One module parameter description (optstr.h:140-206)."""

    name: str
    help: str
    fmt: str                      # 'd', 'f', 's', 'b', 'dxd', '4d'
    default: Any = None
    lo: Optional[float] = None
    hi: Optional[float] = None

    def describe(self) -> str:
        rng = ""
        if self.lo is not None or self.hi is not None:
            rng = f" [{self.lo}..{self.hi}]"
        return f"{self.name} ({self.fmt}) = {self.default!r}{rng}: {self.help}"

    def validate(self, value: Any) -> Any:
        if value is None:
            return self.default
        if self.fmt in ("d", "f") and (self.lo is not None
                                       or self.hi is not None):
            v = float(value)
            if self.lo is not None and v < self.lo:
                raise OptStrError(
                    f"{self.name}={value} below minimum {self.lo}")
            if self.hi is not None and v > self.hi:
                raise OptStrError(
                    f"{self.name}={value} above maximum {self.hi}")
        return value


@dataclass
class ModuleDesc:
    """Module self-description block (optstr_filter_desc analogue)."""

    name: str
    comment: str
    version: str = "0.1.0"
    author: str = "tcforge_tpu"
    capabilities: str = "V"      # V video, A audio, Y YUV, R RGB, M multiple
    frames_needed: int = 1
    params: List[ParamSpec] = field(default_factory=list)

    def param(self, name: str) -> Optional[ParamSpec]:
        for p in self.params:
            if p.name == name:
                return p
        return None

    def parse_options(self, options: Optional[str]) -> Dict[str, Any]:
        """Parse an option string against the declared parameters,
        returning a dict with defaults filled in.  Unknown keys (other
        than 'help') raise."""
        raw = parse_optstr(options)
        out: Dict[str, Any] = {}
        for p in self.params:
            if p.name in raw:
                val = get_value(options, p.name, p.fmt, default=p.default)
                out[p.name] = p.validate(val)
            else:
                out[p.name] = p.default
        for key in raw:
            if key != "help" and self.param(key) is None:
                raise OptStrError(
                    f"{self.name}: unknown option {key!r} "
                    f"(known: {[p.name for p in self.params]})")
        return out

    def describe(self) -> str:
        lines = [f"{self.name} v{self.version}: {self.comment} "
                 f"[{self.capabilities}]"]
        lines += ["  " + p.describe() for p in self.params]
        return "\n".join(lines)
