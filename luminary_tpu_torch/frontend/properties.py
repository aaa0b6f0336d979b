"""Terminal property editor, the Mandarin Duck property-window counterpart.

The port of ``luminary_tpu/frontend/properties.py``, over the port's Host
(``host/host.py``); pure Python, on whichever device the Host renders. The
reference frontend edits entity properties through typed UI elements
(reference: src/mandarin_duck/windows/*, elements/* — checkboxes, sliders
and float inputs bound to LuminaryCamera/Sky/Ocean/... fields). This is the
terminal-native re-design: a declarative registry of editable fields per
entity, a cursor-driven panel rendered as ANSI text lines under the
viewport, and every edit routed through the ordinary Host get/set entity
API, so that the dirty-flag machinery restarts accumulation as any other
mutation does.

Keys (routed by the viewer when the panel is open):
    e       toggle the panel
    [ / ]   previous / next entity page
    up/down (or p/n)  select field
    left/right (or ,/.)  decrement / increment (step x10 with < / >)
    space   toggle booleans / cycle enums
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import Any

_CSI = "\x1b["


@dataclass
class Prop:
    """One editable field: scalar float/int/bool/enum or a vec component."""

    label: str
    attr: str
    kind: str = "float"  # float | int | bool | enum | vec3
    step: float = 0.1
    lo: float = float("-inf")
    hi: float = float("inf")
    index: int | None = None  # for vec3 components
    enum: type | None = None


# entity name (the Host's get_/set_ suffix) to its editable fields; mirrors
# the reference's window layouts (windows/caption controls per entity).
PROPERTY_REGISTRY: dict[str, list[Prop]] = {
    "camera": [
        Prop("pos.x", "pos", "vec3", 0.5, index=0),
        Prop("pos.y", "pos", "vec3", 0.5, index=1),
        Prop("pos.z", "pos", "vec3", 0.5, index=2),
        Prop("rot.x", "rotation", "vec3", 0.05, index=0),
        Prop("rot.y", "rotation", "vec3", 0.05, index=1),
        Prop("exposure", "exposure", "float", 0.25, 0.001, 64.0),
        Prop("bloom", "bloom_blend", "float", 0.02, 0.0, 1.0),
        Prop("film grain", "film_grain", "float", 0.02, 0.0, 1.0),
        Prop("purkinje", "purkinje", "bool"),
    ],
    "sky": [
        Prop("azimuth", "azimuth", "float", 0.1, -7.0, 7.0),
        Prop("altitude", "altitude", "float", 0.05, -1.6, 1.6),
        Prop("sun strength", "sun_strength", "float", 0.1, 0.0, 100.0),
        Prop("density", "base_density", "float", 0.05, 0.0, 10.0),
        Prop("ozone", "ozone_absorption", "bool"),
        Prop("stars count", "stars_count", "int", 1000, 0, 100000),
    ],
    "ocean": [
        Prop("active", "active", "bool"),
        Prop("height", "height", "float", 0.25),
        Prop("amplitude", "amplitude", "float", 0.05, 0.0, 10.0),
        Prop("frequency", "frequency", "float", 0.02, 0.001, 10.0),
        Prop("ior", "refractive_index", "float", 0.01, 1.0, 3.0),
        Prop("caustics", "caustics_active", "bool"),
        Prop("tessellated", "tessellated", "bool"),
    ],
    "fog": [
        Prop("active", "active", "bool"),
        Prop("density", "density", "float", 5.0, 0.0, 1000.0),
        Prop("height", "height", "float", 0.5, 0.0, 1000.0),
        Prop("distance", "dist", "float", 5.0, 0.0, 1000.0),
    ],
    "cloud": [
        Prop("active", "active", "bool"),
        Prop("density", "density", "float", 0.1, 0.0, 10.0),
        Prop("coverage low", "low.coverage", "float", 0.05, 0.0, 2.0),
        Prop("coverage mid", "mid.coverage", "float", 0.05, 0.0, 2.0),
    ],
    "particles": [
        Prop("active", "active", "bool"),
        Prop("count", "count", "int", 512, 0, 1 << 20),
        Prop("scale", "scale", "float", 1.0, 0.1, 1000.0),
        Prop("size", "size", "float", 1.0, 0.01, 1000.0),
        Prop("speed", "speed", "float", 5.0, 0.0, 10000.0),
        Prop("phase diam", "phase_diameter", "float", 1.0, 0.01, 50.0),
    ],
    "settings": [
        Prop("max depth", "max_ray_depth", "int", 1, 1, 16),
        Prop("supersample", "supersampling", "int", 1, 1, 4),
        Prop("RIS K", "light_ris_candidates", "int", 1, 1, 8),
        Prop("bridges M", "bridge_max_num_vertices", "int", 1, 1, 4),
        Prop("ambient NEE", "ambient_nee", "bool"),
        Prop("sun RIS", "sun_ris", "bool"),
        Prop("spectral", "spectral_rendering", "bool"),
        Prop("aerial", "aerial_perspective", "bool"),
        Prop("adaptive", "enable_adaptive_sampling", "bool"),
    ],
}

ENTITY_ORDER = list(PROPERTY_REGISTRY)


def _get(obj: Any, attr: str) -> Any:
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def _set(obj: Any, attr: str, value: Any) -> None:
    parts = attr.split(".")
    for part in parts[:-1]:
        obj = getattr(obj, part)
    setattr(obj, parts[-1], value)


class PropertyPanel:
    """Cursor state + edit application over the Host entity API."""

    def __init__(self) -> None:
        self.open = False
        self.entity_i = 0
        self.field_i = 0

    @property
    def entity(self) -> str:
        return ENTITY_ORDER[self.entity_i]

    @property
    def props(self) -> list[Prop]:
        return PROPERTY_REGISTRY[self.entity]

    def handle_key(self, key: str, host) -> bool:
        """True when the key was consumed (the panel is open, or ``e``)."""
        if key == "e":
            self.open = not self.open
            return True
        if not self.open:
            return False
        if key == "[":
            self.entity_i = (self.entity_i - 1) % len(ENTITY_ORDER)
            self.field_i = 0
        elif key == "]":
            self.entity_i = (self.entity_i + 1) % len(ENTITY_ORDER)
            self.field_i = 0
        elif key in ("p", "A"):  # A / B: the tails of the arrow escapes
            self.field_i = (self.field_i - 1) % len(self.props)
        elif key in ("n", "B"):
            self.field_i = (self.field_i + 1) % len(self.props)
        elif key in (",", "D", "<"):
            self._adjust(host, -1.0, big=key == "<")
        elif key in (".", "C", ">"):
            self._adjust(host, +1.0, big=key == ">")
        elif key == " ":
            self._toggle(host)
        else:
            return False
        return True

    # -- edits ---------------------------------------------------------------

    def _entity_rw(self, host):
        get = getattr(host, f"get_{self.entity}")
        put = getattr(host, f"set_{self.entity}")
        return get(), put

    def _adjust(self, host, sign: float, big: bool = False) -> None:
        p = self.props[self.field_i]
        ent, put = self._entity_rw(host)
        step = p.step * (10.0 if big else 1.0) * sign
        if p.kind == "vec3":
            vec = list(_get(ent, p.attr))
            vec[p.index] = float(vec[p.index]) + step
            _set(ent, p.attr, tuple(vec))
        elif p.kind == "int":
            cur = int(_get(ent, p.attr))
            _set(ent, p.attr, int(min(max(cur + int(step), p.lo), p.hi)))
        elif p.kind == "bool":
            self._toggle(host)
            return
        else:
            cur = float(_get(ent, p.attr))
            _set(ent, p.attr, float(min(max(cur + step, p.lo), p.hi)))
        put(ent)

    def _toggle(self, host) -> None:
        p = self.props[self.field_i]
        ent, put = self._entity_rw(host)
        cur = _get(ent, p.attr)
        if p.kind == "bool":
            _set(ent, p.attr, not bool(cur))
        elif isinstance(cur, IntEnum):
            vals = list(type(cur))
            _set(ent, p.attr, vals[(vals.index(cur) + 1) % len(vals)])
        put(ent)

    # -- rendering -----------------------------------------------------------

    def render(self, host, width: int = 44) -> list[str]:
        """ANSI panel lines (selection inverted) for the viewer footer."""
        if not self.open:
            return []
        ent, _ = self._entity_rw(host)
        title = (f"{_CSI}1m[{self.entity}]{_CSI}0m  "
                 f"[/ ] entity  p/n field  ,/. edit  space toggle")
        lines = [title]
        for i, p in enumerate(self.props):
            val = _get(ent, p.attr)
            if p.kind == "vec3":
                val = float(val[p.index])
            if isinstance(val, bool):
                txt = "on" if val else "off"
            elif isinstance(val, float):
                txt = f"{val:.4g}"
            else:
                txt = str(val)
            row = f" {p.label:<14} {txt:>12} "
            if i == self.field_i:
                row = f"{_CSI}7m{row}{_CSI}0m"
            lines.append(row[: width + 16])
        return lines
