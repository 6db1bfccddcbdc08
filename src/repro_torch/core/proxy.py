"""Auto-generated Python proxies + YAML round-trip (paper §3.1), the
port's copy of ``repro.core.proxy``: the same proxies and the same YAML
text, over the port's configs, building a port ``Simulator``.

Ramulator 2.1 auto-generates Python proxy classes for every C++ simulator
component; proxies are *lightweight structured objects* that mirror the
component hierarchy and hold configuration without binding to the live
engine.  A tool converts a proxy tree into an equivalent pure-text YAML
file so non-Python embedders can drive the simulator.

Here the "components" are the engine's config dataclasses and the standard
registry.  Proxies are generated *automatically* by introspecting the
component registry — adding a new component (or a field to one) requires no
manual proxy maintenance, matching the paper's build-time generation.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Any

from repro_torch.core import spec as S
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.frontend import FrontendConfig

# --------------------------------------------------------------------------
# Component registry: every configurable engine component registers here.
# --------------------------------------------------------------------------

COMPONENTS: dict = {
    "Controller": ControllerConfig,
    "Frontend": FrontendConfig,
}


def _proxy_for(name: str, cls) -> type:
    """Generate a proxy class mirroring a component's config fields."""
    fields = {f.name: f for f in dataclasses.fields(cls)}

    def __init__(self, **kw):
        for k in kw:
            if k not in fields:
                raise TypeError(f"{name}: unknown parameter {k!r}; "
                                f"valid: {sorted(fields)}")
        for f in fields.values():
            if f.name in kw:
                v = kw[f.name]
            elif f.default is not dataclasses.MISSING:
                v = f.default
            elif f.default_factory is not dataclasses.MISSING:  # type: ignore
                v = f.default_factory()                          # type: ignore
            else:
                raise TypeError(f"{name}: missing parameter {f.name!r}")
            setattr(self, f.name, v)

    def params(self):
        return {f: getattr(self, f) for f in fields}

    def build(self):
        return cls(**{f: getattr(self, f) for f in fields
                      if not str(f).startswith("_")})

    def __repr__(self):
        body = ", ".join(f"{k}={getattr(self, k)!r}" for k in fields)
        return f"{name}({body})"

    return type(name, (), {
        "__init__": __init__, "params": params, "build": build,
        "__repr__": __repr__, "_component_cls": cls,
        "_fields": tuple(fields),
    })


def generate_proxies(module_name: str = __name__) -> dict:
    """Generate proxies for every registered component (build-time step)."""
    mod = sys.modules[module_name]
    out = {}
    for name, cls in COMPONENTS.items():
        proxy = _proxy_for(name, cls)
        setattr(mod, name, proxy)
        out[name] = proxy
    return out


PROXIES = generate_proxies()


class System:
    """Top-level proxy composing the simulated system (paper Fig: frontend ->
    controller -> device).  ``build()`` returns a live port ``Simulator``
    on ``device`` (``None``: the card; ``"cpu"`` for tests)."""

    def __init__(self, standard: str, org_preset: str, timing_preset: str,
                 controller=None, frontend=None, n_cycles: int = 100_000,
                 timing_overrides: dict | None = None, channels: int = 1):
        S.get_standard(standard)   # validate early
        self.standard = standard
        self.org_preset = org_preset
        self.timing_preset = timing_preset
        self.controller = controller or PROXIES["Controller"]()
        self.frontend = frontend or PROXIES["Frontend"]()
        self.n_cycles = n_cycles
        self.timing_overrides = timing_overrides or {}
        self.channels = int(channels)

    def build(self, device=None):
        from repro_torch.core.engine import Simulator
        return Simulator(self.standard, self.org_preset, self.timing_preset,
                         controller=self.controller.build(),
                         frontend=self.frontend.build(),
                         timing_overrides=self.timing_overrides or None,
                         channels=self.channels, device=device)

    # ---- YAML round-trip ---------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "standard": self.standard,
            "org_preset": self.org_preset,
            "timing_preset": self.timing_preset,
            "n_cycles": self.n_cycles,
            "channels": self.channels,
            "timing_overrides": dict(self.timing_overrides),
            "Controller": _plain(self.controller.params()),
            "Frontend": _plain(self.frontend.params()),
        }

    def to_yaml(self) -> str:
        return emit_yaml(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict) -> "System":
        ctrl = PROXIES["Controller"](**d.get("Controller", {}))
        front = PROXIES["Frontend"](**d.get("Frontend", {}))
        return cls(d["standard"], d["org_preset"], d["timing_preset"],
                   controller=ctrl, frontend=front,
                   n_cycles=int(d.get("n_cycles", 100_000)),
                   timing_overrides=d.get("timing_overrides") or {},
                   channels=int(d.get("channels", 1)))

    @classmethod
    def from_yaml(cls, text: str) -> "System":
        return cls.from_dict(parse_yaml(text))


def _plain(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, tuple):
            v = list(v)
        if k == "extra_predicates":       # callables are not serializable
            v = []
        out[k] = v
    return out


# --------------------------------------------------------------------------
# Minimal YAML (emit always; parse via pyyaml when present, else built-in
# subset parser — keeps the pure-text path dependency-free, paper §3.1).
# --------------------------------------------------------------------------

def emit_yaml(d: dict, indent: int = 0) -> str:
    pad = "  " * indent
    lines = []
    for k, v in d.items():
        if isinstance(v, dict):
            lines.append(f"{pad}{k}:")
            lines.append(emit_yaml(v, indent + 1))
        elif isinstance(v, (list, tuple)):
            lines.append(f"{pad}{k}: [{', '.join(_scalar(x) for x in v)}]")
        else:
            lines.append(f"{pad}{k}: {_scalar(v)}")
    return "\n".join(x for x in lines if x)


def _scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    return str(v)


def parse_yaml(text: str) -> dict:
    try:
        import yaml
        return yaml.safe_load(text)
    except ImportError:
        pass
    root: dict = {}
    stack: list = [(-1, root)]
    for raw in text.splitlines():
        if not raw.strip() or raw.lstrip().startswith("#"):
            continue
        indent = len(raw) - len(raw.lstrip())
        key, _, val = raw.strip().partition(":")
        val = val.strip()
        while stack and indent <= stack[-1][0]:
            stack.pop()
        cur = stack[-1][1]
        if not val:
            child: dict = {}
            cur[key] = child
            stack.append((indent, child))
        elif val.startswith("["):
            items = [x.strip() for x in val.strip("[]").split(",") if x.strip()]
            cur[key] = [_coerce(x) for x in items]
        else:
            cur[key] = _coerce(val)
    return root


def _coerce(v: str):
    if v in ("true", "True"):
        return True
    if v in ("false", "False"):
        return False
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    return v
