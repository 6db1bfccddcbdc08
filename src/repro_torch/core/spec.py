"""Python DRAM-standard authoring API (paper §3.2, Listing 1).

A DRAM standard is *plain Python data* attached to a class: the organization
hierarchy, the command set, command metadata, timing parameters, and timing
constraints.  Users extend a standard exactly as in the paper's Listing 1:

    class DDR5_VRR(DDR5):
        name = "DDR5_VRR"
        commands = DDR5.commands + ["VRR"]
        timing_params = DDR5.timing_params + ["nVRR"]
        timing_constraints = DDR5.timing_constraints + [
            TimingConstraint(level="Bank", preceding=["VRR"],
                             following=["ACT"], latency="nVRR"),
        ]

``core/compile.py`` is the code-generation step: it lowers these specs to
dense numpy tables consumed by the cycle-level PyTorch engine (the analogue of
Ramulator 2.1 generating C++ from the Python spec).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

# ---------------------------------------------------------------------------
# Command metadata
# ---------------------------------------------------------------------------

# Command "kind" — determines which C/A bus a command occupies (paper §2:
# HBM3/4 and GDDR7 have separate row / column buses) and how the scheduler
# filters it.
KIND_ROW = 0      # ACT / PRE / PREab / ACT1 / ACT2 / VRR / RFM ...
KIND_COL = 1      # RD / WR
KIND_REF = 2      # REFab / REFpb
KIND_SYNC = 3     # CAS_RD / CAS_WR / RCKSTRT (data-clock sync, col bus)

# State effects (bitmask)
FX_NONE = 0
FX_OPEN = 1        # opens the addressed row              (ACT / ACT2)
FX_CLOSE = 2       # closes the addressed bank's row      (PRE)
FX_CLOSE_ALL = 4   # closes every row in the rank         (PREab / REFab)
FX_ACT1 = 8        # bank enters Activating state         (ACT-1)
FX_CLOCK_ON = 16   # starts the WCK/RCK data clock        (CAS_RD/CAS_WR/RCKSTRT)
FX_FINAL_RD = 32   # completes a read request             (RD)
FX_FINAL_WR = 64   # completes a write request            (WR)


@dataclasses.dataclass(frozen=True)
class Command:
    """Metadata for one DRAM command."""
    name: str
    scope: str          # hierarchy level the command addresses ("bank", "rank", ...)
    kind: int = KIND_ROW
    effects: int = FX_NONE


@dataclasses.dataclass(frozen=True)
class TimingConstraint:
    """``following`` may issue no earlier than ``latency`` cycles after the
    ``window``-th most recent ``preceding`` at the same ``level`` node.

    window=1 is the ordinary case; window=4 with preceding=[ACT] and
    latency=nFAW models the four-activate window.
    """
    level: str
    preceding: Sequence[str]
    following: Sequence[str]
    latency: str | int
    window: int = 1
    note: str = ""


@dataclasses.dataclass(frozen=True)
class Organization:
    """Counts per hierarchy level (below channel) plus geometry."""
    density_mb: int
    dq: int                      # data bus width in bits
    counts: dict                 # level name -> count, e.g. {"rank":1,"bankgroup":4,"bank":4}
    rows: int = 1 << 15
    columns: int = 1 << 10


class DRAMSpec:
    """Base class for DRAM standards.  All attributes are plain data."""

    name: str = "ABSTRACT"
    # Hierarchy below the controller; first level is always "channel".
    levels: Sequence[str] = ("channel", "rank", "bankgroup", "bank")
    commands: Sequence[str] = ()
    command_meta: dict = {}
    timing_params: Sequence[str] = ()
    timing_constraints: Sequence[TimingConstraint] = ()
    org_presets: dict = {}
    timing_presets: dict = {}     # name -> {param: cycles, "tCK_ps": ps}
    # request type -> final column command
    request_translation: dict = {"read": "RD", "write": "WR"}

    # --- protocol feature flags (paper §2) ---
    split_activation: bool = False     # LPDDR5/6 ACT-1 / ACT-2
    data_clock_sync: bool = False      # LPDDR5/6 WCK, GDDR7 RCK
    dual_command_bus: bool = False     # HBM3/4, GDDR7 parallel row+col issue
    # data-clock command names when data_clock_sync is set
    clock_sync_commands: dict = {}     # {"read": "CAS_RD", "write": "CAS_WR"}
    # burst length in command-clock cycles is timing param "nBL"

    @classmethod
    def describe(cls) -> dict:
        """Structured, human-readable summary of the standard (pure data)."""
        return {
            "name": cls.name,
            "levels": list(cls.levels),
            "commands": list(cls.commands),
            "timing_params": list(cls.timing_params),
            "n_constraints": len(cls.timing_constraints),
            "org_presets": sorted(cls.org_presets),
            "timing_presets": sorted(cls.timing_presets),
            "features": {
                "split_activation": cls.split_activation,
                "data_clock_sync": cls.data_clock_sync,
                "dual_command_bus": cls.dual_command_bus,
            },
        }


# ---------------------------------------------------------------------------
# Registry — every standard registers itself so proxies / CLIs can find it.
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(spec_cls):
    """Class decorator: register a DRAM standard by its ``name``."""
    _REGISTRY[spec_cls.name] = spec_cls
    return spec_cls


def get_standard(name: str):
    if name not in _REGISTRY:
        raise KeyError(f"unknown DRAM standard {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_standards() -> dict:
    return dict(_REGISTRY)
