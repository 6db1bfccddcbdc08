"""Shared command/constraint builders for DRAM standards.

Ramulator 2.1's LOC reduction comes from factoring the repetitive parts of a
standard (the classic JEDEC constraint set) out of each spec.  Each standard
file then only states its organization, presets, and *deviations* from the
common protocol skeleton — mirroring the paper's Python authoring layer.
"""
from __future__ import annotations

from repro_torch.core.spec import (
    Command, TimingConstraint, KIND_ROW, KIND_COL, KIND_REF, KIND_SYNC,
    FX_OPEN, FX_CLOSE, FX_CLOSE_ALL, FX_ACT1, FX_CLOCK_ON, FX_FINAL_RD,
    FX_FINAL_WR,
)


def base_commands(refresh_level: str = "rank", split_act: bool = False,
                  clock_sync: str | None = None) -> dict:
    """The common command set.

    clock_sync: None | "wck" (LPDDR5/6 CAS_RD/CAS_WR) | "rck" (GDDR7 RCKSTRT)
    """
    cmds = {}
    if split_act:
        cmds["ACT1"] = Command("ACT1", "bank", KIND_ROW, FX_ACT1)
        cmds["ACT2"] = Command("ACT2", "bank", KIND_ROW, FX_OPEN)
    else:
        cmds["ACT"] = Command("ACT", "bank", KIND_ROW, FX_OPEN)
    cmds["PRE"] = Command("PRE", "bank", KIND_ROW, FX_CLOSE)
    cmds["PREab"] = Command("PREab", refresh_level, KIND_ROW, FX_CLOSE_ALL)
    cmds["RD"] = Command("RD", "bank", KIND_COL, FX_FINAL_RD)
    cmds["WR"] = Command("WR", "bank", KIND_COL, FX_FINAL_WR)
    cmds["REFab"] = Command("REFab", refresh_level, KIND_REF, FX_CLOSE_ALL)
    if clock_sync == "wck":
        cmds["CAS_RD"] = Command("CAS_RD", refresh_level, KIND_SYNC, FX_CLOCK_ON)
        cmds["CAS_WR"] = Command("CAS_WR", refresh_level, KIND_SYNC, FX_CLOCK_ON)
    elif clock_sync == "rck":
        cmds["RCKSTRT"] = Command("RCKSTRT", refresh_level, KIND_SYNC, FX_CLOCK_ON)
    return cmds


def base_constraints(*, act: str = "ACT", has_bankgroup: bool = True,
                     refresh_level: str = "rank") -> list:
    """The classic JEDEC timing-constraint skeleton.

    ``act`` names the row-opening command ("ACT", or "ACT2" for split
    activation where ACT1 carries the rank-level ACT-to-ACT spacing).
    Latency fields are parameter expressions resolved against the preset at
    spec-compile time (supports "+"/"-" of params and integer literals).
    """
    R = refresh_level
    opener = "ACT1" if act == "ACT2" else act   # command that *starts* an activation
    c = [
        # --- bank level ---
        TimingConstraint("bank", [act], ["RD", "WR"], "nRCD"),
        TimingConstraint("bank", [act], ["PRE"], "nRAS"),
        TimingConstraint("bank", ["PRE"], [opener], "nRP"),
        TimingConstraint("bank", [act], [opener], "nRC"),
        TimingConstraint("bank", ["RD"], ["PRE"], "nRTP"),
        TimingConstraint("bank", ["WR"], ["PRE"], "nCWL+nBL+nWR"),
        # --- refresh-unit (rank / pseudochannel) level ---
        TimingConstraint(R, [opener], [opener], "nRRD_S"),
        TimingConstraint(R, [opener], [opener], "nFAW", window=4),
        TimingConstraint(R, ["RD"], ["RD"], "nCCD_S"),
        TimingConstraint(R, ["WR"], ["WR"], "nCCD_S"),
        TimingConstraint(R, ["RD"], ["WR"], "nCL+nBL+2-nCWL", note="rd->wr turnaround"),
        TimingConstraint(R, ["WR"], ["RD"], "nCWL+nBL+nWTR_S"),
        TimingConstraint(R, ["RD"], ["PREab"], "nRTP"),
        TimingConstraint(R, ["WR"], ["PREab"], "nCWL+nBL+nWR"),
        TimingConstraint(R, [act], ["PREab"], "nRAS"),
        TimingConstraint(R, ["PREab", "PRE"], ["REFab"], "nRP"),
        TimingConstraint(R, ["REFab"], ["REFab"], "nRFC"),
        TimingConstraint(R, ["REFab"], [opener, "RD", "WR"], "nRFC"),
        TimingConstraint(R, ["PREab"], [opener], "nRP"),
        # --- channel level (shared data bus across refresh units) ---
        TimingConstraint("channel", ["RD"], ["RD"], "nBL"),
        TimingConstraint("channel", ["WR"], ["WR"], "nBL"),
        TimingConstraint("channel", ["RD"], ["WR"], "nBL"),
        TimingConstraint("channel", ["WR"], ["RD"], "nBL"),
    ]
    if has_bankgroup:
        c += [
            TimingConstraint("bankgroup", ["RD"], ["RD"], "nCCD_L"),
            TimingConstraint("bankgroup", ["WR"], ["WR"], "nCCD_L"),
            TimingConstraint("bankgroup", [opener], [opener], "nRRD_L"),
            TimingConstraint("bankgroup", ["WR"], ["RD"], "nCWL+nBL+nWTR_L"),
        ]
    if act == "ACT2":  # split activation: ACT1 -> ACT2 minimum spacing
        c += [TimingConstraint("bank", ["ACT1"], ["ACT2"], "nAAD_MIN")]
    return c


def base_timing_params(has_bankgroup: bool = True, extra: tuple = ()) -> list:
    p = ["nBL", "nCL", "nCWL", "nRCD", "nRP", "nRAS", "nRC", "nWR", "nRTP",
         "nCCD_S", "nRRD_S", "nWTR_S", "nFAW", "nRFC", "nREFI"]
    if has_bankgroup:
        p += ["nCCD_L", "nRRD_L", "nWTR_L"]
    return p + list(extra)
