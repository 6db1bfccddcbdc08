"""LPDDR5 — split ACT-1/ACT-2 activation + WCK data-clock sync (paper §2)."""
from repro_torch.core.spec import DRAMSpec, Organization, TimingConstraint, register
from repro_torch.core.standards.common import base_commands, base_constraints, base_timing_params


@register
class LPDDR5(DRAMSpec):
    name = "LPDDR5"
    levels = ("channel", "rank", "bankgroup", "bank")
    burst_beats = 16
    split_activation = True
    data_clock_sync = True
    clock_sync_commands = {"read": "CAS_RD", "write": "CAS_WR"}
    command_meta = base_commands(split_act=True, clock_sync="wck")
    commands = list(command_meta)
    timing_params = base_timing_params(extra=(
        "nAAD", "nAAD_MIN", "nWCKEN", "nWCKIDLE"))
    timing_constraints = base_constraints(act="ACT2") + [
        # WCK sync commands must lead the column access by nWCKEN
        TimingConstraint("rank", ["CAS_RD"], ["RD"], "nWCKEN"),
        TimingConstraint("rank", ["CAS_WR"], ["WR"], "nWCKEN"),
        TimingConstraint("rank", ["CAS_RD", "CAS_WR"], ["CAS_RD", "CAS_WR"], "nWCKEN"),
    ]
    org_presets = {
        "LPDDR5_8Gb_x16": Organization(8192, 16, {"rank": 1, "bankgroup": 4, "bank": 4}, rows=1 << 15, columns=1 << 10),
        "LPDDR5_8Gb_x16_2R": Organization(8192, 16, {"rank": 2, "bankgroup": 4, "bank": 4}, rows=1 << 15, columns=1 << 10),
    }
    timing_presets = {
        "LPDDR5_6400": dict(
            tCK_ps=1250, nBL=4, nCL=15, nCWL=9, nRCD=15, nRP=15, nRAS=34,
            nRC=49, nWR=28, nRTP=8, nCCD_S=2, nCCD_L=4, nRRD_S=4, nRRD_L=4,
            nWTR_S=5, nWTR_L=8, nFAW=16, nRFC=166, nREFI=3128,
            nAAD=8, nAAD_MIN=2, nWCKEN=3, nWCKIDLE=8,
        ),
    }
