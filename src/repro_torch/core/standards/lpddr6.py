"""LPDDR6 — split activation + WCK, scaled from LPDDR5 (values extrapolated:
JESD209-6 is not fully public)."""
from repro_torch.core.spec import Organization, register
from repro_torch.core.standards.lpddr5 import LPDDR5


@register
class LPDDR6(LPDDR5):
    name = "LPDDR6"
    burst_beats = 24   # LPDDR6: BL24 on a x24 sub-channel pair
    org_presets = {
        "LPDDR6_16Gb_x16": Organization(16384, 16, {"rank": 1, "bankgroup": 4, "bank": 4}, rows=1 << 16, columns=1 << 10),
    }
    timing_presets = {
        "LPDDR6_8533": dict(  # extrapolated
            tCK_ps=937, nBL=4, nCL=20, nCWL=12, nRCD=18, nRP=18, nRAS=40,
            nRC=58, nWR=34, nRTP=10, nCCD_S=2, nCCD_L=4, nRRD_S=4, nRRD_L=4,
            nWTR_S=6, nWTR_L=10, nFAW=20, nRFC=222, nREFI=4163,
            nAAD=8, nAAD_MIN=2, nWCKEN=4, nWCKIDLE=10,
        ),
    }
