"""HBM4 — dual C/A, wider interface (values extrapolated from JESD270-4
public material)."""
from repro_torch.core.spec import Organization, register
from repro_torch.core.standards.hbm3 import HBM3


@register
class HBM4(HBM3):
    name = "HBM4"
    burst_beats = 8
    org_presets = {
        "HBM4_24Gb": Organization(24576, 128, {"pseudochannel": 4, "bankgroup": 4, "bank": 4}, rows=1 << 14, columns=1 << 6),
    }
    timing_presets = {
        "HBM4_8000": dict(  # 8 Gb/s/pin (extrapolated)
            tCK_ps=500, nBL=2, nCL=28, nCWL=8, nRCD=26, nRP=26, nRAS=62,
            nRC=88, nWR=30, nRTP=6, nCCD_S=2, nCCD_L=4, nRRD_S=4, nRRD_L=7,
            nWTR_S=9, nWTR_L=13, nFAW=20, nRFC=520, nREFI=7800,
        ),
    }
