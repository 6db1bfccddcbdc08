"""DRAM standards modeled by the simulator (paper Fig. 1 set + VRR variants)."""
from repro_torch.core.standards.ddr3 import DDR3
from repro_torch.core.standards.ddr4 import DDR4
from repro_torch.core.standards.ddr5 import DDR5
from repro_torch.core.standards.lpddr5 import LPDDR5
from repro_torch.core.standards.lpddr6 import LPDDR6
from repro_torch.core.standards.gddr6 import GDDR6
from repro_torch.core.standards.gddr7 import GDDR7
from repro_torch.core.standards.hbm2 import HBM2
from repro_torch.core.standards.hbm3 import HBM3
from repro_torch.core.standards.hbm4 import HBM4
from repro_torch.core.standards.vrr import DDR4_VRR, DDR5_VRR

ALL = [DDR3, DDR4, DDR5, LPDDR5, LPDDR6, GDDR6, GDDR7, HBM2, HBM3, HBM4,
       DDR4_VRR, DDR5_VRR]

#: (org preset, timing preset) of each default system — the reference's
#: ``repro.dse.spec.DEFAULT_SYSTEMS``, the set the golden hashes cover
DEFAULT_SYSTEMS = {
    "DDR3": ("DDR3_8Gb_x8", "DDR3_1600K"),
    "DDR4": ("DDR4_8Gb_x8", "DDR4_2400R"),
    "DDR5": ("DDR5_16Gb_x8", "DDR5_4800B"),
    "LPDDR5": ("LPDDR5_8Gb_x16", "LPDDR5_6400"),
    "LPDDR6": ("LPDDR6_16Gb_x16", "LPDDR6_8533"),
    "GDDR6": ("GDDR6_8Gb_x16", "GDDR6_16"),
    "GDDR7": ("GDDR7_16Gb_x32", "GDDR7_32"),
    "HBM2": ("HBM2_8Gb", "HBM2_2Gbps"),
    "HBM3": ("HBM3_16Gb", "HBM3_5200"),
    "HBM4": ("HBM4_24Gb", "HBM4_8000"),
    "DDR5_VRR": ("DDR5_16Gb_x8", "DDR5_4800B"),
}

__all__ = [s.__name__ for s in ALL] + ["ALL", "DEFAULT_SYSTEMS"]
