"""Architecture configs the port runs (``repro/configs`` has the rest;
ROADMAP.md queue 1 item 13 lists them)."""
from repro_torch.configs.base import (SHAPES, ModelConfig, MoEConfig,
                                      ShapeConfig, get_arch, register_arch)
from repro_torch.configs.llama3_2_1b import LLAMA32_1B

__all__ = ["LLAMA32_1B", "ModelConfig", "MoEConfig", "ShapeConfig",
           "SHAPES", "get_arch", "register_arch"]
