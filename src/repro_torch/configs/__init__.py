"""Architecture configs the port runs: the dense llama3.2-1b and the
qk-norm family (qwen3-4b, qwen3-14b, glm4-9b), and the hybrid
recurrentgemma-2b (``repro/configs`` has the rest; ROADMAP.md queue 1
item 13 lists them)."""
from repro_torch.configs.base import (SHAPES, ModelConfig, MoEConfig,
                                      ShapeConfig, get_arch, register_arch)
from repro_torch.configs.recurrentgemma_2b import RECURRENTGEMMA_2B
from repro_torch.configs.qwen3_4b import QWEN3_4B
from repro_torch.configs.llama3_2_1b import LLAMA32_1B
from repro_torch.configs.qwen3_14b import QWEN3_14B
from repro_torch.configs.glm4_9b import GLM4_9B

__all__ = ["GLM4_9B", "LLAMA32_1B", "QWEN3_14B", "QWEN3_4B",
           "RECURRENTGEMMA_2B", "ModelConfig", "MoEConfig", "ShapeConfig",
           "SHAPES", "get_arch", "register_arch"]
