"""Architecture configs (public-literature, see each module): the port's
copies of the JAX package's ten, ``repro/configs``."""
from repro_torch.configs.base import (SHAPES, ModelConfig, MoEConfig,
                                      ShapeConfig, all_archs, get_arch,
                                      register_arch, valid_cells)
from repro_torch.configs.recurrentgemma_2b import RECURRENTGEMMA_2B
from repro_torch.configs.qwen3_4b import QWEN3_4B
from repro_torch.configs.llama3_2_1b import LLAMA32_1B
from repro_torch.configs.qwen3_14b import QWEN3_14B
from repro_torch.configs.glm4_9b import GLM4_9B
from repro_torch.configs.phi3_5_moe import PHI35_MOE
from repro_torch.configs.llama4_maverick import LLAMA4_MAVERICK
from repro_torch.configs.qwen2_vl_72b import QWEN2_VL_72B
from repro_torch.configs.xlstm_350m import XLSTM_350M
from repro_torch.configs.musicgen_medium import MUSICGEN_MEDIUM

__all__ = ["GLM4_9B", "LLAMA32_1B", "LLAMA4_MAVERICK", "MUSICGEN_MEDIUM",
           "PHI35_MOE", "QWEN2_VL_72B", "QWEN3_14B", "QWEN3_4B",
           "RECURRENTGEMMA_2B", "XLSTM_350M", "ModelConfig", "MoEConfig",
           "ShapeConfig", "SHAPES", "all_archs", "get_arch",
           "register_arch", "valid_cells"]
