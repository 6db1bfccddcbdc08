"""glm4-9b [dense] — RoPE, GQA [hf:THUDM/glm-4-9b; hf].
40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552."""
from repro_torch.configs.base import ModelConfig, register_arch

GLM4_9B = register_arch(ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13_696,
    vocab=151_552, head_dim=128, rope="rope",
))
