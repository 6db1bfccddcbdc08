"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 pattern
[arXiv:2402.19427; hf].  26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000; two recurrent blocks per local-attention block, 2k window."""
from repro_torch.configs.base import ModelConfig, register_arch

RECURRENTGEMMA_2B = register_arch(ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256_000, head_dim=256,
    block_pattern=("rglru", "rglru", "local_attn"),
    attn_window=2048, rope="rope",
    sub_quadratic=True, tie_embeddings=True,
    notes="RG-LRU recurrence via associative scan; local attn window 2048; "
          "26 = 8x(R,R,A) + (R,R) remainder.",
))
