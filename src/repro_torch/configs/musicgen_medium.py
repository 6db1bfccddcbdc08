"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].  48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048 per codebook, 4 codebooks (delay pattern).
Backbone only: the EnCodec frontend is a STUB — input_specs() provides
the 4 parallel codebook token streams."""
from repro_torch.configs.base import ModelConfig, register_arch

MUSICGEN_MEDIUM = register_arch(ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
    vocab=2048, head_dim=64, rope="none",
    frontend="audio_stub", n_codebooks=4,
    notes="sum of 4 codebook embeddings in, 4 parallel lm heads out "
          "(delay-pattern scheduling happens in the data pipeline).",
))
