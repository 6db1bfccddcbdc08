"""llama4-maverick-400b-a17b [moe] — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].
48L d_model=5120 40H (GQA kv=8) d_ff=8192, MoE 128e top-1 + shared expert."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register_arch

LLAMA4_MAVERICK = register_arch(ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202_048, head_dim=128, rope="rope", rope_theta=500_000.0,
    block_pattern=("attn", "moe"),   # llama4: MoE every other layer
    d_ff_dense=16_384,
    moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192,
                  shared_expert=True),
    notes="shared expert + top-1 routed expert, MoE interleaved 1:2 "
          "(interleave_moe_layer_step=2) per llama4; 'early fusion' concerns "
          "the multimodal frontend, which is out of backbone scope.",
))
