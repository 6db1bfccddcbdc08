"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].
24L d_model=1024 4H d_ff=0 vocab=50304; alternating mLSTM/sLSTM blocks
(d_ff=0: each block carries its own projections)."""
from repro_torch.configs.base import ModelConfig, register_arch

XLSTM_350M = register_arch(ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50_304, head_dim=256, rope="none",
    block_pattern=("mlstm", "slstm"),
    sub_quadratic=True,
    notes="matrix-memory mLSTM + scalar-memory sLSTM, 1:1 alternation; "
          "O(1) state per token => long_500k eligible.",
))
