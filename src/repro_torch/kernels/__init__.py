"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version beside it (``readiness``: the timing-readiness table;
``flash_attention``: the LM's prefill attention)."""
