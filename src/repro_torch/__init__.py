"""PyTorch + CUDA port of the Ramulator 2.1 reproduction (``repro``).

A second package beside the JAX one: the same cycle-level DRAM simulator
on PyTorch tensors, with its timing-readiness check as a hand-written
int32 CUDA kernel for Hopper (``repro_torch.kernels``).  It imports
neither ``jax`` nor ``repro``.  Entry points run on CUDA unless the caller
passes ``device="cpu"``.

    from repro_torch.core import Simulator, throughput_gbps
    sim = Simulator("DDR5", "DDR5_16Gb_x8", "DDR5_4800B")
    stats = sim.run(20_000, interval=2.0, read_ratio=0.8)
"""
