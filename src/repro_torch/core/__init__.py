"""The simulator's core in PyTorch: spec layer, device, controller,
frontend and engine, for one standard (one or many channels) or a
composition of spec groups (``compile_system``).

Public surface (the counterparts of ``repro.core``'s names):
  * ``repro_torch.core.standards`` — the modeled DRAM standards
  * ``Simulator`` — the cycle-level engine, on CUDA by default
  * ``ControllerConfig`` / ``FrontendConfig``
  * ``ReplayStream`` — the request columns of ``pattern="trace"``
  * ``DeviceUnderTest`` — the scalar numpy oracle and its probe API
    (paper Listing 2)
"""
from repro_torch.core import standards  # noqa: F401  (populates the registry)
from repro_torch.core.compile import (CompiledSpec, MemorySystemSpec,
                                      SpecGroup, as_system, compile_spec,
                                      compile_system)
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.dut import DeviceUnderTest, ProbeResult
from repro_torch.core.engine import (RUN_CACHE, RunCache, Simulator, Stats,
                                     avg_probe_latency_ns, channel_breakdown,
                                     format_stats, peak_gbps, row_hit_rate,
                                     throughput_gbps)
from repro_torch.core.frontend import FrontendConfig, ReplayStream
from repro_torch.core.spec import (Command, DRAMSpec, Organization,
                                   TimingConstraint, all_standards,
                                   get_standard)

__all__ = [
    "CompiledSpec", "compile_spec", "MemorySystemSpec", "SpecGroup",
    "as_system", "compile_system", "ControllerConfig", "DeviceUnderTest",
    "ProbeResult", "Simulator",
    "Stats", "FrontendConfig", "ReplayStream", "Command", "DRAMSpec", "Organization",
    "TimingConstraint", "all_standards", "get_standard", "standards",
    "throughput_gbps", "peak_gbps", "avg_probe_latency_ns", "row_hit_rate",
    "channel_breakdown", "format_stats", "RunCache", "RUN_CACHE",
]
