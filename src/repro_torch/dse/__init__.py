"""Design-space-exploration orchestration on the card (the port's
``repro.dse``).

Declare a sweep, run it as cached batched runs, get latency-throughput
curves back:

    from repro_torch.dse import SweepSpec, execute
    result = execute(SweepSpec(systems=("DDR4", "DDR5"),
                               intervals=(64, 8, 1), n_cycles=10_000))
    for curve in result.curves():
        print(curve.system, curve.peak_fraction, curve.knee)
    result.save("results/my_sweep")

``execute(..., devices=["cpu"])`` runs on the CPU.  The CLI is
``python -m repro_torch.dse.sweep``.
"""
from repro_torch.dse.executor import compile_group_key, execute, group_points
from repro_torch.dse.results import (Curve, SweepResult,
                                     avg_probe_latency_ns_array, knee_index,
                                     throughput_gbps_array)
from repro_torch.dse.spec import (DEFAULT_SYSTEMS, Composition, RunPoint,
                                  SweepSpec, System, SystemGroup, system)

__all__ = [
    "SweepSpec", "System", "RunPoint", "system", "DEFAULT_SYSTEMS",
    "Composition", "SystemGroup",
    "execute", "group_points", "compile_group_key",
    "SweepResult", "Curve", "knee_index",
    "throughput_gbps_array", "avg_probe_latency_ns_array",
]
