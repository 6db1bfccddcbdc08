"""Windowed telemetry of the port's runs (``Simulator.run(...,
telemetry=W)`` -> ``(stats, Telemetry)``): per-window, per-channel
counters that sum back to the run's ``Stats``, with the ``.npz`` and JSON
Lines artifacts of the reference's format; and the host-side run
profiler (:class:`Profiler`, :func:`profile_run`)."""
from repro_torch.telemetry.core import (FORMAT_VERSION, GroupTelemetry,
                                        Telemetry, build, load, save,
                                        write_jsonl)
from repro_torch.telemetry.profile import Profiler, profile_run

__all__ = ["FORMAT_VERSION", "GroupTelemetry", "Telemetry", "build", "load",
           "save", "write_jsonl", "Profiler", "profile_run"]
