"""Windowed telemetry of the port's runs (``Simulator.run(...,
telemetry=W)`` -> ``(stats, Telemetry)``): per-window, per-channel
counters that sum back to the run's ``Stats``, with the ``.npz`` and JSON
Lines artifacts of the reference's format."""
from repro_torch.telemetry.core import (FORMAT_VERSION, GroupTelemetry,
                                        Telemetry, build, load, save,
                                        write_jsonl)

__all__ = ["FORMAT_VERSION", "GroupTelemetry", "Telemetry", "build", "load",
           "save", "write_jsonl"]
