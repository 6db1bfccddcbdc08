"""Windowed telemetry of the port's runs (``Simulator.run(...,
telemetry=W)`` -> ``(stats, Telemetry)``): per-window, per-channel
counters that sum back to the run's ``Stats``, with the ``.npz`` and JSON
Lines artifacts of the reference's format; the host-side run profiler
(:class:`Profiler`, :func:`profile_run`); the spans inside the train
step and the prefill, on the profiler's clock (:mod:`spans`); the LOD timeline
(:func:`render_html`, :func:`write_html`); and the ``python -m
repro_torch.telemetry`` CLI."""
from repro_torch.telemetry.core import (FORMAT_VERSION, GroupTelemetry,
                                        Telemetry, build, load, save,
                                        write_jsonl)
from repro_torch.telemetry import spans
from repro_torch.telemetry.profile import Profiler, profile_run
from repro_torch.telemetry.viz import render_html, write_html

__all__ = ["FORMAT_VERSION", "GroupTelemetry", "Telemetry", "build", "load",
           "save", "write_jsonl", "Profiler", "profile_run", "render_html",
           "write_html", "spans"]
