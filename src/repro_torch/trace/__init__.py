"""Command-trace capture for the port's runs (one or more channels)."""
from repro_torch.trace.capture import (FIELDS, CommandTrace, capture,
                                       trace_sha256)

__all__ = ["FIELDS", "CommandTrace", "capture", "trace_sha256"]
