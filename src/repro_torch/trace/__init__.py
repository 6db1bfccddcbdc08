"""Command-trace capture for the port's runs (one or more channels), and
the replay stream of a captured trace (:func:`to_replay`)."""
from repro_torch.trace.capture import (FIELDS, CommandTrace, capture,
                                       to_replay, trace_sha256)

__all__ = ["FIELDS", "CommandTrace", "capture", "to_replay", "trace_sha256"]
