"""Command-trace capture for the port's runs (one or more channels, with
the reference's metadata block), the replay stream of a captured trace
(:func:`to_replay`), and the ``.npz`` / JSON Lines trace artifacts
(:mod:`repro_torch.trace.format`), readable by either package."""
from repro_torch.trace.capture import (FIELDS, CommandTrace, base_meta,
                                       capture, config_doc,
                                       spec_fingerprint_hex,
                                       system_from_meta, to_replay,
                                       trace_sha256)
from repro_torch.trace.format import (iter_records, load, read_jsonl, save,
                                      write_jsonl)

__all__ = ["FIELDS", "CommandTrace", "base_meta", "capture", "config_doc",
           "spec_fingerprint_hex", "system_from_meta", "to_replay",
           "trace_sha256", "iter_records", "load", "read_jsonl", "save",
           "write_jsonl"]
