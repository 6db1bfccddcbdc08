"""Command-trace capture for the port's runs (one or more channels, with
the reference's metadata block), the replay stream of a captured trace
(:func:`to_replay`), the ``.npz`` / JSON Lines trace artifacts
(:mod:`repro_torch.trace.format`), readable by either package, the
independent audit of a trace against its constraint tables
(:mod:`repro_torch.trace.audit`), the LOD HTML visualizer
(:mod:`repro_torch.trace.viz`), and the ``python -m repro_torch.trace``
CLI."""
from repro_torch.trace.audit import AuditReport, Violation, audit
from repro_torch.trace.capture import (FIELDS, CommandTrace, base_meta,
                                       capture, config_doc,
                                       spec_fingerprint_hex,
                                       system_from_meta, to_replay,
                                       trace_sha256)
from repro_torch.trace.format import (iter_records, load, read_jsonl, save,
                                      write_jsonl)
from repro_torch.trace.viz import render_html, write_html

__all__ = ["AuditReport", "Violation", "audit", "FIELDS", "CommandTrace",
           "base_meta", "capture", "config_doc", "spec_fingerprint_hex",
           "system_from_meta", "to_replay", "trace_sha256", "iter_records",
           "load", "read_jsonl", "save", "write_jsonl", "render_html",
           "write_html"]
