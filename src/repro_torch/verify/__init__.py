"""``repro_torch.verify`` — the verification harness of the port (the
reference's ``repro.verify``, on the port's engine and kernels).

Three coordinated layers turn the audit substrate into a gate:

* :mod:`repro_torch.verify.explore` — bounded-depth exhaustive exploration of
  ``controller_step`` on tiny geometries, cross-checked command-by-
  command against the scalar oracle, with counterexample minimization
  and replayable ``.npz`` artifacts;
* :mod:`repro_torch.verify.properties` — property-based scheduler invariants
  (refresh deadlines, starvation bounds, window constraints) over
  adversarial request streams, on full organizations including
  multi-channel and heterogeneous systems;
* :mod:`repro_torch.verify.differential` — differential accuracy comparison
  against pinned upstream-format command-stream fixtures;

plus :mod:`repro_torch.verify.mutation`, the auditor's own detector test: a
matrix of injected single-cycle violations that must ALL be flagged.

CLI: ``python -m repro_torch.verify {explore,mutate,diff} ...
[--device cpu]``.
"""
from .differential import (DiffReport, accuracy_table, compare_streams,
                           diff_against_fixture, dump_cmd_stream,
                           golden_run, parse_cmd_stream, write_fixture)
from .explore import (Counterexample, Divergence, ExploreResult,
                      default_alphabet, explore, load_counterexample,
                      loosen_constraint, smoke, tiny_spec)
from .mutation import (CLASSES, Injection, detected, inject, matrix_table,
                       mutation_matrix)
from .properties import (STREAMS, PropertyReport, bursty_stream,
                         check_faw_windows, check_refresh_deadline,
                         check_starvation, refresh_deadline_bound,
                         refresh_starving_stream, row_conflict_stream,
                         starvation_bound, verify_properties)

__all__ = [
    "CLASSES", "Counterexample", "DiffReport", "Divergence",
    "ExploreResult", "Injection", "PropertyReport", "STREAMS",
    "accuracy_table", "bursty_stream", "check_faw_windows",
    "check_refresh_deadline", "check_starvation", "compare_streams",
    "default_alphabet", "detected", "diff_against_fixture",
    "dump_cmd_stream", "explore", "golden_run", "inject",
    "load_counterexample", "loosen_constraint", "matrix_table",
    "mutation_matrix", "parse_cmd_stream", "refresh_deadline_bound",
    "refresh_starving_stream", "row_conflict_stream", "smoke",
    "starvation_bound", "tiny_spec", "verify_properties", "write_fixture",
]
