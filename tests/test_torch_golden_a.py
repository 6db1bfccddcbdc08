"""PyTorch port, engine on the CPU: golden command streams (DDR3, DDR4, DDR5).

The port reproduces the single-spec golden sha256 hashes of
``tests/trace/golden_hashes.json`` (3000 cycles, interval 2.0, read ratio
0.7, FR-FCFS, fast-forward on) bit for bit; the same run's trace is
audited and mutated as the reference's (``trace.audit``, ``trace.viz``,
``verify.mutation``).  The 11 default systems are
split over four files so that each stays well under a minute."""
import functools

import pytest

torch = pytest.importorskip("torch")

from torch_parity import (check_golden, check_golden_audit,  # noqa: E402
                          jax_stats_dict)

STANDARDS = ['DDR3', 'DDR4', 'DDR5']


@functools.lru_cache(maxsize=None)
def _port_stats(std):
    return check_golden(std)


@pytest.mark.parametrize("std", STANDARDS)
def test_golden_command_stream_fast_forward(std):
    stats = _port_stats(std).to_dict()
    assert stats["scan_steps"] + stats["skipped_cycles"] == 3000


@pytest.mark.parametrize("std", STANDARDS)
def test_golden_audit_and_mutation_row_equal_the_references(std):
    """The same run's trace (with its controller and frontend metadata)
    through ``repro_torch.trace.audit``: the report, the visualizer page
    (digest), each mutation class's injected trace (row, mode, digest),
    its audit and the mutation matrix's row equal the reference's in
    ``tests/torch_verify_stats.json`` exactly, at 100% detection."""
    row = check_golden_audit(std)
    assert set(row.values()) == {"detected"}


def test_stats_equal_reference_fast_forward():
    """``Stats.to_dict()`` — scan_steps and skipped_cycles included —
    equals the reference ``Simulator.run`` at the golden configuration."""
    assert _port_stats('DDR4').to_dict() == jax_stats_dict('DDR4')
