"""PyTorch port, engine on the CPU: golden command streams (HBM4, LPDDR5, LPDDR6).

The port reproduces the single-spec golden sha256 hashes of
``tests/trace/golden_hashes.json`` (3000 cycles, interval 2.0, read ratio
0.7, FR-FCFS, fast-forward on) bit for bit.  The 11 default systems are
split over four files so that each stays well under a minute."""
import functools

import pytest

torch = pytest.importorskip("torch")

from torch_parity import check_golden, jax_stats_dict  # noqa: E402

STANDARDS = ['HBM4', 'LPDDR5', 'LPDDR6']


@functools.lru_cache(maxsize=None)
def _port_stats(std):
    return check_golden(std)


@pytest.mark.parametrize("std", STANDARDS)
def test_golden_command_stream_fast_forward(std):
    stats = _port_stats(std).to_dict()
    assert stats["scan_steps"] + stats["skipped_cycles"] == 3000


def test_stats_equal_reference_fast_forward():
    """``Stats.to_dict()`` — scan_steps and skipped_cycles included —
    equals the reference ``Simulator.run`` at the golden configuration."""
    assert _port_stats('LPDDR5').to_dict() == jax_stats_dict('LPDDR5')
