"""PyTorch port, engine on the CPU: golden command streams (DDR5_VRR, GDDR6, HBM2).

The port reproduces the single-spec golden sha256 hashes of
``tests/trace/golden_hashes.json`` (3000 cycles, interval 2.0, read ratio
0.7, FR-FCFS, fast-forward on) bit for bit; the same run's trace is
audited and mutated as the reference's (``trace.audit``, ``trace.viz``,
``verify.mutation``).  The 11 default systems are
split over four files so that each stays well under a minute."""
import functools

import pytest

torch = pytest.importorskip("torch")

from torch_parity import check_golden, check_golden_audit  # noqa: E402

STANDARDS = ['DDR5_VRR', 'GDDR6', 'HBM2']


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


def test_stats_helpers_match_reference_formulas():
    """Throughput, peak, probe latency and row-hit rate of the port's
    Stats equal the reference helpers applied to the same counters."""
    from repro.core import compile_spec as j_compile
    from repro.core import engine as JE
    from repro_torch import convert
    from repro_torch.core import compile_spec
    from repro_torch.core import engine as TE
    stats = _port_stats("HBM2")
    ref = convert.stats_to_numpy(stats)
    jc = j_compile("HBM2", "HBM2_8Gb", "HBM2_2Gbps")
    tc = compile_spec("HBM2", "HBM2_8Gb", "HBM2_2Gbps")
    assert TE.throughput_gbps(tc, stats) == JE.throughput_gbps(jc, ref)
    assert TE.peak_gbps(tc) == JE.peak_gbps(jc)
    assert TE.avg_probe_latency_ns(tc, stats) \
        == JE.avg_probe_latency_ns(jc, ref)
    assert TE.row_hit_rate(tc, stats) == JE.row_hit_rate(jc, ref)
    assert ref.to_dict() == stats.to_dict()
