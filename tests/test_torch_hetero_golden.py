"""PyTorch port, the heterogeneous memory system end to end on the CPU:
``examples/hetero_system.py``'s DDR5x2 + CXL-DDR4x2@80 composition at the
golden configuration (3000 cycles, FR-FCFS, interval 2.0, read ratio 0.7,
fast-forward on) reproduces ``GOLDEN["DDR5x2+DDR4x2@80"]`` (the sha256
over ``FIELDS + ("group",)``, as ``tests/trace/test_golden_equality.py``
takes it), and its ``Stats.to_dict()`` and every ``per_group`` leaf equal
the JAX package's.  Exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ControllerConfig as JCfg           # noqa: E402
from repro.core import Simulator as JSim                  # noqa: E402
from repro.core import compile_system as j_compile_system  # noqa: E402

from repro_torch.core import (ControllerConfig, Simulator,  # noqa: E402
                              compile_system)
from repro_torch.trace import FIELDS, capture, trace_sha256  # noqa: E402

from torch_parity import GOLDEN, HETERO_SYSTEM, stats_doc  # noqa: E402

RUN = dict(interval=2.0, read_ratio=0.7)


def test_hetero_golden_hash_and_stats_match_reference():
    msys = compile_system(HETERO_SYSTEM)
    sim = Simulator(system=msys, device="cpu",
                    controller=ControllerConfig(scheduler="FRFCFS"))
    stats, dense = sim.run(3000, trace=True, **RUN)
    assert tuple(dense.cmd.shape) == (3000, 4, 2)
    tr = capture(msys, dense)
    want = GOLDEN["DDR5x2+DDR4x2@80"]
    assert len(tr) == want["n"]
    assert trace_sha256(tr, FIELDS + ("group",)) == want["sha256"]
    assert set(np.unique(tr.group)) == {0, 1}
    assert tr.cmd_names == msys.cmd_names
    assert sim.host_syncs == stats.scan_steps

    jsys = j_compile_system(HETERO_SYSTEM)
    jstats = JSim(system=jsys, controller=JCfg(scheduler="FRFCFS")).run(
        3000, **RUN)
    assert stats_doc(stats) == stats_doc(jstats)
    assert [tuple(g.cmd_counts.shape) for g in stats.per_group] == [
        (2, len(g.cspec.cmd_names)) for g in msys.groups]
