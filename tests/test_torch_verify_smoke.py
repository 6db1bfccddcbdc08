"""PyTorch port, bounded exploration (``repro_torch.verify.explore``) on
the CPU against the reference's results in ``tests/torch_verify_stats.json``,
exactly: every ``ExploreResult`` of the smoke matrix (DDR4, DDR5, HBM3 x
the three ``SMOKE_CONFIGS``, at the reference's depths) — unique states,
edges, oracle-checked commands, compared tables, truncation, zero
divergences — and of the refresh-pressure exploration; truncation is
reported; the helpers equal the reference's.

On the CPU the transition is the plain step (one call per 64-lane chunk:
the lanes share the clock); on the card, the fused controller-step
kernel and the readiness kernel (``-m cuda``, ``chip_smoke.py`` phase 17).
The fixture is rewritten by ``tests/torch_parity.py --write-sim-fixtures``.
"""
import importlib
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch import verify                             # noqa: E402
from repro_torch.core import ControllerConfig              # noqa: E402

import torch_parity as tp                                  # noqa: E402

DOC = json.load(open(tp.VERIFY_FIXTURE))
# the modules (each package's ``verify.explore`` names its function)
JX = importlib.import_module("repro.verify.explore")
TX = importlib.import_module("repro_torch.verify.explore")


@pytest.mark.parametrize("standard", tp.VERIFY_STANDARDS)
@pytest.mark.parametrize("cfg", [c[0] for c in TX.SMOKE_CONFIGS])
def test_smoke_matrix_equals_the_reference(standard, cfg):
    config = next(c for c in TX.SMOKE_CONFIGS if c[0] == cfg)
    res = verify.smoke((standard,), (config,), device="cpu")
    got = tp.explore_doc(res[(standard, cfg)])
    assert got == DOC["smoke"][f"{standard}/{cfg}"]
    assert got["divergences"] == [] and got["states_explored"] > 10
    assert got["commands_checked"] > 0 and got["tables_checked"] > 0


def test_smoke_configs_and_timings_are_the_references():
    assert TX.SMOKE_CONFIGS == JX.SMOKE_CONFIGS
    assert TX.FAST_TIMINGS == JX.FAST_TIMINGS
    assert len(DOC["smoke"]) == 9


def test_refresh_pressure_equals_the_reference():
    """nREFI shrunk to 24 so 30 cycles cross several refresh deadlines:
    REFab/PREab issue legality against the oracle."""
    res = tp.refresh_pressure_run(verify, ControllerConfig, device="cpu")
    assert tp.explore_doc(res) == DOC["refresh_pressure"]
    assert res.ok and res.commands_checked > 0


def test_truncation_is_reported_not_silent():
    cspec = verify.tiny_spec("DDR4", banks=2)
    res = verify.explore(cspec, depth=6, ccfg=ControllerConfig(queue_depth=2),
                         max_frontier=4, device="cpu")
    assert res.truncated and res.ok


def test_explore_runs_on_cuda_by_default():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        verify.explore(verify.tiny_spec("DDR4"), depth=1)


@pytest.mark.parametrize("std", ["DDR4", "HBM3", "LPDDR5", "GDDR7"])
def test_tiny_spec_and_address_helpers_equal_the_references(std):
    for kw in (dict(banks=2), dict(banks=4, fast=True),
               dict(banks=2, fast=True, nrefi=24, rows=16)):
        t, j = TX.tiny_spec(std, **kw), JX.tiny_spec(std, **kw)
        assert t.cmd_names == j.cmd_names and t.timings == j.timings
        for f in ("ct_prev", "ct_next", "ct_level", "ct_lat", "ct_win",
                  "level_counts"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
        assert TX.default_alphabet(t) == JX.default_alphabet(j)
        for b in range(int(t.n_banks)):
            np.testing.assert_array_equal(TX.bank_sub(t, b),
                                          JX.bank_sub(j, b))
            assert TX.addr_from_bank(t, b, 3) == JX.addr_from_bank(j, b, 3)
            for lvl in range(len(t.level_counts)):
                assert TX.node_of(t, b, lvl) == JX.node_of(j, b, lvl)


def test_minimize_path_is_the_references():
    """Greedy delta-debugging on a synthetic failure predicate: fails when
    the path still holds a 2 at or before position 4; the divergence is
    observed at the position of the first 2.  Each 2 but the last one
    that keeps it failing goes to the no-op, then the path is cut."""
    class Div:
        def __init__(self, depth):
            self.depth = depth

    def fails(p):
        hits = [i for i, c in enumerate(p[:5]) if c == 2]
        return Div(hits[0]) if hits else None

    path = [1, 3, 2, 1, 2, 3, 1]
    assert TX.minimize_path(path, fails) == JX.minimize_path(path, fails) \
        == (0, 0, 0, 0, 2)
