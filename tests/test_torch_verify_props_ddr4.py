"""PyTorch port, property-based invariants (``repro_torch.verify.
verify_properties``) on DDR4 on the CPU: the three adversarial streams
(bursty, row-conflict, refresh-starving; 4,000 cycles, nREFI 400, seed 7)
run through the port's ``Simulator`` and give the reference's
``PropertyReport`` exactly (``tests/torch_verify_stats.json``): clean
audit, refresh deadline, window and starvation checks with the same
counts, details and info; and with refresh disabled the refresh-deadline
check bites as the reference's does.  The stream generators equal the
reference's.
"""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.verify import properties as JP                  # noqa: E402
from repro_torch import verify                             # noqa: E402
from repro_torch.core import ControllerConfig              # noqa: E402
from repro_torch.verify import properties as TP            # noqa: E402

import torch_parity as tp                                  # noqa: E402

DOC = json.load(open(tp.VERIFY_FIXTURE))["properties"]


@pytest.mark.parametrize("key", [k for k in tp.PROPERTY_CASES
                                 if k.startswith("DDR4/")])
def test_ddr4_properties_equal_the_references(key):
    rep = tp.property_run(verify, ControllerConfig, key, device="cpu")
    assert tp.property_doc(rep) == DOC[key]
    if key == "DDR4/refresh_disabled":
        assert rep.checks["refresh_deadline"] > 0
        assert rep.checks["audit_clean"] == 0
    else:
        assert rep.ok and rep.info["served"] > 10


@pytest.mark.parametrize("kind", sorted(TP.STREAMS))
@pytest.mark.parametrize("seed", [0, 5])
def test_streams_equal_the_references(kind, seed):
    from repro.verify.explore import tiny_spec as jtiny
    t = TP.STREAMS[kind](verify.tiny_spec("DDR4", banks=4, rows=16),
                         seed=seed, n=64)
    j = JP.STREAMS[kind](jtiny("DDR4", banks=4, rows=16), seed=seed, n=64)
    for f in ("chan", "sub", "row", "col", "is_write", "arrive"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
    assert t.fingerprint == j.fingerprint


def test_bounds_equal_the_references():
    from repro.core.controller import ControllerConfig as JCC
    from repro.verify.explore import tiny_spec as jtiny
    for kw in (dict(banks=2), dict(banks=4, fast=True)):
        t, j = verify.tiny_spec("DDR4", **kw), jtiny("DDR4", **kw)
        for q in (2, 8):
            assert TP.refresh_deadline_bound(t, ControllerConfig(
                queue_depth=q)) == JP.refresh_deadline_bound(
                j, JCC(queue_depth=q))
            assert TP.starvation_bound(t, ControllerConfig(queue_depth=q)) \
                == JP.starvation_bound(j, JCC(queue_depth=q))
