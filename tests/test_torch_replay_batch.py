"""PyTorch port, ``run_batch`` over a replay: a DDR4 trace's
``to_replay(deps=True)`` stream without its arrival clocks (so each point
paces it at its own interval, the dependency holds kept) replays at
intervals [8, 2], each point to the reference's ``Stats`` (tolerance
0)."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax                                                 # noqa: E402
from repro.core import FrontendConfig as JFront            # noqa: E402
from repro.core import Simulator as JSim                   # noqa: E402
from repro.trace import capture as j_capture                # noqa: E402
from repro.trace import to_replay as j_to_replay            # noqa: E402

from repro_torch.core import FrontendConfig, Simulator     # noqa: E402
from repro_torch.trace import capture, to_replay           # noqa: E402

DDR4 = ("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")


def test_run_batch_over_a_replay_equals_reference():
    """The stream paces at each point's interval (no ``arrive``), its
    dependency holds kept."""
    src = dict(interval=4.0, read_ratio=0.5, seed=3, trace=True)
    js, jd = JSim(*DDR4).run(1000, **src)
    jr = j_to_replay(j_capture(JSim(*DDR4).cspec, jd), JSim(*DDR4).cspec,
                     deps=True)
    sim = Simulator(*DDR4, device="cpu")
    _, dense = sim.run(1000, **src)
    pr = to_replay(capture(sim.cspec, dense), sim.cspec, deps=True)
    unpaced = lambda r: dataclasses.replace(r, arrive=None, fingerprint="")
    jr, pr = unpaced(jr), unpaced(pr)
    assert pr.fingerprint == jr.fingerprint

    jpts, jstats = JSim(*DDR4, frontend=JFront(pattern="trace"),
                        replay=jr).run_batch(1500, [8.0, 2.0], [1.0])
    bsim = Simulator(*DDR4, frontend=FrontendConfig(pattern="trace"),
                     replay=pr, device="cpu")
    pts, stats = bsim.run_batch(1500, [8.0, 2.0], [1.0])
    assert pts == jpts
    for i in range(len(pts)):
        want = jax.tree.map(lambda a, i=i: np.asarray(a)[i], jstats)
        assert stats.point(i).to_dict() == want.to_dict(), pts[i]
    assert stats.scan_steps[0] < stats.scan_steps[1]
    assert bsim.host_syncs == max(int(v) for v in stats.scan_steps)
