"""PyTorch port, windowed telemetry of a batch of design points:
``make_run(points=P, telemetry_window=W)`` snapshots every point at its
own clock, element for element as the reference's vmapped run
(``RUN_CACHE.get(batched=True, telemetry=W)``), tolerance 0."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                    # noqa: E402
from repro.core import Simulator as JSim                   # noqa: E402
from repro.core import frontend as JF                      # noqa: E402
from repro.core.engine import RUN_CACHE                    # noqa: E402

from repro_torch.core import Simulator                     # noqa: E402
from repro_torch.core import frontend as F                 # noqa: E402
from repro_torch.core.engine import make_run               # noqa: E402

DDR4 = ("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")


def test_batched_points_snapshot_at_their_own_clocks():
    """Two load points, one light (it skips idle cycles), one saturated:
    each lands on the boundaries in different iterations."""
    n, W, seed = 1500, 256, 0x1234
    pts = [(16.0, 0.5), (2.0, 0.5)]
    jsim = JSim(*DDR4, channels=2)
    fn = RUN_CACHE.get(jsim._cache_spec, jsim.controller, jsim.frontend, n,
                       batched=True, telemetry=W)
    jstats, jsnaps = fn(jsim._dyn_params(),
                        JF.stack_params(pts, jsim.frontend.probe_gap),
                        jnp.uint32(seed))
    sim = Simulator(*DDR4, channels=2, device="cpu")
    res = make_run(sim.msys, sim.controller, sim.frontend, n, False,
                   points=2, telemetry_window=W)(
        sim.dps, F.stack_params(pts, sim.frontend.probe_gap, "cpu"), seed,
        "cpu")
    stats, snaps = res.out
    steps = [int(v) for v in stats.scan_steps]
    assert steps[0] < steps[1] == n
    assert res.host_syncs == max(steps)
    for (jg, pg) in zip(jsnaps, snaps):
        assert pg.tm.shape[:2] == (6, 2)
        for p in range(2):
            for f in jg.ch._fields:
                np.testing.assert_array_equal(
                    np.asarray(getattr(jg.ch, f))[p], getattr(pg.ch, f)[:, p],
                    err_msg=f)
            np.testing.assert_array_equal(np.asarray(jg.tm)[p], pg.tm[:, p])
    for p in range(2):
        one = jax_point(jstats, p)
        assert stats.point(p).to_dict() == one.to_dict()


def jax_point(stats, i):
    import jax
    return jax.tree.map(lambda a: np.asarray(a)[i], stats)
