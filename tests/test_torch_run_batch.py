"""PyTorch port, batched design points (``Simulator.run_batch``).

The points run in lockstep, each at its own clock, as the reference's
``vmap`` of its fast-forward ``lax.while_loop``: every loop iteration
executes one cycle of each point still below ``n_cycles``, a finished
point stays frozen, and each point's ``scan_steps`` counts its own
executed cycles.  Here, on the CPU, against the reference and the port's
own scalar runs (tolerance 0):

* per-point ``Stats`` of DDR4 with 2 channels, intervals [8, 2] x read
  ratios [1.0, 0.5], 1,500 cycles, fast-forward on and off (the port's
  own scalar runs and the fixture: ``test_torch_run_batch_fixture.py``);
* a point that finishes early stays frozen while the others run on;
* the host-side per-point LCG maps ``(a_d, c_d)`` against ``d`` single
  steps, and the batched idle jump against the scalar one;
* one host sync per loop iteration and no other read-back.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                  # noqa: E402

from repro.core import Simulator as JSim                    # noqa: E402

from repro_torch.core import FrontendConfig, Simulator, compile_spec  # noqa: E402,E501
from repro_torch.core import controller as TC               # noqa: E402
from repro_torch.core import frontend as TF                 # noqa: E402

SYS = ("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")
RUN = dict(n_cycles=1500, intervals=[8, 2], read_ratios=[1.0, 0.5])


def _point(stats, i):
    return jax.tree.map(lambda a: np.asarray(a)[i], stats)


@functools.lru_cache(maxsize=None)
def _port(fast_forward):
    sim = Simulator(*SYS, channels=2, device="cpu", fast_forward=fast_forward)
    pts, stats = sim.run_batch(RUN["n_cycles"], RUN["intervals"],
                               RUN["read_ratios"])
    return pts, stats, sim.host_syncs


@functools.lru_cache(maxsize=None)
def _reference(fast_forward):
    pts, stats = JSim(*SYS, channels=2, fast_forward=fast_forward).run_batch(
        RUN["n_cycles"], RUN["intervals"], RUN["read_ratios"])
    return pts, [_point(stats, i).to_dict() for i in range(len(pts))]


@pytest.mark.parametrize("fast_forward", [True, False])
def test_points_equal_reference(fast_forward):
    pts, stats, _ = _port(fast_forward)
    jpts, want = _reference(fast_forward)
    assert pts == jpts == [(8, 1.0), (8, 0.5), (2, 1.0), (2, 0.5)]
    assert [stats.point(i).to_dict() for i in range(len(pts))] == want
    assert tuple(stats.cmd_counts.shape) == (4, compile_spec(*SYS).n_cmds)
    assert tuple(stats.per_channel.reads_done.shape) == (4, 2)


def test_per_point_scan_steps_and_syncs():
    pts, stats, syncs = _port(True)
    steps = list(stats.scan_steps)
    # light points skip idle cycles, saturated ones execute every cycle
    assert steps[0] < steps[2] == RUN["n_cycles"]
    assert list(stats.skipped_cycles) == [RUN["n_cycles"] - s for s in steps]
    assert syncs == max(steps)                   # one per loop iteration
    _, _, per_cycle_syncs = _port(False)
    assert per_cycle_syncs == 0
    assert list(_port(False)[1].scan_steps) == [RUN["n_cycles"]] * 4


def test_finished_point_stays_frozen():
    """A short run's point that finishes early is frozen: with more
    cycles for the others its stats do not move, and an inactive
    point's frontend and controller lanes keep their state."""
    sim = Simulator(*SYS, channels=2, device="cpu")
    _, a = sim.run_batch(300, [64], [1.0])
    _, b = sim.run_batch(300, [64, 1], [1.0])
    assert a.point(0).to_dict() == b.point(0).to_dict()
    assert int(b.scan_steps[0]) < int(b.scan_steps[1]) == 300

    cspec, cfg = sim.cspec, FrontendConfig(interval=1.0)
    ft = TF.front_tables(cspec, cfg, 2, "cpu")
    fp = TF.stack_params([(1.0, 0.5), (1.0, 0.5)], cfg.probe_gap, "cpu")
    fs = TF.init_front(7, "cpu", 2)
    cs = TC.init_ctrl_state(cspec, 8, 2, "cpu", True, 2)
    active = torch.tensor([True, False])
    clk = torch.tensor([5, 9], dtype=torch.int32)
    q, draft = TF.frontend_insert(cspec, cfg, fp, fs, cs.queue, clk, ft,
                                  active)
    assert draft.okp.tolist() == [1, 0] and draft.ok.tolist() == [1, 0]
    assert int(draft.rng[1]) == int(fs.rng[1]) != int(draft.rng[0])
    assert int(draft.accum[1]) == int(fs.accum_fp[1])
    assert not q.valid[1].any() and int(q.valid[0].sum()) == 2
    cs1, ev, h = TC.step_lanes_plain(cspec, sim.dp, TC.ControllerConfig(),
                                     cs._replace(queue=q), clk, active)
    for x, y in zip(cs1.dev, cs.dev):
        assert torch.equal(x[1], y[1])
    assert ev.cmd[1].eq(-1).all() and not ev.served_read[1].any()
    assert h[1].eq(TC.HORIZON_MAX).all()


@pytest.mark.parametrize("k", [6, 13])
def test_host_lcg_maps_equal_single_steps(k):
    a, c = TF.lcg_affine(k)
    rng = np.random.default_rng(k)
    xs = torch.tensor(rng.integers(0, 1 << 32, 6, dtype=np.uint64)
                      .astype(np.int64))
    ds = [0, 1, 2, 7, 30, 513]
    ra = torch.tensor([TF.lcg_power(d, a, c)[0] for d in ds])
    rc = torch.tensor([TF.lcg_power(d, a, c)[1] for d in ds])
    got = TF.lcg_apply(xs, ra, rc)
    for i, d in enumerate(ds):
        x = xs[i]
        for _ in range(d * k):
            x = TF._lcg(x)
        assert int(got[i]) == int(x), d
        assert int(TF.lcg_jump(xs[i], d, a, c)) == int(x), d
    # the batched idle jump equals the scalar one point by point
    cfg = FrontendConfig()
    fs = TF.init_front(3, "cpu", len(ds))._replace(
        accum_fp=torch.tensor([0, 10, 300, 5000, 16383, 16384],
                              dtype=torch.int32), rng=xs)
    refill = torch.tensor([min(256 * d, cfg.max_backlog_fp) for d in ds],
                          dtype=torch.int32)
    got = TF.idle_jump(cfg, fs, refill, ra, rc, k)
    for i, d in enumerate(ds):
        one = TF.idle_advance(cfg, TC._tree(lambda t: t[i], fs), d, a, c, k)
        assert int(got.accum_fp[i]) == int(one.accum_fp)
        assert int(got.rng[i]) == int(one.rng)


def test_batched_loop_reads_back_only_its_syncs():
    from torch.profiler import ProfilerActivity, profile
    sim = Simulator(*SYS, channels=2, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, stats = sim.run_batch(20, [2, 16], [0.8])
    reads = [e.key for e in prof.events()
             if e.key in ("aten::_local_scalar_dense", "aten::item")]
    assert reads == []
    assert sim.host_syncs == max(stats.scan_steps) == 20
