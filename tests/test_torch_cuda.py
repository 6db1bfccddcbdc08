"""PyTorch port on the card: the CUDA readiness kernel, the fused
controller-step kernel and the engine on ``cuda``, the flash-attention
kernel and the LM serving path.  Every test here needs an NVIDIA GPU and
``nvcc`` and skips without them; on the card run

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither ``jax`` nor ``repro``, so it runs on a machine
with PyTorch alone.  The kernel is held bit for bit against its plain
PyTorch version on device states after random command histories, at
timestamps below and above 2**24.  The fused controller step is held bit
for bit against ``step_and_horizon_plain`` (next state, every event field
and the horizon) on random controller states of all 11 default systems,
both schedulers, refresh on and off, queue depths 8, 32 and 64, three
channels in one launch, several cycles in a row; the engine on ``cuda``
reproduces a golden command stream with one fused launch per executed
step and no call of the plain step.  The flash-attention
kernels are held against their plain version at the reference's
tolerances (fp32 2e-5, bf16 2e-2), each call counted on the route
``flash_attention.route`` picks (the tensor-core kernel also on ragged
and ring-wrapping lengths, Tq != Tk, GQA rep 8 and fused qkv views),
and the reduced GQA Llama of ``tests/torch_serve_fixture.npz`` served on
``cuda`` gives the JAX package's logits (atol 0.2, rtol 0.05) and greedy
tokens.  The fused step over (point x channel) lanes at per-point clocks,
and with every point active at one clock, is held against
``step_lanes_plain`` (1, 5 and 32 points of 1, 2 and 4 channels, DDR4,
LPDDR5, HBM3); ``run_batch`` on ``cuda`` equals the CPU
run point by point, and the ``DDR4@2ch`` golden stream reproduces.  With
BlockHammer, PRAC and a link latency (DDR4, LPDDR5, HBM3, GDDR7; around
the sketch's decay cycles) and with a user predicate (its mask computed
on the card) the fused step equals the plain version; the
``DDR5x2+DDR4x2@80`` system reproduces its golden stream with one fused
launch per spec group and loop iteration, and a run with a user predicate
launches the kernel once per executed step (once per pass on a dual
command bus) and never the plain step.  A paced replay with dependencies
and windowed telemetry on ``cuda`` equals the CPU run window for window,
and a ``repro_torch.dse`` sweep of two groups (and a capturing one) on
the card equals the CPU sweep point by point.  The general (max,+) kernel of
``readiness.cu`` equals its plain version bit for bit in every tile
configuration (int32 sums that wrap, fp32 rows of -inf terms), the
readiness table holds its masks at latencies and timestamps far past the
default ones, ``ops.earliest_for`` on the card equals the CPU's, and
the CUDA-core flash kernel's tiles and unaligned k/v hold the plain
version's tolerances.  The flash backward kernel (training) equals its
plain version (each of dQ, dK, dV: max |diff| within 2e-2 x max |plain|,
relative L2 error within 1e-2), bit for bit from run to run, runs under
autograd, and refuses D 256, fp32 and rows off 16 bytes."""
import itertools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert                             # noqa: E402
from repro_torch.configs import ModelConfig                 # noqa: E402
from repro_torch import testing as T                        # noqa: E402
from repro_torch.core import ControllerConfig, Simulator, compile_spec  # noqa: E402,E501
from repro_torch.core import controller as C                # noqa: E402
from repro_torch.core import device as D                    # noqa: E402
from repro_torch.core import FrontendConfig                 # noqa: E402
from repro_torch.core.standards import DEFAULT_SYSTEMS      # noqa: E402
from repro_torch.kernels import controller_step as KS      # noqa: E402
from repro_torch.kernels import flash_attention as FA       # noqa: E402
from repro_torch.kernels import readiness as R              # noqa: E402
from repro_torch.models import blocks as PB                 # noqa: E402
from repro_torch.models import model as M                   # noqa: E402
from repro_torch.serve.step import make_prefill_step, serve_batch  # noqa: E402,E501
from repro_torch.trace import capture, to_replay, trace_sha256  # noqa: E402

pytestmark = pytest.mark.cuda

HERE = os.path.dirname(os.path.abspath(__file__))
SYSTEMS = [(s, o, t) for s, (o, t) in sorted(DEFAULT_SYSTEMS.items())]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card: "
                    "python -m pytest -q -m cuda tests/test_torch_cuda.py)")
    return torch.device("cuda")


@pytest.mark.parametrize("std,org,tim", SYSTEMS)
def test_kernel_equals_plain_version(cuda, std, org, tim):
    cspec = compile_spec(std, org, tim)
    dp = D.dyn_params(cspec, cuda, channels=3)
    tab = dp.tables.ready
    for seed, clk0 in ((1, 0), (2, (1 << 24) + 777)):
        st, _ = T.random_device_state(cspec, dp, cuda, seed, clk0, channels=3)
        before = R.launch_count
        got = R.readiness_table(tab, st.last_issue, st.win_ring)
        assert R.launch_count == before + 1
        want = R.readiness_table_plain(tab, st.last_issue, st.win_ring)
        torch.cuda.synchronize()
        assert got.shape == (3, cspec.n_cmds, cspec.n_banks)
        assert torch.equal(got, want), (std, clk0)


def test_kernel_rejects_wrong_dtype(cuda):
    cspec = compile_spec("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")
    dp = D.dyn_params(cspec, cuda)
    st = D.init_state(cspec, 1, cuda)
    with pytest.raises(ValueError):
        R.readiness_table(dp.tables.ready, st.last_issue.long(),
                          st.win_ring)


def _maxplus_operands(Q, K, C, dtype, cuda, seed):
    """int32 over the whole range (sums wrap) or fp32 with -3e38 entries
    (outputs whose every term is -inf) and values past 2**24."""
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        T = rng.integers(-(1 << 31), 1 << 31, (Q, K)).astype(np.int32)
        A = rng.integers(-(1 << 31), 1 << 31, (K, C)).astype(np.int32)
    else:
        T = rng.integers(-(1 << 25), 1 << 25, (Q, K)).astype(np.float32)
        A = rng.integers(0, 1 << 24, (K, C)).astype(np.float32)
        T[rng.random((Q, K)) < 0.2] = -3e38
        A[rng.random((K, C)) < 0.5] = -3e38
        T[:1] = -3e38
        A[:, C - 1:] = -3e38
    return torch.as_tensor(T, device=cuda), torch.as_tensor(A, device=cuda)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("Q,K,C", [(8, 16, 8), (32, 30, 10), (1, 1, 1),
                                   (129, 70, 12), (128, 128, 128),
                                   (5, 200, 3), (0, 4, 3), (3, 0, 5),
                                   (300, 257, 130), (1100, 33, 1100)])
def test_maxplus_kernel_equals_plain_version(cuda, dtype, Q, K, C):
    """The general (max,+) kernel in each tile configuration (one block,
    32- and 128-wide tiles, ragged edges) bit for bit with its plain
    version; fp32 through ``timing_check.maxplus_matmul`` (start -3e38),
    int32 through the launcher (start INT32_MIN)."""
    from repro_torch.kernels.timing_check import NEG, maxplus_matmul
    T, A = _maxplus_operands(Q, K, C, dtype, cuda, Q + 7 * K + C)
    init = R.INT32_MIN if dtype == torch.int32 else NEG
    before = R.launch_count
    got = (R.maxplus_cuda(T, A, init) if dtype == torch.int32
           else maxplus_matmul(T, A))
    assert R.launch_count == before + (Q * C > 0)
    want = R.maxplus_plain(T, A, init)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (Q, C)
    if dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)


def test_maxplus_kernel_rejects_what_it_does_not_take(cuda):
    z = lambda *s, dt=torch.int32: torch.zeros(*s, dtype=dt, device=cuda)
    for T, A in ((z(4, 3), z(4, 3)), (z(4, 3), z(3, 2, dt=torch.float32)),
                 (z(4, 3, dt=torch.int64), z(3, 2, dt=torch.int64)),
                 (z(3, 4).T, z(3, 2)), (z(4, 3), z(3, 2).cpu())):
        with pytest.raises(ValueError):
            R.maxplus_cuda(T, A, 0)


@pytest.mark.parametrize("std,org,tim", [SYSTEMS[i] for i in (1, 7, 9)])
def test_readiness_kernel_explicit_masks(cuda, std, org, tim):
    """Latencies past 2**28 and negative ones, and timestamps past the
    2**30 clock cap: the kernel's explicit masks still equal the plain
    version."""
    cspec = compile_spec(std, org, tim)
    dp = D.dyn_params(cspec, cuda, channels=3)
    lat = np.asarray(cspec.ct_lat, np.int64)
    lat[::3] = (1 << 28) + 5
    lat[1::5] = -7
    for tables, clk0 in ((R.build_tables(cspec, lat, cuda), 0),
                         (dp.tables.ready, 5 * (1 << 28) - 100)):
        st, _ = T.random_device_state(cspec, dp, cuda, 4, clk0, channels=3)
        got = R.readiness_table(tables, st.last_issue, st.win_ring)
        want = R.readiness_table_plain(tables, st.last_issue, st.win_ring)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (std, clk0)


@pytest.mark.parametrize("std,org,tim", [SYSTEMS[i] for i in (1, 7, 9)])
def test_readiness_matrix_on_cuda_equals_cpu(cuda, std, org, tim):
    from repro_torch.kernels import ops
    cspec = compile_spec(std, org, tim)
    dp = D.dyn_params(cspec, "cpu", channels=2)
    st, _ = T.random_device_state(cspec, dp, "cpu", 9, 500, channels=2)
    rng = np.random.default_rng(9)
    subs = np.stack([rng.integers(0, int(n), 40) for n in
                     cspec.level_counts[1:]], 1).astype(np.int32)
    cand = rng.integers(0, cspec.n_cmds, 40)
    keys = ops.build_keys(cspec)
    want = ops.earliest_for(cspec, keys, cspec.ct_lat, st, subs, cand)
    before = R.launch_count
    got = ops.earliest_for(cspec, keys, cspec.ct_lat,
                           D.DeviceState(*(f.to(cuda) for f in st)), subs,
                           cand)
    assert R.launch_count == before + 1
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("std,org,tim", SYSTEMS)
def test_fused_step_equals_plain_version(cuda, std, org, tim):
    cspec = compile_spec(std, org, tim)
    dp = D.dyn_params(cspec, cuda, channels=3)
    cases = itertools.product(("FRFCFS", "FCFS"), (True, False), (8, 32, 64),
                              (0, (1 << 24) + 12345))
    for i, (sched, refresh, depth, clk0) in enumerate(cases):
        cfg = ControllerConfig(scheduler=sched, refresh_enabled=refresh)
        cs, clk = T.random_ctrl_state(cspec, dp, cuda, seed=i, clk0=clk0,
                                      depth=depth)
        kcs = T.clone_ctrl(cs)
        for step in range(4):
            before = KS.launch_count
            if step == 3:           # the engine's step without fast-forward
                kcs, kev, _ = T.step_one_point(cspec, dp, cfg, kcs, clk,
                                               False)
                cs, pev = C.controller_step_plain(cspec, dp, cfg, cs, clk)
            else:
                kcs, kev, kh = T.step_one_point(cspec, dp, cfg, kcs, clk)
                cs, pev, ph = C.step_and_horizon_plain(cspec, dp, cfg, cs,
                                                       clk)
                assert torch.equal(kh, ph), (std, sched, refresh, depth, clk)
            assert KS.launch_count == before + 1
            torch.cuda.synchronize()
            where = (std, sched, refresh, depth, clk0, step)
            assert T.ctrl_diff(kcs, cs) == {}, where
            assert T.events_diff(kev, pev) == {}, where
            clk += 1


def test_fused_step_rejects_what_it_does_not_take(cuda):
    cspec = compile_spec("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")
    dp = D.dyn_params(cspec, cuda)
    cs = C.init_ctrl_state(cspec, 32, 1, cuda)
    cfg = ControllerConfig()
    before = KS.launch_count
    bad = cs._replace(queue=cs.queue._replace(row=cs.queue.row.long()))
    with pytest.raises(ValueError):
        T.step_one_point(cspec, dp, cfg, bad, 0)
    bad = cs._replace(dev=cs.dev._replace(last_ref=cs.dev.last_ref.cpu()))
    with pytest.raises(ValueError):
        T.step_one_point(cspec, dp, cfg, bad, 0)
    with pytest.raises(ValueError):
        T.step_one_point(cspec, dp, cfg,
                         C.init_ctrl_state(cspec, 300, 1, cuda), 0)
    with pytest.raises(ValueError):     # leaves (C, ...): no point axis
        C.step_and_horizon(cspec, dp, cfg, cs, *T.one_point(cs, 0)[1:])
    assert KS.launch_count == before


LANE_SYSTEMS = [(s, *DEFAULT_SYSTEMS[s]) for s in ("DDR4", "LPDDR5", "HBM3")]


@pytest.mark.parametrize("std,org,tim", LANE_SYSTEMS)
@pytest.mark.parametrize("points", [1, 5, 32])
@pytest.mark.parametrize("channels", [1, 2, 4])
def test_fused_step_over_lanes_equals_plain_version(cuda, std, org, tim,
                                                    points, channels):
    """One launch over points x channels lanes at per-point clocks (every
    third point inactive), from reset states at clock 0 with refresh
    stagger on and off and from random states, then from random states
    with every point active at one clock (the plain version's one-step
    branch), 3 cycles in a row."""
    cspec = compile_spec(std, org, tim, channels=channels)
    dp = D.dyn_params(cspec, cuda, channels)
    cfg = ControllerConfig()
    for i, case in enumerate(("stagger", "in phase", "random", "lockstep")):
        cs, clk, active = T.lane_case(
            cspec, dp, cuda, i, points, channels,
            case in ("stagger", "in phase"), case == "stagger",
            lockstep=case == "lockstep")
        for step in range(3):
            kcs = T.clone_ctrl(cs)
            before = KS.launch_count
            kcs, kev, kh = C.step_and_horizon(cspec, dp, cfg, kcs, clk,
                                              active)
            cs, pev, ph = C.step_lanes_plain(cspec, dp, cfg, cs, clk, active)
            assert KS.launch_count == before + 1
            torch.cuda.synchronize()
            where = (std, points, channels, case, step)
            assert T.ctrl_diff(kcs, cs) == {}, where
            assert T.events_diff(kev, pev) == {}, where
            assert torch.equal(kh, ph), where
            clk = clk + 1


def test_fused_step_over_lanes_rejects_bad_clocks(cuda):
    cspec = compile_spec("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", channels=2)
    dp = D.dyn_params(cspec, cuda, 2)
    cfg = ControllerConfig()
    cs = C.init_ctrl_state(cspec, 32, 2, cuda, True, 3)
    clk = torch.zeros(3, dtype=torch.int32, device=cuda)
    on = torch.ones(3, dtype=torch.bool, device=cuda)
    before = KS.launch_count
    for bad_clk, bad_on in ((clk.long(), on), (clk, on.int()),
                            (clk[:2], on), (clk.cpu(), on)):
        with pytest.raises(ValueError):
            C.step_and_horizon(cspec, dp, cfg, cs, bad_clk, bad_on)
    assert KS.launch_count == before


def test_run_batch_on_cuda_equals_the_cpu(cuda):
    """``run_batch`` on the card equals the port's CPU run point by point,
    with one fused launch and one host sync per loop iteration."""
    kw = dict(intervals=[16, 2], read_ratios=[1.0, 0.5])
    sim = Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", channels=2)
    before, plain = KS.launch_count, C.plain_calls
    pts, got = sim.run_batch(1500, **kw)
    iters = sim.host_syncs
    assert KS.launch_count - before == iters == max(got.scan_steps)
    assert C.plain_calls == plain
    ref = Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", channels=2,
                    device="cpu")
    _, want = ref.run_batch(1500, **kw)
    for i in range(len(pts)):
        assert got.point(i).to_dict() == want.point(i).to_dict(), pts[i]
    off_sims = [Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", channels=2,
                          fast_forward=False, device=d) for d in (cuda, "cpu")]
    _, off = off_sims[0].run_batch(300, **kw)
    _, off_cpu = off_sims[1].run_batch(300, **kw)
    for i in range(len(pts)):
        assert off.point(i).to_dict() == off_cpu.point(i).to_dict(), pts[i]


def test_telemetry_and_replay_on_cuda_equal_the_cpu(cuda):
    """A paced replay with dependencies and windowed telemetry on the card
    equals the port's CPU run (``Stats`` and every window), with one fused
    launch and one host sync per loop iteration and no plain step."""
    src = Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", device="cpu")
    _, dense = src.run(1200, interval=16.0, read_ratio=0.5, trace=True)
    stream = to_replay(capture(src.cspec, dense), src.cspec, deps=True)
    runs = []
    for d in (cuda, "cpu"):
        sim = Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", replay=stream,
                        frontend=FrontendConfig(pattern="trace"), device=d)
        before, plain = KS.launch_count, C.plain_calls
        stats, telem = sim.run(2000, telemetry=256)
        runs.append((stats, telem))
        if d is cuda:
            assert KS.launch_count - before == sim.host_syncs \
                == stats.scan_steps
            assert C.plain_calls == plain
            telem.check(stats)
    (got, gt), (want, wt) = runs
    assert got.to_dict() == want.to_dict()
    np.testing.assert_array_equal(gt.t_end, wt.t_end)
    for a, b in zip(gt.groups, wt.groups):
        for f in ("reads", "writes", "occ_sum", "cmd_counts", "lat_hist",
                  "probe_lat_sum", "deferred"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_dse_sweep_on_cuda_equals_the_cpu(cuda, monkeypatch):
    """``repro_torch.dse.execute`` of a 2-group sweep on the card equals
    the port's CPU sweep point by point (every column, the command
    counts, each point's captured trace), with one fused launch per loop
    iteration of each group, one host sync each and no plain step; the
    same sweep again from the cache builds no kernel plan."""
    from repro_torch import dse
    from repro_torch.core import engine as E
    from repro_torch.core import FrontendConfig
    spec = dse.SweepSpec(systems=("DDR4", "HBM3"), intervals=(16.0, 2.0),
                         read_ratios=(1.0, 0.5), n_cycles=1500)
    before, plain = KS.launch_count, C.plain_calls
    cache = E.RunCache()
    got = dse.execute(spec, cache=cache)
    assert KS.launch_count - before == got.meta["host_syncs"] == sum(
        g["iterations"] for g in got.meta["groups"])
    assert C.plain_calls == plain and got.meta["device"] == "cuda"
    builds = []
    real = KS.build_plan
    monkeypatch.setattr(KS, "build_plan",
                        lambda *a, **k: builds.append(1) or real(*a, **k))
    again = dse.execute(spec, cache=cache)
    assert builds == [] and again.meta["compile_cache_hits"] == 2
    np.testing.assert_array_equal(again.reads_done, got.reads_done)
    want = dse.execute(spec, cache=E.RunCache(), devices=["cpu"])
    for k in ("throughput_gbps", "latency_ns", "reads_done", "writes_done",
              "probe_cnt", "deferred", "scan_steps", "skipped_cycles"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), k)
    assert [c.tolist() for c in got.cmd_counts] == \
        [c.tolist() for c in want.cmd_counts]
    cap = dse.SweepSpec(systems=("DDR4",), intervals=(8.0, 2.0),
                        read_ratios=(0.7,), n_cycles=800,
                        frontend=FrontendConfig(pattern="random"),
                        capture_traces=True)
    traces = [dse.execute(cap, cache=E.RunCache(), devices=d).traces
              for d in (None, ["cpu"])]
    assert [trace_sha256(t) for t in traces[0]] == \
        [trace_sha256(t) for t in traces[1]]


def test_two_channel_golden_stream_on_cuda(cuda):
    golden = json.load(open(os.path.join(HERE, "trace",
                                         "golden_hashes.json")))["DDR4@2ch"]
    sim = Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", channels=2,
                    mapper="RoBaRaCoCh",
                    controller=ControllerConfig(refresh_stagger=False))
    before = KS.launch_count
    stats, dense = sim.run(3000, interval=2.0, read_ratio=0.7, trace=True)
    assert KS.launch_count - before == stats.scan_steps
    tr = capture(sim.cspec, dense)
    assert len(tr) == golden["n"] and trace_sha256(tr) == golden["sha256"]


PRED_FEATURES = [(3, 0, 0, False), (0, 4, 0, False), (0, 0, 80, False),
                 (3, 4, 80, False), (0, 0, 0, True), (3, 4, 80, True)]


@pytest.mark.parametrize("std", ["DDR4", "LPDDR5", "HBM3", "GDDR7"])
@pytest.mark.parametrize("bh,prac,link,user", PRED_FEATURES)
def test_fused_step_with_predicates_equals_plain_version(cuda, std, bh,
                                                         prac, link, user):
    org, tim = DEFAULT_SYSTEMS[std]
    cspec = compile_spec(std, org, tim)
    dp = D.dyn_params(cspec, cuda, channels=3)
    cfg = ControllerConfig(blockhammer_threshold=bh, prac_threshold=prac,
                           extra_predicates=(T.reads_every_field,) if user
                           else ())
    cs, clk = T.predicate_ctrl_state(cspec, dp, cuda, seed=bh + prac + link,
                                     bh=bh, prac=prac, link=link)
    kcs = T.clone_ctrl(cs)
    for t in T.predicate_clocks(clk, dp.nREFI, 4):
        kcs, kev, kh = T.step_one_point(cspec, dp, cfg, kcs, t, True, link)
        cs, pev, ph = C.step_and_horizon_plain(cspec, dp, cfg, cs, t, link)
        torch.cuda.synchronize()
        assert not T.ctrl_diff(kcs, cs), (std, t)
        assert not T.events_diff(kev, pev), (std, t)
        assert torch.equal(kh, ph), (std, t)


def test_hetero_golden_stream_on_cuda(cuda):
    from repro_torch.core import compile_system
    from repro_torch.trace import FIELDS
    golden = json.load(open(os.path.join(HERE, "trace", "golden_hashes.json"))
                       )["DDR5x2+DDR4x2@80"]
    msys = compile_system([
        dict(standard="DDR5", org_preset="DDR5_16Gb_x8",
             timing_preset="DDR5_4800B", channels=2),
        dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
             timing_preset="DDR4_2400R", channels=2, link_latency=80)])
    sim = Simulator(system=msys,
                    controller=ControllerConfig(scheduler="FRFCFS"))
    before, plain = KS.launch_count, C.plain_calls
    stats, dense = sim.run(3000, interval=2.0, read_ratio=0.7, trace=True)
    assert KS.launch_count - before == 2 * stats.scan_steps
    assert C.plain_calls == plain and sim.host_syncs == stats.scan_steps
    tr = capture(msys, dense)
    assert len(tr) == golden["n"]
    assert trace_sha256(tr, FIELDS + ("group",)) == golden["sha256"]


@pytest.mark.parametrize("std", ["DDR4", "HBM3"])
def test_user_predicate_rides_the_kernel_on_cuda(cuda, std):
    pred = lambda cspec, ctx: ctx.cand_cmd != cspec.id_WR   # noqa: E731
    cfg = ControllerConfig(extra_predicates=(pred,))
    org, tim = DEFAULT_SYSTEMS[std]
    sim = Simulator(std, org, tim, controller=cfg)
    before, plain = KS.launch_count, C.plain_calls
    got = sim.run(600, interval=2.0, read_ratio=0.5)
    passes = 2 if sim.cspec.dual_command_bus else 1
    assert KS.launch_count - before == passes * got.scan_steps
    assert C.plain_calls == plain and got.scan_steps == sim.host_syncs
    want = Simulator(std, org, tim, controller=cfg,
                     device="cpu").run(600, interval=2.0, read_ratio=0.5)
    assert got.to_dict() == want.to_dict()


def test_golden_stream_on_cuda(cuda):
    golden = json.load(open(os.path.join(HERE, "trace",
                                         "golden_hashes.json")))
    sim = Simulator("LPDDR5", "LPDDR5_8Gb_x16", "LPDDR5_6400",
                    controller=ControllerConfig(scheduler="FRFCFS"))
    assert sim.device.type == "cuda"
    before, plain = KS.launch_count, C.plain_calls
    stats, dense = sim.run(3000, interval=2.0, read_ratio=0.7, trace=True)
    assert KS.launch_count - before == stats.scan_steps
    assert C.plain_calls == plain
    tr = capture(sim.cspec, dense)
    assert len(tr) == golden["LPDDR5"]["n"]
    assert trace_sha256(tr) == golden["LPDDR5"]["sha256"]
    assert sim.host_syncs == stats.scan_steps


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_equals_plain_version(cuda, dtype, tol, D, causal):
    gen = torch.Generator(device=cuda).manual_seed(D)
    for T, rep in ((100, 1), (300, 4), (64, 2)):
        q, k, v = ((torch.randn(2, h, T, D, generator=gen, device=cuda)
                    * 0.3).to(dtype) for h in (2 * rep, 2, 2))
        t = lambda x: x.transpose(1, 2).contiguous()
        before = _counts()
        got = FA.gqa_flash_attention(q, k, v, causal=causal)
        got2 = FA.flash_attention_bthd(t(q), t(k), t(v), causal=causal)
        assert _counts() == _stepped(before, FA.route(dtype, D), 2)
        want = FA.attention_plain(q, k, v, causal=causal, sm_scale=D ** -0.5)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == want.shape
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)
        torch.testing.assert_close(got2.transpose(1, 2), want, atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,T,Hq,Hkv,D", [(4, 256, 2, 2, 32),
                                          (1, 256, 2, 2, 16),
                                          (2, 300, 8, 2, 32)])
def test_core_kernel_tiles(cuda, dtype, tol, causal, B, T, Hq, Hkv, D):
    """The reduced model's prefill shape, a ragged last q tile and GQA:
    one counted launch a call, the same bits on a repeat, within the
    tolerance of the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(T + D)
    q, k, v = (torch.randn(B, T, h, D, generator=gen, device=cuda)
               .to(dtype) for h in (Hq, Hkv, Hkv))
    before = _counts()
    got = FA.flash_attention_bthd(q, k, v, causal=causal)
    assert _counts() == _stepped(before, "cuda_core", 1)
    assert torch.equal(FA.flash_attention_bthd(q, k, v, causal=causal), got)
    t = lambda x: x.transpose(1, 2)
    want = t(FA.attention_plain(t(q), t(k), t(v), causal=causal,
                                sm_scale=D ** -0.5))
    torch.cuda.synchronize()
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_core_kernel_unaligned_kv(cuda, dtype, tol):
    """k and v one element off a 16-byte boundary: staged through
    registers instead of cp.async."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    flat = torch.randn(1 + 2 * 100 * 2 * 32, generator=gen,
                       device=cuda).to(dtype)
    k = flat[1:].view(2, 100, 2, 32)
    v = (flat[1:] * 0.5).view(2, 100, 2, 32)
    q = torch.randn(2, 100, 4, 32, generator=gen, device=cuda).to(dtype)
    got = FA.flash_attention_bthd(q, k, v, causal=True)
    t = lambda x: x.transpose(1, 2)
    want = t(FA.attention_plain(t(q), t(k), t(v), causal=True,
                                sm_scale=32 ** -0.5))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


def _counts():
    return {"cuda_core": FA.launch_count, "sm90": FA.sm90_launch_count,
            "d256": FA.d256_launch_count}


def _stepped(before, route, n):
    return {k: c + (n if k == route else 0) for k, c in before.items()}


def _sm90_check(q, k, v, causal, head_axis=2):
    """One sm90 launch (counted on its route alone) within the bf16
    tolerance of the plain version."""
    t = (lambda x: x) if head_axis == 1 else (lambda x: x.transpose(1, 2))
    before = _counts()
    if head_axis == 1:
        got = FA.gqa_flash_attention(q, k, v, causal=causal)
    else:
        got = FA.flash_attention_bthd(q, k, v, causal=causal)
    assert _counts() == _stepped(before, "sm90", 1)
    want = t(FA.attention_plain(t(q), t(k), t(v), causal=causal,
                                sm_scale=q.shape[-1] ** -0.5))
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("rep", [1, 4, 5, 8])
@pytest.mark.parametrize("Tq,Tk", [(100, 100), (300, 300), (1000, 1000),
                                   (4096, 4096), (40, 100)])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_sm90_kernel_equals_plain_version(cuda, causal, D, Tq, Tk, rep):
    """The tensor-core kernel: T 1000 is ragged (7 x 128 + 104), at T 4096
    the 2-stage k/v ring wraps 16 times, Tq != Tk keeps the top-left
    mask; rep 5 is llama4-maverick's 40 q heads on 8 kv heads."""
    gen = torch.Generator(device=cuda).manual_seed(D + Tq + rep)
    q, k, v = (torch.randn(1 if Tq == 4096 else 2, T, h, D, generator=gen,
                           device=cuda).to(torch.bfloat16)
               for T, h in ((Tq, 2 * rep), (Tk, 2), (Tk, 2)))
    _sm90_check(q, k, v, causal)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_sm90_layouts_and_fused_qkv_view(cuda, causal, D):
    gen = torch.Generator(device=cuda).manual_seed(3 * D)
    q, k, v = (torch.randn(2, h, 300, D, generator=gen, device=cuda)
               .to(torch.bfloat16) for h in (8, 2, 2))
    _sm90_check(q, k, v, causal, head_axis=1)
    qkv = torch.randn(2, 300, 12, D, generator=gen, device=cuda).to(
        torch.bfloat16)
    _sm90_check(*qkv.split([8, 2, 2], dim=2), causal)


def test_sm90_rejects_misaligned_tensors(cuda):
    """TMA needs a 16-byte aligned base and 16-byte multiples for its
    strides: the wrapper raises, and neither kernel is launched."""
    flat = torch.zeros(1 + 2 * 64 * 4 * 64, dtype=torch.bfloat16,
                       device=cuda)
    shifted = flat[1:].view(2, 64, 4, 64)
    padded = torch.zeros(2, 64, 4, 68, dtype=torch.bfloat16,
                         device=cuda)[..., :64]
    before = _counts()
    for bad in (shifted, padded):
        with pytest.raises(ValueError):
            FA.flash_attention_bthd(bad, bad, bad, causal=True)
    assert _counts() == before


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    z = lambda *s, dt=torch.bfloat16: torch.zeros(*s, dtype=dt, device=cuda)
    with pytest.raises(ValueError):
        FA.gqa_flash_attention(z(1, 2, 8, 48), z(1, 2, 8, 48),
                               z(1, 2, 8, 48))             # head_dim 48
    with pytest.raises(ValueError):
        FA.gqa_flash_attention(*(z(1, 2, 8, 64, dt=torch.float16),) * 3)
    with pytest.raises(ValueError):
        FA.gqa_flash_attention(z(1, 2, 8, 64), z(1, 2, 8, 64).float(),
                               z(1, 2, 8, 64))


@pytest.mark.parametrize("D,dtype", [(32, torch.bfloat16), (64, torch.bfloat16),
                                     (128, torch.bfloat16),
                                     (256, torch.bfloat16),
                                     (64, torch.float32)])
@pytest.mark.parametrize("window", [1, 64, 100, 2048])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_window_equals_plain_version(cuda, D, dtype, window, causal):
    """Local attention on every route: T 300 (the window cuts through kv
    tiles, and skips whole ones) and 1000 (ragged), GQA rep 4, one counted
    launch a call."""
    gen = torch.Generator(device=cuda).manual_seed(D + window)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    t = lambda x: x.transpose(1, 2)
    for T in (300, 1000):
        q, k, v = (torch.randn(2, T, h, D, generator=gen, device=cuda)
                   .to(dtype) for h in (8, 2, 2))
        before = _counts()
        got = FA.flash_attention_bthd(q, k, v, causal=causal, window=window)
        assert _counts() == _stepped(before, FA.counter(dtype, D), 1)
        want = t(FA.attention_plain(t(q), t(k), t(v), causal=causal,
                                    sm_scale=D ** -0.5, window=window))
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)


def _d256_check(q, k, v, causal, window=None):
    """Both layouts of one D-256 case: two launches of the sm90 kernel,
    counted in ``d256_launch_count`` alone, each within the bf16 tolerance
    of the plain version."""
    t = lambda x: x.transpose(1, 2)
    before = _counts()
    got = FA.flash_attention_bthd(q, k, v, causal=causal, window=window)
    got2 = FA.gqa_flash_attention(t(q).contiguous(), t(k).contiguous(),
                                  t(v).contiguous(), causal=causal,
                                  window=window)
    assert _counts() == _stepped(before, "d256", 2)
    want = t(FA.attention_plain(t(q), t(k), t(v), causal=causal,
                                sm_scale=1 / 16, window=window))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(t(got2), want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("T,window", [(1, None), (100, None), (300, None),
                                      (1000, None), (4096, None),
                                      (4096, 64), (4096, 2048)])
@pytest.mark.parametrize("causal", [True, False])
def test_d256_kernel_mqa(cuda, T, window, causal):
    """Head dim 256 with recurrentgemma-2b's MQA (10 q heads read one kv
    head in place) on the sm90 route's 64-row kv tiles: ragged T, and at
    T 4096 the 2-stage ring wraps 32 times, with and without a window."""
    gen = torch.Generator(device=cuda).manual_seed(T + (window or 0))
    q, k, v = (torch.randn(2 if T == 4096 else 3, T, h, 256, generator=gen,
                           device=cuda).to(torch.bfloat16)
               for h in (10, 1, 1))
    _d256_check(q, k, v, causal, window)


@pytest.mark.parametrize("causal", [True, False])
def test_d256_tq_ne_tk_and_fused_qkv_view(cuda, causal):
    """Tq 40 against Tk 100 (the top-left mask), and q, k, v as head
    slices of one fused (B, T, 10 + 1 + 1, 256) tensor."""
    gen = torch.Generator(device=cuda).manual_seed(256)
    r = lambda *s: torch.randn(*s, generator=gen, device=cuda).to(
        torch.bfloat16)
    _d256_check(r(2, 40, 10, 256), r(2, 100, 1, 256), r(2, 100, 1, 256),
                causal)
    _d256_check(*r(2, 300, 12, 256).split([10, 1, 1], dim=2), causal)


@pytest.mark.parametrize("name", ["qwen3-4b", "qwen3-14b", "glm4-9b",
                                  "recurrentgemma-2b"])
def test_lm_families_fixture_on_cuda(cuda, name):
    """The reduced families of ``tests/torch_lm_families.npz`` (the JAX
    package's weights, prompts and logits) served on the card: prefill
    and teacher-forced decode logits within atol 0.2 / rtol 0.05."""
    z = np.load(os.path.join(HERE, "torch_lm_families.npz"))
    pre = f"{name}@"
    arrs = {k[len(pre):]: z[k] for k in z.files if k.startswith(pre)}
    fields = json.loads(str(arrs["config"]))
    fields["block_pattern"] = tuple(fields["block_pattern"])
    cfg = ModelConfig(**fields)
    params = convert.lm_params(convert.nest(
        {k[len("param."):]: v for k, v in arrs.items()
         if k.startswith("param.")}), cfg, cuda)
    pr = torch.as_tensor(arrs["prompts"], device=cuda)
    B, T = pr.shape
    n = arrs["tokens"].shape[1]
    seq = torch.as_tensor(np.concatenate([arrs["first"][:, None],
                                          arrs["tokens"]], 1), device=cuda)
    before = _counts()
    pos = torch.arange(T, dtype=torch.int32, device=cuda)[None].repeat(B, 1)
    lg, cache = make_prefill_step(cfg, T + n)(
        params, M.Batch(tokens=pr, positions=pos))
    n_attn = sum(k in PB.ATTN_KINDS for k in cfg.pattern_layers())
    assert _counts() == _stepped(before, FA.route(torch.bfloat16,
                                                  cfg.head_dim), n_attn)
    got = [lg[:, -1]]
    for i in range(n):
        lg, cache = M.decode_step(cfg, params, cache, M.Batch(
            tokens=seq[:, i:i + 1],
            positions=torch.full((B, 1), T + i, dtype=torch.int32,
                                 device=cuda),
            cache_index=T + i, cache_len=T + i + 1))
        got.append(lg[:, -1])
    got = torch.stack(got, 1).cpu().numpy()
    want = np.concatenate([arrs["prefill_logits"][:, None],
                           arrs["decode_logits"]], 1)
    np.testing.assert_allclose(got, want, atol=0.2, rtol=0.05)


def test_serve_fixture_on_cuda(cuda):
    z = np.load(os.path.join(HERE, "torch_serve_fixture.npz"))
    fields = json.loads(str(z["config"]))
    fields["block_pattern"] = tuple(fields["block_pattern"])
    cfg = ModelConfig(**fields)
    params = convert.lm_params(convert.nest(
        {k[len("param."):]: z[k] for k in z.files if k.startswith("param.")}),
        cfg, cuda)
    pr = torch.as_tensor(z["prompts"], device=cuda)
    B, T = pr.shape
    n = z["tokens"].shape[1]
    before = _counts()
    toks, first = serve_batch(cfg, params, pr, n)
    route = FA.route(torch.bfloat16, cfg.head_dim)
    assert _counts() == _stepped(before, route, cfg.n_layers)
    want_seq = np.concatenate([z["first"][:, None], z["tokens"]], 1)
    seq = torch.as_tensor(want_seq, device=cuda)
    pos = torch.arange(T, dtype=torch.int32, device=cuda)[None].repeat(B, 1)
    lg, cache = make_prefill_step(cfg, T + n)(
        params, M.Batch(tokens=pr, positions=pos))
    got = [lg[:, -1]]
    for i in range(n):
        lg, cache = M.decode_step(cfg, params, cache, M.Batch(
            tokens=seq[:, i:i + 1],
            positions=torch.full((B, 1), T + i, dtype=torch.int32,
                                 device=cuda),
            cache_index=T + i, cache_len=T + i + 1))
        got.append(lg[:, -1])
    got = torch.stack(got, 1).cpu().numpy()
    want = np.concatenate([z["prefill_logits"][:, None], z["decode_logits"]],
                          1)
    np.testing.assert_allclose(got, want, atol=0.2, rtol=0.05)
    # greedy tokens: a request's token may differ from the JAX package's
    # only at a near tie (top-two margin within twice that position's
    # logit difference); its later tokens are then not compared
    top2 = np.sort(want, -1)[..., -2:]
    tie = top2[..., 1] - top2[..., 0] <= 2 * np.abs(got - want).max(-1)
    got_seq = np.concatenate([first.cpu().numpy()[:, None],
                              toks.cpu().numpy()], 1)
    for b in range(B):
        for i in range(n + 1):
            if got_seq[b, i] != want_seq[b, i]:
                assert tie[b, i], (b, i)
                break


@pytest.mark.parametrize("entry", ["phi3.5-moe-42b-a6.6b",
                                   "phi3.5-moe-42b-a6.6b+cf1",
                                   "llama4-maverick-400b-a17b",
                                   "qwen2-vl-72b", "musicgen-medium",
                                   "xlstm-350m", "llama3.2-1b+kv_quant"])
def test_lm_families_b_fixture_on_cuda(cuda, entry):
    """The reduced MoE, vision, audio, xLSTM and int8-cache entries of
    ``tests/torch_lm_families_b.npz`` served on the card: one flash
    launch per attention (or moe) layer, prefill and teacher-forced decode
    logits within atol 0.2 / rtol 0.05 of the JAX package's, and the
    vision stub's forward too."""
    import torch_parity as tp
    z = np.load(tp.LM_FAMILIES_B_FIXTURE)
    cfg, params, arrs = tp.load_lm_family(z, entry, cuda)
    pr = torch.as_tensor(arrs["prompts"], device=cuda)
    B, T = pr.shape[:2]
    n = arrs["tokens"].shape[1]
    seq = torch.as_tensor(np.concatenate([arrs["first"][:, None],
                                          arrs["tokens"]], 1), device=cuda)
    pos = lambda L, start=0: torch.as_tensor(tp.positions(cfg, B, L, start),
                                             device=cuda)
    before = _counts()
    lg, cache = make_prefill_step(cfg, T + n)(
        params, M.Batch(tokens=pr, positions=pos(T)))
    n_attn = sum(k in PB.ATTN_KINDS for k in cfg.pattern_layers())
    assert _counts() == _stepped(before, FA.route(torch.bfloat16,
                                                  cfg.head_dim), n_attn)
    got = [lg[:, -1]]
    for i in range(n):
        lg, cache = M.decode_step(cfg, params, cache, M.Batch(
            tokens=seq[:, i:i + 1], positions=pos(1, T + i),
            cache_index=T + i, cache_len=T + i + 1))
        got.append(lg[:, -1])
    got = torch.stack(got, 1).cpu().numpy()
    want = np.concatenate([arrs["prefill_logits"][:, None],
                           arrs["decode_logits"]], 1)
    np.testing.assert_allclose(got, want, atol=0.2, rtol=0.05)
    if "vis_embeds" in arrs:
        x, _ = M.forward(cfg, params, M.Batch(
            tokens=pr, positions=pos(T), vis_embeds=torch.as_tensor(
                arrs["vis_embeds"], device=cuda).bfloat16()))
        lg = x.float() @ M._unembed(cfg, params).float()
        np.testing.assert_allclose(lg.cpu().numpy(), arrs["vis_logits"],
                                   atol=0.2, rtol=0.05)


@pytest.mark.parametrize("counts", [(8, 6, 7, 11), (12, 6, 6, 8)])
def test_moe_flat_overflow_on_cuda_equals_cpu(cuda, counts):
    """The flat MoE dispatch's overflow of expert E-1 (the reference's
    in-order scatter zeroes the last kept row of that expert) on the card
    equals the port's CPU result bit for bit in fp32: the inputs make
    every product and sum exact, so only the dispatch's order could
    differ."""
    import dataclasses
    import torch_parity as tp
    from repro_torch.configs import get_arch
    moe, params, x, kept_last = tp.moe_overflow_case(counts)
    cfg = get_arch("phi3.5-moe-42b-a6.6b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    out = {}
    for dev in ("cpu", cuda):
        p = {k: torch.as_tensor(v, device=dev) for k, v in params.items()}
        out[str(dev)], _ = PB.moe_ffn(cfg, p, torch.as_tensor(x, device=dev))
    got, want = out["cuda"].cpu(), out["cpu"]
    assert torch.equal(got, want)
    assert (not got[kept_last].any()) == (counts[-1] > 8)


def _assert_bwd_close(got, want, tol=2e-2):
    """A backward kernel's gradient against its plain version: max |diff|
    within ``tol`` x max |plain| and relative L2 error within ``tol / 2``
    (bf16: 2e-2; fp32 on the CUDA cores: 1e-4, the same fp32 products
    summed in another order)."""
    g, w = got.float(), want.float()
    assert (g - w).abs().max().item() <= tol * w.abs().max().item()
    assert (g - w).norm().item() <= tol / 2 * w.norm().item()


def _bwd_counts():
    return (FA.bwd_launch_count, FA.bwd_sm90_launch_count)


def _bwd_case(cuda, D, causal, window, T, rep, layout, seed,
              dtype=torch.bfloat16, Hkv=2):
    """q, k, v, dO in ``dtype`` and the plain forward's o and lse."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v, do = ((torch.randn(2, T, h, D, generator=gen, device=cuda)
                    * 0.5).to(dtype) for h in (Hkv * rep, Hkv, Hkv,
                                               Hkv * rep))
    t = lambda x: x.transpose(1, 2)
    if layout == 1:
        q, k, v, do = (t(x).contiguous() for x in (q, k, v, do))
    tl = (lambda x: x) if layout == 1 else t
    o, lse = FA.attention_plain(tl(q), tl(k), tl(v), causal=causal,
                                sm_scale=D ** -0.5, window=window,
                                return_lse=True)
    return q, k, v, tl(o), do, lse


def _bwd_check(q, k, v, o, do, lse, tol, **kw):
    """Two calls of the route's backward kernel (one count each, on its
    counter only) against ``attention_backward_plain``; bit-equal reruns."""
    route = FA.route(q.dtype, q.shape[-1])
    before, n = _counts(), _bwd_counts()
    got = FA.attention_backward_cuda(q, k, v, o, do, lse, **kw)
    again = FA.attention_backward_cuda(q, k, v, o, do, lse, **kw)
    step = tuple(2 * (r == route) for r in ("cuda_core", "sm90"))
    assert _counts() == before
    assert tuple(b - a for a, b in zip(n, _bwd_counts())) == step
    want = FA.attention_backward_plain(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    for g, w, a in zip(got, want, again):
        _assert_bwd_close(g, w, tol)
        assert torch.equal(g, a) and g.dtype == q.dtype


@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64), (False, 2048)])
@pytest.mark.parametrize("T,rep,layout", [(100, 1, 2), (300, 4, 1),
                                          (300, 5, 2)])
def test_flash_backward_kernel_equals_plain_version(cuda, D, causal, window,
                                                    T, rep, layout):
    """The bf16 backward kernels (``csrc/flash_attention_bwd_sm90.cu`` at D
    64-256, ``csrc/flash_attention_bwd.cu`` at D 16/32) against
    ``attention_backward_plain`` on the same tensors and lse: dQ, dK, dV
    within :func:`_assert_bwd_close`'s bounds, one counted launch per call
    on the route's counter and no forward count; a second run is bit-equal
    (no atomics)."""
    q, k, v, o, do, lse = _bwd_case(cuda, D, causal, window, T, rep, layout,
                                    D + T + rep)
    _bwd_check(q, k, v, o, do, lse, 2e-2, causal=causal, sm_scale=D ** -0.5,
               window=window, head_axis=layout)


@pytest.mark.parametrize("rep,window,T", [(5, 64, 300), (10, 2048, 2200),
                                          (10, None, 130)])
def test_flash_backward_d256_mqa_equals_plain_version(cuda, rep, window, T):
    """recurrentgemma-2b's case: D 256, MQA (one kv head), a window, T past
    it; the dK/dV kernel's head split and its reduce pass run at these
    shapes (few kv tiles)."""
    q, k, v, o, do, lse = _bwd_case(cuda, 256, True, window, T, rep, 2, 11,
                                    Hkv=1)
    _bwd_check(q, k, v, o, do, lse, 2e-2, causal=True, sm_scale=1 / 16,
               window=window, head_axis=2)


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("causal,window", [(True, None), (False, 64)])
@pytest.mark.parametrize("T,rep,layout", [(100, 1, 2), (300, 4, 1)])
def test_flash_backward_fp32_kernel_equals_plain_version(cuda, D, causal,
                                                         window, T, rep,
                                                         layout):
    """fp32 on the CUDA cores (``csrc/flash_attention_bwd.cu``) against the
    plain version at fp32's bound."""
    q, k, v, o, do, lse = _bwd_case(cuda, D, causal, window, T, rep, layout,
                                    D + T, dtype=torch.float32)
    _bwd_check(q, k, v, o, do, lse, 1e-4, causal=causal, sm_scale=D ** -0.5,
               window=window, head_axis=layout)


#: the CUDA-core backward's tile edges (as ``chip_smoke.EDGE_T`` and
#: ``EDGE_MASKS``; window 1 without the causal mask, which with it leaves
#: dQ = dK = 0 exactly)
EDGE_T = (31, 32, 33, 63, 65, 257)
EDGE_MASKS = ((True, None), (False, 1), (True, 31), (False, 33))


@pytest.mark.parametrize("dtype,D,tol", [(torch.bfloat16, 16, 2e-2),
                                         (torch.bfloat16, 32, 2e-2),
                                         (torch.float32, 16, 1e-4),
                                         (torch.float32, 32, 1e-4),
                                         (torch.float32, 64, 1e-4),
                                         (torch.float32, 128, 1e-4)])
@pytest.mark.parametrize("t", range(len(EDGE_T)))
@pytest.mark.parametrize("m", range(len(EDGE_MASKS)))
def test_flash_backward_core_tile_edges(cuda, dtype, D, tol, t, m):
    """The CUDA-core backward's one launch at its tile edges (32-row bf16
    and 64-row fp32 own tiles, 64-row other tiles, 32 at fp32 D 128):
    T 31-257, windows 1, 31 and 33, GQA rep 1, 2 and 5 and both layouts
    in turn, against the plain version; one count a call, bit-equal
    reruns."""
    causal, window = EDGE_MASKS[m]
    rep = (1, 2, 5)[(t + m) % 3]
    q, k, v, o, do, lse = _bwd_case(cuda, D, causal, window, EDGE_T[t], rep,
                                    (1, 2)[(t + m // 2) % 2], D + t + m,
                                    dtype=dtype, Hkv=1 if rep == 5 else 2)
    _bwd_check(q, k, v, o, do, lse, tol, causal=causal, sm_scale=D ** -0.5,
               window=window, head_axis=(1, 2)[(t + m // 2) % 2])


def test_forward_kernels_write_lse_only_when_asked(cuda):
    """With ``return_lse`` each forward kernel writes the rows' lse (equal
    to the plain version's within 1e-3 in log2 units); without it the same
    output and no buffer."""
    for D, dtype in ((64, torch.bfloat16), (256, torch.bfloat16),
                     (32, torch.bfloat16), (64, torch.float32)):
        q, k, v, o, do, lse = _bwd_case(cuda, D, True, 64, 200, 2, 2, 5,
                                        dtype=dtype)
        out, got = FA.attention_cuda(q, k, v, causal=True, sm_scale=D ** -0.5,
                                     head_axis=2, window=64, return_lse=True)
        plain = FA.attention_cuda(q, k, v, causal=True, sm_scale=D ** -0.5,
                                  head_axis=2, window=64)
        assert torch.equal(out, plain)
        assert (got - lse).abs().max().item() <= 1e-3


def test_flash_autograd_on_cuda_runs_the_backward_kernel(cuda):
    """Training's route: with inputs requiring grad, the entry point saves
    its inputs, output and lse, and the backward launches the kernel (never
    the plain version), the forward counted as before."""
    q, k, v, o, do, _ = _bwd_case(cuda, 64, True, None, 200, 4, 2, 7)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    before, n = _counts(), _bwd_counts()
    out = FA.flash_attention_bthd(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert _counts() == _stepped(before, "sm90", 1)
    assert _bwd_counts() == (n[0], n[1] + 1)
    want = FA.attention_backward_plain(q.detach(), k.detach(), v.detach(),
                                       out.detach(), do, causal=True,
                                       sm_scale=1 / 8, head_axis=2)
    for g, w in zip(grads, want):
        _assert_bwd_close(g, w)


def test_flash_backward_refuses_d256_and_fp32_on_the_card(cuda):
    """fp32 at D 256 has no kernel, forward or backward (as the forward
    refuses it): both raise ValueError, never fall back to the plain
    version."""
    q, k, v = (torch.zeros(1, 64, 2, 256, dtype=torch.float32, device=cuda,
                           requires_grad=True) for _ in range(3))
    with pytest.raises(ValueError, match="head_dim 256"):
        FA.flash_attention_bthd(q, k, v, causal=True)
    lse = torch.zeros(1, 2, 64, device=cuda)
    n = _bwd_counts()
    with pytest.raises(ValueError, match="head_dim 256"):
        FA.attention_backward_cuda(*(x.detach() for x in (q, k, v, q, q)),
                                   lse, causal=True, sm_scale=1 / 16,
                                   head_axis=2)
    assert _bwd_counts() == n


def test_flash_backward_refuses_rows_off_16_bytes(cuda):
    """The CUDA-core backward stages q, k, v and dO rows by 16-byte
    ``cp.async``, the sm90 one reads them by TMA: a tensor whose rows do
    not start on 16 bytes raises ``ValueError`` on either route (the
    model's projections and the autograd route's contiguous dO always
    do)."""
    for D, match in ((32, "16 bytes"), (64, "16-byte aligned")):
        q, k, v, o, do, lse = _bwd_case(cuda, D, True, None, 64, 1, 2, 3)
        kw = dict(causal=True, sm_scale=D ** -0.5, head_axis=2)
        odd = torch.zeros(2, 64, 2, D + 1, dtype=torch.bfloat16,
                          device=cuda)[..., 1:]
        odd.copy_(k)
        n = _bwd_counts()
        for args in ((q, odd, v, o, do), (q, k, v, o, odd)):
            with pytest.raises(ValueError, match=match):
                FA.attention_backward_cuda(*args, lse, **kw)
        assert _bwd_counts() == n
