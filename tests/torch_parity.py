"""Shared helpers of the ``test_torch_*`` parity tests: the same inputs,
made from numpy seeds, go through the JAX reference (``repro``) and the
PyTorch port (``repro_torch``).  The simulator's results are compared
exactly — both are integer state machines, so the tolerance is 0.  The
LM serving path's are compared at the reference's own tolerances
(``LOGITS_TOL`` for logits); its helpers are at the end of this file.

    PYTHONPATH=src python tests/torch_parity.py --write-serve-fixture

rewrites ``tests/torch_serve_fixture.npz`` from the JAX package, and

    PYTHONPATH=src python tests/torch_parity.py --write-sim-fixtures

rewrites ``tests/torch_batch_stats.json``,
``tests/torch_multichannel_stats.json``, ``tests/torch_hetero_stats.json``,
``tests/torch_telemetry_stats.json``, ``tests/torch_replay_stats.json``,
``tests/torch_dse_stats.json`` and ``tests/torch_verify_stats.json``, and

    PYTHONPATH=src python tests/torch_parity.py --write-example-fixtures

rewrites ``tests/torch_examples_stats.json`` and
``tests/torch_examples_serve.npz`` (the reference examples' sessions at
their own sizes: a few minutes of JAX on the CPU), and

    PYTHONPATH=src python tests/torch_parity.py --write-lm-families-fixture

rewrites ``tests/torch_lm_families.npz`` (the reduced qwen3-4b,
qwen3-14b, glm4-9b and recurrentgemma-2b served by the JAX package), and

    PYTHONPATH=src python tests/torch_parity.py --write-lm-families-b-fixture

rewrites ``tests/torch_lm_families_b.npz`` (the reduced MoE, xLSTM,
vision, audio and int8-cache configurations of ``LM_FAMILIES_B``), and

    PYTHONPATH=src python tests/torch_parity.py --write-lm-train-fixture

rewrites ``tests/torch_lm_train.npz`` (the loss, gradients and one AdamW
step of the ten reduced configurations, ``LM_TRAIN_ARCHS``)."""
from __future__ import annotations

import functools
import hashlib
import json
import os

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = json.load(open(os.path.join(HERE, "trace", "golden_hashes.json")))
MAIN_FIXTURE = os.path.join(HERE, "torch_main_path_stats.json")
BATCH_FIXTURE = os.path.join(HERE, "torch_batch_stats.json")
MULTI_FIXTURE = os.path.join(HERE, "torch_multichannel_stats.json")

#: the batched latency-throughput session ``chip_smoke.py`` holds the port
#: to: 8 intervals x 4 read ratios over a 4-channel DDR4 system (refresh
#: stagger on, probes on), ``run_batch`` at the README session's length
BATCH_RUN = dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
                 timing_preset="DDR4_2400R", channels=4, n_cycles=20_000,
                 intervals=[1, 1.5, 2, 3, 4, 6, 8, 16],
                 read_ratios=[1.0, 0.8, 0.6, 0.5], seed=0x1234)
#: the 4-channel scalar session (``examples/multichannel.py``'s arguments)
MULTI_RUN = dict(standard="HBM3", org_preset="HBM3_16Gb",
                 timing_preset="HBM3_5200", channels=4, mapper="RoBaRaCoCh",
                 n_cycles=10_000, interval=0.5, read_ratio=0.9, seed=0x1234)

#: the three standards the device/controller/engine parity tests cover:
#: plain, split activation + data-clock sync, dual command bus
TRIO = [("DDR4", "DDR4_8Gb_x8", "DDR4_2400R"),
        ("LPDDR5", "LPDDR5_8Gb_x16", "LPDDR5_6400"),
        ("HBM3", "HBM3_16Gb", "HBM3_5200")]


def default_systems() -> dict:
    from repro.dse.spec import DEFAULT_SYSTEMS
    return dict(DEFAULT_SYSTEMS)


def jax_history_state(std, org, tim, seed=3, steps=50, clk0=0):
    """Replay a random legal command history through the reference's
    scalar ``DeviceUnderTest`` oracle, then apply it with the reference's
    ``device.issue``.  Returns ``(jax cspec, jax dp, jax DeviceState,
    history, numpy rng)``."""
    import jax
    import jax.numpy as jnp
    from repro.core import DeviceUnderTest
    from repro.core import device as D
    rng = np.random.default_rng(seed)
    dut = DeviceUnderTest(std, org, tim)
    cspec = dut.cspec
    clk = clk0
    for _ in range(steps):
        sub = {lv: int(rng.integers(int(cspec.level_counts[i + 1])))
               for i, lv in enumerate(cspec.levels[1:])}
        addr = dict(sub, row=int(rng.integers(32)), col=0)
        cmd = dut.probe("RD" if rng.random() < 0.7 else "WR", addr,
                        clk).preq
        if dut.probe(cmd, addr, clk).timing_OK:
            if cmd == "ACT2":
                addr = dict(addr, row=int(dut.act1_row[dut._bank(addr)]))
            dut.issue(cmd, addr, clk=clk)
        clk += int(rng.integers(1, 6))
    dp = D.dyn_params(cspec)
    issue = jax.jit(lambda s, c, sub, row, clk: D.issue(
        cspec, dp, s, c, sub, row, clk, jnp.asarray(True)))
    state = D.init_state(cspec)
    for c, cmd, addr in dut.history:
        sub = jnp.asarray([addr[lv] for lv in cspec.levels[1:]], jnp.int32)
        state = issue(state, jnp.int32(cspec.cmd_id(cmd)), sub,
                      jnp.int32(addr["row"]), jnp.int32(c))
    return cspec, dp, state, dut.history, rng


def random_ctrl(std, org, tim, seed, depth=32):
    """A reference CtrlState with a legal device history, a random queue
    (with forced arrival ties) and refresh units around their due time,
    plus the clock to step from."""
    import jax.numpy as jnp
    from repro.core import controller as JC
    jc, jdp, jstate, history, rng = jax_history_state(std, org, tim,
                                                      seed=seed)
    clk = int(history[-1][0]) + 3 if history else 10
    nrefi = int(jc.timings["nREFI"])
    last_ref = clk - nrefi + rng.integers(-6, 3, jc.n_refresh_units)
    jstate = jstate._replace(last_ref=jnp.asarray(last_ref, jnp.int32))
    counts = [int(c) for c in jc.level_counts[1:]]
    sub = np.stack([rng.integers(0, c, depth) for c in counts], 1)
    arrive = clk - rng.integers(1, 5, depth)          # many equal arrivals
    valid = rng.random(depth) < 0.75
    valid[:2] = True
    arrive[1] = arrive[0]
    q = JC.Queue(valid=jnp.asarray(valid),
                 is_write=jnp.asarray(rng.random(depth) < 0.3),
                 is_probe=jnp.asarray(rng.random(depth) < 0.15),
                 sub=jnp.asarray(sub, jnp.int32),
                 row=jnp.asarray(rng.integers(0, 32, depth), jnp.int32),
                 col=jnp.asarray(rng.integers(0, 8, depth), jnp.int32),
                 arrive=jnp.asarray(arrive, jnp.int32))
    cs = JC.init_ctrl_state(jc, depth)._replace(
        dev=jstate, queue=q,
        hit_streak=jnp.asarray(rng.integers(0, 4, jc.n_banks), jnp.int32),
        prac_count=jnp.asarray(rng.integers(0, 3, jc.n_banks), jnp.int32))
    return jc, jdp, cs, clk


def predicate_ctrl(std, org, tim, seed, bh=0, prac=0, link=0, depth=32):
    """:func:`random_ctrl` with BlockHammer and PRAC state around their
    thresholds and arrivals around the link boundary: sketch counts in
    ``[0, 2 bh)`` (so some rows are blacklisted and some not), in each
    refresh unit every bank's PRAC counter below ``prac`` or, in about
    half of the units, one bank at it, and arrivals from ``link + 4``
    before the clock to 4 after ``clk - link``."""
    import jax.numpy as jnp
    jc, jdp, cs, clk = random_ctrl(std, org, tim, seed, depth)
    rng = np.random.default_rng(seed + 31)
    if bh:
        cs = cs._replace(bh_sketch=jnp.asarray(
            rng.integers(0, 2 * bh, cs.bh_sketch.shape), jnp.int32))
    if prac:
        B, U = jc.n_banks, jc.n_refresh_units
        count = rng.integers(max(prac - 3, 0), prac, B)
        for u in range(U):
            if rng.random() < 0.5:
                count[u * (B // U) + rng.integers(B // U)] = prac
        cs = cs._replace(prac_count=jnp.asarray(count, jnp.int32))
    if link:
        arrive = clk - link + rng.integers(-4, 5, depth)
        cs = cs._replace(queue=cs.queue._replace(
            arrive=jnp.asarray(arrive, jnp.int32)))
    return jc, jdp, cs, clk


def tree_np(x):
    import jax
    return jax.tree.map(np.asarray, x)


def assert_tree_equal(jax_nt, torch_nt, what=""):
    """Field-by-field exact equality of a reference NamedTuple (one
    channel, numpy leaves) and the port's (leading channel axis of 1)."""
    from repro_torch.convert import to_numpy
    port = to_numpy(torch_nt)
    for name in jax_nt._fields:
        a, b = getattr(jax_nt, name), getattr(port, name)
        if hasattr(a, "_fields"):
            assert_tree_equal(a, getattr(torch_nt, name), f"{what}.{name}")
            continue
        a = np.asarray(a)
        b = np.asarray(b)
        if b.ndim == a.ndim + 1:
            assert b.shape[0] == 1, (what, name, b.shape)
            b = b[0]
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                      err_msg=f"{what}.{name}")


def trace_sha256(tr) -> str:
    """The golden-hash digest (as ``tests/trace/test_golden_equality``)."""
    from repro.trace.capture import FIELDS
    h = hashlib.sha256()
    for f in FIELDS:
        h.update(np.ascontiguousarray(getattr(tr, f), np.int32).tobytes())
    return h.hexdigest()


def port_golden_run(std, fast_forward=True):
    """Run the port on the CPU at the golden configuration, once per
    process; returns ``(stats, cspec, CommandTrace)``, the trace captured
    with the controller and frontend metadata (which the golden hash's
    columns do not read)."""
    return _port_golden_run(std, bool(fast_forward))


@functools.lru_cache(maxsize=None)
def _port_golden_run(std, fast_forward):
    from repro_torch.core import ControllerConfig, Simulator
    from repro_torch.trace import capture
    org, tim = default_systems()[std]
    sim = Simulator(std, org, tim, device="cpu", fast_forward=fast_forward,
                    controller=ControllerConfig(scheduler="FRFCFS"))
    stats, dense = sim.run(3000, interval=2.0, read_ratio=0.7, trace=True)
    return stats, sim.cspec, capture(sim.cspec, dense,
                                     controller=sim.controller,
                                     frontend=sim.frontend)


def port_golden(std, fast_forward=True):
    """Run the port on the CPU at the golden configuration; returns
    ``(stats, CommandTrace)``."""
    stats, _, tr = port_golden_run(std, fast_forward)
    return stats, tr


def check_golden(std, fast_forward=True):
    """The port's command stream hashes to the reference's golden value
    (checked with both packages' digest functions)."""
    from repro_torch.trace import trace_sha256 as port_sha
    stats, tr = port_golden(std, fast_forward)
    want = GOLDEN[std]
    assert len(tr) == want["n"], (std, len(tr))
    assert trace_sha256(tr) == want["sha256"], std
    assert port_sha(tr) == want["sha256"], std
    return stats


def jax_stats_dict(std, n_cycles=3000, interval=2.0, read_ratio=0.7,
                   fast_forward=True):
    from repro.core import ControllerConfig, Simulator
    org, tim = default_systems()[std]
    sim = Simulator(std, org, tim, fast_forward=fast_forward,
                    controller=ControllerConfig(scheduler="FRFCFS"))
    return sim.run(n_cycles, interval=interval,
                   read_ratio=read_ratio).to_dict()


TELEMETRY_FIELDS = ("reads", "writes", "probe_lat_sum", "probe_cnt",
                    "data_bus_busy", "deferred", "occ_sum", "cmd_counts",
                    "lat_hist")


def assert_telemetry_equal(jt, tt):
    """Every window's counters, window ends and group metadata of the
    reference's ``Telemetry`` ``jt`` equal the port's ``tt`` exactly."""
    assert (jt.window, jt.n_cycles) == (tt.window, tt.n_cycles)
    np.testing.assert_array_equal(jt.t_end, tt.t_end)
    assert len(jt.groups) == len(tt.groups)
    for g, (a, b) in enumerate(zip(jt.groups, tt.groups)):
        for f in ("standard", "channels", "link_latency", "tCK_ps",
                  "access_bytes", "cmd_names", "lat_edges"):
            assert getattr(a, f) == getattr(b, f), (g, f)
        for f in TELEMETRY_FIELDS:
            x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            assert x.shape == y.shape, (g, f, x.shape, y.shape)
            np.testing.assert_array_equal(x, y, err_msg=f"group {g} {f}")
    assert jt.meta == tt.meta


#: the windowed-telemetry cases of ``tests/test_torch_telemetry*.py``: a
#: ragged DDR4 run, one shorter than its window, one of exactly four
#: windows, a 2-channel HBM3 run and a DDR5 + CXL-DDR4@40 system
TELEMETRY_HETERO = [dict(standard="DDR5", org_preset="DDR5_16Gb_x8",
                         timing_preset="DDR5_4800B", channels=1),
                    dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
                         timing_preset="DDR4_2400R", channels=1,
                         link_latency=40)]

#: (name, Simulator arguments, cycles, window, run arguments)
TELEMETRY_CASES = {
    "ddr4_ragged": (dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
                         timing_preset="DDR4_2400R"), 1500, 256,
                    dict(interval=6.0, read_ratio=0.7)),
    "hbm3_2ch": (dict(standard="HBM3", org_preset="HBM3_16Gb",
                      timing_preset="HBM3_5200", channels=2), 2000, 128,
                 dict(interval=3.0, read_ratio=0.8)),
    "hetero": (dict(system=TELEMETRY_HETERO), 1200, 300,
               dict(interval=2.0, read_ratio=0.7)),
    "short": (dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
                   timing_preset="DDR4_2400R"), 100, 256, dict(interval=4.0)),
    "exact": (dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
                   timing_preset="DDR4_2400R"), 1024, 256,
              dict(interval=8.0, read_ratio=0.5)),
}


def telemetry_pair(kw, n, W, run, **sim_kw):
    """The reference's and the port's ``(stats, telem)`` of one case."""
    from repro.core import Simulator as JSim
    from repro_torch.core import Simulator
    js, jt = JSim(**kw, **sim_kw).run(n, telemetry=W, **run)
    sim = Simulator(**kw, device="cpu", **sim_kw)
    s, t = sim.run(n, telemetry=W, **run)
    return js, jt, s, t, sim


def check_telemetry_case(case, rerun=True):
    """The case's windows equal the reference's and sum to its ``Stats``;
    with ``rerun`` the port's run without telemetry gives the same
    counters (fast-forward executes more steps with telemetry: a jump
    stops at each window boundary)."""
    kw, n, W, run = TELEMETRY_CASES[case]
    js, jt, s, t, sim = telemetry_pair(kw, n, W, run)
    assert s.to_dict() == js.to_dict()
    assert_telemetry_equal(jt, t)
    t.check(s)
    jt.check(s)
    assert t.n_windows == max(-(-n // W), 1)
    assert sim.host_syncs == s.scan_steps       # no sync of its own
    if rerun:
        from repro_torch.core import Simulator
        plain = Simulator(**kw, device="cpu").run(n, **run).to_dict()
        got = s.to_dict()
        for d in (plain, got):
            d.pop("scan_steps")
            d.pop("skipped_cycles")
        assert plain == got


def check_config(sim_kw: dict, n_cycles=1500, controller=None,
                 frontend=None, **run):
    """A DDR-family run of the port on the CPU (``Simulator(**sim_kw)``)
    gives the reference's ``Stats.to_dict()`` and command-stream sha256;
    ``controller`` / ``frontend`` are the two configs' keyword arguments.
    Returns the port's stats."""
    from repro.core import ControllerConfig as JCtl
    from repro.core import FrontendConfig as JFront
    from repro.core import Simulator as JSim
    from repro.trace import capture as j_capture
    from repro_torch.core import ControllerConfig, FrontendConfig, Simulator
    from repro_torch.trace import capture
    ctl, front = controller or {}, frontend or {}
    jsim = JSim(**sim_kw, controller=JCtl(**ctl), frontend=JFront(**front))
    js, jd = jsim.run(n_cycles, trace=True, **run)
    sim = Simulator(**sim_kw, controller=ControllerConfig(**ctl),
                    frontend=FrontendConfig(**front), device="cpu")
    s, dense = sim.run(n_cycles, trace=True, **run)
    assert s.to_dict() == js.to_dict()
    assert trace_sha256(capture(sim.cspec, dense)) \
        == trace_sha256(j_capture(jsim.cspec, jd))
    return s


def batch_fixture() -> dict:
    """The reference's ``run_batch`` of :data:`BATCH_RUN`: the run, the
    points in ``run_batch``'s order and each point's ``Stats.to_dict()``."""
    import jax
    from repro.core import Simulator
    r = BATCH_RUN
    sim = Simulator(r["standard"], r["org_preset"], r["timing_preset"],
                    channels=r["channels"])
    pts, stats = sim.run_batch(r["n_cycles"], r["intervals"],
                               r["read_ratios"], seed=r["seed"])
    return dict(run=r, points=[list(p) for p in pts],
                stats=[jax.tree.map(lambda a, i=i: np.asarray(a)[i],
                                    stats).to_dict()
                       for i in range(len(pts))])


def multichannel_fixture() -> dict:
    """The reference's ``Stats.to_dict()`` of :data:`MULTI_RUN`."""
    from repro.core import Simulator
    r = MULTI_RUN
    sim = Simulator(r["standard"], r["org_preset"], r["timing_preset"],
                    channels=r["channels"], mapper=r["mapper"])
    stats = sim.run(r["n_cycles"], interval=r["interval"],
                    read_ratio=r["read_ratio"], seed=r["seed"])
    return dict(run=r, stats=stats.to_dict())


#: the memory system of ``examples/hetero_system.py``: two DDR5 channels
#: and two CXL-attached DDR4 channels (80 cycles of link latency)
HETERO_SYSTEM = [dict(standard="DDR5", org_preset="DDR5_16Gb_x8",
                      timing_preset="DDR5_4800B", channels=2),
                 dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
                      timing_preset="DDR4_2400R", channels=2,
                      link_latency=80)]
#: the sessions ``chip_smoke.py`` holds the port to on the card
#: (``tests/torch_hetero_stats.json``): the example's session, ``run_batch``
#: over its system, and the predicate sessions of
#: ``benchmarks/bench_features.py`` (BlockHammer on a 2-row hammer and on
#: benign traffic, PRAC on 4 rows) plus ``tests/core/test_controllers.py``'s
#: user predicate, each a DDR4_8Gb_x8 / DDR4_2400R run
HETERO_RUN = dict(n_cycles=20_000, interval=1.0, read_ratio=0.7,
                  seed=0x1234)
HETERO_BATCH = dict(n_cycles=4_000, intervals=[8.0, 2.0], read_ratios=[1.0],
                    seed=0x1234)
PREDICATE_RUNS = {
    "blockhammer": dict(controller=dict(blockhammer_threshold=8),
                        frontend=dict(pattern="random", probes=False),
                        rows=2, n_cycles=20_000, interval=2.0,
                        read_ratio=1.0),
    "blockhammer_benign": dict(controller=dict(blockhammer_threshold=1024),
                               frontend=dict(probes=False), rows=None,
                               n_cycles=20_000, interval=2.0,
                               read_ratio=1.0),
    "prac": dict(controller=dict(prac_threshold=16),
                 frontend=dict(pattern="random", probes=False), rows=4,
                 n_cycles=20_000, interval=2.0, read_ratio=1.0),
    "no_writes_ever": dict(controller=dict(extra_predicates=[
        "no_writes_ever"]), frontend=dict(probes=False), rows=None,
        n_cycles=4_000, interval=2.0, read_ratio=0.5),
}
HETERO_FIXTURE = os.path.join(HERE, "torch_hetero_stats.json")


def no_writes_ever(cspec, ctx):
    """``tests/core/test_controllers.py``'s user predicate: the same
    expression runs on the reference's and the port's tensors."""
    return ctx.cand_cmd != cspec.id_WR


USER_PREDICATES = {"no_writes_ever": no_writes_ever}


def stats_doc(stats) -> dict:
    """``Stats.to_dict()`` of one scalar run (either package's) plus every
    ``per_group`` leaf as lists, in each group's own namespace."""
    d = stats.to_dict()
    d["per_group"] = [{k: np.asarray(
        v.cpu() if hasattr(v, "cpu") else v).tolist()
        for k, v in ch._asdict().items()} for ch in stats.per_group]
    return d


def controller_kwargs(run: dict) -> dict:
    """A :data:`PREDICATE_RUNS` entry's controller options, the user
    predicates resolved by name."""
    c = dict(run["controller"])
    if "extra_predicates" in c:
        c["extra_predicates"] = tuple(USER_PREDICATES[n]
                                      for n in c["extra_predicates"])
    return c


def hetero_fixture() -> dict:
    """The reference's results of the card's system and predicate
    sessions (:data:`HETERO_RUN`, :data:`HETERO_BATCH`,
    :data:`PREDICATE_RUNS`)."""
    import jax
    from repro.core import ControllerConfig, FrontendConfig, Simulator
    from repro.core import compile_system
    msys = compile_system(HETERO_SYSTEM)
    r = HETERO_RUN
    session = Simulator(system=msys).run(
        r["n_cycles"], interval=r["interval"], read_ratio=r["read_ratio"],
        seed=r["seed"])
    b = HETERO_BATCH
    pts, stats = Simulator(system=msys).run_batch(
        b["n_cycles"], b["intervals"], b["read_ratios"], seed=b["seed"])
    batch = [stats_doc(jax.tree.map(lambda a, i=i: np.asarray(a)[i], stats))
             for i in range(len(pts))]
    preds = {}
    for name, p in PREDICATE_RUNS.items():
        sim = Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R",
                        controller=ControllerConfig(**controller_kwargs(p)),
                        frontend=FrontendConfig(**p["frontend"]))
        if p["rows"]:
            sim.cspec.rows = p["rows"]
        preds[name] = dict(run=p, stats=stats_doc(sim.run(
            p["n_cycles"], interval=p["interval"],
            read_ratio=p["read_ratio"])))
    return dict(system=HETERO_SYSTEM,
                session=dict(run=r, stats=stats_doc(session)),
                batch=dict(run=b, points=[list(p) for p in pts],
                           stats=batch),
                predicates=preds)


TELEMETRY_FIXTURE = os.path.join(HERE, "torch_telemetry_stats.json")
REPLAY_FIXTURE = os.path.join(HERE, "torch_replay_stats.json")
#: the telemetry sessions ``chip_smoke.py`` phase 15 holds the port to
#: (``tests/torch_telemetry_stats.json``): the README's DDR5 session in
#: 1,000-cycle windows and the hetero system in 256-cycle windows
TELEMETRY_RUNS = dict(
    session=dict(standard="DDR5", org_preset="DDR5_16Gb_x8",
                 timing_preset="DDR5_4800B", n_cycles=20_000, interval=2.0,
                 read_ratio=0.8, seed=0x1234, window=1000),
    hetero=dict(n_cycles=4_000, interval=1.0, read_ratio=0.7, seed=0x1234,
                window=256))
#: the replay sessions of phase 15 (``tests/torch_replay_stats.json``): a
#: DDR4 source run captured and turned into a paced stream with
#: dependencies, replayed 20,000 cycles without probes; the same for the
#: hetero system (probes on); and ``run_batch`` over the DDR4 stream
#: without its arrival clocks (probes on)
REPLAY_RUNS = dict(
    source=dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
                timing_preset="DDR4_2400R", n_cycles=4_000, interval=4.0,
                read_ratio=0.5, seed=0x1234),
    replay=dict(n_cycles=20_000, seed=0x1234),
    hetero_source=dict(n_cycles=4_000, interval=4.0, read_ratio=0.5,
                       seed=0x1234),
    hetero_replay=dict(n_cycles=4_000, seed=0x1234),
    batch=dict(n_cycles=4_000, intervals=[8.0, 2.0], read_ratios=[1.0],
               seed=0x1234))


def telemetry_doc(telem) -> dict:
    """A ``Telemetry`` (either package's) as JSON-ready lists."""
    return dict(t_end=np.asarray(telem.t_end).tolist(), groups=[
        {f: np.asarray(getattr(g, f)).tolist() for f in TELEMETRY_FIELDS}
        for g in telem.groups])


def telemetry_fixture() -> dict:
    """The reference's ``(stats, telemetry)`` of :data:`TELEMETRY_RUNS`."""
    from repro.core import Simulator
    s = dict(TELEMETRY_RUNS["session"])
    sim = Simulator(s.pop("standard"), s.pop("org_preset"),
                    s.pop("timing_preset"))
    doc = dict(runs=TELEMETRY_RUNS, system=HETERO_SYSTEM)
    for name, sim in (("session", sim),
                      ("hetero", Simulator(system=HETERO_SYSTEM))):
        r = TELEMETRY_RUNS[name]
        stats, telem = sim.run(r["n_cycles"], interval=r["interval"],
                               read_ratio=r["read_ratio"], seed=r["seed"],
                               telemetry=r["window"])
        doc[name] = dict(stats=stats_doc(stats),
                         telemetry=telemetry_doc(telem))
    return doc


def replay_fixture() -> dict:
    """The reference's replay sessions of :data:`REPLAY_RUNS`: each
    stream's fingerprint and length, each replay's ``Stats`` (every
    ``per_group`` leaf for the system) and command-stream digest."""
    import dataclasses
    import jax
    from repro.core import FrontendConfig, Simulator, compile_system
    from repro.trace import capture, to_replay
    from repro.trace.capture import FIELDS
    r = REPLAY_RUNS
    src = r["source"]
    sim = Simulator(src["standard"], src["org_preset"], src["timing_preset"])
    msys = compile_system(HETERO_SYSTEM)

    def stream(sim, spec, s):
        _, dense = sim.run(s["n_cycles"], interval=s["interval"],
                           read_ratio=s["read_ratio"], seed=s["seed"],
                           trace=True)
        return to_replay(capture(spec, dense), spec, deps=True)

    def digest(tr, fields=FIELDS):
        h = hashlib.sha256()
        for f in fields:
            h.update(np.ascontiguousarray(getattr(tr, f), np.int32)
                     .tobytes())
        return dict(n=len(tr), sha256=h.hexdigest())

    rs = stream(sim, sim.cspec, src)
    doc = dict(runs=r, system=HETERO_SYSTEM,
               source=dict(fingerprint=rs.fingerprint, n=len(rs)))
    rep = Simulator(src["standard"], src["org_preset"], src["timing_preset"],
                    frontend=FrontendConfig(pattern="trace", probes=False),
                    replay=rs)
    stats, dense = rep.run(r["replay"]["n_cycles"], seed=r["replay"]["seed"],
                           trace=True)
    doc["replay"] = dict(stats=stats.to_dict(),
                         **digest(capture(rep.cspec, dense)))

    hs = stream(Simulator(system=msys), msys, r["hetero_source"])
    rep = Simulator(system=msys, frontend=FrontendConfig(pattern="trace"),
                    replay=hs)
    stats, dense = rep.run(r["hetero_replay"]["n_cycles"],
                           seed=r["hetero_replay"]["seed"], trace=True)
    doc["hetero"] = dict(fingerprint=hs.fingerprint, n_stream=len(hs),
                         stats=stats_doc(stats),
                         **digest(capture(msys, dense), FIELDS + ("group",)))

    unpaced = dataclasses.replace(rs, arrive=None, fingerprint="")
    b = r["batch"]
    pts, stats = Simulator(
        src["standard"], src["org_preset"], src["timing_preset"],
        frontend=FrontendConfig(pattern="trace"), replay=unpaced).run_batch(
        b["n_cycles"], b["intervals"], b["read_ratios"], seed=b["seed"])
    doc["batch"] = dict(fingerprint=unpaced.fingerprint,
                        points=[list(p) for p in pts],
                        stats=[jax.tree.map(lambda a, i=i: np.asarray(a)[i],
                                            stats).to_dict()
                               for i in range(len(pts))])
    return doc


DSE_FIXTURE = os.path.join(HERE, "torch_dse_stats.json")
#: ``chip_smoke.py`` phase 16: the paper's Fig. 1 sweep
#: (``benchmarks/bench_latency_throughput.py``'s 11 standards x 6
#: intervals x 3 read ratios, FR-FCFS) cut to 5,000 cycles: 198 points in
#: 11 compile groups (``tests/torch_dse_stats.json``)
DSE_FIG1 = dict(
    systems=[["DDR3", "DDR3_8Gb_x8", "DDR3_1600K"],
             ["DDR4", "DDR4_8Gb_x8", "DDR4_2400R"],
             ["DDR5", "DDR5_16Gb_x8", "DDR5_4800B"],
             ["LPDDR5", "LPDDR5_8Gb_x16", "LPDDR5_6400"],
             ["LPDDR6", "LPDDR6_16Gb_x16", "LPDDR6_8533"],
             ["GDDR6", "GDDR6_8Gb_x16", "GDDR6_16"],
             ["GDDR7", "GDDR7_16Gb_x32", "GDDR7_32"],
             ["HBM2", "HBM2_8Gb", "HBM2_2Gbps"],
             ["HBM3", "HBM3_16Gb", "HBM3_5200"],
             ["HBM4", "HBM4_24Gb", "HBM4_8000"],
             ["DDR5_VRR", "DDR5_16Gb_x8", "DDR5_4800B"]],
    intervals=[64.0, 16.0, 8.0, 4.0, 2.0, 1.0], read_ratios=[1.0, 0.8, 0.5],
    n_cycles=5_000, seed=0x1234, scheduler="FRFCFS")
#: phase 16's trace-capture check: two DDR4 points with capture_traces
DSE_CAPTURE = dict(systems=["DDR4"], intervals=[8.0, 2.0],
                   read_ratios=[0.7], n_cycles=2_000, seed=0x1234,
                   scheduler="FRFCFS")
#: the per-point columns of a sweep the fixture holds
DSE_COLUMNS = ("throughput_gbps", "latency_ns", "peak_gbps", "reads_done",
               "writes_done", "probe_cnt", "deferred", "cycles",
               "scan_steps", "skipped_cycles")


def sweep_spec(dse, run: dict, **kw):
    """The ``SweepSpec`` of :data:`DSE_FIG1` / :data:`DSE_CAPTURE` in
    either package (``dse`` is ``repro.dse`` or ``repro_torch.dse``; the
    controller config comes from the same package)."""
    import importlib
    core = importlib.import_module(dse.__name__.split(".")[0] + ".core")
    return dse.SweepSpec(
        systems=tuple(s if isinstance(s, str) else tuple(s)
                      for s in run["systems"]),
        intervals=tuple(run["intervals"]),
        read_ratios=tuple(run["read_ratios"]), n_cycles=run["n_cycles"],
        seed=run["seed"],
        controllers=(core.ControllerConfig(scheduler=run["scheduler"]),),
        **kw)


def sweep_doc(result) -> dict:
    """A ``SweepResult``'s per-point columns and command counts as lists
    (floats as JSON numbers: ``repr`` round-trips them exactly)."""
    return dict(
        columns={k: np.asarray(getattr(result, k)).tolist()
                 for k in DSE_COLUMNS},
        cmd_counts=[np.asarray(c).tolist() for c in result.cmd_counts],
        cmd_names=[list(n) for n in result.cmd_names],
        labels=[pt.label for pt in result.points],
        n_groups=result.meta["n_groups"])


def packages():
    """``(reference, port)``: each a namespace of its ``core``, ``dse`` and
    ``engine`` modules, for specs built the same way in both."""
    import importlib
    import types
    out = []
    for top in ("repro", "repro_torch"):
        out.append(types.SimpleNamespace(
            core=importlib.import_module(top + ".core"),
            dse=importlib.import_module(top + ".dse"),
            engine=importlib.import_module(top + ".core.engine")))
    return tuple(out)


def assert_sweep_equal(j, t):
    """Two ``SweepResult``s (reference ``j``, port ``t``) agree point by
    point: every column (floats bit for bit, NaN where NaN), the command
    counts and names, the points and the curves."""
    for k in DSE_COLUMNS:
        a, b = np.asarray(getattr(j, k)), np.asarray(getattr(t, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert [c.tolist() for c in map(np.asarray, t.cmd_counts)] == \
        [c.tolist() for c in map(np.asarray, j.cmd_counts)]
    assert t.cmd_names == j.cmd_names
    assert [p.label for p in t.points] == [p.label for p in j.points]
    jc, tc = j.curves(), t.curves()
    assert len(jc) == len(tc)
    for a, b in zip(jc, tc):
        assert (a.system, a.scheduler, a.read_ratio, a.knee, a.n_channels,
                a.peak_gbps, a.peak_fraction) == \
            (b.system, b.scheduler, b.read_ratio, b.knee, b.n_channels,
             b.peak_gbps, b.peak_fraction)
        for f in ("intervals", "throughput_gbps", "latency_ns"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for k in ("n_points", "n_groups", "compile_cache_misses",
              "compile_cache_hits", "traces", "seed", "padded_points"):
        assert t.meta[k] == j.meta[k], k
    assert t.meta["profile"]["fast_forward"] == \
        j.meta["profile"]["fast_forward"]
    assert t.to_table() == j.to_table()


def check_sweep(make_spec, **kw):
    """Execute ``make_spec(pkg)`` (a ``SweepSpec`` built from ``pkg.core``
    and ``pkg.dse``) in both packages, each with a fresh cache, the port
    on the CPU; assert the results equal and return ``(ref, port)``."""
    jp, tp = packages()
    j = jp.dse.execute(make_spec(jp), cache=jp.engine.RunCache(), **kw)
    t = tp.dse.execute(make_spec(tp), cache=tp.engine.RunCache(),
                       devices=["cpu"], **kw)
    assert_sweep_equal(j, t)
    return j, t


def dse_fixture() -> dict:
    """The reference's ``repro.dse.execute`` of :data:`DSE_FIG1` and of
    the capture sweep :data:`DSE_CAPTURE` (each point's command-stream
    digest and length) on the CPU."""
    from repro import dse
    from repro.core import engine as JE
    fig1 = dse.execute(sweep_spec(dse, DSE_FIG1), cache=JE.RunCache())
    cap = dse.execute(sweep_spec(dse, DSE_CAPTURE, capture_traces=True),
                      cache=JE.RunCache())
    return dict(fig1=dict(run=DSE_FIG1, **sweep_doc(fig1)),
                capture=dict(run=DSE_CAPTURE, **sweep_doc(cap),
                             traces=[dict(n=len(t), sha256=trace_sha256(t))
                                     for t in cap.traces]))


# ---------------------------------------------------------------------------
# The validation workflow (``repro.verify``, ``trace.audit``, the
# visualizers and the CLIs): its runs, JSON docs of its results (either
# package's objects) and the reference's side in ``VERIFY_FIXTURE``
# ---------------------------------------------------------------------------

VERIFY_FIXTURE = os.path.join(HERE, "torch_verify_stats.json")
#: the smoke matrix's standards (``explore.smoke``'s default)
VERIFY_STANDARDS = ("DDR4", "DDR5", "HBM3")
#: the miscompiled spec of ``tests/verify/test_explore.py``: ACT->RD
#: loosened by one cycle on a fast 2-bank DDR4, explored without the table
#: check (an illegal issue) and with it (a table mismatch one layer
#: earlier)
LOOSEN = dict(standard="DDR4", banks=2, fast=True, prev="ACT",
              following="RD", queue_depth=2)
LOOSEN_CASES = {"counterexample": dict(depth=12, check_tables=False),
                "table_divergence": dict(depth=6, check_tables=True)}
#: the refresh-pressure exploration of ``tests/verify/test_explore.py``
REFRESH_PRESSURE = dict(standard="DDR4", banks=2, fast=True, nrefi=24,
                        depth=30, queue_depth=2, max_frontier=64)
_DDR4 = dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
             timing_preset="DDR4_2400R")
#: the property runs of ``tests/verify/test_properties.py``: (system
#: arguments, stream, ``verify_properties`` keywords, controller keywords)
PROPERTY_CASES = {
    f"DDR4/{k}": (_DDR4, k, dict(n_cycles=4000, seed=7, nrefi=400), None)
    for k in ("bursty", "refresh_starving", "row_conflict")}
PROPERTY_CASES.update({
    "HBM3x2/row_conflict": (
        dict(standard="HBM3", org_preset="HBM3_16Gb",
             timing_preset="HBM3_5200", channels=2), "row_conflict",
        dict(n_cycles=4000, seed=3, nrefi=400), None),
    "hetero/bursty": (
        dict(system=[dict(standard="DDR5", org_preset="DDR5_16Gb_x8",
                          timing_preset="DDR5_4800B", channels=1),
                     dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
                          timing_preset="DDR4_2400R", channels=1,
                          link_latency=40)]),
        "bursty", dict(n_cycles=6000, seed=11), None),
    "DDR4/refresh_disabled": (
        _DDR4, "refresh_starving", dict(n_cycles=4000, seed=7, nrefi=400),
        dict(queue_depth=8, refresh_enabled=False))})
#: the golden trace of ``tests/trace/test_mutation_matrix.py`` (and of the
#: golden hashes): 3000 cycles, interval 2.0, read ratio 0.7, FR-FCFS
MUTATION_RUN = dict(n_cycles=3000, interval=2.0, read_ratio=0.7)
#: the CLI runs held to the reference's artifacts (``{dir}`` is a temporary
#: directory); the port's runs add ``--device cpu`` (``analysis`` runs no
#: simulation)
CLI_RUNS = {
    "trace": ("trace", ["--standard", "DDR4", "--cycles", "2000",
                        "--out", "{dir}/t.npz", "--html", "{dir}/t.html",
                        "--jsonl", "{dir}/t.jsonl", "--fail-on-violations"]),
    "trace_hetero": ("trace", ["--group", "DDR5:1", "--group", "DDR4:1:80",
                               "--cycles", "1000", "--out", "{dir}/h.npz",
                               "--html", "{dir}/h.html",
                               "--fail-on-violations"]),
    "telemetry": ("telemetry", ["--standard", "DDR4", "--cycles", "2000",
                                "--window", "256", "--out", "{dir}/w.npz",
                                "--html", "{dir}/w.html",
                                "--jsonl", "{dir}/w.jsonl", "--check"]),
    "analysis_spec": ("analysis", ["spec", "--standard", "DDR5",
                                   "--channels", "4", "--override",
                                   "nRCD=50", "--out", "{dir}/lint.json"]),
    "analysis_diff": ("analysis", ["diff", "DDR4", "DDR5"]),
    "verify_diff": ("verify", ["diff", "--fixtures",
                               os.path.join(HERE, "verify", "fixtures")]),
    "verify_loosen": ("verify", ["explore", "--standard", "DDR4", "--loosen",
                                 "ACT:RD", "--expect-counterexample",
                                 "--artifact-dir", "{dir}"]),
}


def sha(text) -> str:
    if isinstance(text, str):
        text = text.encode()
    return hashlib.sha256(text).hexdigest()


def explore_doc(res) -> dict:
    """An ``ExploreResult``'s counts, flag and divergences."""
    return dict(states_explored=res.states_explored, edges=res.edges,
                commands_checked=res.commands_checked,
                tables_checked=res.tables_checked, truncated=res.truncated,
                divergences=[str(d) for d in res.divergences],
                text=str(res))


def trace_doc(tr) -> dict:
    """A ``CommandTrace``'s columns (with ``group``), length, names and
    metadata."""
    cols = {f: np.asarray(getattr(tr, f)).tolist()
            for f in ("clk", "cmd", "bank", "row", "bus", "arrive",
                      "hit_ready", "chan", "group")}
    return dict(cols, n_cycles=int(tr.n_cycles),
                cmd_names=list(tr.cmd_names), meta=tr.meta)


def trace_digest(tr) -> dict:
    """:func:`trace_doc` with its columns digested (artifacts of long
    runs)."""
    doc = trace_doc(tr)
    cols = ("clk", "cmd", "bank", "row", "bus", "arrive", "hit_ready",
            "chan", "group")
    h = hashlib.sha256()
    for f in cols:
        h.update(np.asarray(doc.pop(f), np.int32).tobytes())
    return dict(doc, n=len(tr), sha256=h.hexdigest())


def cex_doc(res, row: int) -> dict:
    """A miscompiled-spec exploration: its result, the loosened row, and
    the minimized counterexample (path, divergence, trace)."""
    cex = res.counterexample
    return dict(explore_doc(res), row=int(row), path=list(cex.path),
                divergence=str(cex.divergence), trace=trace_doc(cex.trace))


def loosened_run(verify, ControllerConfig, case: str, **kw):
    """``(row, ExploreResult)`` of :data:`LOOSEN_CASES` ``[case]`` in one
    package (``verify`` its ``verify`` module); ``kw`` goes to
    ``explore`` (``device=``, ``artifact_dir=``)."""
    c = LOOSEN
    oracle = verify.tiny_spec(c["standard"], banks=c["banks"],
                              fast=c["fast"])
    bad, row = verify.loosen_constraint(oracle, c["prev"], c["following"],
                                        amount=1)
    res = verify.explore(
        bad, oracle=oracle, ccfg=ControllerConfig(
            queue_depth=c["queue_depth"]), standard=c["standard"],
        config_doc=dict(standard=c["standard"], banks=c["banks"], rows=8,
                        columns=8, fast=c["fast"]),
        **LOOSEN_CASES[case], **kw)
    return row, res


def refresh_pressure_run(verify, ControllerConfig, **kw):
    c = REFRESH_PRESSURE
    cspec = verify.tiny_spec(c["standard"], banks=c["banks"], fast=c["fast"],
                             nrefi=c["nrefi"])
    return verify.explore(cspec, depth=c["depth"],
                          ccfg=ControllerConfig(queue_depth=c["queue_depth"]),
                          alphabet=(None, (0, 0, False)),
                          max_frontier=c["max_frontier"],
                          standard=c["standard"], **kw)


def explore_walk_specs(X, ControllerConfig) -> list:
    """The specs on which the exploration transition is held, kernel
    against plain version (``testing.explore_walk``): ``(key, cspec,
    ccfg)`` for the 9 smoke specs and DDR4's loosened ACT->RD spec
    (``X`` the port's ``verify.explore`` module)."""
    out = []
    for std in VERIFY_STANDARDS:
        for name, tkw, ckw, _ in X.SMOKE_CONFIGS:
            out.append((f"{std}/{name}", X.tiny_spec(std, **tkw),
                        ControllerConfig(**ckw)))
    loose, _ = X.loosen_constraint(X.tiny_spec("DDR4", banks=2, fast=True))
    out.append(("DDR4/loosened", loose, ControllerConfig(queue_depth=2)))
    return out


def property_run(verify, ControllerConfig, key: str, **kw):
    args, stream, vkw, ckw = PROPERTY_CASES[key]
    ccfg = ControllerConfig(**ckw) if ckw else None
    return verify.verify_properties(args, stream, ccfg=ccfg, **vkw, **kw)


def property_doc(rep) -> dict:
    import dataclasses
    return dataclasses.asdict(rep)


def diff_doc(rep) -> dict:
    import dataclasses
    doc = dataclasses.asdict(rep)
    doc["per_cmd"] = {k: list(v) for k, v in rep.per_cmd.items()}
    return dict(doc, text=str(rep))


def audit_doc(rep) -> dict:
    """An ``AuditReport`` in full (its violations as text)."""
    return dict(summary=rep.summary(), n_commands=rep.n_commands,
                n_pairs_checked=rep.n_pairs_checked, checks=rep.checks,
                truncated=rep.truncated, ok=rep.ok,
                by_channel={str(k): v for k, v in rep.by_channel.items()},
                by_group={str(k): v for k, v in rep.by_group.items()},
                group_labels={str(k): v
                              for k, v in rep.group_labels.items()},
                violations=[str(v) for v in rep.violations])


def golden_systems() -> dict:
    """The default system of every standard (the port's copy of
    ``repro.dse.spec.DEFAULT_SYSTEMS``: no JAX needed)."""
    from repro_torch.core.standards import DEFAULT_SYSTEMS
    return dict(DEFAULT_SYSTEMS)


def all_standard_names() -> list:
    """Every registered standard (the spec-mutation matrix's rows)."""
    from repro_torch.core.spec import all_standards
    return sorted(all_standards())


def golden_trace(core, trace, std: str, **sim_kw):
    """``(cspec, CommandTrace)`` of :data:`MUTATION_RUN` for ``std`` in
    one package (``core`` and ``trace`` its modules), captured with the
    controller and frontend metadata."""
    org, tim = golden_systems()[std]
    sim = core.Simulator(std, org, tim, controller=core.ControllerConfig(),
                         **sim_kw)
    r = MUTATION_RUN
    _, dense = sim.run(r["n_cycles"], interval=r["interval"],
                       read_ratio=r["read_ratio"], trace=True)
    return sim.cspec, trace.capture(sim.cspec, dense,
                                    controller=sim.controller,
                                    frontend=sim.frontend)


def golden_audit_doc(trace, verify, cspec, tr) -> dict:
    """What the tests hold per golden trace: its audit, its visualizer
    page (digest), and per mutation class the injection (row, mode,
    mutated trace digest), its audit and the matrix verdict."""
    rep = trace.audit(cspec, tr)
    doc = dict(audit=audit_doc(rep),
               html=sha(trace.render_html(tr, cspec, rep, title="golden")),
               inject={})
    for klass in verify.CLASSES:
        inj = verify.inject(cspec, tr, klass)
        if inj is None:
            doc["inject"][klass] = None
            continue
        mrep = trace.audit(cspec, inj.trace, check_fingerprint=False)
        doc["inject"][klass] = dict(
            row=inj.row, prev=inj.prev, next=inj.next, lat=inj.lat,
            win=inj.win, mode=inj.mode, trace=trace_digest(inj.trace),
            audit=audit_doc(mrep),
            detected=verify.detected(cspec, inj, mrep))
    return doc


def check_golden_audit(std: str) -> dict:
    """The port on the CPU at :data:`MUTATION_RUN` for ``std`` (the golden
    hash's run, :func:`port_golden_run`): its audit, page digest,
    injections, their audits and the mutation-matrix row equal
    :data:`VERIFY_FIXTURE`'s (the reference's).  Returns the row."""
    from repro_torch import trace, verify
    want = json.load(open(VERIFY_FIXTURE))
    _, cspec, tr = port_golden_run(std)
    assert len(tr) == GOLDEN[std]["n"]
    assert golden_audit_doc(trace, verify, cspec, tr) == want["golden"][std]
    row = verify.mutation_matrix({std: (cspec, tr)})
    cells = want["mutation_matrix"]["cells"]
    assert {"/".join(k): v for k, v in row.items()} == {
        k: v for k, v in cells.items() if k.split("/")[0] == std}
    return row


def matrix_doc(verify, matrix: dict) -> dict:
    return dict(cells={"/".join(k): v for k, v in sorted(matrix.items())},
                table=verify.matrix_table(matrix))


def telemetry_digest(telem) -> dict:
    return dict(window=telem.window, n_cycles=telem.n_cycles,
                meta=telem.meta, **telemetry_doc(telem))


def cli_artifacts(out: str, d: str, trace_load, telemetry_load) -> dict:
    """A CLI run's stdout (the temporary directory ``d`` replaced) and its
    artifacts in ``d``: traces (:func:`trace_digest`, a counterexample's
    :func:`trace_doc`) and telemetry (:func:`telemetry_digest`) through
    the given loaders, lint reports as JSON, pages and JSON Lines by
    digest."""
    doc = dict(stdout=out.replace(d, "{dir}"))
    for f in sorted(os.listdir(d)):
        p = os.path.join(d, f)
        if f.endswith(".npz"):
            with np.load(p) as z:
                is_trace = "cmd_names" in z
            if not is_trace:
                doc[f] = telemetry_digest(telemetry_load(p))
            elif f.startswith("counterexample_"):
                doc[f] = trace_doc(trace_load(p))
            else:
                doc[f] = trace_digest(trace_load(p))
        elif f.endswith(".json"):
            doc[f] = json.load(open(p))
        else:
            doc[f] = sha(open(p, "rb").read())
    return doc


def cli_argv(name: str, d: str, device: str | None = None) -> list:
    """:data:`CLI_RUNS` ``[name]``'s arguments in the temporary directory
    ``d``, with ``--device`` where the command simulates."""
    pkg, argv = CLI_RUNS[name]
    argv = [a.replace("{dir}", d) for a in argv]
    if device is not None and pkg != "analysis":
        argv += ["--device", device]
    return argv


def reference_cli(name: str) -> dict:
    """Run :data:`CLI_RUNS` ``[name]`` through the reference's ``main``
    in this process; its exit code and :func:`cli_artifacts`."""
    import contextlib
    import importlib
    import io
    import tempfile
    from repro import telemetry, trace
    main = importlib.import_module(f"repro.{CLI_RUNS[name][0]}.__main__").main
    with tempfile.TemporaryDirectory() as d:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(cli_argv(name, d))
        return dict(rc=rc, **cli_artifacts(buf.getvalue(), d, trace.load,
                                           telemetry.load))


def port_cli(name: str, d: str) -> dict:
    """Run :data:`CLI_RUNS` ``[name]`` as ``python -m repro_torch.<cli>
    ... --device cpu`` in a subprocess in the temporary directory ``d``; its
    exit code and :func:`cli_artifacts`."""
    import subprocess
    import sys
    from repro_torch import telemetry, trace
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(HERE),
                                                   "src"))
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.{CLI_RUNS[name][0]}"]
        + cli_argv(name, d, device="cpu"), env=env, capture_output=True,
        text=True, timeout=600)
    assert not out.stderr.strip() or out.returncode == 0, out.stderr
    return dict(rc=out.returncode, **cli_artifacts(out.stdout, d,
                                                   trace.load,
                                                   telemetry.load))


def verify_fixture() -> dict:
    """The reference's side of the validation workflow on the CPU."""
    from repro import trace as JTR
    from repro import verify
    from repro.core import ControllerConfig
    import repro.core as core
    doc = dict(loosen=LOOSEN, loosen_cases=LOOSEN_CASES,
               refresh_pressure_run=REFRESH_PRESSURE,
               mutation_run=MUTATION_RUN)
    doc["smoke"] = {"/".join(k): explore_doc(r)
                    for k, r in verify.smoke(VERIFY_STANDARDS).items()}
    doc["refresh_pressure"] = explore_doc(
        refresh_pressure_run(verify, ControllerConfig))
    for case in LOOSEN_CASES:
        doc[case] = cex_doc(*reversed(loosened_run(verify, ControllerConfig,
                                                   case)))
    fx = os.path.join(HERE, "verify", "fixtures")
    reports = {std: verify.diff_against_fixture(
        std, os.path.join(fx, f"{std}.cmdstream"))
        for std in VERIFY_STANDARDS}
    doc["differential"] = dict(
        reports={s: diff_doc(r) for s, r in reports.items()},
        dumps={s: sha(verify.dump_cmd_stream(*verify.golden_run(s)))
               for s in VERIFY_STANDARDS},
        table=verify.accuracy_table(list(reports.values())))
    doc["properties"] = {k: property_doc(property_run(
        verify, ControllerConfig, k)) for k in PROPERTY_CASES}
    traces = {std: golden_trace(core, JTR, std) for std in golden_systems()}
    doc["golden"] = {std: golden_audit_doc(JTR, verify, *traces[std])
                     for std in traces}
    doc["mutation_matrix"] = matrix_doc(verify,
                                        verify.mutation_matrix(traces))
    from repro.verify import spec_mutation as SM
    doc["spec_mutation_matrix"] = {
        "/".join(k): v for k, v in sorted(SM.spec_mutation_matrix(
            all_standard_names()).items())}
    doc["cli"] = {name: reference_cli(name) for name in CLI_RUNS}
    return doc


def write_sim_fixtures():
    for path, doc in ((BATCH_FIXTURE, batch_fixture()),
                      (MULTI_FIXTURE, multichannel_fixture()),
                      (HETERO_FIXTURE, hetero_fixture()),
                      (TELEMETRY_FIXTURE, telemetry_fixture()),
                      (REPLAY_FIXTURE, replay_fixture()),
                      (DSE_FIXTURE, dse_fixture()),
                      (VERIFY_FIXTURE, verify_fixture())):
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        print("wrote", path)


# ---------------------------------------------------------------------------
# LM serving path: numpy-made inputs and the JAX -> port parameter hand-over
# ---------------------------------------------------------------------------

SERVE_FIXTURE = os.path.join(HERE, "torch_serve_fixture.npz")
#: the fixture's run: GQA-reduced llama3.2-1b, params from PRNGKey(SEED),
#: prompts (B, T) from numpy's default_rng(SEED), N decoded tokens
SERVE_RUN = dict(variant="gqa", seed=0, batch=2, prompt_len=24, max_new=8)
#: the JAX package's decode-parity tolerance (tests/models/
#: test_decode_parity.py), used for every logits comparison of the port
#: against it: bf16 activations round at other places in the two packages
LOGITS_TOL = dict(atol=0.2, rtol=0.05)


def rand(shape, seed, scale=0.3):
    """Standard normal fp32 times ``scale``, from numpy's generator."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def lm_configs(variant="reduced"):
    """``(jax cfg, port cfg)`` of llama3.2-1b: ``"full"``, ``"reduced"``
    (``cfg.reduced()``), or ``"gqa"`` (reduced with 8 q heads, 2 kv heads
    and head_dim 64)."""
    import dataclasses
    from repro.configs import get_arch as jax_arch
    from repro_torch.configs import get_arch
    out = []
    for cfg in (jax_arch("llama3.2-1b"), get_arch("llama3.2-1b")):
        if variant != "full":
            cfg = cfg.reduced()
        if variant == "gqa":
            cfg = dataclasses.replace(cfg, n_heads=8, n_kv_heads=2,
                                      head_dim=64)
        out.append(cfg)
    return tuple(out)


def lm_pair(variant="reduced", seed=0):
    """``(jax cfg, jax params, port cfg, port params on the CPU)``: the
    JAX package's random parameters, handed to the port through
    ``repro_torch.convert.lm_params``."""
    import jax
    from repro.models import init_params
    from repro_torch import convert
    jc, pc = lm_configs(variant)
    jp = init_params(jc, jax.random.PRNGKey(seed))
    return jc, jp, pc, convert.lm_params(tree_np(jp), pc, "cpu")


def prompts(cfg, batch, length, seed):
    """Uniform tokens (batch, length), or (batch, length, K) for an audio
    config, from numpy's ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    shape = (batch, length)
    if cfg.frontend == "audio_stub":
        shape += (cfg.n_codebooks,)
    return rng.integers(0, cfg.vocab, shape).astype(np.int32)


def positions(cfg, batch, length, start=0):
    """Text positions ``start..start+length-1`` per request, (batch,
    length), or M-RoPE's ``(p, p // 7, p % 7)`` triples (batch, length, 3)
    as the JAX package's ``serve_batch`` makes them."""
    pos = np.arange(start, start + length, dtype=np.int32)[None].repeat(
        batch, 0)
    if cfg.rope == "mrope":
        pos = np.stack([pos, pos // 7, pos % 7], -1)
    return pos


def flatten(tree, prefix=""):
    """Nested dict -> ``{"a.b.c": leaf}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def serve_fixture_arrays(run: dict = SERVE_RUN) -> dict:
    """The fixture's content, computed with the JAX package: the config
    (JSON), parameters (uint16 bf16 bits under ``param.<path>``), the
    prompts, ``serve_batch``'s ``tokens`` and ``first``, the prefill's
    last-position ``prefill_logits`` and the teacher-forced
    ``decode_logits`` of each decoded position."""
    jc, jp, _, _ = lm_pair(run["variant"], run["seed"])
    return lm_run_arrays(jc, jp, run)


def lm_run_arrays(jc, jp, run: dict) -> dict:
    """A serve fixture's arrays (see :func:`serve_fixture_arrays`) for the
    JAX package's config ``jc`` and parameters ``jp``: ``run`` gives
    ``batch``, ``prompt_len``, ``max_new`` and the prompts' ``seed``."""
    import dataclasses
    import jax.numpy as jnp
    from repro.models import Batch, decode_step
    from repro.serve.step import make_prefill_step, serve_batch
    B, T, N = run["batch"], run["prompt_len"], run["max_new"]
    pr = prompts(jc, B, T, run["seed"])
    toks, first = serve_batch(jc, jp, jnp.asarray(pr), N)
    logits, cache = make_prefill_step(jc, T + N)(
        jp, Batch(tokens=jnp.asarray(pr),
                  positions=jnp.asarray(positions(jc, B, T))))
    seq = np.concatenate([np.asarray(first)[:, None], np.asarray(toks)], 1)
    dec = []
    for i in range(N):
        lg, cache = decode_step(jc, jp, cache, Batch(
            tokens=jnp.asarray(seq[:, i:i + 1]),
            positions=jnp.asarray(positions(jc, B, 1, T + i)),
            cache_index=jnp.int32(T + i), cache_len=jnp.int32(T + i + 1)))
        dec.append(np.asarray(lg[:, -1]))
    out = {"param." + k: np.asarray(v).view(np.uint16)
           for k, v in flatten(tree_np(jp)).items()}
    out.update(config=np.asarray(json.dumps(dataclasses.asdict(jc))),
               run=np.asarray(json.dumps(run)), prompts=pr,
               tokens=np.asarray(toks), first=np.asarray(first),
               prefill_logits=np.asarray(logits[:, -1], np.float32),
               decode_logits=np.stack(dec, 1).astype(np.float32))
    return out


def write_serve_fixture():
    np.savez_compressed(SERVE_FIXTURE, **serve_fixture_arrays())


# ---------------------------------------------------------------------------
# The qk-norm dense family and the hybrid recurrentgemma-2b (reduced)
# ---------------------------------------------------------------------------

LM_FAMILIES_FIXTURE = os.path.join(HERE, "torch_lm_families.npz")
#: the configurations ported with local attention, qk-norm and RG-LRU
LM_FAMILIES = ("qwen3-4b", "qwen3-14b", "glm4-9b", "recurrentgemma-2b")
#: the fixture's run of each (reduced, parameters from PRNGKey(seed),
#: prompts from numpy's default_rng(seed)): recurrentgemma's prompt is
#: longer than its reduced window (64), so the ring wraps in prefill and
#: decode
LM_FAMILY_RUNS = {name: dict(seed=0, batch=2, prompt_len=24, max_new=4)
                  for name in LM_FAMILIES}
LM_FAMILY_RUNS["recurrentgemma-2b"] = dict(seed=0, batch=2, prompt_len=80,
                                           max_new=4)
#: the full-width parameter counts (the reference's ``count_params``)
FAMILY_PARAMS = {"qwen3-4b": 4_411_424_256, "glm4-9b": 9_399_767_040,
                 "qwen3-14b": 14_768_307_200,
                 "recurrentgemma-2b": 2_894_435_840}


def unstacked_shapes(defs: dict, cfg) -> dict:
    """The reference's ParamDef tree as the port's per-layer names and
    shapes: ``groups.b{j}`` stacked over the groups is layer ``g * P + j``,
    ``rem.r{j}`` layer ``G * P + j``."""
    P, G = len(cfg.block_pattern), cfg.n_groups()
    out = {}
    for path, d in flatten(defs).items():
        top, *rest = path.split(".")
        if top == "groups":
            j = int(rest[0][1:])
            for g in range(d.shape[0]):
                out[".".join(["layers", str(g * P + j)] + rest[1:])] = \
                    d.shape[1:]
        elif top == "rem":
            out[".".join(["layers", str(G * P + int(rest[0][1:]))]
                         + rest[1:])] = d.shape
        else:
            out[path] = d.shape
    return out


def family_configs(name: str, n_layers=None, full: bool = False):
    """``(jax cfg, port cfg)`` of arch ``name``, ``reduced(n_layers)``
    unless ``full``."""
    from repro.configs import get_arch as jax_arch
    from repro_torch.configs import get_arch
    cfgs = (jax_arch(name), get_arch(name))
    return cfgs if full else tuple(c.reduced(n_layers) for c in cfgs)


def family_pair(name: str, seed=0, n_layers=None):
    """``(jax cfg, jax params, port cfg, port params on the CPU)`` of the
    reduced arch ``name``, the reference's ``PRNGKey(seed)`` parameters
    handed over through ``repro_torch.convert.lm_params``."""
    import jax
    from repro.models import init_params
    from repro_torch import convert
    jc, pc = family_configs(name, n_layers)
    jp = init_params(jc, jax.random.PRNGKey(seed))
    return jc, jp, pc, convert.lm_params(tree_np(jp), pc, "cpu")


def lm_family_arrays(name: str) -> dict:
    """One arch's part of the fixture (keys ``<arch>@<key>``).  The JAX
    package's run is cached per process by the config without its name
    and notes, and the run: the reduced qwen3-4b and qwen3-14b have the
    same shapes, so the same seed gives them the same weights and run."""
    import dataclasses
    run = LM_FAMILY_RUNS[name]
    jc, _ = family_configs(name)
    key = (json.dumps(dataclasses.asdict(dataclasses.replace(
        jc, name="", notes="")), sort_keys=True), json.dumps(run,
                                                            sort_keys=True))
    if key not in _FAMILY_RUNS:
        jc, jp, _, _ = family_pair(name, run["seed"])
        _FAMILY_RUNS[key] = lm_run_arrays(jc, jp, run)
    arrs = dict(_FAMILY_RUNS[key],
                config=np.asarray(json.dumps(dataclasses.asdict(jc))))
    return {f"{name}@{k}": v for k, v in arrs.items()}


_FAMILY_RUNS: dict = {}


def load_lm_family(z, name: str, device):
    """``(port cfg, port params on device, {key: array})`` of one arch
    from the fixture ``z`` (an ``np.load`` of it): what ``chip_smoke.py``
    serves on the card."""
    from repro_torch import convert
    from repro_torch.configs import ModelConfig, MoEConfig
    pre = f"{name}@"
    arrs = {k[len(pre):]: z[k] for k in z.files if k.startswith(pre)}
    fields = json.loads(str(arrs["config"]))
    fields["block_pattern"] = tuple(fields["block_pattern"])
    if fields["moe"] is not None:
        fields["moe"] = MoEConfig(**fields["moe"])
    cfg = ModelConfig(**fields)
    params = convert.lm_params(convert.nest(
        {k[len("param."):]: v for k, v in arrs.items()
         if k.startswith("param.")}), cfg, device)
    return cfg, params, arrs


def write_lm_families_fixture():
    out = {}
    for name in LM_FAMILIES:
        out.update(lm_family_arrays(name))
    np.savez_compressed(LM_FAMILIES_FIXTURE, **out)


# ---------------------------------------------------------------------------
# MoE, xLSTM, M-RoPE with the vision stub, the audio stub and the int8 KV
# cache (reduced)
# ---------------------------------------------------------------------------

LM_FAMILIES_B_FIXTURE = os.path.join(HERE, "torch_lm_families_b.npz")
#: fixture entry -> (arch, changes to its ``reduced()`` config):
#: ``capacity_factor`` is the MoE's (1.0: tokens drop in prefill)
LM_FAMILIES_B = {
    "phi3.5-moe-42b-a6.6b": ("phi3.5-moe-42b-a6.6b", {}),
    "phi3.5-moe-42b-a6.6b+cf1": ("phi3.5-moe-42b-a6.6b",
                                 {"capacity_factor": 1.0}),
    "llama4-maverick-400b-a17b": ("llama4-maverick-400b-a17b", {}),
    "qwen2-vl-72b": ("qwen2-vl-72b", {}),
    "musicgen-medium": ("musicgen-medium", {}),
    "xlstm-350m": ("xlstm-350m", {}),
    "llama3.2-1b+kv_quant": ("llama3.2-1b", {"kv_quant": True}),
}
#: every entry's run (parameters from PRNGKey(seed), prompts from numpy's
#: default_rng(seed))
LM_FAMILY_B_RUN = dict(seed=0, batch=2, prompt_len=24, max_new=4)
#: the full-width (parameters, active parameters) of the new configs (the
#: reference's ``count_params``)
FAMILY_B_PARAMS = {
    "phi3.5-moe-42b-a6.6b": (41_872_527_360, 6_640_373_760),
    "llama4-maverick-400b-a17b": (400_711_848_960, 14_188_385_280),
    "qwen2-vl-72b": (72_705_384_448, 72_705_384_448),
    "musicgen-medium": (1_837_254_144, 1_837_254_144),
    "xlstm-350m": (241_558_528, 241_558_528),
}


def family_b_configs(entry: str, n_layers=None):
    """``(jax cfg, port cfg)`` of a fixture entry of ``LM_FAMILIES_B``."""
    import dataclasses
    arch, change = LM_FAMILIES_B[entry]
    out = []
    for cfg in family_configs(arch, n_layers):
        ch = dict(change)
        if "capacity_factor" in ch:
            ch["moe"] = dataclasses.replace(
                cfg.moe, capacity_factor=ch.pop("capacity_factor"))
        out.append(dataclasses.replace(cfg, **ch))
    return tuple(out)


def family_b_pair(entry: str, seed=0, n_layers=None):
    """As :func:`family_pair`, for a fixture entry of ``LM_FAMILIES_B``."""
    import jax
    from repro.models import init_params
    from repro_torch import convert
    jc, pc = family_b_configs(entry, n_layers)
    jp = init_params(jc, jax.random.PRNGKey(seed))
    return jc, jp, pc, convert.lm_params(tree_np(jp), pc, "cpu")


def vis_embeds(cfg, batch, length, seed):
    """The vision stub's patch embeddings (batch, length // VIS_FRAC,
    d_model), bf16 values held in fp32."""
    import torch
    from repro_torch.models.model import VIS_FRAC
    x = rand((batch, length // VIS_FRAC, cfg.d_model), seed, scale=1.0)
    return torch.tensor(x).bfloat16().float().numpy()


def lm_family_b_arrays(entry: str) -> dict:
    """One entry's part of ``tests/torch_lm_families_b.npz`` (keys
    ``<entry>@<key>``): :func:`lm_run_arrays`, and for the vision stub
    ``vis_embeds`` and the fp32 ``vis_logits`` of every position of a
    forward that takes them."""
    import jax.numpy as jnp
    from repro.models import Batch, forward
    from repro.models.model import _unembed
    run = LM_FAMILY_B_RUN
    jc, jp, _, _ = family_b_pair(entry, run["seed"])
    arrs = lm_run_arrays(jc, jp, run)
    if jc.frontend == "vision_stub":
        B, T = run["batch"], run["prompt_len"]
        ve = vis_embeds(jc, B, T, run["seed"] + 1)
        x, _ = forward(jc, jp, Batch(
            tokens=jnp.asarray(arrs["prompts"]),
            positions=jnp.asarray(positions(jc, B, T)),
            vis_embeds=jnp.asarray(ve, jnp.bfloat16)))
        arrs.update(vis_embeds=ve, vis_logits=np.asarray(
            x.astype(jnp.float32) @ _unembed(jc, jp).astype(jnp.float32)))
    return {f"{entry}@{k}": v for k, v in arrs.items()}


def both_trees(tree: dict):
    """A tree of fp32 numpy leaves as ``(the JAX package's, the port's)``
    (``jnp`` arrays, ``torch`` tensors)."""
    import jax
    import jax.numpy as jnp
    import torch
    return (jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree),
            jax.tree.map(torch.tensor, tree))


def defs_params(defs: dict, seed: int, scale=0.125) -> dict:
    """fp32 numpy values of a ParamDef tree for the block tests: normal
    times ``scale`` (the reference's ``1/sqrt(fan_in)`` at d 64), norm
    scales (``zeros``/``ones`` init) normal times 0.1."""
    out = {}
    for i, (k, d) in enumerate(sorted(defs.items())):
        if isinstance(d, dict):
            out[k] = defs_params(d, seed * 100 + i, scale)
        else:
            out[k] = rand(d.shape, seed * 100 + i,
                          0.1 if d.init != "normal" else scale)
    return out


def block_ctx(T, B=2, start=0, cache_index=0, cache_len=0):
    """``(the JAX package's Ctx, the port's)`` of text positions
    ``start..start+T-1``."""
    import jax.numpy as jnp
    import torch
    from repro.models import blocks as JB
    from repro_torch.models import blocks as PB
    pos = np.arange(start, start + T, dtype=np.int32)[None].repeat(B, 0)
    return (JB.Ctx(positions=jnp.asarray(pos),
                   cache_index=jnp.int32(cache_index),
                   cache_len=jnp.int32(cache_len)),
            PB.Ctx(positions=torch.tensor(pos), cache_index=cache_index,
                   cache_len=cache_len))


def as_np(x):
    """A ``jnp`` array or a CPU tensor as numpy (bf16 as fp32)."""
    import torch
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def moe_overflow_case(counts, d=64, ff=64, seed=0):
    """Inputs of the flat MoE dispatch (``moe_ffn``, top-1 of
    ``len(counts)`` experts, capacity factor 1.0, so ``C = 8`` for 32
    tokens) where ``counts[e]`` tokens choose expert ``e``, in a shuffled
    token order, and every product and sum is exact in fp32 (integers and
    powers of two; every SwiGLU gate input is >= 48, so SiLU is the
    identity in fp32), so the result has the same bits in any summation
    order, on any device.  -> ``(moe config changes, fp32 params {name:
    array}, x (N, d), the token in slot (E - 1, C - 1) or None)``."""
    rng = np.random.default_rng(seed)
    E, N = len(counts), sum(counts)
    choice = rng.permutation(np.repeat(np.arange(E), counts))
    x = np.ones((N, d), np.float32)
    x[:, :E] = 0.0
    x[np.arange(N), choice] = 4.0
    x[:, E:E + 8] = rng.choice([-1.0, 1.0], (N, 8))
    router = np.zeros((d, E), np.float32)
    router[np.arange(E), np.arange(E)] = 1.0
    params = dict(
        router=router, w_gate=np.ones((E, d, ff), np.float32),
        w_up=rng.choice([-1.0, 1.0], (E, d, ff)).astype(np.float32),
        w_down=(rng.choice([-1.0, 1.0], (E, ff, d)) / 64).astype(
            np.float32))
    C = max(8, min(int(1.0 * N / E + 0.5), N))
    last = np.flatnonzero(choice == E - 1)
    kept_last = int(last[C - 1]) if len(last) >= C else None
    moe = dict(num_experts=E, top_k=1, capacity_factor=1.0, grouped=False)
    return moe, params, x, kept_last


def write_lm_families_b_fixture():
    out = {}
    for entry in LM_FAMILIES_B:
        out.update(lm_family_b_arrays(entry))
    np.savez_compressed(LM_FAMILIES_B_FIXTURE, **out)


def port_teacher_forced(pc, pp, pr, seq, n) -> list:
    """The port's prefill logits of prompts ``pr`` and the decode logits
    of feeding ``seq[:, i]`` at position T + i, on the CPU: ``n + 1``
    arrays ``(B, V)`` (``(B, K, V)`` for audio)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serve.step import make_prefill_step
    B, T = pr.shape[:2]
    lg, cache = make_prefill_step(pc, T + n)(pp, M.Batch(
        tokens=torch.tensor(pr), positions=torch.tensor(positions(pc, B, T))))
    out = [lg[:, -1].numpy()]
    for i in range(n):
        lg, cache = M.decode_step(pc, pp, cache, M.Batch(
            tokens=torch.tensor(seq[:, i:i + 1]),
            positions=torch.tensor(positions(pc, B, 1, T + i)),
            cache_index=T + i, cache_len=T + i + 1))
        out.append(lg[:, -1].numpy())
    return out


def check_family_b(entry: str):
    """The port on the CPU against its entry of the fixture: the config,
    greedy ``serve_batch`` tokens equal, prefill and teacher-forced decode
    logits (and the vision stub's forward) within ``LOGITS_TOL``; returns
    the port's config and parameters."""
    import dataclasses
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.model import _unembed
    from repro_torch.serve.step import serve_batch
    z = np.load(LM_FAMILIES_B_FIXTURE)
    pc, pp, arrs = load_lm_family(z, entry, "cpu")
    assert dataclasses.asdict(pc) == dataclasses.asdict(
        family_b_configs(entry)[1])
    pr, n = arrs["prompts"], arrs["tokens"].shape[1]
    toks, first = serve_batch(pc, pp, pr, n, device="cpu")
    np.testing.assert_array_equal(toks.numpy(), arrs["tokens"])
    np.testing.assert_array_equal(first.numpy(), arrs["first"])
    seq = np.concatenate([arrs["first"][:, None], arrs["tokens"]], 1)
    got = port_teacher_forced(pc, pp, pr, seq, n)
    np.testing.assert_allclose(got[0], arrs["prefill_logits"], **LOGITS_TOL)
    np.testing.assert_allclose(np.stack(got[1:], 1), arrs["decode_logits"],
                               **LOGITS_TOL)
    if "vis_embeds" in arrs:
        B, T = pr.shape
        x, _ = M.forward(pc, pp, M.Batch(
            tokens=torch.tensor(pr), positions=torch.tensor(
                positions(pc, B, T)),
            vis_embeds=torch.tensor(arrs["vis_embeds"]).bfloat16()))
        lg = x.float() @ _unembed(pc, pp).float()
        np.testing.assert_allclose(lg.numpy(), arrs["vis_logits"],
                                   **LOGITS_TOL)
    return pc, pp


# ---------------------------------------------------------------------------
# The examples: ``examples/torch/<name>.py`` against the reference's
# ``examples/<name>.py``.  One recipe per example (:func:`session_doc`)
# runs the reference example's statements in either package; the fixture
# holds the reference's docs at the examples' own sizes, and the tests run
# the port's examples small against the same recipe on the port.
# ---------------------------------------------------------------------------

EXAMPLES_FIXTURE = os.path.join(HERE, "torch_examples_stats.json")
EXAMPLES_SERVE = os.path.join(HERE, "torch_examples_serve.npz")
EXAMPLES_DIR = os.path.join(os.path.dirname(HERE), "examples", "torch")
#: the port's examples, in the order ``chip_smoke.py`` reports them
EXAMPLES = ("quickstart", "extend_standard", "hetero_system", "multichannel",
            "dse_sweep", "visualize_trace", "serve_lm",
            "memsys_aware_roofline")
#: each reference example's session at its own size (the port example's
#: defaults; ``serve_lm``'s weights are the reference's ``PRNGKey(seed)``
#: parameters, handed to the port through ``EXAMPLES_SERVE``)
EXAMPLE_RUNS = dict(
    quickstart=dict(cycles=20_000),
    extend_standard=dict(),
    hetero_system=dict(cycles=20_000, sweep_cycles=4_000,
                       links=[40, 80, 160, 320]),
    multichannel=dict(cycles=10_000, requests=8_000),
    dse_sweep=dict(cycles=10_000, intervals=[32.0, 8.0, 4.0, 2.0, 1.0],
                   read_ratios=[1.0, 0.5], trace_cycles=2_000),
    visualize_trace=dict(standard="LPDDR5", cycles=3_000),
    serve_lm=dict(variant="reduced", seed=0, batch=4, prompt_len=32,
                  max_new=16),
    memsys_aware_roofline=dict(cycles=20_000),
)
#: sessions a fixture of an earlier slice already holds: (file, key) of
#: the reference's stats doc
EXAMPLE_REUSE = dict(quickstart=(MAIN_FIXTURE, "stats"),
                     hetero_system=(HETERO_FIXTURE, "session"),
                     multichannel=(MULTI_FIXTURE, "stats"))


def load_example(name: str):
    """Import ``examples/torch/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", os.path.join(EXAMPLES_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_argv(name: str, run: dict, device: str, out: str) -> list:
    """The port example's command line for ``run`` (an
    :data:`EXAMPLE_RUNS`-shaped dict)."""
    argv = ["--device", device, "--out", out]
    if name == "serve_lm":
        return argv + ["--prompt-len", str(run["prompt_len"]),
                       "--params", EXAMPLES_SERVE]
    if name == "visualize_trace":
        argv = [run["standard"]] + argv
    join = lambda xs: ",".join(str(x) for x in xs)
    for k in ("cycles", "sweep_cycles", "requests", "trace_cycles"):
        if k in run:
            argv += ["--" + k.replace("_", "-"), str(run[k])]
    for k in ("links", "intervals", "read_ratios"):
        if k in run:
            argv += ["--" + k.replace("_", "-"), join(run[k])]
    return argv


def example_packages(top: str):
    """The modules an example uses, of ``repro`` or ``repro_torch``."""
    import importlib
    import types
    mod = lambda m: importlib.import_module(f"{top}.{m}")
    return types.SimpleNamespace(
        top=top, core=mod("core"), dse=mod("dse"), trace=mod("trace"),
        proxy=mod("core.proxy"), spec=mod("core.spec"),
        ddr5=mod("core.standards.ddr5"))


def probe_doc(p) -> dict:
    return dict(preq=p.preq, timing_OK=bool(p.timing_OK),
                ready=bool(p.ready), row_hit=bool(p.row_hit),
                row_open=bool(p.row_open), earliest=int(p.earliest))


def curves_doc(result) -> list:
    return [dict(system=cv.system, read_ratio=float(cv.read_ratio),
                 peak_fraction=float(cv.peak_fraction),
                 knee_interval=float(cv.intervals[cv.knee]))
            for cv in result.curves()]


def vrr_class(pkg):
    """The reference example's ``DDR5_VRR_Example`` (paper Listing 1) on
    ``pkg``'s spec layer, registered there."""
    import math
    S, DDR5 = pkg.spec, pkg.ddr5.DDR5

    class DDR5_VRR_Example(DDR5):
        name = "DDR5_VRR_Example"
        command_meta = dict(DDR5.command_meta,
                            VRR=S.Command("VRR", "bank", S.KIND_ROW))
        commands = DDR5.commands + ["VRR"]
        timing_params = DDR5.timing_params + ["nVRR"]
        timing_constraints = DDR5.timing_constraints + [
            S.TimingConstraint(level="bank", preceding=["VRR"],
                               following=["ACT"], latency="nVRR"),
            S.TimingConstraint(level="bank", preceding=["ACT"],
                               following=["VRR"], latency="nRC"),
            S.TimingConstraint(level="rank", preceding=["PRE", "PREab"],
                               following=["VRR"], latency="nRP"),
        ]
        org_presets = DDR5.org_presets
        timing_presets = {}

    for name, timings in DDR5.timing_presets.items():
        vrr = dict(timings)
        vrr["nVRR"] = math.ceil(280_000 / timings["tCK_ps"])
        DDR5_VRR_Example.timing_presets[name] = vrr
    return S.register(DDR5_VRR_Example)


def session_doc(name: str, run: dict, top: str = "repro",
                device: str = "cpu") -> dict:
    """The reference example ``name``'s statements at ``run`` in package
    ``top`` (the port on ``device``) as a JSON doc; ``serve_lm`` (the
    port's only) serves ``EXAMPLES_SERVE``'s weights."""
    pkg = example_packages(top)
    core, tr = pkg.core, pkg.trace
    dev = {} if top == "repro" else dict(device=device)
    devs = {} if top == "repro" else dict(devices=[device])
    if name == "quickstart":
        P = pkg.proxy.PROXIES
        system = pkg.proxy.System(
            "DDR5", "DDR5_16Gb_x8", "DDR5_4800B",
            controller=P["Controller"](scheduler="FRFCFS", queue_depth=32),
            frontend=P["Frontend"](interval=2.0, read_ratio=0.8),
            n_cycles=run["cycles"])
        sim = system.build(**dev)
        stats = sim.run(system.n_cycles)
        dut = core.DeviceUnderTest("DDR5", org_preset="DDR5_16Gb_x8",
                                   timing_preset="DDR5_4800B")
        addr = dut.addr_vec(Rank=0, BankGroup=0, Bank=0, Row=12, Column=0)
        probes = {"closed": probe_doc(dut.probe("RD", addr, clk=0))}
        dut.issue("ACT", addr, clk=0)
        probes["before_nRCD"] = probe_doc(dut.probe(
            "RD", addr, clk=dut.timings["nRCD"] - 1))
        probes["at_nRCD"] = probe_doc(dut.probe("RD", addr,
                                                clk=dut.timings["nRCD"]))
        return dict(yaml=system.to_yaml(), stats=stats.to_dict(),
                    summary=stats.summary(sim.cspec), probes=probes)
    if name == "extend_standard":
        vrr_class(pkg)
        dut = core.DeviceUnderTest("DDR5_VRR_Example", "DDR5_16Gb_x8",
                                   "DDR5_4800B")
        addr = dut.addr_vec(Rank=0, BankGroup=0, Bank=0, Row=5, Column=0)
        dut.issue("VRR", addr, clk=0)
        n = dut.timings["nVRR"]
        return dict(nVRR=int(n),
                    blocked=probe_doc(dut.probe("ACT", addr, clk=n - 1)),
                    legal=probe_doc(dut.probe("ACT", addr, clk=n)),
                    earliest=int(dut.earliest("ACT", addr)))
    if name == "hetero_system":
        msys = core.compile_system([
            dict(standard="DDR5", org_preset="DDR5_16Gb_x8",
                 timing_preset="DDR5_4800B", channels=2),
            dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
                 timing_preset="DDR4_2400R", channels=2, link_latency=80)])
        sim = core.Simulator(system=msys, **dev)
        stats, dense = sim.run(run["cycles"], interval=1.0, read_ratio=0.7,
                               trace=True)
        t = tr.capture(msys, dense, controller=sim.controller,
                       frontend=sim.frontend)
        spec = pkg.dse.SweepSpec(
            systems=tuple(pkg.dse.Composition((("DDR5", 2),
                                               ("DDR4", 2, link)))
                          for link in run["links"]),
            intervals=(8.0, 2.0), read_ratios=(1.0,),
            n_cycles=run["sweep_cycles"])
        res = pkg.dse.execute(spec, **devs)
        return dict(session=dict(run=HETERO_RUN | dict(
            n_cycles=run["cycles"]), stats=stats_doc(stats)),
            summary=stats.summary(msys), trace=trace_digest(t),
            audit=audit_doc(tr.audit(msys, t)), sweep=sweep_doc(res),
            table=res.to_table())
    if name == "memsys_aware_roofline":
        # the simulated part (the dry run's bytes are each package's own)
        sim = core.Simulator("HBM3", "HBM3_16Gb", "HBM3_5200", **dev)
        stats = sim.run(run["cycles"], interval=1.0, read_ratio=0.66)
        return dict(stats=stats.to_dict(),
                    achieved_gbps=float(core.throughput_gbps(sim.cspec,
                                                             stats)),
                    peak_gbps=float(core.peak_gbps(sim.cspec)))
    if name == "multichannel":
        quad = core.Simulator("HBM3", "HBM3_16Gb", "HBM3_5200", channels=4,
                              mapper="RoBaRaCoCh", **dev)
        stats, dense = quad.run(run["cycles"], interval=0.5,
                                read_ratio=0.9, trace=True)
        t = tr.capture(quad.cspec, dense, controller=quad.controller,
                       frontend=quad.frontend)
        same = tr.to_replay(t, quad.cspec)
        ddr = core.Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R",
                             channels=2, **dev)
        rng = np.random.default_rng(0)
        n = run["requests"]
        addrs = rng.integers(0, 1 << 28, n).astype(np.int64) \
            * ddr.cspec.access_bytes
        rs = core.ReplayStream.from_addresses(ddr.cspec, addrs,
                                              is_write=rng.random(n) < 0.3)
        st = core.Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", channels=2,
                            frontend=core.FrontendConfig(pattern="trace",
                                                         probes=False),
                            replay=rs, **dev).run(run["cycles"],
                                                  interval=1.0)
        return dict(stats=stats.to_dict(), trace=trace_digest(t),
                    audit=audit_doc(tr.audit(quad.cspec, t)),
                    replay=dict(n=len(same), fingerprint=same.fingerprint),
                    replay_stats=stats_doc(st))
    if name == "dse_sweep":
        spec = pkg.dse.SweepSpec(
            systems=(("DDR5", "DDR5_16Gb_x8", "DDR5_4800B"),
                     ("HBM3", "HBM3_16Gb", "HBM3_5200")),
            intervals=tuple(run["intervals"]),
            read_ratios=tuple(run["read_ratios"]), n_cycles=run["cycles"])
        result = pkg.dse.execute(spec, **devs)
        sim = core.Simulator("HBM3", "HBM3_16Gb", "HBM3_5200", **dev)
        stats, dense = sim.run(run["trace_cycles"], interval=1.0,
                               read_ratio=0.7, trace=True)
        t = tr.capture(sim.cspec, dense, controller=sim.controller,
                       frontend=sim.frontend)
        return dict(sweep=sweep_doc(result), table=result.to_table(),
                    curves=curves_doc(result), trace_stats=stats_doc(stats),
                    trace=trace_digest(t))
    if name == "visualize_trace":
        std, org, tim = dict(
            DDR5=("DDR5", "DDR5_16Gb_x8", "DDR5_4800B"),
            HBM3=("HBM3", "HBM3_16Gb", "HBM3_5200"),
            LPDDR5=("LPDDR5", "LPDDR5_8Gb_x16", "LPDDR5_6400"),
            GDDR7=("GDDR7", "GDDR7_16Gb_x32", "GDDR7_32"))[run["standard"]]
        sim = core.Simulator(std, org, tim, **dev)
        stats, dense = sim.run(run["cycles"], interval=2.0, read_ratio=0.75,
                               trace=True)
        t = tr.capture(sim.cspec, dense, controller=sim.controller,
                       frontend=sim.frontend)
        return dict(stats=stats_doc(stats), trace=trace_digest(t),
                    audit=audit_doc(tr.audit(sim.cspec, t)))
    if name == "serve_lm":
        import torch
        from repro_torch.configs import get_arch
        from repro_torch.launch.serve import load_params
        from repro_torch.serve.step import serve_batch
        cfg = get_arch("llama3.2-1b").reduced()
        pr = prompts(cfg, run["batch"], run["prompt_len"], run["seed"])
        toks, first = serve_batch(
            cfg, load_params(EXAMPLES_SERVE, cfg, device),
            torch.as_tensor(pr, device=device), run["max_new"],
            device=device)
        return dict(tokens=toks.tolist(), first=first.tolist())
    raise KeyError(name)


def port_example_doc(name: str, res: dict) -> dict:
    """The doc of a port example's ``main`` result (the keys of
    :func:`session_doc`)."""
    if name == "quickstart":
        return dict(yaml=res["system"].to_yaml(),
                    stats=res["stats"].to_dict(),
                    summary=res["stats"].summary(res["sim"].cspec),
                    probes={k: probe_doc(v)
                            for k, v in res["probes"].items()})
    if name == "extend_standard":
        return dict(nVRR=res["nVRR"], blocked=probe_doc(res["blocked"]),
                    legal=probe_doc(res["legal"]), earliest=res["table"])
    if name == "hetero_system":
        return dict(session=dict(run=HETERO_RUN | dict(
            n_cycles=int(res["stats"].cycles)),
            stats=stats_doc(res["stats"])),
            summary=res["stats"].summary(res["msys"]),
            trace=trace_digest(res["trace"]), audit=audit_doc(res["audit"]),
            sweep=sweep_doc(res["sweep"]), table=res["sweep"].to_table())
    if name == "multichannel":
        return dict(stats=res["stats"].to_dict(),
                    trace=trace_digest(res["trace"]),
                    audit=audit_doc(res["audit"]),
                    replay=dict(n=len(res["replay"]),
                                fingerprint=res["replay"].fingerprint),
                    replay_stats=stats_doc(res["replay_stats"]))
    if name == "dse_sweep":
        return dict(sweep=sweep_doc(res["result"]),
                    table=res["result"].to_table(),
                    curves=curves_doc(res["result"]),
                    trace_stats=stats_doc(res["stats"]),
                    trace=trace_digest(res["trace"]))
    if name == "visualize_trace":
        return dict(stats=stats_doc(res["stats"]),
                    trace=trace_digest(res["trace"]),
                    audit=audit_doc(res["audit"]))
    if name == "serve_lm":
        return dict(tokens=res["tokens"].tolist(),
                    first=res["first"].tolist())
    if name == "memsys_aware_roofline":
        return dict(stats=res["stats"].to_dict(),
                    achieved_gbps=float(res["achieved_gbps"]),
                    peak_gbps=float(res["peak_gbps"]))
    raise KeyError(name)


def example_reference_doc(name: str) -> dict:
    """The fixture's doc of example ``name`` (its reused session filled in
    from the earlier slice's fixture), without ``run``."""
    doc = dict(json.load(open(EXAMPLES_FIXTURE))[name])
    doc.pop("run")
    reuse = doc.pop("reused", None)
    if reuse is not None:
        path, key = EXAMPLE_REUSE[name]
        doc[reuse] = json.load(open(path))[key]
    return doc


def examples_fixture() -> dict:
    """The reference examples' docs at :data:`EXAMPLE_RUNS` (JAX on the
    CPU); a session an earlier fixture holds is checked equal to it and
    stored as a reference to it."""
    doc = {}
    for name in EXAMPLES:
        run = EXAMPLE_RUNS[name]
        if name == "serve_lm":
            z = np.load(EXAMPLES_SERVE)
            d = dict(tokens=z["tokens"].tolist(), first=z["first"].tolist())
        else:
            d = session_doc(name, run)
        if name in EXAMPLE_REUSE:
            path, key = EXAMPLE_REUSE[name]
            field = "session" if name == "hetero_system" else "stats"
            want = json.load(open(path))[key]
            assert d[field] == want, (name, "differs from", path)
            d.pop(field)
            d["reused"] = field
        doc[name] = dict(run=run, **d)
    return doc


def write_example_fixtures():
    run = EXAMPLE_RUNS["serve_lm"]
    np.savez_compressed(EXAMPLES_SERVE, **serve_fixture_arrays(run))
    print("wrote", EXAMPLES_SERVE)
    doc = examples_fixture()
    with open(EXAMPLES_FIXTURE, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print("wrote", EXAMPLES_FIXTURE)


# ---------------------------------------------------------------------------
# Training: the loss, the gradients and one AdamW step of the ten reduced
# configurations
# ---------------------------------------------------------------------------

LM_TRAIN_FIXTURE = os.path.join(HERE, "torch_lm_train.npz")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Autouse in the training test modules that import it: torch's CPU
    ops on one thread for the module, restored after it.  The suite runs
    several workers on the machine's cores, and torch's default thread
    pool in each oversubscribes them (a training step ran 20x slower)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
#: the ten reduced configurations
LM_TRAIN_ARCHS = ("llama3.2-1b", "qwen3-4b", "qwen3-14b", "glm4-9b",
                  "recurrentgemma-2b", "phi3.5-moe-42b-a6.6b",
                  "llama4-maverick-400b-a17b", "qwen2-vl-72b",
                  "musicgen-medium", "xlstm-350m")
#: each arch's run: parameters from PRNGKey(seed), the reference's
#: ``make_batch`` at step 0 (seq_len x global_batch), one
#: ``make_train_step`` with this AdamWConfig; recurrentgemma's sequence is
#: longer than its reduced window (64), so the window binds
LM_TRAIN_RUNS = {name: dict(seed=0, seq_len=32, global_batch=2, lr=1e-3,
                            warmup_steps=1, total_steps=10)
                 for name in LM_TRAIN_ARCHS}
LM_TRAIN_RUNS["recurrentgemma-2b"] = dict(LM_TRAIN_RUNS["llama3.2-1b"],
                                          seq_len=80)
#: the configs whose fp32 gradient the training fixture also holds
#: (``grad32.<path>``: the JAX package's gradient of ``loss_fn`` at the
#: fixture's parameters cast to fp32, on the fixture's batch; sampled as
#: the bf16 leaves are, in fp32): the card's fp32 step is held to it
#: (``chip_smoke.py`` phase 21 (c)), the CPU's in
#: ``test_torch_lm_train.py``
LM_TRAIN_FP32_ARCHS = ("llama3.2-1b", "recurrentgemma-2b")
#: per arch, the bound on each fp32 gradient leaf's relative L2 error
#: (its sampled elements) and its L2 norm's relative error against the
#: fixture.  On the CPU the port's fp32 gradient agrees with the
#: reference's to 1.06e-5 (llama; held at 2e-5) and to 2.73e-3 for
#: recurrentgemma, whose RG-LRU scan sums in another order (held at
#: 5e-3; changing attention's fp32 order moves it by 4.5e-6: the leaves
#: it misses most by, its attention block's wq, wk and norm, are set by
#: the recurrent path's arithmetic).  On the card, nothing rounds to a
#: narrower type, but every fp32 sum and elementwise function (cuBLAS'
#: GEMM reductions, the kernels' tile order, exp, sigmoid, logaddexp)
#: differs from the CPU's by an ulp or so: llama's bound is widened 5x to
#: 1e-4 (measured 1.59e-5); recurrentgemma's card gradient lies 8.70e-3
#: from the reference's with plain attention as with the kernels (the
#: kernels move it 1.2e-5; NVIDIA H100 80GB HBM3, ``chip_smoke.py`` phase
#: 21 (c)), so its bound is 1.25x that, 1.1e-2.
#: ``LM_TRAIN_FP32_STEP_TOL`` holds the kernels' own share
LM_TRAIN_FP32_TOL = {"llama3.2-1b": 2e-5, "recurrentgemma-2b": 5e-3}
LM_TRAIN_FP32_CARD_TOL = {"llama3.2-1b": 1e-4, "recurrentgemma-2b": 1.1e-2}
#: the card's fp32 gradient with the attention kernels against the same
#: card gradient with plain attention (forward and autograd backward):
#: each whole leaf's relative L2 error.  Only attention's fp32 sums are
#: ordered otherwise (measured 1.4e-5 for llama, 1.2e-5 for
#: recurrentgemma on an NVIDIA H100 80GB HBM3, ``chip_smoke.py`` phase 21
#: (c))
LM_TRAIN_FP32_STEP_TOL = 1e-4
#: where each arch's reduced PRNGKey(0) parameters already stand (the
#: serving fixtures, whose currency tests hold them to the JAX package):
#: the training fixture does not store them again
LM_TRAIN_PARAMS = {
    "llama3.2-1b": ("LM_FAMILIES_B_FIXTURE", "llama3.2-1b+kv_quant"),
    "qwen3-4b": ("LM_FAMILIES_FIXTURE", "qwen3-4b"),
    "qwen3-14b": ("LM_FAMILIES_FIXTURE", "qwen3-14b"),
    "glm4-9b": ("LM_FAMILIES_FIXTURE", "glm4-9b"),
    "recurrentgemma-2b": ("LM_FAMILIES_FIXTURE", "recurrentgemma-2b"),
    "phi3.5-moe-42b-a6.6b": ("LM_FAMILIES_B_FIXTURE",
                             "phi3.5-moe-42b-a6.6b"),
    "llama4-maverick-400b-a17b": ("LM_FAMILIES_B_FIXTURE",
                                  "llama4-maverick-400b-a17b"),
    "qwen2-vl-72b": ("LM_FAMILIES_B_FIXTURE", "qwen2-vl-72b"),
    "musicgen-medium": ("LM_FAMILIES_B_FIXTURE", "musicgen-medium"),
    "xlstm-350m": ("LM_FAMILIES_B_FIXTURE", "xlstm-350m"),
}


def _bits(tree: dict, prefix: str) -> dict:
    """A bf16 tree's leaves as ``uint16`` bits under ``<prefix><path>``."""
    return {prefix + k: np.asarray(v).view(np.uint16)
            for k, v in flatten(tree_np(tree)).items()}


#: elements of a leaf the training fixture keeps (the first ones, in C
#: order) of the gradient and the new parameters, and of the moments
#: (after one step a moment is the clipped gradient scaled, squared for
#: ``v``): the file stays near 5 MB with llama4-maverick's expert leaves
LM_TRAIN_CAP = 8192
LM_TRAIN_MOMENT_CAP = 1024


def _leaf_sample(a: np.ndarray, cap: int = LM_TRAIN_CAP) -> np.ndarray:
    return np.ravel(a)[:cap]


def _sampled(tree: dict, prefix: str, base: dict | None = None,
             cap: int = LM_TRAIN_CAP) -> dict:
    """A bf16 tree's leaves as ``<prefix><path>``: the first ``cap``
    elements as ``uint16`` bits (as int16 differences from ``base``'s
    bits, if given) and ``<prefix>l2.<path>``, the whole leaf's fp32 L2
    norm."""
    out = {}
    for k, v in _bits(tree, "").items():
        s = _leaf_sample(v, cap)
        if base is not None:
            s = (s.astype(np.int32)
                 - _leaf_sample(base[k], cap)).astype(np.int16)
        f = v.view(np.int16).astype(np.int32) << 16
        out[prefix + k] = s
        out[prefix + "l2." + k] = np.float32(np.linalg.norm(
            f.view(np.float32).astype(np.float64)))
    return out


def lm_train_arrays(arch: str) -> dict:
    """One arch's part of ``tests/torch_lm_train.npz`` (keys
    ``<arch>@<key>``), computed with the JAX package in one ``jax.jit``:
    the config and run (JSON), the batch (``tokens``, ``labels``,
    ``positions``, ``vis_embeds`` as fp32 holding bf16 values) and one
    ``make_train_step``: its ``loss`` and ``aux`` (``logits_and_loss``'s),
    the gradient of ``loss_fn`` it takes (``grad.<path>``, read by its
    ``grad_transform`` hook), ``grad_norm``, ``lr``, ``m`` and ``v``
    (``m.``, ``v.<path>``) and the new parameters (``new.<path>``: int16
    differences from the old parameters' bits).  Each tree leaf is
    sampled (:func:`_sampled`): its first ``LM_TRAIN_CAP`` (moments:
    ``LM_TRAIN_MOMENT_CAP``) elements' bf16 bits and its L2 norm.  The
    parameters are :func:`lm_train_params`' (the serving fixtures' currency
    tests hold them to ``init_params(PRNGKey(0))``)."""
    import dataclasses
    from repro.configs import get_arch as jax_arch
    run = LM_TRAIN_RUNS[arch]
    jc = jax_arch(arch).reduced()
    # the reduced qwen3-4b and qwen3-14b are the same config but for the
    # name: one run serves both (cached per process)
    key = json.dumps([dataclasses.asdict(dataclasses.replace(
        jc, name="", notes="")), run], sort_keys=True)
    if key not in _TRAIN_RUNS:
        _TRAIN_RUNS[key] = _lm_train_run(arch, jc, run)
    out = dict(_TRAIN_RUNS[key],
               config=np.asarray(json.dumps(dataclasses.asdict(jc))))
    return {f"{arch}@{k}": v for k, v in out.items()}


_TRAIN_RUNS: dict = {}


def _lm_train_run(arch: str, jc, run: dict) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.data import DataConfig, make_batch
    from repro.optim import AdamWConfig
    from repro.train.step import make_train_step, train_init
    oc = AdamWConfig(lr=run["lr"], warmup_steps=run["warmup_steps"],
                     total_steps=run["total_steps"])

    from repro_torch.convert import nest
    jp = jax.tree.map(lambda a: jnp.asarray(a.view(jnp.bfloat16)),
                      nest(lm_train_params(arch)))

    def batch_grads_and_step(params):
        # one program (a compile, not hundreds of eager dispatches): the
        # batch and the step, its gradient taken by its own grad_transform
        # hook
        batch = make_batch(jc, DataConfig(seq_len=run["seq_len"],
                                          global_batch=run["global_batch"]),
                           0)
        seen = []
        step = make_train_step(jc, oc, grad_transform=lambda g: seen.append(
            g) or g)
        st, m = step(train_init(jc, params, oc), batch)
        return batch, seen[0], st, m

    jb, g, st, m = jax.jit(batch_grads_and_step)(jp)
    loss, aux = m["loss"], m["aux_loss"]
    fp32 = _fp32_grads(jc, jp, jb) if arch in LM_TRAIN_FP32_ARCHS else {}
    old = _bits(jp, "")
    out = {**_sampled(g, "grad."), **_sampled(st.params, "new.", old),
           **_sampled(st.opt.m, "m.", cap=LM_TRAIN_MOMENT_CAP),
           **_sampled(st.opt.v, "v.", cap=LM_TRAIN_MOMENT_CAP)}
    out.update(run=np.asarray(json.dumps(run)),
               tokens=np.asarray(jb.tokens), labels=np.asarray(jb.labels),
               positions=np.asarray(jb.positions),
               loss=np.float32(loss), aux=np.float32(aux),
               grad_norm=np.float32(m["grad_norm"]),
               lr=np.float32(m["lr"]))
    if jb.vis_embeds is not None:
        out["vis_embeds"] = np.asarray(jb.vis_embeds, np.float32)
    out.update(fp32)
    return out


def _fp32_grads(jc, jp, jb) -> dict:
    """The JAX package's gradient of ``loss_fn`` at the bf16 parameters
    ``jp`` cast to fp32, on the batch ``jb``: each leaf's first
    ``LM_TRAIN_CAP`` elements (``grad32.<path>``, fp32) and its L2 norm
    (``grad32.l2.<path>``)."""
    import jax
    import jax.numpy as jnp
    from repro.models import Batch
    from repro.train.step import loss_fn
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    batch = Batch(tokens=jb.tokens, positions=jb.positions, labels=jb.labels)
    g = jax.jit(jax.grad(lambda p, b: loss_fn(jc, p, b)[0]))(p32, batch)
    out = {}
    for k, v in flatten(tree_np(g)).items():
        v = np.asarray(v, np.float32)
        out["grad32." + k] = _leaf_sample(v)
        out["grad32.l2." + k] = np.float32(np.linalg.norm(
            v.astype(np.float64)))
    return out


def lm_train_params(arch: str) -> dict:
    """``{path: uint16 bits}`` of an arch's parameters from the serving
    fixture :data:`LM_TRAIN_PARAMS` names."""
    name, entry = LM_TRAIN_PARAMS[arch]
    z = np.load(globals()[name])
    pre = f"{entry}@param."
    return {k[len(pre):]: z[k] for k in z.files if k.startswith(pre)}


def load_lm_train(z, arch: str, device):
    """``(port cfg, port params on device, port Batch on device, {key:
    array})`` of one arch from the training fixture ``z`` (an
    ``np.load`` of it), its parameters from :func:`lm_train_params`: what
    the CPU tests and ``chip_smoke.py`` phase 21 train."""
    from repro_torch import convert
    from repro_torch.configs import ModelConfig, MoEConfig
    pre = f"{arch}@"
    arrs = {k[len(pre):]: z[k] for k in z.files if k.startswith(pre)}
    fields = json.loads(str(arrs["config"]))
    fields["block_pattern"] = tuple(fields["block_pattern"])
    if fields["moe"] is not None:
        fields["moe"] = MoEConfig(**fields["moe"])
    cfg = ModelConfig(**fields)
    params = convert.lm_params(convert.nest(lm_train_params(arch)), cfg,
                               device)
    batch = convert.batch({k: arrs.get(k) for k in (
        "tokens", "positions", "labels", "vis_embeds")}, device)
    return cfg, params, batch, arrs


#: the port's step against the fixture (``test_torch_lm_train.py`` gives
#: the reasons): loss and aux atol, then per arch the gradient's relative
#: L2 error per leaf (the moments' the same, ``v``'s twice it),
#: ``grad_norm``'s relative error and the share of new parameters more
#: than one bf16 ulp from the reference's
LM_TRAIN_LOSS_ATOL = 1e-2
#: arch -> (gradient leaf rel L2, grad_norm rel, share of new parameters
#: more than one ulp apart, aux atol); None: measured, not held
LM_TRAIN_TOL = {arch: (5e-2, 2e-2, 0.01, 1e-3) for arch in LM_TRAIN_ARCHS}
#: the reduced recurrentgemma's bf16 gradient is set by where bf16
#: rounds: the port's own gradient norm moves by 85% and a leaf by up to
#: 3.2x its norm when its fused rounding is replaced by op-by-op rounding
#: (``LM_TRAIN_ROUNDING_SHIFT``), so no bound on it would separate a
#: wrong gradient from a rounding: its bf16 step holds only the loss, aux,
#: lr and the step count, and ``test_fp32_gradients_equal_jax`` holds its
#: gradient to the JAX package's within 5e-3 in fp32 on the same 80
#: positions (its window of 64 binds)
LM_TRAIN_TOL["recurrentgemma-2b"] = (None, None, None, 1e-3)
#: two CPU measurements per arch (torch on one thread, as the tests run
#: it) that bound how far the card's step may lie from the fixture
#: (``test_torch_lm_train.py`` measures both again):
#: the errors of a step whose forward attention rounds P to bf16 before
#: P V as both forward kernels do (:func:`attention_kernel_rounding`;
#: its numbers match the card's to 2-3 digits where the card ran them):
#: (worst gradient leaf, grad_norm, share of new parameters > 1 ulp, aux)
LM_TRAIN_KERNEL_ROUNDING = {
    "llama3.2-1b": (0.01868, 7e-05, 0.00172, 0.0),
    "qwen3-4b": (0.01692, 0.00092, 0.00132, 0.0),
    "qwen3-14b": (0.01692, 0.00092, 0.00132, 0.0),
    "glm4-9b": (0.03269, 0.0028, 0.00239, 0.0),
    "recurrentgemma-2b": (0.49308, 0.03138, 0.02581, 0.0),
    "phi3.5-moe-42b-a6.6b": (0.31491, 0.23892, 0.00794, 0.00193),
    "llama4-maverick-400b-a17b": (0.0888, 0.00021, 0.00289, 0.00036),
    "qwen2-vl-72b": (0.15892, 0.00501, 0.00787, 0.0),
    "musicgen-medium": (0.15368, 0.01695, 0.00373, 0.0),
    "xlstm-350m": (0.03296, 0.00581, 0.00099, 0.0),
}
#: and :func:`rounding_shift`'s (worst leaf, grad_norm): how far moving
#: where bf16 rounds moves the port's own gradient (the card's GEMMs,
#: exps and sums round otherwise than the CPU's)
LM_TRAIN_ROUNDING_SHIFT = {
    "llama3.2-1b": (0.1555, 0.0034),
    "qwen3-4b": (0.0173, 0.0004),
    "qwen3-14b": (0.0173, 0.0004),
    "glm4-9b": (0.087, 0.0144),
    "recurrentgemma-2b": (3.2168, 0.8487),
    "phi3.5-moe-42b-a6.6b": (0.2605, 0.1129),
    "llama4-maverick-400b-a17b": (0.1915, 0.0007),
    "qwen2-vl-72b": (0.1149, 0.0033),
    "musicgen-medium": (0.1631, 0.017),
    "xlstm-350m": (0.4451, 0.0796),
}


def _card_tol(arch: str) -> tuple:
    g, n, f, a = LM_TRAIN_TOL[arch]
    eg, en, ef, ea = LM_TRAIN_KERNEL_ROUNDING[arch]
    sg, sn = LM_TRAIN_ROUNDING_SHIFT[arch]
    wider = lambda cpu, *more: None if cpu is None else max(cpu, *more)
    return (wider(g, 1.5 * eg, 1.25 * sg), wider(n, 1.5 * en, 1.25 * sn),
            wider(f, 1.5 * ef), wider(a, 1.5 * ea))


#: the card's step against the fixture (``chip_smoke.py`` phase 21): the
#: CPU tolerance, or 1.5x the kernel-rounding error, or 1.25x the
#: rounding shift, whichever is largest (None where the CPU's is)
LM_TRAIN_CARD_TOL = {arch: _card_tol(arch) for arch in LM_TRAIN_ARCHS}


#: a reduced config's card step with the backward kernel against the same
#: card step with ``attention_backward_plain`` in the kernel's place (the
#: same forward kernels, GEMMs and batch; ``chip_smoke.py`` phase 21):
#: loss atol, the worst gradient leaf's relative L2 error, grad_norm
#: relative.  ``tools/bwd_step_sensitivity.py`` measures, on the CPU, how
#: far a backward off by a bf16 rounding or by a few percent moves these
BWD_STEP_TOL = dict(loss=1e-5, grad=5e-2, grad_norm=1e-2)


def step_vs_plain_backward(res, plain) -> dict:
    """One :func:`lm_train_step` (``res``) against another (``plain``)
    of the same arch and batch: loss |diff|, the worst gradient leaf's
    relative L2 error and grad_norm's relative error."""
    g, gp = res[5], plain[5]
    rel = lambda a, b: ((a.float() - b.float()).norm()
                        / b.float().norm().clamp_min(1e-30)).item()
    return dict(loss=abs(float(res[4]["loss"]) - float(plain[4]["loss"])),
                grad=max(rel(g[k], gp[k]) for k in gp),
                grad_norm=abs(float(res[4]["grad_norm"])
                              / float(plain[4]["grad_norm"]) - 1))


def attention_kernel_rounding(q, k, v, *, causal: bool, sm_scale: float,
                              window=None, return_lse: bool = False):
    """``flash_attention.attention_plain`` with the forward kernels'
    rounding: P = exp(S - max) rounded to bf16 before the product with V,
    the row sum of the unrounded P dividing after (the CPU's stand-in for
    the card's step; ``(B, H, T, D)`` layout); with ``return_lse`` also the
    rows' log-sum-exp as ``attention_plain`` gives it."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Hkv, Hq // Hkv, Tq, D)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qf, k.float()) * sm_scale
    vis = FA._visible(Tq, Tk, causal, window, q.device)
    if vis is not None:
        s = s.masked_fill(~vis, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bgrqk,bgkd->bgrqd", p.bfloat16().float(),
                     v.float()) / p.sum(-1, keepdim=True)
    o = o.reshape(B, Hq, Tq, D).to(q.dtype)
    if not return_lse:
        return o
    return o, (torch.logsumexp(s, dim=-1) * FA.LOG2E).reshape(B, Hq, Tq)


def _f32(bits: np.ndarray) -> np.ndarray:
    """bf16 bits (uint16) as fp32 values."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def lm_train_step(z, arch: str, device):
    """One port ``make_train_step`` of ``arch`` from the training fixture
    ``z`` on ``device``, its gradients captured by the ``grad_transform``
    hook: ``(cfg, AdamWConfig, old params, new state, metrics, grads,
    fixture arrays)``."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step, train_init
    cfg, params, batch, arrs = load_lm_train(z, arch, device)
    run = json.loads(str(arrs["run"]))
    oc = AdamWConfig(lr=run["lr"], warmup_steps=run["warmup_steps"],
                     total_steps=run["total_steps"])
    state = train_init(cfg, params, oc)
    grads = {}
    step = make_train_step(cfg, oc,
                           grad_transform=lambda g: grads.update(g) or g)
    new, metrics = step(state, batch)
    return cfg, oc, params, new, metrics, grads, arrs


def lm_train_fp32_grads(z, arch: str, device) -> tuple:
    """The port's gradient of ``loss_fn`` at the fixture's parameters cast
    to fp32 (``params.float()``), on the fixture's batch, on ``device``:
    ``({path: fp32 numpy leaf}, fixture arrays)``.  On the card every
    attention layer runs the fp32 CUDA-core kernels forward and
    backward."""
    import torch
    from repro_torch import convert
    from repro_torch.train import loss_fn
    cfg, params, batch, arrs = load_lm_train(z, arch, device)
    p32 = params.float().requires_grad_(True)
    leaves = dict(p32.named_parameters())
    tot, _ = loss_fn(cfg, p32, batch)
    grads = torch.autograd.grad(tot, list(leaves.values()))
    return flatten(convert.named_to_numpy(dict(zip(leaves, grads)),
                                          cfg)), arrs


def check_lm_train_fp32(arch: str, got: dict, arrs, tol: float) -> float:
    """Hold an fp32 gradient (:func:`lm_train_fp32_grads`) to the
    fixture's ``grad32`` leaves: each leaf's sampled elements in relative
    L2 and its whole L2 norm, relatively, within ``tol``; raises
    AssertionError on a miss, else returns the worst."""
    errs = {k: max(_rel(np.ravel(g)[:LM_TRAIN_CAP], arrs[f"grad32.{k}"]),
                   abs(float(np.linalg.norm(g.astype(np.float64)))
                       / max(float(arrs[f"grad32.l2.{k}"]), 1e-30) - 1))
            for k, g in got.items()}
    assert len(errs) == sum(k.startswith("grad32.l2.") for k in arrs), arch
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, (arch, worst, errs[worst], tol)
    return errs[worst]


def rounding_shift(z, arch: str) -> tuple:
    """How far a change of where bf16 rounds moves ``arch``'s gradient on
    the fixture's batch (CPU): the port's step with every layer rounding
    op by op (no fp32 residual handed on) against its own step as it
    runs, as ``(worst leaf relative L2, grad_norm relative)``."""
    import torch
    from repro_torch import convert
    from repro_torch.models import model as M
    from repro_torch.train import loss_fn
    cfg, params, batch, _ = load_lm_train(z, arch, "cpu")
    leaves = dict(params.requires_grad_(True).named_parameters())

    def grads():
        tot, _ = loss_fn(cfg, params, batch)
        g = torch.autograd.grad(tot, list(leaves.values()))
        return flatten(convert.named_to_numpy(dict(zip(leaves, g)), cfg))

    base = grads()
    group_step = M._group_step
    M._group_step = lambda cfg, i, resid: (False, None)
    try:
        op_by_op = grads()
    finally:
        M._group_step = group_step
    norm = lambda t: float(np.sqrt(sum(np.sum(np.square(x))
                                       for x in t.values())))
    return (max(_rel(op_by_op[k], base[k]) for k in base),
            abs(norm(op_by_op) / norm(base) - 1))


def check_lm_train(arch: str, cfg, oc, params, new, m, grads, arrs,
                   tol=None) -> dict:
    """Hold one port step (:func:`lm_train_step`) to the fixture at
    ``tol`` (default :data:`LM_TRAIN_TOL`'s; a None bound is not held);
    raises AssertionError on a
    miss, else returns the errors: ``loss``, ``aux``, ``grad_norm``
    (relative), the worst leaf's ``grad``, ``m`` and ``v`` relative L2
    error and ``far``, the share of sampled new parameters more than one
    ulp apart."""
    from repro_torch import convert
    grad_rel, norm_rel, far_share, aux_atol = tol or LM_TRAIN_TOL[arch]
    out = dict(loss=abs(float(m["loss"]) - float(arrs["loss"])),
               aux=abs(float(m["aux_loss"]) - float(arrs["aux"])),
               grad_norm=abs(float(m["grad_norm"]) / float(arrs["grad_norm"])
                             - 1),
               lr=abs(float(m["lr"]) / float(arrs["lr"]) - 1))
    held = lambda err, bound: bound is None or err <= bound
    missed = [k for k, bound in (("loss", LM_TRAIN_LOSS_ATOL),
                                 ("aux", aux_atol), ("grad_norm", norm_rel),
                                 ("lr", 1e-6))
              if not held(out[k], bound)]
    trees = {"grad": (convert.named_to_numpy(grads, cfg), LM_TRAIN_CAP),
             "m": (convert.named_to_numpy(new.opt.m, cfg),
                   LM_TRAIN_MOMENT_CAP),
             "v": (convert.named_to_numpy(new.opt.v, cfg),
                   LM_TRAIN_MOMENT_CAP)}
    for pre, (tree, cap) in trees.items():
        out[pre] = max(
            max(_rel(np.ravel(got)[:cap], _f32(arrs[f"{pre}.{k}"])),
                abs(float(np.linalg.norm(got))
                    / max(float(arrs[f"{pre}.l2.{k}"]), 1e-30) - 1))
            for k, got in flatten(tree).items())
        if not held(out[pre], grad_rel and grad_rel * (2 if pre == "v"
                                                       else 1)):
            missed.append(pre)
    old = flatten(convert.lm_params_to_numpy(params, cfg))
    got = flatten(convert.lm_params_to_numpy(new.params, cfg))
    far = total = 0
    for k, o in old.items():
        o = np.ravel(o)[:LM_TRAIN_CAP]
        want = _f32((o.astype(np.int32) + arrs["new." + k].astype(np.int32))
                    & 0xFFFF)
        g = _f32(np.ravel(got[k])[:LM_TRAIN_CAP])
        # one bf16 ulp of the larger (each side rounds its new value once)
        ulp = np.maximum(np.abs(want), np.abs(g)) * 2.0 ** -7 + 1e-30
        bound = 2 * oc.lr * (1 + oc.weight_decay * np.abs(_f32(o))) + ulp
        if not np.all(np.abs(g - want) <= bound):
            missed.append(f"new.{k}")
        far += int(np.sum(np.abs(g - want) > ulp))
        total += g.size
    out["far"] = far / total
    if not held(out["far"], far_share) or int(new.opt.step) != 1:
        missed.append("far")
    assert not missed, (arch, "missed", missed, out)
    return out


def write_lm_train_fixture():
    out = {}
    for arch in LM_TRAIN_ARCHS:
        out.update(lm_train_arrays(arch))
    np.savez_compressed(LM_TRAIN_FIXTURE, **out)


if __name__ == "__main__":
    import sys
    if sys.argv[1:] == ["--write-serve-fixture"]:
        write_serve_fixture()
        print("wrote", SERVE_FIXTURE)
    elif sys.argv[1:] == ["--write-sim-fixtures"]:
        write_sim_fixtures()
    elif sys.argv[1:] == ["--write-example-fixtures"]:
        write_example_fixtures()
    elif sys.argv[1:] == ["--write-lm-families-fixture"]:
        write_lm_families_fixture()
        print("wrote", LM_FAMILIES_FIXTURE)
    elif sys.argv[1:] == ["--write-lm-families-b-fixture"]:
        write_lm_families_b_fixture()
        print("wrote", LM_FAMILIES_B_FIXTURE)
    elif sys.argv[1:] == ["--write-lm-train-fixture"]:
        write_lm_train_fixture()
        print("wrote", LM_TRAIN_FIXTURE)
