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
``tests/torch_telemetry_stats.json`` and ``tests/torch_replay_stats.json``."""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np

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


def port_golden(std, fast_forward=True):
    """Run the port on the CPU at the golden configuration; returns
    ``(stats, CommandTrace)``."""
    from repro_torch.core import ControllerConfig, Simulator
    from repro_torch.trace import capture
    org, tim = default_systems()[std]
    sim = Simulator(std, org, tim, device="cpu", fast_forward=fast_forward,
                    controller=ControllerConfig(scheduler="FRFCFS"))
    stats, dense = sim.run(3000, interval=2.0, read_ratio=0.7, trace=True)
    return stats, capture(sim.cspec, dense)


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


def write_sim_fixtures():
    for path, doc in ((BATCH_FIXTURE, batch_fixture()),
                      (MULTI_FIXTURE, multichannel_fixture()),
                      (HETERO_FIXTURE, hetero_fixture()),
                      (TELEMETRY_FIXTURE, telemetry_fixture()),
                      (REPLAY_FIXTURE, replay_fixture())):
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
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (batch, length)).astype(np.int32)


def flatten(tree, prefix=""):
    """Nested dict -> ``{"a.b.c": leaf}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def serve_fixture_arrays() -> dict:
    """The fixture's content, computed with the JAX package: the config
    (JSON), parameters (uint16 bf16 bits under ``param.<path>``), the
    prompts, ``serve_batch``'s ``tokens`` and ``first``, the prefill's
    last-position ``prefill_logits`` and the teacher-forced
    ``decode_logits`` of each decoded position."""
    import dataclasses
    import jax.numpy as jnp
    from repro.models import Batch, decode_step
    from repro.serve.step import make_prefill_step, serve_batch
    run = SERVE_RUN
    jc, jp, _, _ = lm_pair(run["variant"], run["seed"])
    B, T, N = run["batch"], run["prompt_len"], run["max_new"]
    pr = prompts(jc, B, T, run["seed"])
    toks, first = serve_batch(jc, jp, jnp.asarray(pr), N)
    pos = jnp.arange(T, dtype=jnp.int32)[None].repeat(B, 0)
    logits, cache = make_prefill_step(jc, T + N)(
        jp, Batch(tokens=jnp.asarray(pr), positions=pos))
    seq = np.concatenate([np.asarray(first)[:, None], np.asarray(toks)], 1)
    dec = []
    for i in range(N):
        lg, cache = decode_step(jc, jp, cache, Batch(
            tokens=jnp.asarray(seq[:, i:i + 1]),
            positions=jnp.full((B, 1), T + i, jnp.int32),
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


if __name__ == "__main__":
    import sys
    if sys.argv[1:] == ["--write-serve-fixture"]:
        write_serve_fixture()
        print("wrote", SERVE_FIXTURE)
    elif sys.argv[1:] == ["--write-sim-fixtures"]:
        write_sim_fixtures()
