"""PyTorch port, memory systems of spec groups on the CPU, against the JAX
package (exact):

* composition: ``compile_system`` over every descriptor form, the merged
  command namespace, the group-local id maps, channel bases and owners,
  ``homogeneous`` and ``label``;
* the system address mapper: the mixed-radix round trip over three groups
  of different radices in every supported order (as
  ``tests/core/test_hetero_system.py`` does), channel-MSB orders refused,
  and the decode equal to the reference's;
* the system frontend's insert, on random frontend states and queues, and
  its draws per cycle, against the reference's;
* a one-group zero-link system equals ``Simulator(..., channels=N)`` bit
  for bit (``Stats`` and the dense trace);
* ``run_batch`` over a two-group system against the reference's, and the
  group-aware metrics.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                # noqa: E402
import jax.numpy as jnp                                   # noqa: E402

from repro.core import Simulator as JSim                  # noqa: E402
from repro.core import compile_system as j_compile_system  # noqa: E402
from repro.core import controller as JC                   # noqa: E402
from repro.core import engine as JE                       # noqa: E402
from repro.core import frontend as JF                     # noqa: E402
from repro.core.addrmap import MAPPERS                    # noqa: E402
from repro.core.addrmap import \
    SystemAddressMapper as JMapper                        # noqa: E402
from repro.core.addrmap import \
    make_system_layout as j_system_layout                 # noqa: E402

from repro_torch import convert                           # noqa: E402
from repro_torch.core import (MemorySystemSpec, Simulator,  # noqa: E402
                              SpecGroup, as_system, compile_spec,
                              compile_system)
from repro_torch.core import engine as TE                 # noqa: E402
from repro_torch.core import frontend as TF               # noqa: E402
from repro_torch.core.addrmap import (SystemAddressMapper,  # noqa: E402
                                      make_system_layout)
from repro_torch.trace import FIELDS, capture             # noqa: E402

from torch_parity import tree_np                          # noqa: E402

HETERO = [dict(standard="DDR5", org_preset="DDR5_16Gb_x8",
               timing_preset="DDR5_4800B", channels=2),
          dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
               timing_preset="DDR4_2400R", channels=2, link_latency=80)]
#: three groups of different radices (the reference's round-trip system)
TRIPLE = [dict(standard="DDR5", org_preset="DDR5_16Gb_x8",
               timing_preset="DDR5_4800B", channels=2),
          dict(standard="HBM3", org_preset="HBM3_16Gb",
               timing_preset="HBM3_5200", channels=1),
          dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
               timing_preset="DDR4_2400R", channels=3, link_latency=64)]


def _descriptor_forms():
    """The same 3-group system from every descriptor form."""
    return {
        "dict": lambda cs: cs(TRIPLE),
        "tuple": lambda cs: cs([
            ("DDR5", "DDR5_16Gb_x8", "DDR5_4800B", 2),
            ("HBM3", "HBM3_16Gb", "HBM3_5200"),
            ("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", 3, 64)]),
    }


@pytest.mark.parametrize("form", sorted(_descriptor_forms()))
def test_composition_matches_reference(form):
    build = _descriptor_forms()[form]
    j, t = build(j_compile_system), build(compile_system)
    assert isinstance(t, MemorySystemSpec)
    assert t.cmd_names == j.cmd_names and t.n_cmds == j.n_cmds
    assert [m.tolist() for m in t.group_cmd_maps] == \
        [m.tolist() for m in j.group_cmd_maps]
    np.testing.assert_array_equal(t.chan_base, j.chan_base)
    np.testing.assert_array_equal(t.chan_group, j.chan_group)
    assert (t.n_groups, t.n_channels, t.homogeneous, t.label, t.tCK_ps) == (
        j.n_groups, j.n_channels, j.homogeneous, j.label, j.tCK_ps)
    assert [g.link_latency for g in t.groups] == [0, 0, 64]
    assert [t.group_of_channel(c) for c in range(6)] == [0, 0, 1, 2, 2, 2]


def test_other_descriptor_forms_and_coercion():
    cs = compile_spec("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", channels=2)
    one = as_system(cs)
    assert one.homogeneous and one.n_channels == 2 and one.groups[0].cspec \
        is cs
    assert as_system(one) is one
    mixed = compile_system([cs, SpecGroup(compile_spec(
        "DDR5", "DDR5_16Gb_x8", "DDR5_4800B"), 1, 40)])
    assert mixed.label == "DDR4x2+DDR5x1@40" and not mixed.homogeneous
    assert as_system([("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", 1, 8)]).label \
        == "DDR4x1@8"
    with pytest.raises(ValueError, match="compiled for 1"):
        MemorySystemSpec([SpecGroup(compile_spec(
            "DDR4", "DDR4_8Gb_x8", "DDR4_2400R"), 2)])
    with pytest.raises(ValueError, match="at least one"):
        MemorySystemSpec([])
    with pytest.raises(TypeError, match="unknown group descriptor"):
        compile_system([dict(HETERO[0], colour="red")])


@pytest.mark.parametrize("order", MAPPERS)
def test_system_mapper_round_trip_mixed_radix(order):
    """Address -> (chan, sub, row, col) -> address round-trips across
    groups of different radices, and decodes as the reference does."""
    msys = compile_system(TRIPLE)
    m = SystemAddressMapper(msys, order)
    jm = JMapper(j_compile_system(TRIPLE), order)
    assert m.tx_bits == jm.tx_bits and m.sublayouts == jm.sublayouts
    rng = np.random.default_rng(7)
    cap = min(int(np.prod([c for _, c in lay])) for lay in m.sublayouts)
    q = rng.integers(0, cap, 5000)
    addrs = (q * msys.n_channels
             + rng.integers(0, msys.n_channels, 5000)) << m.tx_bits
    got = m.to_chan_sub_row_col(addrs)
    for a, b in zip(got, jm.to_chan_sub_row_col(addrs)):
        np.testing.assert_array_equal(a, b)
    chan, sub, row, col = got
    assert set(np.unique(chan)) == set(range(6))
    for g, grp in enumerate(msys.groups):
        mk = msys.chan_group[chan] == g
        assert (row[mk] < grp.cspec.rows).all()
        assert (col[mk] < grp.cspec.columns).all()
        for i in range(len(grp.cspec.levels) - 1):
            assert (sub[mk, i] < int(grp.cspec.level_counts[i + 1])).all()
    np.testing.assert_array_equal(m.encode(chan, sub, row, col), addrs)


def test_channel_msb_orders_refused_for_several_groups():
    msys = compile_system(HETERO)
    with pytest.raises(ValueError, match="channel field above the LSB"):
        make_system_layout(msys, "ChRoBaRaCo")
    with pytest.raises(ValueError, match="channel field above the LSB"):
        SystemAddressMapper(msys, "RoChBaRaCo")
    # one group takes any order, as its own layout
    one = compile_system(HETERO[:1])
    assert make_system_layout(one, "ChRoBaRaCo")[0] == "single"
    m = SystemAddressMapper(one, "RoBaRaCoCh")
    a = np.arange(0, 1 << 16, 64, dtype=np.int64)
    np.testing.assert_array_equal(m.encode(*m.to_chan_sub_row_col(a)), a)


FRONT_CFGS = [dict(), dict(pattern="random"), dict(probes=False),
              dict(stream=False), dict(pattern="random", probes=False,
                                       read_ratio=0.3),
              dict(mapper="RoBaRaCoCh", interval=1.0)]


@pytest.mark.parametrize("ci", range(len(FRONT_CFGS)))
def test_system_frontend_insert_matches_reference(ci):
    """The system frontend's insert and commit on random frontend states
    and part-filled queues of the three groups, against the reference's
    ``system_frontend_step`` (draws, routing, backpressure)."""
    jcfg = JF.FrontendConfig(**FRONT_CFGS[ci])
    tcfg = TF.FrontendConfig(**FRONT_CFGS[ci])
    jsys, tsys = j_compile_system(TRIPLE), compile_system(TRIPLE)
    jlay = j_system_layout(jsys, jcfg.mapper)
    st = TF.system_front_tables(tsys, tcfg, "cpu")
    assert st.k_draws == JF.rng_draws_per_cycle(jcfg, jlay) == \
        TF.rng_draws_per_cycle(tcfg, make_system_layout(tsys, tcfg.mapper))
    jfp, tfp = jcfg.params(), tcfg.params()
    step = jax.jit(lambda fs, qs, clk: JF.system_frontend_step(
        jsys, jcfg, jfp, fs, qs, clk, jlay))
    rng = np.random.default_rng(ci)
    for trial in range(6):
        fs = JF.init_front()._replace(
            rng=jnp.uint32(int(rng.integers(0, 2**32))),
            seq=jnp.int32(int(rng.integers(0, 10**6))),
            accum_fp=jnp.int32(int(rng.integers(0, 512))),
            probe_busy=jnp.asarray(bool(rng.random() < 0.3)),
            probe_next=jnp.int32(int(rng.integers(0, 40))))
        qs = []
        for g in jsys.groups:
            depth = 4
            q = jax.tree.map(lambda a: jnp.broadcast_to(
                a, (g.channels,) + a.shape), JC.empty_queue(g.cspec, depth))
            full = rng.random((g.channels, depth)) < 0.7
            qs.append(q._replace(valid=jnp.asarray(full)))
        clk = int(rng.integers(0, 40))
        jq, jfs = step(fs, tuple(qs), jnp.int32(clk))
        tq = tuple(convert.queue(tree_np(q), "cpu") for q in qs)
        tfs = convert.front_state(tree_np(fs), "cpu")
        tq, draft = TF.system_frontend_insert(tsys, tcfg, tfp, tfs, tq, clk,
                                              st)
        tfs = TF.frontend_commit(tcfg, tfp, tfs, draft, draft.okp, draft.ok)
        for name in jfs._fields:
            assert int(getattr(jfs, name)) == int(getattr(tfs, name)), (
                ci, trial, name)
        for g, (a, b) in enumerate(zip(jq, tq)):
            for name in a._fields:
                np.testing.assert_array_equal(
                    np.asarray(getattr(a, name)).astype(np.int64),
                    getattr(b, name).numpy().astype(np.int64),
                    err_msg=f"{ci} {trial} group {g} {name}")


def test_one_group_system_equals_channels_path():
    """``Simulator(system=[one group])`` is the ``channels=N`` path: the
    same Stats and the same dense trace, bit for bit."""
    kw = dict(device="cpu", mapper="RoBaRaCoCh")
    classic = Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", channels=2,
                        **kw)
    grouped = Simulator(system=[("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", 2)],
                        **kw)
    assert grouped.msys.homogeneous and grouped.cspec.n_channels == 2
    s1, d1 = classic.run(400, interval=2.0, read_ratio=0.7, trace=True)
    s2, d2 = grouped.run(400, interval=2.0, read_ratio=0.7, trace=True)
    assert s1.to_dict() == s2.to_dict()
    for a, b in zip(d1, d2):
        assert torch.equal(a, b)
    t1, t2 = capture(classic.cspec, d1), capture(grouped.msys, d2)
    for f in FIELDS + ("group",):
        np.testing.assert_array_equal(getattr(t1, f), getattr(t2, f))


def test_simulator_argument_checks():
    with pytest.raises(ValueError, match="not both"):
        Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", system=HETERO,
                  device="cpu")
    with pytest.raises(ValueError, match="channels="):
        Simulator(system=HETERO, channels=2, device="cpu")
    with pytest.raises(ValueError, match="timing_overrides="):
        Simulator(system=HETERO, timing_overrides={"nCL": 20}, device="cpu")
    sim = Simulator(system=HETERO, device="cpu")
    assert sim.cspec is None and len(sim.dps) == 2


def test_run_batch_over_a_system_matches_reference():
    """Two load points over DDR5x2 + DDR4x2@80: every point's Stats and
    per-group leaves equal the reference's ``run_batch``; the group-aware
    metrics of a point equal the reference's on its own stats."""
    pts, stats = Simulator(system=HETERO, device="cpu").run_batch(
        300, [8.0, 1.0], [0.7])
    jsys = j_compile_system(HETERO)
    jpts, jstats = JSim(system=jsys).run_batch(300, [8.0, 1.0], [0.7])
    assert pts == jpts
    for i in range(len(pts)):
        want = jax.tree.map(lambda a, i=i: np.asarray(a)[i], jstats)
        got = stats.point(i)
        assert got.to_dict() == want.to_dict(), pts[i]
        assert len(got.per_group) == 2
        for g, (a, b) in enumerate(zip(want.per_group, got.per_group)):
            for name in a._fields:
                np.testing.assert_array_equal(
                    np.asarray(getattr(a, name)),
                    getattr(b, name).numpy(), err_msg=f"{i} {g} {name}")
        for fn in ("throughput_gbps", "avg_probe_latency_ns",
                   "row_hit_rate"):
            assert getattr(TE, fn)(compile_system(HETERO), got) == \
                getattr(JE, fn)(jsys, want), fn
    assert TE.peak_gbps(compile_system(HETERO)) == JE.peak_gbps(jsys)
    with pytest.raises(ValueError, match="spec group"):
        TE.throughput_gbps(compile_spec("DDR4", "DDR4_8Gb_x8",
                                        "DDR4_2400R"), stats.point(0))


def test_geometry_edit_after_construction_reaches_the_frontend():
    """``sim.cspec.rows = 2`` after construction is read when a run
    starts, as in the reference (the frontend's tables are built then)."""
    sim = Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", device="cpu",
                    frontend=TF.FrontendConfig(pattern="random",
                                               probes=False))
    sim.cspec.rows = 2
    got, dense = sim.run(400, interval=2.0, read_ratio=1.0, trace=True)
    rows = dense.row[dense.cmd >= 0]
    assert int(rows.max()) <= 1
    jsim = JSim("DDR4", "DDR4_8Gb_x8", "DDR4_2400R",
                frontend=JF.FrontendConfig(pattern="random", probes=False))
    jsim.cspec.rows = 2
    want = jsim.run(400, interval=2.0, read_ratio=1.0)
    assert got.to_dict() == want.to_dict()
