"""PyTorch port, the validation workflow's oracle: ``repro_torch.core.dut``
(the paper's §4 Listing 2 probe API, a scalar numpy model) against the
reference's ``repro.core.dut``, exactly.

* The Listing 2 sequence and every case of ``tests/core/test_probe_ddr4.py``
  hold on the port's oracle, and each of its probes equals the
  reference's on the same sequence.
* A random legal command history (numpy seed) drives both oracles: every
  probe result, the state arrays and the history agree.
* After that history is applied with the port's ``device.issue``, the
  port's ``earliest_ready_table`` equals the oracle's ``earliest`` for
  every (command, bank) — DDR4, LPDDR5 (split activation, data-clock
  sync) and HBM3 (dual command bus).
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
import torch                                              # noqa: E402

from repro.core import DeviceUnderTest as JDut            # noqa: E402
from repro_torch.core import DeviceUnderTest as TDut      # noqa: E402
from repro_torch.core import device as D                  # noqa: E402

import torch_parity as tp                                 # noqa: E402

DDR4 = ("DDR4", "DDR4_8Gb_x8", "DDR4_2400R")


class Both:
    """The two oracles driven in lockstep: every call goes to both and
    the results must be equal (probe results as dicts)."""

    def __init__(self, *args):
        self.j, self.t = JDut(*args), TDut(*args)
        self.timings = self.t.timings
        assert self.j.timings == self.t.timings

    def addr_vec(self, **kw):
        a = self.t.addr_vec(**kw)
        assert a == self.j.addr_vec(**kw)
        return a

    def probe(self, cmd, addr, clk):
        r = self.t.probe(cmd, addr, clk=clk)
        assert dataclasses.asdict(r) == dataclasses.asdict(
            self.j.probe(cmd, addr, clk=clk)), (cmd, addr, clk)
        return r

    def issue(self, cmd, addr, clk, check=False):
        self.t.issue(cmd, addr, clk=clk, check=check)
        self.j.issue(cmd, addr, clk=clk, check=check)


@pytest.fixture
def dut():
    return Both(*DDR4)


def test_listing2_rd_blocked_until_act_and_nrcd(dut):
    addr = dut.addr_vec(Rank=0, BankGroup=0, Bank=0, Row=12, Column=0)
    closed = dut.probe("RD", addr, clk=0)
    assert (closed.preq, closed.timing_OK, closed.ready) == ("ACT", True,
                                                             False)
    dut.issue("ACT", addr, clk=0)
    early = dut.probe("RD", addr, clk=dut.timings["nRCD"] - 1)
    assert (early.preq, early.timing_OK, early.ready, early.row_hit,
            early.row_open) == ("RD", False, False, True, True)
    ontime = dut.probe("RD", addr, clk=dut.timings["nRCD"])
    assert (ontime.preq, ontime.timing_OK, ontime.ready) == ("RD", True, True)


def test_row_miss_requires_precharge(dut):
    addr = dut.addr_vec(Rank=0, BankGroup=1, Bank=2, Row=7, Column=0)
    dut.issue("ACT", addr, clk=0)
    other = dict(addr, row=9)
    r = dut.probe("RD", other, clk=100)
    assert r.preq == "PRE" and not r.row_hit and r.row_open
    dut.issue("PRE", other, clk=100)
    assert dut.probe("RD", other, clk=100 + dut.timings["nRP"] - 1).preq \
        == "ACT"


def test_nrc_act_to_act_same_bank(dut):
    addr = dut.addr_vec(Rank=0, BankGroup=0, Bank=1, Row=1, Column=0)
    dut.issue("ACT", addr, clk=0)
    dut.issue("PRE", addr, clk=dut.timings["nRAS"])
    clk_ok = dut.timings["nRC"]
    assert dut.probe("ACT", addr, clk=clk_ok - 1).timing_OK is False
    assert dut.probe("ACT", addr, clk=clk_ok).timing_OK is True


def test_nfaw_window(dut):
    t = 0
    for b in range(4):
        addr = dut.addr_vec(Rank=0, BankGroup=b, Bank=0, Row=1, Column=0)
        assert dut.probe("ACT", addr, clk=t).timing_OK
        dut.issue("ACT", addr, clk=t)
        t += dut.timings["nRRD_S"]
    fifth = dut.addr_vec(Rank=0, BankGroup=0, Bank=3, Row=1, Column=0)
    assert dut.probe("ACT", fifth, clk=t).timing_OK is False
    assert dut.probe("ACT", fifth, clk=dut.timings["nFAW"]).timing_OK is True


def test_bankgroup_ccd_long_vs_short(dut):
    a = dut.addr_vec(Rank=0, BankGroup=0, Bank=0, Row=1, Column=0)
    b = dut.addr_vec(Rank=0, BankGroup=0, Bank=1, Row=1, Column=0)
    c = dut.addr_vec(Rank=0, BankGroup=1, Bank=0, Row=1, Column=0)
    for addr in (a, b, c):
        dut.issue("ACT", addr, clk=0)
    t = dut.timings["nRCD"]
    dut.issue("RD", a, clk=t, check=True)
    assert dut.probe("RD", b, clk=t + dut.timings["nCCD_S"]).timing_OK \
        is False
    assert dut.probe("RD", b, clk=t + dut.timings["nCCD_L"]).timing_OK is True
    assert dut.probe("RD", c, clk=t + dut.timings["nCCD_S"]).timing_OK is True


def test_write_to_precharge(dut):
    addr = dut.addr_vec(Rank=0, BankGroup=2, Bank=0, Row=3, Column=0)
    dut.issue("ACT", addr, clk=0)
    t = dut.timings["nRCD"]
    dut.issue("WR", addr, clk=t)
    wait = dut.timings["nCWL"] + dut.timings["nBL"] + dut.timings["nWR"]
    assert dut.probe("PRE", addr, clk=t + wait - 1).timing_OK is False
    assert dut.probe("PRE", addr, clk=t + wait).timing_OK is True


def test_checked_issue_refuses_an_illegal_command():
    t = TDut(*DDR4)
    addr = t.addr_vec(Rank=0, BankGroup=0, Bank=0, Row=12, Column=0)
    with pytest.raises(AssertionError, match="illegal issue of RD"):
        t.issue("RD", addr, clk=0, check=True)
    with pytest.raises(TypeError, match="unknown address fields"):
        t.addr_vec(Bogus=1)


def _random_history(dut, rng, steps=80):
    """A random state-legal command sequence through ``dut`` (either
    oracle or :class:`Both`), the reference tests' recipe."""
    cspec = dut.t.cspec if isinstance(dut, Both) else dut.cspec
    clk = 0
    for _ in range(steps):
        sub = {lv: int(rng.integers(int(cspec.level_counts[i + 1])))
               for i, lv in enumerate(cspec.levels[1:])}
        addr = dict(sub, row=int(rng.integers(32)), col=0)
        cmd = dut.probe("WR" if rng.random() < 0.3 else "RD", addr,
                        clk).preq
        if dut.probe(cmd, addr, clk).timing_OK:
            if cmd == "ACT2":
                o = dut.t if isinstance(dut, Both) else dut
                addr = dict(addr, row=int(o.act1_row[o._bank(addr)]))
            dut.issue(cmd, addr, clk=clk)
        clk += int(rng.integers(1, 6))
    return clk


@pytest.mark.parametrize("std,org,tim", tp.TRIO)
def test_oracles_agree_on_a_random_history(std, org, tim):
    both = Both(std, org, tim)
    rng = np.random.default_rng(11)
    _random_history(both, rng)
    j, t = both.j, both.t
    assert len(t.history) > 10 and t.history == j.history
    for f in ("last_issue", "win_ring", "row_state", "act1_row", "act1_clk",
              "clock_until"):
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype == np.int64, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("std,org,tim", tp.TRIO)
def test_oracle_against_the_ports_earliest_ready_table(std, org, tim):
    """The oracle's ``earliest`` equals the port's dense table entry for
    entry after the oracle's history is applied with ``device.issue``
    (int64 oracle against int32 table, compared as Python ints)."""
    dut = TDut(std, org, tim)
    cspec = dut.cspec
    rng = np.random.default_rng(5)
    _random_history(dut, rng, steps=60)
    assert len(dut.history) > 10
    dp = D.dyn_params(cspec, "cpu")
    state = D.init_state(cspec, 1, "cpu")
    for c, cmd, addr in dut.history:
        sub = torch.tensor([[addr[lv] for lv in cspec.levels[1:]]],
                           dtype=torch.int32)
        state = D.issue(cspec, dp, state,
                        torch.tensor([cspec.cmd_id(cmd)], dtype=torch.int32),
                        sub, torch.tensor([addr["row"]], dtype=torch.int32),
                        c, torch.tensor([True]))
    np.testing.assert_array_equal(state.row_state[0].numpy(), dut.row_state)
    table = D.earliest_ready_table(cspec, dp, state)[0]
    from repro_torch.verify.explore import addr_from_bank
    checked = 0
    for b in range(int(cspec.n_banks)):
        addr = addr_from_bank(cspec, b, 0)
        for ci, name in enumerate(cspec.cmd_names):
            assert int(table[ci, b]) == int(dut.earliest(name, addr)), \
                (std, name, b)
            checked += 1
    assert checked == cspec.n_banks * cspec.n_cmds


def test_from_compiled_is_the_group_spec():
    from repro_torch.core import compile_system
    msys = compile_system([dict(standard="DDR5", org_preset="DDR5_16Gb_x8",
                                timing_preset="DDR5_4800B", channels=1),
                           dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
                                timing_preset="DDR4_2400R", channels=1,
                                link_latency=40)])
    for g in msys.groups:
        d = TDut.from_compiled(g.cspec)
        assert d.cspec is g.cspec
        assert d.last_issue.shape == (g.cspec.num_nodes, g.cspec.n_cmds)
