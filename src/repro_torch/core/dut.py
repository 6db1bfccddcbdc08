"""DeviceUnderTest: fine-grained probe API (paper §4, Listing 2).

The port's copy of ``repro.core.dut``: an *independent*, scalar numpy
implementation of the device semantics (int64 state, ``NEG = -(1 << 28)``)
used as the oracle for the port's tensor engine, its fused controller-step
kernel and its readiness kernel.  It reads the port's ``CompiledSpec`` and
touches no tensor.  The API mirrors the paper:

    dram = ...  # any registered standard
    dut  = DeviceUnderTest(dram, org_preset=..., timing_preset=...)
    addr = dut.addr_vec(Rank=0, BankGroup=0, Bank=0, Row=12, Column=0)
    closed = dut.probe("RD", addr, clk=0)
    assert closed.preq == "ACT"
    assert closed.timing_OK is True
    assert closed.ready is False
    dut.issue("ACT", addr, clk=0)
    early = dut.probe("RD", addr, clk=dut.timings["nRCD"] - 1)
    assert early.timing_OK is False and early.row_hit is True
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import spec as S
from repro_torch.core.compile import CompiledSpec, compile_spec

NEG = -(1 << 28)
_LEVEL_KEYS = {"channel": "Channel", "rank": "Rank", "pseudochannel":
               "PseudoChannel", "bankgroup": "BankGroup", "bank": "Bank"}


@dataclasses.dataclass
class ProbeResult:
    preq: str           # prerequisite command needed before `cmd`
    timing_OK: bool     # `cmd` itself satisfies all timing constraints now
    ready: bool         # preq == cmd and timing_OK
    row_hit: bool
    row_open: bool
    earliest: int       # earliest cycle `cmd` is timing-legal


class DeviceUnderTest:
    def __init__(self, standard, org_preset: str, timing_preset: str,
                 timing_overrides: dict | None = None,
                 _cspec: CompiledSpec | None = None):
        if _cspec is not None:
            self.cspec = _cspec
        else:
            if not isinstance(standard, (str, type)):
                raise TypeError("pass a standard class or name")
            self.cspec: CompiledSpec = compile_spec(standard, org_preset,
                                                    timing_preset,
                                                    timing_overrides)
        cs = self.cspec
        self.timings = cs.timings
        # mirror of the engine's split timing state: dense most-recent
        # table + compact windowed ring (DUT-replay cross-checks must see
        # the exact same layout semantics)
        self.last_issue = np.full((cs.num_nodes, cs.n_cmds), NEG, np.int64)
        self.win_ring = np.full((max(cs.n_ring, 1), cs.ring_depth),
                                NEG, np.int64)
        self.row_state = np.full((cs.n_banks,), -1, np.int64)
        self.act1_row = np.zeros((cs.n_banks,), np.int64)
        self.act1_clk = np.full((cs.n_banks,), NEG, np.int64)
        self.clock_until = np.zeros((cs.n_refresh_units,), np.int64)
        self.history: list = []

    @classmethod
    def from_compiled(cls, cspec: CompiledSpec) -> "DeviceUnderTest":
        """Build the oracle directly from a compiled spec — e.g. one spec
        group of a heterogeneous ``MemorySystemSpec``, timing overrides
        and post-compile geometry edits included — so every channel of
        every group can be cross-checked against its OWN device model."""
        return cls(None, "", "", _cspec=cspec)

    # ---- addressing -------------------------------------------------------
    def addr_vec(self, **kw) -> dict:
        """addr_vec(Rank=0, BankGroup=0, Bank=0, Row=12, Column=0)"""
        addr = {}
        for lv in self.cspec.levels[1:]:
            addr[lv] = int(kw.pop(_LEVEL_KEYS[lv], kw.pop(lv, 0)))
        addr["row"] = int(kw.pop("Row", kw.pop("row", 0)))
        addr["col"] = int(kw.pop("Column", kw.pop("col", 0)))
        if kw:
            raise TypeError(f"unknown address fields {sorted(kw)} "
                            f"(levels: {self.cspec.levels[1:]})")
        return addr

    def _nodes(self, addr) -> list:
        cs = self.cspec
        nodes, flat = [0], 0
        for i, lv in enumerate(cs.levels[1:], start=1):
            flat = flat * int(cs.level_counts[i]) + addr[lv]
            nodes.append(int(cs.level_offsets[i]) + flat)
        return nodes

    def _bank(self, addr) -> int:
        cs = self.cspec
        flat = 0
        for i, lv in enumerate(cs.levels[1:], start=1):
            flat = flat * int(cs.level_counts[i]) + addr[lv]
        return flat

    # ---- semantics (scalar, loop-based — the oracle) -----------------------
    def earliest(self, cmd: str, addr) -> int:
        cs = self.cspec
        c = cs.cmd_id(cmd)
        nodes = self._nodes(addr)
        t = NEG
        for i in range(len(cs.ct_next)):
            if cs.ct_next[i] != c:
                continue
            node = nodes[cs.ct_level[i]]
            if cs.ct_win[i] > 1:
                ro = int(cs.ct_ring[i])
                if ro < 0:
                    continue    # window the preceding command never stamps
                e = ro + node - int(cs.level_offsets[cs.ct_level[i]])
                prev_t = self.win_ring[e, cs.ct_win[i] - 1]
            else:
                prev_t = self.last_issue[node, cs.ct_prev[i]]
            if prev_t > NEG:
                t = max(t, prev_t + int(cs.ct_lat[i]))
        return t

    def prereq(self, cmd: str, addr) -> str:
        """Prerequisite for the *request* carried by a column command, or
        for the command itself when it is not a column command."""
        cs = self.cspec
        kind = cs.cmd_kind[cs.cmd_id(cmd)]
        if kind != S.KIND_COL:
            return cmd
        bank = self._bank(addr)
        rs = self.row_state[bank]
        ru = addr[cs.levels[1]]
        if rs == -1:
            return "ACT1" if cs.split_activation else "ACT"
        if rs == -2:
            return "ACT2"
        if rs != addr["row"]:
            return "PRE"
        if cs.data_clock_sync and not (self._now_clock_on(ru)):
            if cs.id_RCKSTRT >= 0:
                return "RCKSTRT"
            return "CAS_WR" if cmd == "WR" else "CAS_RD"
        return cmd

    def _now_clock_on(self, ru) -> bool:
        return self._probe_clk < self.clock_until[ru]

    _probe_clk = 0

    def probe(self, cmd: str, addr, clk: int) -> ProbeResult:
        self._probe_clk = clk
        cs = self.cspec
        bank = self._bank(addr)
        rs = self.row_state[bank]
        earliest = self.earliest(cmd, addr)
        timing_OK = clk >= earliest
        preq = self.prereq(cmd, addr)
        return ProbeResult(preq=preq, timing_OK=bool(timing_OK),
                           ready=bool((preq == cmd) and timing_OK),
                           row_hit=bool(rs == addr["row"]),
                           row_open=bool(rs >= 0),
                           earliest=int(earliest))

    def issue(self, cmd: str, addr, clk: int, check: bool = False):
        cs = self.cspec
        c = cs.cmd_id(cmd)
        if check:
            r = self.probe(cmd, addr, clk)
            if not (r.timing_OK and r.preq == cmd):
                raise AssertionError(
                    f"illegal issue of {cmd} at clk={clk}: {r}")
        nodes = self._nodes(addr)
        scope = cs.cmd_scope[c]
        for lvl in range(scope + 1):
            self.last_issue[nodes[lvl], c] = clk
        for pcmd, plvl, eoff, _n_l in cs.ring_pairs:
            if pcmd != c:       # pair levels are <= the command's scope
                continue
            e = eoff + nodes[plvl] - int(cs.level_offsets[plvl])
            ring = self.win_ring[e]
            ring[1:] = ring[:-1]
            ring[0] = clk
        fx = int(cs.cmd_fx[c])
        bank = self._bank(addr)
        ru = addr[cs.levels[1]]
        if fx & S.FX_OPEN:
            self.row_state[bank] = addr["row"]
        if fx & S.FX_CLOSE:
            self.row_state[bank] = -1
        if fx & S.FX_CLOSE_ALL:
            bpr = cs.n_banks // cs.n_refresh_units
            self.row_state[ru * bpr:(ru + 1) * bpr] = -1
        if fx & S.FX_ACT1:
            self.row_state[bank] = -2
            self.act1_row[bank] = addr["row"]
            self.act1_clk[bank] = clk
        if fx & S.FX_CLOCK_ON:
            self.clock_until[ru] = clk + cs.clock_idle
        if fx & (S.FX_FINAL_RD | S.FX_FINAL_WR) and cs.data_clock_sync:
            self.clock_until[ru] = max(self.clock_until[ru],
                                       clk + cs.clock_idle)
        self.history.append((clk, cmd, dict(addr)))
