"""Cycle-level DRAM device model on PyTorch tensors.

The counterpart of ``repro.core.device``.  All mutable device state is a
:class:`DeviceState` of dense int32 tensors, each with a leading channel
axis of size ``channels``; every operation is a plain function
``(cspec, dp, state, ...) -> ...`` over the whole channel batch (the
reference's ``vmap`` written out as that leading axis).

State encoding (per channel)
----------------------------
row_state[bank]  : -1 closed, -2 activating (split ACT-1 issued), else open row
last_issue[node, cmd] : most-recent issue clock (every window=1 constraint)
win_ring[e, w]   : issue-clock history (most recent first) only for the
                   (prev_cmd, level) pairs with a window>1 constraint
clock_until[ru]  : WCK/RCK data clock active until this cycle (exclusive)
last_ref[ru]     : last REFab issue clock per refresh unit

The dense readiness table (:func:`earliest_ready_table`) is computed by
the CUDA kernel of ``repro_torch.kernels.readiness`` on CUDA tensors (off
the main path: the engine's step computes it inside the fused controller
step kernel, and the plain step with :func:`earliest_ready_table_plain`).
Static spec tables live on the run's device in :class:`SpecTables`, which
:class:`DynParams` carries, so the cycle loop never copies a constant
from the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import spec as S
from repro_torch.core.compile import CompiledSpec
from repro_torch.kernels import readiness as R

NEG = -(1 << 28)     # "never issued"
ROW_CLOSED = -1
ROW_ACTIVATING = -2

I32 = torch.int32


class SpecTables(NamedTuple):
    """Static index/lookup tensors of one spec on the run's device."""
    cmd_kind: torch.Tensor      # (n_cmds,) int32
    cmd_scope: torch.Tensor     # (n_cmds,) int32
    cmd_fx: torch.Tensor        # (n_cmds,) int32
    lvl_idx: torch.Tensor       # (L,) int32
    node_ids: torch.Tensor      # (num_nodes,) int32
    cmd_ids: torch.Tensor       # (n_cmds,) int32
    bank_ids: torch.Tensor      # (n_banks,) int32
    ru_ids: torch.Tensor        # (n_refresh_units,) int32
    bank_ru: torch.Tensor       # (n_banks,) int32 owning refresh unit
    node_mul: torch.Tensor      # (L-1, L) int32 sub-index -> node multiplier
    node_off: torch.Tensor      # (L,) int32 level node offsets
    bank_stride: torch.Tensor   # (L-1,) int32 sub-index -> flat bank stride
    sub_e0: torch.Tensor        # (L-1,) int32 one-hot of the refresh level
    col_cmds: torch.Tensor      # (n_cmds,) bool — column/sync-bus commands
    row_cmds: torch.Tensor      # (n_cmds,) bool — row/refresh-bus commands
    ring_cmd: torch.Tensor      # (R,) int32
    ring_level: torch.Tensor    # (R,) int64
    ring_node: torch.Tensor     # (R,) int32
    ct_prev: torch.Tensor       # (C,) int32 — the per-constraint tables
    ct_next: torch.Tensor       #   read by earliest_ready (off the main
    ct_level: torch.Tensor      #   path: the engine reads the dense
    ct_ring: torch.Tensor       #   table through the kernel)
    ct_win: torch.Tensor
    ct_lvl_off: torch.Tensor
    ch_idx: torch.Tensor        # (channels, 1) int64 channel index column
    ready: R.ReadinessTables    # the readiness kernel's key tables + A
    #: numpy copies of what the fused kernel's plan packs ("Keys" (4, K),
    #: "A", "ColCmds", "RowCmds", "BankStride", "NodeMul", "NodeOff"), so
    #: a plan is built without reading the device back
    host: dict


class DynParams(NamedTuple):
    """Preset-dependent latencies of one run: the constraint latencies as
    a device tensor, the scalar timings as Python ints, and the spec's
    device tables (built from the same latencies)."""
    ct_lat: torch.Tensor         # (C,) int32 resolved constraint latencies
    nREFI: int
    nRFC: int
    nAAD: int                    # ACT-2 deadline (0 = n/a)
    clock_idle: int              # WCK/RCK idle window (0 = n/a)
    read_latency: int            # RD issue -> data valid
    tables: SpecTables


def spec_tables(cspec: CompiledSpec, ct_lat, device,
                channels: int = 1) -> SpecTables:
    """Copy the static tables of ``cspec`` to ``device`` (once per run)."""
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    L = len(cspec.levels)
    counts = np.asarray(cspec.level_counts, np.int64)
    # node at level l = off[l] + sum_{i<=l} sub[i-1] * prod(counts[i+1..l])
    mul = np.zeros((L - 1, L), np.int64)
    for lvl in range(1, L):
        m = 1
        for i in range(lvl, 0, -1):
            mul[i - 1, lvl] = m
            m *= int(counts[i])
    bpr = cspec.n_banks // cspec.n_refresh_units
    keys, A = R.key_tables(cspec, ct_lat)
    col = np.isin(cspec.cmd_kind, (S.KIND_COL, S.KIND_SYNC))
    row = np.isin(cspec.cmd_kind, (S.KIND_ROW, S.KIND_REF))
    return SpecTables(
        cmd_kind=i32(cspec.cmd_kind), cmd_scope=i32(cspec.cmd_scope),
        cmd_fx=i32(cspec.cmd_fx), lvl_idx=i32(np.arange(L)),
        node_ids=i32(np.arange(cspec.num_nodes)),
        cmd_ids=i32(np.arange(cspec.n_cmds)),
        bank_ids=i32(np.arange(cspec.n_banks)),
        ru_ids=i32(np.arange(cspec.n_refresh_units)),
        bank_ru=i32(np.arange(cspec.n_banks) // bpr),
        node_mul=i32(mul), node_off=i32(cspec.level_offsets),
        bank_stride=i32(cspec.addr_strides()),
        sub_e0=i32(np.eye(L - 1)[0]),
        col_cmds=torch.as_tensor(col, device=device),
        row_cmds=torch.as_tensor(row, device=device),
        ring_cmd=i32(cspec.ring_cmd), ring_level=torch.as_tensor(np.asarray(cspec.ring_level, np.int64),
                                    device=device),
        ring_node=i32(cspec.ring_node),
        ct_prev=i32(cspec.ct_prev), ct_next=i32(cspec.ct_next),
        ct_level=i32(cspec.ct_level), ct_ring=i32(cspec.ct_ring),
        ct_win=i32(cspec.ct_win),
        ct_lvl_off=i32(np.asarray(cspec.level_offsets)[cspec.ct_level]),
        ch_idx=torch.arange(channels, device=device)[:, None],
        ready=R.build_tables(cspec, ct_lat, device),
        host=dict(Keys=keys.T, A=A, ColCmds=col, RowCmds=row,
                  BankStride=np.asarray(cspec.addr_strides(), np.int64),
                  NodeMul=mul, NodeOff=np.asarray(cspec.level_offsets,
                                                  np.int64)))


def dyn_params(cspec: CompiledSpec, device, channels: int = 1,
               ct_lat=None) -> DynParams:
    """The run's :class:`DynParams` (``ct_lat`` defaults to the spec's)."""
    t = cspec.timings
    lat = np.asarray(cspec.ct_lat if ct_lat is None else ct_lat, np.int32)
    return DynParams(
        ct_lat=torch.tensor(lat, device=device),
        nREFI=int(t["nREFI"]), nRFC=int(t["nRFC"]), nAAD=int(cspec.nAAD),
        clock_idle=int(cspec.clock_idle),
        read_latency=int(cspec.read_latency),
        tables=spec_tables(cspec, lat, device, channels))


class DeviceState(NamedTuple):
    last_issue: torch.Tensor     # (C, num_nodes, n_cmds) int32
    win_ring: torch.Tensor       # (C, max(n_ring,1), ring_depth) int32
    row_state: torch.Tensor      # (C, n_banks) int32
    act1_row: torch.Tensor       # (C, n_banks) int32
    act1_clk: torch.Tensor       # (C, n_banks) int32
    clock_until: torch.Tensor    # (C, n_refresh_units) int32
    last_ref: torch.Tensor       # (C, n_refresh_units) int32


def init_state(cspec: CompiledSpec, channels: int, device) -> DeviceState:
    full = lambda shape, v: torch.full((channels,) + shape, v, dtype=I32,
                                       device=device)
    return DeviceState(
        last_issue=full((cspec.num_nodes, cspec.n_cmds), NEG),
        # a standard with no windowed constraints keeps a 1x1 dummy ring
        win_ring=full((max(cspec.n_ring, 1), cspec.ring_depth), NEG),
        row_state=full((cspec.n_banks,), ROW_CLOSED),
        act1_row=full((cspec.n_banks,), 0),
        act1_clk=full((cspec.n_banks,), NEG),
        clock_until=full((cspec.n_refresh_units,), 0),
        last_ref=full((cspec.n_refresh_units,), 0),
    )


# --------------------------------------------------------------------------
# Addressing helpers
# --------------------------------------------------------------------------

def node_per_level(cspec: CompiledSpec, tab: SpecTables,
                   addr_sub: torch.Tensor) -> torch.Tensor:
    """Node index at each hierarchy level for addresses ``(..., L-1)``
    (per-level indices below channel).  Returns ``(..., L)``; level 0 is
    the channel node 0."""
    return ((addr_sub[..., :, None] * tab.node_mul).sum(-2, dtype=I32)
            + tab.node_off)


def flat_bank(cspec: CompiledSpec, tab: SpecTables,
              addr_sub: torch.Tensor) -> torch.Tensor:
    return (addr_sub * tab.bank_stride).sum(-1, dtype=I32)


def refresh_unit(cspec: CompiledSpec, addr_sub: torch.Tensor) -> torch.Tensor:
    return addr_sub[..., 0]


# Lookups use gather/take with int64 indices: on CUDA, advanced indexing
# with int32 index tensors costs several times more host time per call.

def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[c, idx[c, ...]]`` for a ``(C, n)`` tensor and ``(C, ...)``
    integer indices."""
    return x.gather(1, idx.reshape(x.shape[0], -1).long()).reshape(idx.shape)


def lut(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a static 1-d lookup table."""
    return torch.take(table, idx.long())


def table_at(table: torch.Tensor, cmd: torch.Tensor,
             bank: torch.Tensor) -> torch.Tensor:
    """``table[c, cmd[c, ...], bank[c, ...]]`` of a ``(C, n_cmds,
    n_banks)`` readiness table."""
    C, _, B = table.shape
    return take(table.reshape(C, -1), cmd * B + bank)


# --------------------------------------------------------------------------
# Timing-readiness check
# --------------------------------------------------------------------------

def earliest_ready(cspec: CompiledSpec, dp: DynParams, state: DeviceState,
                   cmd: torch.Tensor, addr_sub: torch.Tensor) -> torch.Tensor:
    """Earliest cycle at which ``cmd[c]`` may issue at ``addr_sub[c]``
    (timing only), per channel: ``cmd (C,)``, ``addr_sub (C, L-1)``."""
    tab = dp.tables
    nodes = node_per_level(cspec, tab, addr_sub)             # (C, L)
    node = nodes[:, tab.ct_level]                            # (C, Ct)
    t_prev = state.last_issue[tab.ch_idx, node, tab.ct_prev]
    if cspec.n_ring:
        # rows with ct_ring == -1 keep the dense value; their indices are
        # clamped in range as jnp's gather clamps them
        ridx = (tab.ct_ring + node - tab.ct_lvl_off).clamp(0, cspec.n_ring - 1)
        w = (tab.ct_win - 1).clamp(max=cspec.ring_depth - 1)
        t_ring = state.win_ring[tab.ch_idx, ridx, w]
        t_prev = torch.where(tab.ct_ring >= 0, t_ring, t_prev)
    allowed = (t_prev + dp.ct_lat).masked_fill(
        (tab.ct_next != cmd[:, None]) | (t_prev <= NEG), NEG)
    return allowed.amax(1).clamp(min=NEG)


def earliest_ready_table(cspec: CompiledSpec, dp: DynParams,
                         state: DeviceState) -> torch.Tensor:
    """Dense ``(C, n_cmds, n_banks)`` earliest-issue table of every
    channel — the readiness kernel on CUDA, its plain version on CPU.
    The controller resolves a queue slot's readiness with one
    ``table[c, cmd, bank]`` lookup."""
    return R.readiness_table(dp.tables.ready, state.last_issue,
                             state.win_ring)


def earliest_ready_table_plain(cspec: CompiledSpec, dp: DynParams,
                               state: DeviceState) -> torch.Tensor:
    """:func:`earliest_ready_table` in plain PyTorch on any device (the
    plain controller step's table)."""
    return R.readiness_table_plain(dp.tables.ready, state.last_issue,
                                   state.win_ring)


# --------------------------------------------------------------------------
# Prerequisite decode (per-standard request -> next command)
# --------------------------------------------------------------------------

def prereq(cspec: CompiledSpec, dp: DynParams, state: DeviceState,
           is_write: torch.Tensor, addr_sub: torch.Tensor, row: torch.Tensor,
           clk):
    """Next command needed to advance each request (``is_write``/``row``
    ``(C, Q)``, ``addr_sub (C, Q, L-1)``).

    Returns (cmd, cmd_row, open_hit): cmd_row is the row the command
    actually targets (ACT-2 completes the *pending* activation row, not
    the request's row).
    """
    tab = dp.tables
    bank = flat_bank(cspec, tab, addr_sub)
    rs = take(state.row_state, bank)
    open_hit = rs == row

    def pick(cond, a: int, b: int):
        # int32 select of two command ids
        return torch.full_like(rs, b).masked_fill(cond, a)

    col_cmd = pick(is_write, cspec.id_WR, cspec.id_RD)
    if cspec.data_clock_sync:
        clock_on = clk < take(state.clock_until,
                              refresh_unit(cspec, addr_sub))
        sync_wr = cspec.id_CAS_WR if cspec.id_CAS_WR >= 0 \
            else cspec.id_RCKSTRT
        sync_rd = cspec.id_CAS_RD if cspec.id_CAS_RD >= 0 \
            else cspec.id_RCKSTRT
        col_cmd = torch.where(clock_on, col_cmd,
                              pick(is_write, sync_wr, sync_rd))

    cmd = col_cmd.masked_fill(~open_hit, cspec.id_PRE)
    if cspec.split_activation:
        cmd = cmd.masked_fill(rs == ROW_ACTIVATING, cspec.id_ACT2)
        cmd = cmd.masked_fill(rs == ROW_CLOSED, cspec.id_ACT1)
        cmd_row = torch.where(cmd == cspec.id_ACT2,
                              take(state.act1_row, bank), row)
    else:
        cmd = cmd.masked_fill(rs == ROW_CLOSED, cspec.id_ACT)
        cmd_row = row
    return cmd, cmd_row, open_hit


# --------------------------------------------------------------------------
# Command issue: timestamp rings + state effects
# --------------------------------------------------------------------------

def issue(cspec: CompiledSpec, dp: DynParams, state: DeviceState,
          cmd: torch.Tensor, addr_sub: torch.Tensor, row: torch.Tensor,
          clk: int, enable: torch.Tensor) -> DeviceState:
    """Issue ``cmd[c]`` at ``addr_sub[c]`` on cycle ``clk`` in every
    channel whose ``enable[c]`` is set (``cmd``/``row``/``enable`` are
    ``(C,)``).  Every mutation is a dense masked select, as in the
    reference, so a disabled channel is left bit-identical."""
    tab = dp.tables
    nodes = node_per_level(cspec, tab, addr_sub)                # (C, L)
    cmd_l = cmd.long()
    scope = tab.cmd_scope.gather(0, cmd_l)                      # (C,)
    upd_mask = (tab.lvl_idx <= scope[:, None]) & enable[:, None]
    node_hit = ((tab.node_ids[None, :, None] == nodes[:, None, :])
                & upd_mask[:, None, :]).any(2)                  # (C, N)
    cmd_hit = tab.cmd_ids == cmd[:, None]                       # (C, cmds)
    li = state.last_issue.masked_fill(
        node_hit[:, :, None] & cmd_hit[:, None, :], clk)

    ring = state.win_ring
    if cspec.n_ring:
        # shift-insert only the ring entries owned by (cmd, its level node)
        entry_hit = ((tab.ring_cmd == cmd[:, None])
                     & (nodes.index_select(1, tab.ring_level)
                        == tab.ring_node)
                     & enable[:, None])                         # (C, R)
        shifted = torch.cat([torch.full_like(ring[:, :, :1], clk),
                             ring[:, :, :-1]], dim=2)
        ring = torch.where(entry_hit[:, :, None], shifted, ring)

    fx = tab.cmd_fx.gather(0, cmd_l) * enable                   # (C,)
    bank = flat_bank(cspec, tab, addr_sub)
    ru = refresh_unit(cspec, addr_sub)
    bank_hit = tab.bank_ids == bank[:, None]                    # (C, B)
    ru_hit = tab.ru_ids == ru[:, None]                          # (C, U)

    def has(bit):
        return ((fx & bit) != 0)[:, None]

    rs = state.row_state
    rs = torch.where(has(S.FX_OPEN) & bank_hit, row[:, None], rs)
    rs = rs.masked_fill(has(S.FX_CLOSE) & bank_hit, ROW_CLOSED)
    # FX_CLOSE_ALL: close every bank in this refresh unit
    rs = rs.masked_fill(has(S.FX_CLOSE_ALL) & (tab.bank_ru == ru[:, None]),
                        ROW_CLOSED)
    a1_hit = has(S.FX_ACT1) & bank_hit
    rs = rs.masked_fill(a1_hit, ROW_ACTIVATING)
    a1r = torch.where(a1_hit, row[:, None], state.act1_row)
    a1c = state.act1_clk.masked_fill(a1_hit, clk)

    cu = state.clock_until.masked_fill(has(S.FX_CLOCK_ON) & ru_hit,
                                       clk + dp.clock_idle)
    if cspec.data_clock_sync:
        # data transfer keeps the data clock alive
        is_data = has(S.FX_FINAL_RD | S.FX_FINAL_WR)
        cu = torch.where(is_data & ru_hit,
                         cu.clamp(min=clk + dp.clock_idle), cu)

    lr = state.last_ref.masked_fill(
        ((cmd == cspec.id_REFab) & enable)[:, None] & ru_hit, clk)

    return DeviceState(last_issue=li, win_ring=ring, row_state=rs,
                       act1_row=a1r, act1_clk=a1c, clock_until=cu,
                       last_ref=lr)
