"""Compact columnar command-trace capture.

The counterpart of ``repro.trace.capture``'s capture: :func:`capture`
compacts the dense ``[T, 2]`` (one channel) or ``[T, C, 2]`` (``C``
channels) arrays of ``Simulator.run(..., trace=True)`` into one int32
column per field, one entry per issued command, in issue order
(cycle-major, then channel, column bus before row bus).  For a memory
system of several spec groups (or one group behind a link) the engine's
group-local command ids are resolved into the system's merged
``cmd_names`` and a ``group`` column is attached.  :func:`trace_sha256`
digests the columns in :data:`FIELDS` order — the digest
``tests/trace/golden_hashes.json`` pins (the hetero system's over
``FIELDS + ("group",)``).
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.core import spec as S
from repro_torch.core.compile import (CompiledSpec, MemorySystemSpec,
                                      as_system)
from repro_torch.core.frontend import ReplayStream

#: Columnar int32 fields of a CommandTrace, in digest order (the ``group``
#: column is digested only when asked for, as the reference's v3 format).
FIELDS = ("clk", "cmd", "bank", "row", "bus", "arrive", "hit_ready", "chan")


@dataclasses.dataclass
class CommandTrace:
    """Columnar DRAM command trace: one row per issued command (all
    columns ``(N,)`` int32 numpy arrays; ``group`` is all zero for a
    homogeneous run)."""
    clk: np.ndarray
    cmd: np.ndarray
    bank: np.ndarray
    row: np.ndarray
    bus: np.ndarray
    arrive: np.ndarray
    hit_ready: np.ndarray
    chan: np.ndarray
    n_cycles: int
    cmd_names: list
    group: np.ndarray | None = None

    def __post_init__(self):
        if self.group is None:
            self.group = np.zeros_like(np.asarray(self.clk, np.int32))

    def __len__(self) -> int:
        return int(self.clk.shape[0])


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def capture(spec, trace) -> CommandTrace:
    """Compact a dense trace (``TraceArrays`` of ``[T, 2]`` tensors or
    arrays for one channel, ``[T, C, 2]`` for ``C`` channels) of a run of
    ``spec`` (a ``CompiledSpec`` or a ``MemorySystemSpec``) into a
    :class:`CommandTrace`."""
    cmd, bank, row, arrive, hit_ready = (_host(a) for a in tuple(trace)[:5])
    msys = spec if isinstance(spec, MemorySystemSpec) else None
    if msys is not None and msys.homogeneous:
        spec, msys = msys.groups[0].cspec, None
    n_channels = int(msys.n_channels if msys is not None
                     else getattr(spec, "n_channels", 1))
    want = 2 if n_channels == 1 else 3
    if cmd.ndim != want:
        raise ValueError(f"expected {want}-d trace arrays for a "
                         f"{n_channels}-channel system, got {cmd.shape}")
    idx = np.nonzero(cmd >= 0)              # row-major == issue order
    if n_channels == 1:
        t_idx, bus_idx = idx
        chan = np.zeros(len(t_idx), np.int64)
    else:
        t_idx, chan, bus_idx = idx
    ids = cmd[idx]
    group = None
    names = list(spec.cmd_names)
    if msys is not None:
        # group-local command ids -> the merged namespace, per event
        group = msys.chan_group[chan]
        lut = np.zeros((msys.n_groups, max(len(m) for m in
                                           msys.group_cmd_maps)), np.int64)
        for g, m in enumerate(msys.group_cmd_maps):
            lut[g, :len(m)] = m
        ids = lut[group, ids]
        names = list(msys.cmd_names)
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    return CommandTrace(
        clk=i32(t_idx), cmd=i32(ids), bank=i32(bank[idx]),
        row=i32(row[idx]), bus=i32(bus_idx), arrive=i32(arrive[idx]),
        hit_ready=i32(hit_ready[idx].astype(np.int32)), chan=i32(chan),
        n_cycles=int(cmd.shape[0]), cmd_names=names,
        group=None if group is None else i32(group))


def trace_sha256(tr: CommandTrace, fields=FIELDS) -> str:
    """sha256 over the int32 columns in ``fields`` order (:data:`FIELDS`,
    or ``FIELDS + ("group",)`` for a system's trace)."""
    h = hashlib.sha256()
    for f in fields:
        h.update(np.ascontiguousarray(getattr(tr, f), np.int32).tobytes())
    return h.hexdigest()


def _unflatten_banks(cspec: CompiledSpec, bank: np.ndarray,
                     width: int) -> np.ndarray:
    """Flat bank ids -> ``(N, width)`` sub-level indices (zero-padded)."""
    counts = cspec.level_counts
    b = bank.astype(np.int64)
    subs = []
    for i in range(len(counts) - 1, 0, -1):
        subs.append(b % int(counts[i]))
        b = b // int(counts[i])
    sub = np.stack(subs[::-1], axis=-1)
    if sub.shape[-1] < width:
        pad = np.zeros(sub.shape[:-1] + (width - sub.shape[-1],), np.int64)
        sub = np.concatenate([sub, pad], axis=-1)
    return sub


def _replay_deps(chan, bank, row, is_wr) -> np.ndarray:
    """Same-row RAW/WAR dependency index per request, -1 = none: a read
    depends on the latest earlier write to its (chan, bank, row), a write
    on the latest earlier read.  Producers precede their dependents in
    the arrival-ordered stream."""
    dep = np.full(len(chan), -1, np.int64)
    last_w: dict = {}
    last_r: dict = {}
    for k in range(len(chan)):
        key = (int(chan[k]), int(bank[k]), int(row[k]))
        if is_wr[k]:
            dep[k] = last_r.get(key, -1)
            last_w[key] = k
        else:
            dep[k] = last_w.get(key, -1)
            last_r[key] = k
    return dep


def to_replay(trace: CommandTrace, spec, *, deps: bool = False
              ) -> ReplayStream:
    """The replay stream of a captured trace's served requests (its final
    RD/WR commands with an arrival clock), in arrival order (a stable
    sort; issue order is the scheduler's), with their channel, sub-level
    indices (a system trace resolves each command through its group),
    row and captured ``arrive`` clocks, which then pace the replay.  With
    ``deps=True`` it also carries the same-row RAW/WAR dependencies
    (``ReplayStream.dep``).  ``spec`` (the ``CompiledSpec`` or
    ``MemorySystemSpec`` of the captured run) is required: the port's
    :class:`CommandTrace` carries no metadata to rebuild it from.  Feed
    the result to ``Simulator(..., frontend=FrontendConfig(
    pattern="trace"), replay=...)``."""
    msys = as_system(spec)
    if msys.n_groups == 1:
        fx = np.asarray(msys.groups[0].cspec.cmd_fx)[trace.cmd]
    else:
        # the trace's namespace is the merged one: resolve per group
        fx_lut = np.zeros((msys.n_groups, len(trace.cmd_names)), np.int64)
        for g, grp in enumerate(msys.groups):
            fx_lut[g, msys.group_cmd_maps[g]] = grp.cspec.cmd_fx
        fx = fx_lut[trace.group, trace.cmd]
    is_wr = (fx & S.FX_FINAL_WR) != 0
    sel = np.nonzero((((fx & S.FX_FINAL_RD) != 0) | is_wr)
                     & (trace.arrive >= 0))[0]
    if len(sel) == 0:
        raise ValueError("trace has no served column commands to replay")
    sel = sel[np.argsort(trace.arrive[sel], kind="stable")]
    width = max(len(g.cspec.levels) - 1 for g in msys.groups)
    if msys.n_groups == 1:
        sub = _unflatten_banks(msys.groups[0].cspec, trace.bank[sel], width)
    else:
        sub = np.zeros((len(sel), width), np.int64)
        gsel = trace.group[sel]
        for g, grp in enumerate(msys.groups):
            m = gsel == g
            if np.any(m):
                sub[m] = _unflatten_banks(grp.cspec, trace.bank[sel][m],
                                          width)
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    chan = i32(trace.chan[sel])
    row = i32(np.maximum(trace.row[sel], 0))
    dep = None
    if deps:
        dep = i32(_replay_deps(chan, trace.bank[sel], row, is_wr[sel]))
    return ReplayStream(
        chan=chan, sub=i32(sub), row=row,
        col=np.zeros(len(sel), np.int32), is_write=i32(is_wr[sel]),
        arrive=i32(trace.arrive[sel]), dep=dep)
