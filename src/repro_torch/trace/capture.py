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

from repro_torch.core.compile import MemorySystemSpec

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
