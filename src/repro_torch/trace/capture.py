"""Compact columnar command-trace capture for one homogeneous run.

The counterpart of the homogeneous path of ``repro.trace.capture``:
:func:`capture` compacts the dense ``[T, 2]`` (one channel) or ``[T, C,
2]`` (``C`` channels) arrays of ``Simulator.run(..., trace=True)`` into
one int32 column per field, one entry per issued command, in issue order
(cycle-major, then channel, column bus before row bus).
:func:`trace_sha256` digests the columns in :data:`FIELDS` order — the
digest ``tests/trace/golden_hashes.json`` pins.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

#: Columnar int32 fields of a CommandTrace, in digest order.
FIELDS = ("clk", "cmd", "bank", "row", "bus", "arrive", "hit_ready", "chan")


@dataclasses.dataclass
class CommandTrace:
    """Columnar DRAM command trace: one row per issued command (all
    columns ``(N,)`` int32 numpy arrays)."""
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

    def __len__(self) -> int:
        return int(self.clk.shape[0])


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def capture(cspec, trace) -> CommandTrace:
    """Compact a dense trace (``TraceArrays`` of ``[T, 2]`` tensors or
    arrays for one channel, ``[T, C, 2]`` for ``C`` channels) into a
    :class:`CommandTrace`."""
    cmd, bank, row, arrive, hit_ready = (_host(a) for a in tuple(trace)[:5])
    n_channels = int(getattr(cspec, "n_channels", 1))
    want = 2 if n_channels == 1 else 3
    if cmd.ndim != want:
        raise ValueError(f"expected {want}-d trace arrays for a "
                         f"{n_channels}-channel spec, got {cmd.shape}")
    idx = np.nonzero(cmd >= 0)              # row-major == issue order
    if n_channels == 1:
        t_idx, bus_idx = idx
        chan = np.zeros(len(t_idx), np.int32)
    else:
        t_idx, chan, bus_idx = idx
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    return CommandTrace(
        clk=i32(t_idx), cmd=i32(cmd[idx]), bank=i32(bank[idx]),
        row=i32(row[idx]), bus=i32(bus_idx), arrive=i32(arrive[idx]),
        hit_ready=i32(hit_ready[idx].astype(np.int32)), chan=i32(chan),
        n_cycles=int(cmd.shape[0]), cmd_names=list(cspec.cmd_names))


def trace_sha256(tr: CommandTrace) -> str:
    """sha256 over the int32 columns in :data:`FIELDS` order."""
    h = hashlib.sha256()
    for f in FIELDS:
        h.update(np.ascontiguousarray(getattr(tr, f), np.int32).tobytes())
    return h.hexdigest()
