"""Compact columnar command-trace capture.

The counterpart of ``repro.trace.capture``: :func:`capture` compacts the
dense ``[T, 2]`` (one channel) or ``[T, C, 2]`` (``C`` channels) arrays
of ``Simulator.run(..., trace=True)`` into one int32 column per field,
one entry per issued command, in issue order (cycle-major, then channel,
column bus before row bus).  For a memory system of several spec groups
(or one group behind a link) the engine's group-local command ids are
resolved into the system's merged ``cmd_names`` and a ``group`` column is
attached.  Every capture embeds the reference's metadata block
(:func:`base_meta`: preset names, the resolved timing table, the spec
fingerprint and the run configuration), so an artifact of either package
re-audits against its spec.  :func:`trace_sha256` digests the columns in
:data:`FIELDS` order — the digest ``tests/trace/golden_hashes.json`` pins
(the hetero system's over ``FIELDS + ("group",)``).
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.core import engine as E
from repro_torch.core import spec as S
from repro_torch.core.compile import (CompiledSpec, MemorySystemSpec,
                                      as_system, compile_spec,
                                      compile_system)
from repro_torch.core.frontend import ReplayStream

#: Columnar int32 fields of a CommandTrace, in digest order (the ``group``
#: column is digested only when asked for, as the reference's v3 format).
FIELDS = ("clk", "cmd", "bank", "row", "bus", "arrive", "hit_ready", "chan")


def spec_fingerprint_hex(spec) -> str:
    """Stable hex digest of a compiled spec's or memory system's identity
    (``engine.system_fingerprint``): the reference's digest, so a 1-group
    zero-link system digests as its bare spec."""
    return hashlib.sha256(
        repr(E.system_fingerprint(spec)).encode()).hexdigest()[:16]


@dataclasses.dataclass
class CommandTrace:
    """Columnar DRAM command trace: one row per issued command (all
    columns ``(N,)`` int32 numpy arrays; ``group`` is all zero for a
    homogeneous run).  ``meta`` is the :func:`base_meta` block: spec
    provenance, resolved timings, fingerprint and run configuration."""
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
    meta: dict = dataclasses.field(default_factory=dict)
    group: np.ndarray | None = None

    def __post_init__(self):
        if self.chan is None:
            self.chan = np.zeros_like(np.asarray(self.clk, np.int32))
        if self.group is None:
            self.group = np.zeros_like(np.asarray(self.clk, np.int32))

    def __len__(self) -> int:
        return int(self.clk.shape[0])

    @property
    def n_channels(self) -> int:
        return int(self.meta.get("n_channels", 1))

    @property
    def n_groups(self) -> int:
        return len(self.meta.get("system", ())) or 1

    @property
    def fingerprint(self) -> str:
        return self.meta.get("fingerprint", "")

    def cmd_count(self, name: str) -> int:
        if name not in self.cmd_names:
            return 0
        return int(np.count_nonzero(self.cmd == self.cmd_names.index(name)))

    def compiled_spec(self) -> CompiledSpec:
        """Recompile the spec this trace was captured from (the stored
        timing table replayed as overrides, the geometry edits replayed),
        fingerprint-checked.  A system of several groups has no single
        spec: use :meth:`compiled_system`."""
        if self.n_groups > 1:
            raise ValueError(
                "this trace was captured from a heterogeneous memory "
                "system — use compiled_system()")
        if "system" in self.meta:
            return self.compiled_system().groups[0].cspec
        m = self.meta
        cspec = compile_spec(m["standard"], m["org_preset"],
                             m["timing_preset"],
                             {k: int(v) for k, v in m["timings"].items()},
                             channels=int(m.get("n_channels", 1)))
        cspec.rows = int(m.get("rows", cspec.rows))
        cspec.columns = int(m.get("columns", cspec.columns))
        got = spec_fingerprint_hex(cspec)
        if m.get("fingerprint") and got != m["fingerprint"]:
            raise ValueError(
                f"recompiled spec fingerprint {got} != captured "
                f"{m['fingerprint']} — standard definition changed since "
                "capture")
        return cspec

    def compiled_system(self) -> MemorySystemSpec:
        """Recompile the (possibly heterogeneous) memory system this trace
        was captured from, fingerprint-checked."""
        if "system" not in self.meta:
            return as_system(self.compiled_spec())
        msys = system_from_meta(self.meta)
        got = spec_fingerprint_hex(msys)
        if self.fingerprint and got != self.fingerprint:
            raise ValueError(
                f"recompiled system fingerprint {got} != captured "
                f"{self.fingerprint} — a standard definition changed "
                "since capture")
        return msys


def config_doc(cfg) -> dict:
    """JSON-representable scalar fields of a config dataclass (callables
    such as ``extra_predicates`` are dropped): the one serialization rule
    of run configs, shared with ``repro_torch.dse.results``."""
    if cfg is None:
        return {}
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, (int, float, str, bool)) or v is None:
            out[f.name] = v
    return out


def system_from_meta(meta: dict) -> MemorySystemSpec:
    """Rebuild a memory system from a capture's ``meta["system"]`` block,
    the geometry edits (rows, columns) replayed per group."""
    msys = compile_system([
        dict(standard=g["standard"], org_preset=g["org_preset"],
             timing_preset=g["timing_preset"],
             timing_overrides={k: int(v) for k, v in g["timings"].items()},
             channels=int(g["channels"]),
             link_latency=int(g.get("link_latency", 0)))
        for g in meta["system"]])
    for g, doc in zip(msys.groups, meta["system"]):
        g.cspec.rows = int(doc.get("rows", g.cspec.rows))
        g.cspec.columns = int(doc.get("columns", g.cspec.columns))
    return msys


def _group_doc(cspec: CompiledSpec, channels: int, link_latency: int) -> dict:
    return {
        "standard": cspec.standard or cspec.name,
        "org_preset": cspec.org_preset,
        "timing_preset": cspec.timing_preset,
        "timings": {k: int(v) for k, v in cspec.timings.items()},
        "rows": int(cspec.rows),
        "columns": int(cspec.columns),
        "tCK_ps": int(cspec.tCK_ps),
        "n_banks": int(cspec.n_banks),
        "channels": int(channels),
        "link_latency": int(link_latency),
        "dual_command_bus": bool(cspec.dual_command_bus),
    }


def base_meta(spec, controller=None, frontend=None, **extra) -> dict:
    """The metadata block of every capture (the reference's): provenance,
    resolved timings, fingerprint and the optional run configuration.  A
    system of several groups, or one behind a link, has one block per
    group under ``"system"``; a plain spec the flat block."""
    if isinstance(spec, MemorySystemSpec) and not spec.homogeneous:
        meta = {
            "system": [_group_doc(g.cspec, g.channels, g.link_latency)
                       for g in spec.groups],
            "fingerprint": spec_fingerprint_hex(spec),
            "n_channels": int(spec.n_channels),
            "n_groups": int(spec.n_groups),
        }
    else:
        if isinstance(spec, MemorySystemSpec):
            spec = spec.groups[0].cspec
        cspec = spec
        meta = {
            "standard": cspec.standard or cspec.name,
            "org_preset": cspec.org_preset,
            "timing_preset": cspec.timing_preset,
            "timings": {k: int(v) for k, v in cspec.timings.items()},
            "fingerprint": spec_fingerprint_hex(cspec),
            "rows": int(cspec.rows),
            "columns": int(cspec.columns),
            "tCK_ps": int(cspec.tCK_ps),
            "n_banks": int(cspec.n_banks),
            "n_channels": int(cspec.n_channels),
            "dual_command_bus": bool(cspec.dual_command_bus),
        }
    if controller is not None:
        meta["controller"] = config_doc(controller)
    if frontend is not None:
        meta["frontend"] = config_doc(frontend)
    meta.update({k: v for k, v in extra.items() if v is not None})
    return meta


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def capture(spec, trace, *, point: int | None = None, controller=None,
            frontend=None, **extra_meta) -> CommandTrace:
    """Compact a dense trace (``TraceArrays`` of ``[T, 2]`` tensors or
    arrays for one channel, ``[T, C, 2]`` for ``C`` channels) of a run of
    ``spec`` (a ``CompiledSpec`` or a ``MemorySystemSpec``) into a
    :class:`CommandTrace`.  Arrays with a leading batch axis (the
    reference's batched sweeps) need ``point=j``.  ``controller``,
    ``frontend`` and ``extra_meta`` go into the metadata
    (:func:`base_meta`)."""
    cmd, bank, row, arrive, hit_ready = (_host(a) for a in tuple(trace)[:5])
    msys = spec if isinstance(spec, MemorySystemSpec) else None
    if msys is not None and msys.homogeneous:
        spec, msys = msys.groups[0].cspec, None
    n_channels = int(msys.n_channels if msys is not None
                     else getattr(spec, "n_channels", 1))
    want = 2 if n_channels == 1 else 3
    if cmd.ndim == want + 1:
        if point is None:
            raise ValueError(f"batched {cmd.shape} trace: pass "
                             "point=<batch index>")
        cmd, bank, row, arrive, hit_ready = (
            a[point] for a in (cmd, bank, row, arrive, hit_ready))
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
        meta=base_meta(spec if msys is None else msys,
                       controller=controller, frontend=frontend,
                       **extra_meta),
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


def to_replay(trace: CommandTrace, spec=None, *, deps: bool = False
              ) -> ReplayStream:
    """The replay stream of a captured trace's served requests (its final
    RD/WR commands with an arrival clock), in arrival order (a stable
    sort; issue order is the scheduler's), with their channel, sub-level
    indices (a system trace resolves each command through its group),
    row and captured ``arrive`` clocks, which then pace the replay.  With
    ``deps=True`` it also carries the same-row RAW/WAR dependencies
    (``ReplayStream.dep``).  ``spec`` (the ``CompiledSpec`` or
    ``MemorySystemSpec`` of the captured run) defaults to the one the
    trace's metadata rebuilds (:meth:`CommandTrace.compiled_system`).
    Feed the result to ``Simulator(..., frontend=FrontendConfig(
    pattern="trace"), replay=...)``."""
    msys = trace.compiled_system() if spec is None else as_system(spec)
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
