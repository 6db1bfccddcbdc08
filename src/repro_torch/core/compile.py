"""Spec "code generation": lower a Python DRAM spec to dense numpy tables.

The counterpart of ``repro.core.compile`` for the PyTorch port.  The
tables are plain numpy; the engine copies the ones it reads every cycle to
the run's device once (``repro_torch.core.device.dyn_params``):

  * a constraint table  (prev_cmd, next_cmd, level, latency, window)
  * per-command metadata vectors (kind, scope level, effect bitmask)
  * hierarchy-node indexing (flattened channel/rank/bankgroup/bank tree)
  * resolved timing preset (latency *expressions* -> cycles)

Memory systems compose ordered spec groups (``SpecGroup``, one
``CompiledSpec`` each, with a channel count and an optional CXL-style link
latency) behind one system address mapper: ``MemorySystemSpec``,
``compile_system`` and ``as_system``.  The compile-time spec-lint gate is
not ported yet.
"""
from __future__ import annotations

import dataclasses
import os
import re

import numpy as np

from repro_torch.core import spec as S

_TOKEN = re.compile(r"([+-]?)\s*([A-Za-z_][A-Za-z_0-9]*|\d+)")


def resolve_latency(expr, timings: dict, context: str = "") -> int:
    """Resolve a latency expression ("nCWL+nBL+nWR", "nBL+2", 7) to cycles.

    ``context`` (e.g. "DDR5 constraint ACT->RD@bank") is prepended to
    error messages so DSL-authored specs fail legibly."""
    if isinstance(expr, int):
        return expr
    where = f"{context}: " if context else ""
    total, matched = 0, 0
    for sign, tok in _TOKEN.findall(expr):
        matched += 1
        if tok.isdigit():
            val = int(tok)
        elif tok in timings:
            val = timings[tok]
        else:
            raise ValueError(
                f"{where}latency expression {expr!r} references unknown "
                f"timing parameter {tok!r} (known: {sorted(timings)})")
        total += -val if sign == "-" else val
    if matched == 0:
        raise ValueError(f"{where}bad latency expression {expr!r}")
    return total


@dataclasses.dataclass
class CompiledSpec:
    """Dense-table form of one (standard, org preset, timing preset).

    The node tables describe ONE channel; the engine's state tensors carry
    a leading channel axis of size ``n_channels``.
    """
    name: str
    levels: list                    # level names, levels[0] == "channel"
    level_counts: np.ndarray        # per-level fan-out within one channel
    level_offsets: np.ndarray       # node-index base per level
    num_nodes: int
    n_banks: int
    n_refresh_units: int            # ranks / pseudochannels
    rows: int
    columns: int

    cmd_names: list
    n_cmds: int
    cmd_kind: np.ndarray            # KIND_* per command
    cmd_scope: np.ndarray           # level index per command
    cmd_fx: np.ndarray              # FX_* bitmask per command

    # constraint table
    ct_prev: np.ndarray
    ct_next: np.ndarray
    ct_level: np.ndarray
    ct_lat: np.ndarray
    ct_win: np.ndarray
    max_window: int

    # windowed-ring sub-table (see build_windowed_rings)
    ring_pairs: list            # [(cmd, level, entry_offset, n_nodes), ...]
    ring_cmd: np.ndarray        # (R,) per-entry prev-command id
    ring_level: np.ndarray      # (R,) per-entry hierarchy level
    ring_node: np.ndarray       # (R,) per-entry global node id
    ct_ring: np.ndarray         # (C,) per-constraint ring entry base, -1=dense
    n_ring: int                 # total ring entries R (0: no windowed pairs)
    ring_depth: int             # max window among allocated pairs (>= 1)

    timings: dict                   # resolved preset (cycles)
    tCK_ps: int
    read_latency: int               # RD issue -> data completion
    access_bytes: int
    peak_bytes_per_cycle: float

    # feature flags + special command ids (-1 when absent)
    split_activation: bool
    data_clock_sync: bool
    dual_command_bus: bool
    id_ACT: int; id_ACT1: int; id_ACT2: int
    id_PRE: int; id_PREab: int; id_RD: int; id_WR: int; id_REFab: int
    id_CAS_RD: int; id_CAS_WR: int; id_RCKSTRT: int
    nAAD: int                       # ACT2 deadline (0 if n/a)
    clock_idle: int                 # WCK/RCK idle expiry (0 if n/a)

    # provenance
    standard: str = ""
    org_preset: str = ""
    timing_preset: str = ""
    n_channels: int = 1             # memory-system channel fan-out

    #: telemetry latency-histogram bucket edges (see plan_latency_buckets)
    lat_bucket_edges: tuple = ()

    def cmd_id(self, name: str) -> int:
        return self.cmd_names.index(name)

    def addr_strides(self) -> np.ndarray:
        """Strides to flatten per-level indices into a flat bank id."""
        counts = self.level_counts[1:]          # below channel
        strides = np.ones(len(counts), dtype=np.int64)
        for i in range(len(counts) - 2, -1, -1):
            strides[i] = strides[i + 1] * counts[i + 1]
        return strides


def build_windowed_rings(ct_prev, ct_level, ct_win, cmd_scope,
                         level_counts, level_offsets) -> dict:
    """Plan the compact windowed-ring layout for a constraint table.

    Only (prev_cmd, level) pairs referenced by a ``window > 1`` constraint
    — and reachable, i.e. ``level <= cmd_scope[prev_cmd]`` so the command
    actually stamps that level — get a deep issue-history ring.  Each pair
    owns one contiguous block of entries, one entry per level-``level``
    node.

    Returns the ``ring_*`` / ``ct_ring`` / ``n_ring`` / ``ring_depth``
    fields of :class:`CompiledSpec` as a dict.
    """
    node_counts = np.cumprod(np.asarray(level_counts, np.int64))
    pairs: dict = {}            # (cmd, level) -> [entry_offset, depth]
    n_ring = 0
    for i in range(len(ct_prev)):
        if int(ct_win[i]) <= 1:
            continue
        p, level = int(ct_prev[i]), int(ct_level[i])
        if level > int(cmd_scope[p]):
            continue            # the command never stamps this level
        key = (p, level)
        if key not in pairs:
            pairs[key] = [n_ring, int(ct_win[i])]
            n_ring += int(node_counts[level])
        else:
            pairs[key][1] = max(pairs[key][1], int(ct_win[i]))
    ring_depth = max((d for _, d in pairs.values()), default=1)

    ct_ring = np.full(len(ct_prev), -1, np.int32)
    for i in range(len(ct_prev)):
        key = (int(ct_prev[i]), int(ct_level[i]))
        if int(ct_win[i]) > 1 and key in pairs:
            ct_ring[i] = pairs[key][0]

    ring_cmd = np.zeros(n_ring, np.int32)
    ring_level = np.zeros(n_ring, np.int32)
    ring_node = np.zeros(n_ring, np.int32)
    ring_pairs = []
    for (p, level), (off, _depth) in sorted(pairs.items(),
                                            key=lambda kv: kv[1][0]):
        n_l = int(node_counts[level])
        ring_pairs.append((p, level, off, n_l))
        ring_cmd[off:off + n_l] = p
        ring_level[off:off + n_l] = level
        ring_node[off:off + n_l] = (int(level_offsets[level])
                                    + np.arange(n_l, dtype=np.int32))
    return dict(ring_pairs=ring_pairs, ring_cmd=ring_cmd,
                ring_level=ring_level, ring_node=ring_node, ct_ring=ct_ring,
                n_ring=int(n_ring), ring_depth=int(ring_depth))


#: Number of request-latency histogram buckets: len(lat_bucket_edges) + 1.
N_LAT_BUCKETS = 16

#: Bucket-edge multipliers over the spec's unloaded read latency.
_LAT_EDGE_MULTIPLIERS = (1.0, 1.25, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0,
                         12.0, 16.0, 24.0, 32.0, 48.0, 64.0, 96.0)


def plan_latency_buckets(read_latency: int) -> tuple:
    """Plan the ``N_LAT_BUCKETS``-bucket request-latency histogram edges
    for a spec with unloaded read latency ``read_latency`` cycles:
    ``N_LAT_BUCKETS - 1`` strictly increasing integer edges."""
    edges, prev = [], 0
    for m in _LAT_EDGE_MULTIPLIERS:
        e = max(int(round(m * max(read_latency, 1))) + 1, prev + 1)
        edges.append(e)
        prev = e
    return tuple(edges)


# --------------------------------------------------------------------------
# Memory-system composition: ordered spec groups behind one address mapper
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpecGroup:
    """One homogeneous slice of a memory system: ``channels`` identical
    channels of ``cspec``, optionally behind a CXL-style link that adds
    ``link_latency`` cycles in each direction (requests become visible to
    the group's controllers ``link_latency`` cycles after arrival, and
    read data needs another ``link_latency`` cycles to come back)."""
    cspec: CompiledSpec
    channels: int = 1
    link_latency: int = 0


class MemorySystemSpec:
    """An ordered list of :class:`SpecGroup`s composed behind one
    system-level address mapper.

    System channel ids are group-major: group 0 owns channels ``[0,
    groups[0].channels)``, group 1 the next block, and so on.  Each group
    keeps its own command namespace (its ``CompiledSpec``); the system
    also carries a merged ``cmd_names`` table (first-seen name order
    across groups) and per-group local->global id maps, so that traces and
    aggregate ``cmd_counts`` name commands uniformly.  The homogeneous
    ``Simulator(..., channels=N)`` path is the 1-group, zero-link case.
    """

    def __init__(self, groups):
        groups = tuple(groups)
        if not groups:
            raise ValueError("a memory system needs at least one spec group")
        for g in groups:
            if not isinstance(g, SpecGroup):
                raise TypeError(f"expected SpecGroup, got {type(g).__name__}")
            if g.channels < 1:
                raise ValueError(f"group channels must be >= 1, got "
                                 f"{g.channels}")
            if g.link_latency < 0:
                raise ValueError("link_latency must be >= 0")
            if g.cspec.n_channels != g.channels:
                raise ValueError(
                    f"group cspec compiled for {g.cspec.n_channels} "
                    f"channel(s) but the group declares {g.channels} — "
                    "compile the group spec with channels=<group channels> "
                    "(compile_system does this for you)")
        self.groups = groups
        self.n_groups = len(groups)
        self.n_channels = sum(g.channels for g in groups)
        #: first system channel id of each group
        self.chan_base = np.concatenate(
            [[0], np.cumsum([g.channels for g in groups])[:-1]]).astype(
                np.int64)
        #: owning group of each system channel, shape (n_channels,)
        self.chan_group = np.repeat(np.arange(self.n_groups, dtype=np.int64),
                                    [g.channels for g in groups])
        names: list = []
        maps = []
        for g in groups:
            local = []
            for n in g.cspec.cmd_names:
                if n not in names:
                    names.append(n)
                local.append(names.index(n))
            maps.append(np.asarray(local, np.int64))
        self.cmd_names = names
        self.n_cmds = len(names)
        #: per-group (n_cmds_g,) arrays mapping local command id -> merged id
        self.group_cmd_maps = tuple(maps)

    @property
    def homogeneous(self) -> bool:
        """True when the system is the plain multi-channel special case."""
        return self.n_groups == 1 and self.groups[0].link_latency == 0

    @property
    def tCK_ps(self) -> int:
        """Reference clock of the system: every group steps on one shared
        cycle index, read on group 0's clock."""
        return self.groups[0].cspec.tCK_ps

    def group_of_channel(self, chan: int) -> int:
        return int(self.chan_group[chan])

    @property
    def label(self) -> str:
        parts = []
        for g in self.groups:
            p = f"{g.cspec.standard or g.cspec.name}x{g.channels}"
            if g.link_latency:
                p += f"@{g.link_latency}"
            parts.append(p)
        return "+".join(parts)

    def __repr__(self):
        return f"MemorySystemSpec({self.label})"


def compile_system(groups) -> MemorySystemSpec:
    """Compile a memory system from group descriptors, each one of:

      * a mapping ``dict(standard=..., org_preset=..., timing_preset=...,
        timing_overrides=None, channels=1, link_latency=0)``;
      * a tuple ``(standard, org_preset, timing_preset[, channels
        [, link_latency]])``;
      * a :class:`SpecGroup` (used as is);
      * a :class:`CompiledSpec` (its ``n_channels`` channels, link 0).
    """
    out = []
    for g in groups:
        if isinstance(g, SpecGroup):
            out.append(g)
            continue
        if isinstance(g, CompiledSpec):
            out.append(SpecGroup(g, g.n_channels, 0))
            continue
        if isinstance(g, dict):
            d = dict(g)
            std = d.pop("standard")
            org = d.pop("org_preset")
            tim = d.pop("timing_preset")
            ov = d.pop("timing_overrides", None)
            ch = int(d.pop("channels", 1))
            ll = int(d.pop("link_latency", 0))
            if d:
                raise TypeError(f"unknown group descriptor keys {sorted(d)}")
        else:
            std, org, tim, *rest = g
            ch = int(rest[0]) if rest else 1
            ll = int(rest[1]) if len(rest) > 1 else 0
            ov = None
        out.append(SpecGroup(compile_spec(std, org, tim, ov, channels=ch),
                             ch, ll))
    return MemorySystemSpec(out)


def as_system(spec) -> MemorySystemSpec:
    """Coerce a CompiledSpec / MemorySystemSpec / descriptor list into a
    :class:`MemorySystemSpec` (a bare spec becomes the 1-group system)."""
    if isinstance(spec, MemorySystemSpec):
        return spec
    if isinstance(spec, CompiledSpec):
        return MemorySystemSpec((SpecGroup(spec, spec.n_channels, 0),))
    if isinstance(spec, (list, tuple)):
        return compile_system(spec)
    raise TypeError(f"cannot build a memory system from "
                    f"{type(spec).__name__}")


def compile_spec(standard, org_preset: str, timing_preset: str,
                 timing_overrides: dict | None = None,
                 channels: int = 1, lint: str | None = None) -> CompiledSpec:
    """Lower a standard to its dense-table form.

    ``lint`` keeps the reference's signature: ``None`` reads the
    ``REPRO_SPEC_LINT`` environment variable, ``"off"`` skips the pass.
    The spec linter itself is not ported, so ``"warn"`` and ``"error"``
    raise ``NotImplementedError`` instead of being ignored.
    """
    _check_lint_mode(lint)
    if isinstance(standard, str):
        standard = S.get_standard(standard)
    if channels < 1:
        raise ValueError(f"channels must be >= 1, got {channels}")
    org: S.Organization = standard.org_presets[org_preset]
    timings = dict(standard.timing_presets[timing_preset])
    if timing_overrides:
        unknown = (set(timing_overrides) - set(timings)
                   - set(standard.timing_params) - {"tCK_ps"})
        if unknown:
            valid = sorted(set(timings) | set(standard.timing_params)
                           | {"tCK_ps"})
            raise ValueError(
                f"{standard.name}: unknown timing_overrides key(s) "
                f"{sorted(unknown)} — overrides must name an existing "
                f"timing parameter (valid: {valid})")
        timings.update(timing_overrides)

    levels = list(standard.levels)
    counts = [1] + [org.counts[lv] for lv in levels[1:]]
    # cumulative node counts per level: channel=1, rank=R, bankgroup=R*BG, ...
    sizes, acc = [], 1
    for c in counts:
        acc *= c
        sizes.append(acc)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    num_nodes = int(np.sum(sizes))
    n_banks = sizes[-1]
    n_refresh_units = sizes[1] if len(sizes) > 1 else 1

    cmd_names = list(standard.commands)
    n_cmds = len(cmd_names)
    meta = standard.command_meta
    kind = np.array([meta[c].kind for c in cmd_names], dtype=np.int32)
    scope = np.array([levels.index(meta[c].scope) for c in cmd_names], dtype=np.int32)
    fx = np.array([meta[c].effects for c in cmd_names], dtype=np.int32)

    prev, nxt, lvl, lat, win = [], [], [], [], []
    for tc in standard.timing_constraints:
        latency = resolve_latency(
            tc.latency, timings,
            context=f"{standard.name} constraint "
                    f"{','.join(tc.preceding)}->{','.join(tc.following)}"
                    f"@{tc.level}")
        for p in tc.preceding:
            for f in tc.following:
                prev.append(cmd_names.index(p))
                nxt.append(cmd_names.index(f))
                lvl.append(levels.index(tc.level))
                lat.append(latency)
                win.append(tc.window)
    ct_prev = np.array(prev, dtype=np.int32)
    ct_next = np.array(nxt, dtype=np.int32)
    ct_level = np.array(lvl, dtype=np.int32)
    ct_lat = np.array(lat, dtype=np.int32)
    ct_win = np.array(win, dtype=np.int32)
    max_window = int(ct_win.max()) if len(win) else 1
    rings = build_windowed_rings(ct_prev, ct_level, ct_win, scope,
                                 counts, offsets)

    def cid(name):
        return cmd_names.index(name) if name in cmd_names else -1

    access_bytes = org.dq * standard.burst_beats // 8
    nBL = timings["nBL"]
    read_latency = timings["nCL"] + nBL

    return CompiledSpec(
        name=standard.name, levels=levels,
        level_counts=np.array(counts, dtype=np.int64),
        level_offsets=offsets, num_nodes=num_nodes, n_banks=n_banks,
        n_refresh_units=n_refresh_units, rows=org.rows, columns=org.columns,
        cmd_names=cmd_names, n_cmds=n_cmds, cmd_kind=kind, cmd_scope=scope,
        cmd_fx=fx, ct_prev=ct_prev, ct_next=ct_next, ct_level=ct_level,
        ct_lat=ct_lat, ct_win=ct_win, max_window=max_window, **rings,
        timings=timings, tCK_ps=timings["tCK_ps"], read_latency=read_latency,
        access_bytes=access_bytes,
        peak_bytes_per_cycle=access_bytes / nBL,
        split_activation=standard.split_activation,
        data_clock_sync=standard.data_clock_sync,
        dual_command_bus=standard.dual_command_bus,
        id_ACT=cid("ACT"), id_ACT1=cid("ACT1"), id_ACT2=cid("ACT2"),
        id_PRE=cid("PRE"), id_PREab=cid("PREab"), id_RD=cid("RD"),
        id_WR=cid("WR"), id_REFab=cid("REFab"), id_CAS_RD=cid("CAS_RD"),
        id_CAS_WR=cid("CAS_WR"), id_RCKSTRT=cid("RCKSTRT"),
        nAAD=timings.get("nAAD", 0),
        clock_idle=timings.get("nWCKIDLE", timings.get("nRCKIDLE", 0)),
        standard=standard.name, org_preset=org_preset,
        timing_preset=timing_preset, n_channels=int(channels),
        lat_bucket_edges=plan_latency_buckets(read_latency),
    )


def _check_lint_mode(lint: str | None):
    """The reference's compile-time lint gate, minus the linter: an armed
    gate raises rather than silently compiling unlinted."""
    mode = lint if lint is not None else os.environ.get(
        "REPRO_SPEC_LINT", "off")
    if mode in ("off", "", None):
        return
    if mode not in ("warn", "error"):
        raise ValueError(f"lint mode must be off|warn|error, got {mode!r}")
    raise NotImplementedError(
        f"compile_spec(lint={mode!r}): the spec linter (repro.analysis) is "
        "not ported to repro_torch yet — see ROADMAP.md queue 1")
