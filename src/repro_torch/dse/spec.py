"""Declarative design-space-exploration sweep specifications (the port's
copy of ``repro.dse.spec``).

A `SweepSpec` names the axes of a Ramulator-style DSE campaign — DRAM
systems (standard x org preset x timing preset, optionally with timing
overrides, or heterogeneous compositions), controller configurations,
channel counts, mapper orders, and the load grid (streaming intervals x
read ratios) — and `expand()`s them into the cartesian list of concrete
`RunPoint`s.

The spec layer is plain Python bookkeeping.  The executor
(`repro_torch.dse.executor`) groups the expanded points by *compile
group* — everything that changes the run — and runs each group as one
cached batched run on the card.
"""
from __future__ import annotations

import dataclasses
import itertools

from repro_torch.core import controller as C
from repro_torch.core import frontend as F
from repro_torch.core.standards import DEFAULT_SYSTEMS

__all__ = ["DEFAULT_SYSTEMS", "System", "system", "SystemGroup",
           "Composition", "RunPoint", "SweepSpec"]


@dataclasses.dataclass(frozen=True)
class System:
    """One DRAM system under test: a (standard, org, timing) triple plus
    optional timing overrides (stored frozen so the system is hashable)."""
    standard: str
    org_preset: str
    timing_preset: str
    timing_overrides: tuple = ()    # sorted (name, cycles) pairs

    def __post_init__(self):
        # normalize every construction path (dict, unsorted tuple, list of
        # pairs) to sorted tuples so equal overrides compare/hash equal and
        # never split a compile group or a curve
        ov = self.timing_overrides
        ov = ov.items() if isinstance(ov, dict) else (ov or ())
        object.__setattr__(self, "timing_overrides",
                           tuple(sorted(tuple(kv) for kv in ov)))

    @property
    def overrides_dict(self) -> dict | None:
        return dict(self.timing_overrides) if self.timing_overrides else None

    @property
    def label(self) -> str:
        return self.standard

    @classmethod
    def make(cls, spec) -> "System":
        """Coerce a System, a standard name, or a 3/4-tuple into a System."""
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            return system(spec)
        std, org, tim, *rest = spec
        return cls(std, org, tim, rest[0] if rest else ())


def system(standard: str, timing_overrides: dict | None = None) -> System:
    """Build a `System` from a standard name using `DEFAULT_SYSTEMS`."""
    if standard not in DEFAULT_SYSTEMS:
        raise KeyError(f"no default org/timing for {standard!r}; "
                       f"known: {sorted(DEFAULT_SYSTEMS)}")
    org, tim = DEFAULT_SYSTEMS[standard]
    return System(standard, org, tim, timing_overrides or ())


@dataclasses.dataclass(frozen=True)
class SystemGroup:
    """One spec group of a heterogeneous composition: a `System` fanned
    out over `channels` identical channels, optionally behind a CXL-style
    link adding `link_latency` cycles each way."""
    system: System
    channels: int = 1
    link_latency: int = 0

    def __post_init__(self):
        object.__setattr__(self, "system", System.make(self.system))

    @property
    def label(self) -> str:
        lbl = f"{self.system.label}x{self.channels}"
        if self.link_latency:
            lbl += f"@{self.link_latency}"
        return lbl


@dataclasses.dataclass(frozen=True)
class Composition:
    """A heterogeneous memory system as a first-class sweep axis: an
    ordered tuple of :class:`SystemGroup`s (e.g. DDR5 channels plus
    CXL-attached DDR4 channels behind one mapper).  Compositions go into
    ``SweepSpec.systems`` alongside plain systems; each composition is
    its own compile group.  Entries coerce from `SystemGroup`, a
    ``(standard_or_system, channels[, link_latency])`` tuple, or a bare
    standard name / `System` (one channel, no link).

    >>> Composition((("DDR5", 2), ("DDR4", 2, 80))).label
    'DDR5x2+DDR4x2@80'
    """
    groups: tuple

    def __post_init__(self):
        out = []
        for g in self.groups:
            if isinstance(g, SystemGroup):
                out.append(g)
            elif isinstance(g, (str, System)):
                out.append(SystemGroup(System.make(g)))
            else:
                sy, *rest = g
                out.append(SystemGroup(
                    System.make(sy),
                    int(rest[0]) if rest else 1,
                    int(rest[1]) if len(rest) > 1 else 0))
        if not out:
            raise ValueError("Composition needs at least one group")
        object.__setattr__(self, "groups", tuple(out))

    @property
    def n_channels(self) -> int:
        return sum(g.channels for g in self.groups)

    @property
    def label(self) -> str:
        return "+".join(g.label for g in self.groups)

    @property
    def standard(self) -> str:      # mirror of System.standard for tables
        return self.label


@dataclasses.dataclass(frozen=True)
class RunPoint:
    """One concrete simulation: a system (plain `System` or heterogeneous
    `Composition`) + controller + channel/mapper configuration + one load
    point.  The mapper order rides inside ``frontend.mapper``; for a
    composition ``n_channels`` is the system-wide channel total."""
    system: object                  # System | Composition
    controller: C.ControllerConfig
    frontend: F.FrontendConfig
    n_cycles: int
    interval: float
    read_ratio: float
    n_channels: int = 1

    @property
    def mapper(self) -> str:
        return self.frontend.mapper

    @property
    def label(self) -> str:
        ch = f" {self.n_channels}ch" if self.n_channels != 1 else ""
        return (f"{self.system.label}{ch} {self.controller.scheduler} "
                f"i={self.interval:g} r={self.read_ratio:g}")


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Declarative sweep: systems x controllers x channels x mappers x
    intervals x read ratios.

    `systems` entries may be `System` objects, bare standard names (resolved
    via `DEFAULT_SYSTEMS`), (standard, org, timing[, overrides]) tuples, or
    heterogeneous `Composition`s (e.g. DDR5:CXL-DDR4 ratios / link
    latencies as first-class sweep entries).  ``channels`` sweeps the
    memory-system channel count of the PLAIN systems (compositions carry
    their own per-group fan-out and ignore the axis) and ``mappers`` the
    address-mapper order (see ``repro_torch.core.addrmap.MAPPERS``) — all
    of these are compile-group axes: each combination is its own cached
    run, with the whole load grid as its design points.

    >>> spec = SweepSpec(systems=("DDR4", "DDR5"),
    ...                  intervals=(16.0, 4.0, 1.0), read_ratios=(1.0, 0.5))
    >>> len(spec.expand())      # 2 * 1 * 1 * 1 * 3 * 2
    12
    >>> hetero = SweepSpec(
    ...     systems=(Composition((("DDR5", 2), ("DDR4", 2, 80))),
    ...              Composition((("DDR5", 2), ("DDR4", 2, 160)))),
    ...     intervals=(4.0, 1.0))        # link latency as a sweep axis
    """
    systems: tuple
    intervals: tuple = (64.0, 16.0, 8.0, 4.0, 2.0, 1.0)
    read_ratios: tuple = (1.0,)
    controllers: tuple = None   # defaults to (ControllerConfig(),)
    channels: tuple = (1,)
    mappers: tuple = None       # defaults to (frontend.mapper,)
    frontend: F.FrontendConfig = dataclasses.field(
        default_factory=F.FrontendConfig)
    n_cycles: int = 20_000
    seed: int = 0x1234
    #: Capture a per-point command trace (``repro_torch.trace.
    #: CommandTrace``).  ``True`` keeps traces in memory on
    #: ``SweepResult.traces``; a string is a directory to also persist one
    #: ``.npz`` trace artifact per point.  Each compile group then runs
    #: its points one at a time through its trace-recording run — still
    #: one cached run per group, so ``engine.TRACE_COUNT`` grows exactly
    #: as in a no-capture sweep.
    capture_traces: bool | str = False
    #: Windowed-telemetry window in cycles (0 = off).  Each compile group
    #: then runs its telemetry-recording run (one per group, the same
    #: TRACE_COUNT accounting as capture_traces) and every point gains a
    #: ``repro_torch.telemetry.Telemetry`` on ``SweepResult.telemetry``.
    telemetry: int = 0
    #: Directory to persist one telemetry ``.npz`` artifact per point
    #: (paths land in ``meta["telemetry_artifacts"]``); needs
    #: ``telemetry > 0``.
    telemetry_dir: str | None = None
    #: Run the spec linter (``repro_torch.analysis``) over every distinct
    #: override-carrying system before any compile group runs, so an
    #: invalid design-space corner (``tRC < tRAS + tRP``, an unschedulable
    #: refresh, a typo'd override key) fails fast with a structured
    #: ``LintReport`` instead of producing a silently-wrong curve.  Set
    #: False to opt out (e.g. when deliberately sweeping through
    #: rule-violating corners to map the cliff).
    lint_specs: bool = True

    def __post_init__(self):
        object.__setattr__(self, "systems",
                           tuple(s if isinstance(s, Composition)
                                 else System.make(s) for s in self.systems))
        object.__setattr__(self, "intervals",
                           tuple(float(i) for i in self.intervals))
        object.__setattr__(self, "read_ratios",
                           tuple(float(r) for r in self.read_ratios))
        ctrls = self.controllers
        if ctrls is None:
            ctrls = (C.ControllerConfig(),)
        elif isinstance(ctrls, C.ControllerConfig):
            ctrls = (ctrls,)
        object.__setattr__(self, "controllers", tuple(ctrls))
        chans = self.channels
        if isinstance(chans, int):
            chans = (chans,)
        object.__setattr__(self, "channels", tuple(int(c) for c in chans))
        maps = self.mappers
        if maps is None:
            maps = (self.frontend.mapper,)
        elif isinstance(maps, str):
            maps = (maps,)
        object.__setattr__(self, "mappers", tuple(maps))
        if not self.systems:
            raise ValueError("SweepSpec needs at least one system")
        if not self.channels or any(c < 1 for c in self.channels):
            raise ValueError("SweepSpec needs channel counts >= 1")
        if not self.intervals or not self.read_ratios:
            raise ValueError("SweepSpec needs a non-empty load grid")
        if self.telemetry < 0:
            raise ValueError("telemetry window must be >= 0 cycles")
        if self.telemetry_dir and not self.telemetry:
            raise ValueError("telemetry_dir needs telemetry=W > 0")

    @property
    def grid_shape(self) -> tuple:
        """(n_systems, n_controllers, n_channels, n_mappers, n_intervals,
        n_read_ratios)."""
        return (len(self.systems), len(self.controllers),
                len(self.channels), len(self.mappers),
                len(self.intervals), len(self.read_ratios))

    @property
    def n_points(self) -> int:
        return len(self.expand())

    def expand(self) -> list:
        """The full cartesian grid, in (system, controller, channels,
        mapper, interval, read_ratio) row-major order — the executor
        relies on the load points of one compile group being contiguous.
        Compositions fix their own channel fan-out, so they expand once
        per (controller, mapper, load point) regardless of the
        ``channels`` axis."""
        out = []
        for sy, ct, nc, mp, iv, rr in itertools.product(
                self.systems, self.controllers, self.channels,
                self.mappers, self.intervals, self.read_ratios):
            if isinstance(sy, Composition):
                if nc != self.channels[0]:
                    continue        # the channels axis is a no-op here
                nc = sy.n_channels
            out.append(RunPoint(
                system=sy, controller=ct,
                frontend=dataclasses.replace(self.frontend, mapper=mp),
                n_cycles=self.n_cycles, interval=iv, read_ratio=rr,
                n_channels=nc))
        return out
