"""Traffic-generator frontend for one spec: streaming + serialized probes.

The counterpart of ``repro.core.frontend``:

  1. *streaming* requests at a configurable inter-arrival interval with a
     configurable read ratio, addressed by a ``sequential`` linear counter
     decoded through the mapper layout or by ``random`` draws;
  2. *serialized random-access probes*: a probe is only issued after the
     previous probe's data returned;
  3. *trace replay* (``pattern="trace"``): the pre-decoded request columns
     of a :class:`ReplayStream`, taken in order (wrapping around), at the
     streaming pace or at the captured arrival clocks, with optional
     read-after-write / write-after-read holds.

The frontend state is a :class:`FrontState` of tensors on the run's
device: 0-d for one run, ``(P,)`` for a batch of ``P`` design points
(load points), each point with its own clock, parameters and rng; every
function here works on either shape.  The reference's uint32 LCG is
carried in int64, masked to 32 bits after every step (PyTorch has no
uint32 add on the CPU).  A cycle's draws are unconditional and fixed in
number (:func:`rng_draws_per_cycle`), so they are computed together as
affine images of the cycle's starting state — the same values as drawing
them one after another with :func:`_lcg`.

A memory system of several spec groups decodes its requests through the
system channel digit (:func:`system_frontend_insert`, the reference's
``system_frontend_insert``): the channel first, then every group's own
fields from the rest, and the request goes to the one (group, channel)
that owns the system channel.  A 1-group system takes the single-spec
path unchanged.  A replay stream's columns go to the run's device once
(:func:`replay_tables`); each cycle gathers every point's next request by
``seq % n``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import controller as C
from repro_torch.core.addrmap import (AddressMapper, SystemAddressMapper,
                                      make_layout, make_system_layout)
from repro_torch.core.compile import CompiledSpec, MemorySystemSpec

I32 = torch.int32
MASK32 = 0xFFFFFFFF
LCG_A, LCG_C = 1664525, 1013904223


class FrontParams(NamedTuple):
    """Load knobs (fixed-point by 256): Python ints for one run
    (:meth:`FrontendConfig.params`), ``(P,)`` int32 tensors for a batch of
    load points (:func:`stack_params`)."""
    interval_fp: int            # inter-arrival interval in cycles * 256
    read_ratio_fp: int          # P(read) * 256
    probe_gap: int              # idle cycles between probes


class FrontState(NamedTuple):
    accum_fp: torch.Tensor        # int32 arrival accumulator (x256)
    rng: torch.Tensor             # int64 holding the uint32 LCG state
    seq: torch.Tensor             # int32 linear request counter
    probe_busy: torch.Tensor      # bool — a probe is in flight
    probe_next: torch.Tensor      # int32 earliest clock for the next probe
    sent: torch.Tensor            # int32 streaming requests injected
    dropped_backpressure: torch.Tensor
    served: torch.Tensor          # int32 non-probe requests served
    #                               (the replay dependency hold reads it)


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    interval: float = 4.0        # cycles between streaming arrivals
    read_ratio: float = 1.0
    probe_gap: int = 16
    probes: bool = True
    stream: bool = True
    #: streaming address pattern: ``sequential`` (linear counter decoded
    #: through ``mapper``), ``random``, or ``trace`` (replay the
    #: :class:`ReplayStream` given to the engine)
    pattern: str = "sequential"
    #: address-mapper order (see ``repro_torch.core.addrmap.MAPPERS``)
    mapper: str = "RoCoBaRaCh"
    max_backlog_fp: int = 256 * 64   # accumulator cap: ≤64 queued arrivals

    def __post_init__(self):
        if self.pattern not in ("sequential", "random", "trace"):
            raise ValueError(f"unknown pattern {self.pattern!r}")

    def params(self) -> FrontParams:
        return FrontParams(
            interval_fp=max(int(self.interval * 256), 1),
            read_ratio_fp=int(self.read_ratio * 256),
            probe_gap=int(self.probe_gap))


def stack_params(load_points, probe_gap: int, device) -> FrontParams:
    """Stack ``(interval, read_ratio)`` pairs into batched ``FrontParams``
    of ``(P,)`` int32 tensors on ``device``, with the x256 fixed-point
    encoding of :meth:`FrontendConfig.params` (the reference's
    ``stack_params``)."""
    i32 = lambda v: torch.tensor(v, dtype=I32, device=device)
    return FrontParams(
        interval_fp=i32([max(int(i * 256), 1) for i, _ in load_points]),
        read_ratio_fp=i32([int(r * 256) for _, r in load_points]),
        probe_gap=i32([int(probe_gap)] * len(load_points)))


class FrontDraft(NamedTuple):
    """One cycle's frontend-insert outcome, before the accept flags fold
    back into :class:`FrontState`."""
    rng: torch.Tensor     # LCG state after this cycle's draws
    accum: torch.Tensor   # accumulator after refill/clamp
    want: torch.Tensor    # bool — a stream insert was attempted
    okp: torch.Tensor     # int32 — accepted probes (0/1)
    ok: torch.Tensor      # int32 — accepted stream requests (0/1)


class FrontTables(NamedTuple):
    """Per-run device constants of the frontend: the mapper layout's
    radices, the affine coefficients of the cycle's LCG draws, and the
    permutation from layout order to ``(channel, sub-levels..., row,
    col)``."""
    layout: list                  # [(field, count)] LSB-first
    counts: torch.Tensor          # (n,) int64 field radices
    strides: torch.Tensor         # (n,) int64 mixed-radix place values
    perm: torch.Tensor            # (n,) int64 layout -> packed field order
    draw_a_lo: torch.Tensor       # (K,) int64 low 16 bits of lcg^k's a
    draw_a_hi: torch.Tensor       # (K,) int64 high 16 bits
    draw_c: torch.Tensor          # (K,) int64 lcg^k's c
    chan_ids: torch.Tensor        # (channels,) int32


def _i64(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int64), device=device)


def _decode_tables(layout, order, device) -> tuple:
    """``(counts, strides, perm)`` of a layout: its radices, mixed-radix
    place values and the permutation to the field ``order``."""
    names = [n for n, _ in layout]
    counts = np.asarray([c for _, c in layout], np.int64)
    return (_i64(counts, device),
            _i64(np.concatenate([[1], np.cumprod(counts)[:-1]]), device),
            _i64([names.index(n) for n in order], device))


def _draw_tables(k: int, device) -> tuple:
    """``(a_lo, a_hi, c)`` of ``lcg^1 .. lcg^k``: the affine maps of a
    cycle's ``k`` draws, ``a`` split in 16-bit halves for :func:`_mul32`."""
    a = np.asarray([lcg_affine(i)[0] for i in range(1, k + 1)], np.int64)
    c = np.asarray([lcg_affine(i)[1] for i in range(1, k + 1)], np.int64)
    return _i64(a & 0xFFFF, device), _i64(a >> 16, device), _i64(c, device)


def front_tables(cspec: CompiledSpec, cfg: FrontendConfig, channels: int,
                 device) -> FrontTables:
    layout = make_layout(cspec, cfg.mapper)
    order = ["channel"] + list(cspec.levels[1:]) + ["row", "col"]
    return FrontTables(
        layout, *_decode_tables(layout, order, device),
        *_draw_tables(rng_draws_per_cycle(cfg, ("single", layout)), device),
        chan_ids=torch.arange(channels, dtype=I32, device=device))


def init_front(seed: int = 0x1234, device="cpu",
               points: int | None = None) -> FrontState:
    """The reset frontend state: 0-d leaves, or ``(points,)`` leaves of
    ``points`` runs that share the seed."""
    shape = () if points is None else (points,)
    z = lambda: torch.zeros(shape, dtype=I32, device=device)
    return FrontState(accum_fp=z(),
                      rng=torch.full(shape, (seed | 1) & MASK32,
                                     dtype=torch.int64, device=device),
                      seq=z(), probe_busy=torch.zeros(shape, dtype=torch.bool,
                                                      device=device),
                      probe_next=z(), sent=z(), dropped_backpressure=z(),
                      served=z())


# --------------------------------------------------------------------------
# Trace-driven replay source
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class ReplayStream:
    """Pre-decoded replay request columns (the reference's
    ``ReplayStream``): host numpy int32 arrays of equal length ``N`` —
    target ``chan``, per-channel ``sub`` level indices ``(N, L-1)``,
    ``row``, ``col`` and ``is_write``.  For a memory system of several
    spec groups ``chan`` is the system channel and ``sub`` is padded to
    the widest group's sub-level count.  ``arrive`` (optional) holds each
    request's captured arrival clock: replay then injects request ``k`` at
    its arrival rebased to the stream start (a wrapped lap repeats the
    pattern shifted by the span plus the mean gap) instead of at the
    streaming interval.  ``dep`` (optional) holds a same-row producer
    index per request (-1 = none): such a request waits until every
    earlier stream request has been served.  ``fingerprint`` is the
    reference's digest of the columns (``arrive`` and ``dep`` included
    when present), so both packages fingerprint one stream alike."""
    chan: np.ndarray
    sub: np.ndarray
    row: np.ndarray
    col: np.ndarray
    is_write: np.ndarray
    arrive: np.ndarray | None = None
    fingerprint: str = ""
    dep: np.ndarray | None = None

    def __post_init__(self):
        if not self.fingerprint:
            h = hashlib.sha256()
            cols = (self.chan, self.sub, self.row, self.col, self.is_write)
            if self.arrive is not None:
                cols = cols + (self.arrive,)
            if self.dep is not None:
                cols = cols + (self.dep,)
            for a in cols:
                h.update(np.ascontiguousarray(a, np.int32).tobytes())
            object.__setattr__(self, "fingerprint", h.hexdigest()[:16])

    def __len__(self) -> int:
        return int(self.chan.shape[0])

    @classmethod
    def from_addresses(cls, spec, addrs, is_write=None,
                       order: str = "RoBaRaCoCh") -> "ReplayStream":
        """Decode a linear byte-address stream through ``order``;
        ``spec`` is a :class:`CompiledSpec` or a :class:`MemorySystemSpec`
        (decoded through the system channel digit)."""
        addrs = np.asarray(addrs, np.int64)
        if isinstance(spec, MemorySystemSpec):
            chan, sub, row, col = SystemAddressMapper(
                spec, order).to_chan_sub_row_col(addrs)
        else:
            chan, sub, row, col = AddressMapper(
                spec, order).to_chan_sub_row_col(addrs)
        wr = np.zeros(len(chan), np.int32) if is_write is None \
            else np.asarray(is_write, np.int32)
        i32 = lambda a: np.ascontiguousarray(a, np.int32)
        return cls(chan=i32(chan), sub=i32(sub), row=i32(row), col=i32(col),
                   is_write=i32(wr))


class ReplayTables(NamedTuple):
    """A :class:`ReplayStream`'s columns on the run's device (int32), sent
    once per run: ``arrive`` rebased to the stream's first arrival, and
    the wrap lap's length ``span + gap`` (the reference's pacing
    scalars)."""
    chan: torch.Tensor            # (n,)
    sub: torch.Tensor             # (n, L-1)
    row: torch.Tensor
    col: torch.Tensor
    is_write: torch.Tensor        # (n,) bool
    arrive: torch.Tensor | None   # (n,) rebased arrival clocks
    dep: torch.Tensor | None      # (n,) producer index, -1 = none
    n: int
    lap_len: int                  # span + gap of one lap


def replay_tables(replay: ReplayStream, device) -> ReplayTables:
    """Send a stream's columns to ``device`` as int32 tensors."""
    i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                    device=device)
    n = len(replay)
    arrive, lap_len = None, 0
    if replay.arrive is not None:
        arr = np.asarray(replay.arrive, np.int64)
        base = int(arr[0])
        span = int(arr[-1]) - base
        lap_len = span + max(span // max(n - 1, 1), 1)
        arrive = i32(arr - base)
    return ReplayTables(
        chan=i32(replay.chan), sub=i32(replay.sub), row=i32(replay.row),
        col=i32(replay.col), is_write=i32(replay.is_write) != 0,
        arrive=arrive, dep=None if replay.dep is None else i32(replay.dep),
        n=n, lap_len=lap_len)


def paced_by_arrive(cfg: FrontendConfig, replay) -> bool:
    """True when the captured ``arrive`` clocks pace the replay instead of
    the interval accumulator (a static property of config and stream;
    ``replay`` a :class:`ReplayStream` or its :class:`ReplayTables`)."""
    return (cfg.stream and cfg.pattern == "trace" and replay is not None
            and replay.arrive is not None)


def _gather(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``col[idx]`` per point: ``idx.shape + col.shape[1:]``."""
    return col.index_select(0, idx.reshape(-1)).view(idx.shape
                                                     + col.shape[1:])


def _due(rt: ReplayTables, fs: FrontState, idx):
    """The paced due clock of each point's stream position ``seq``:
    ``arrive[seq % n] + (seq // n) * (span + gap)``, in int32."""
    return _gather(rt.arrive, idx) + (fs.seq // rt.n) * rt.lap_len


def _replay_next(rt: ReplayTables, fs: FrontState, want, clk):
    """Each point's request at its stream position ``seq``: ``(want,
    chan, sub, row, col, is_write)``, ``sub`` ``S + (L-1,)``, the rest
    ``S``.  The gate is the reference's ``_replay_want``: with ``arrive``
    the request is due at ``arrive[seq % n] + (seq // n) * (span + gap)``,
    which replaces the accumulator gate ``want``; with ``dep`` a request
    with a producer also waits until ``served >= seq`` (every earlier
    request served).  int32 throughout, as the reference computes it."""
    idx = fs.seq % rt.n
    if rt.arrive is not None:
        want = _due(rt, fs, idx) <= clk
    if rt.dep is not None:
        want = want & ((_gather(rt.dep, idx) < 0) | (fs.served >= fs.seq))
    return (want, _gather(rt.chan, idx), _gather(rt.sub, idx),
            _gather(rt.row, idx), _gather(rt.col, idx),
            _gather(rt.is_write, idx))


def _lane_sub(sub):
    """``S + (L-1,)`` sub-level indices -> ``S + (1, 1, L-1)``, to
    broadcast against a queue's ``S + (C, Q, L-1)``."""
    return sub.view(sub.shape[:-1] + (1, 1, sub.shape[-1]))


def require_replay(cfg: FrontendConfig, replay):
    """Raise when ``pattern="trace"`` streams without a replay stream."""
    if cfg.stream and cfg.pattern == "trace" and replay is None:
        raise ValueError('pattern="trace" needs a ReplayStream '
                         "(Simulator(..., replay=...))")


# --------------------------------------------------------------------------
# Address generation
# --------------------------------------------------------------------------


def _lcg(rng):
    """One LCG step on an int64 tensor holding a uint32 (the product stays
    below 2**53, so it cannot overflow)."""
    return (rng * LCG_A + LCG_C) & MASK32


def _mul32(a_lo, a_hi, x):
    """``(a * x) mod 2**32`` for ``a = a_hi * 2**16 + a_lo`` and ``x <
    2**32``, with every intermediate below 2**49."""
    return (a_lo * x + (((a_hi * x) & 0xFFFF) << 16)) & MASK32


def _draws(ft: FrontTables, rng):
    """The cycle's K LCG draws ``lcg^1(rng) .. lcg^K(rng)``, ``rng.shape
    + (K,)``."""
    return (_mul32(ft.draw_a_lo, ft.draw_a_hi, rng[..., None])
            + ft.draw_c) & MASK32


def _pack_fields(ft: FrontTables, values):
    """Layout-ordered field values ``S + (n,)`` -> (chan ``S``, sub, row,
    col), the last three shaped to broadcast against the queue's ``S +
    (C, Q)``: ``S + (1, 1, L-1)`` and ``S + (1, 1)``."""
    v = values.to(I32).index_select(-1, ft.perm)
    q = v.view(v.shape[:-1] + (1, 1, v.shape[-1]))
    return v[..., 0], q[..., 1:-2], q[..., -2], q[..., -1]


def _seq_addr(cspec: CompiledSpec, ft: FrontTables, seq):
    """Decode the linear request counter through the mapper layout (the
    mixed-radix decode of ``addrmap.decode_fields`` in one step)."""
    return _pack_fields(ft, (seq[..., None].to(torch.int64) // ft.strides)
                        % ft.counts)


def _rand_addr(cspec: CompiledSpec, ft: FrontTables, draws):
    """One random value per layout field (channel included) from
    ``len(layout)`` consecutive draws (the last axis of ``draws``)."""
    return _pack_fields(ft, (draws >> 8) % ft.counts)


# --------------------------------------------------------------------------
# Per-channel routing
# --------------------------------------------------------------------------


def route_insert(queues: C.Queue, ft: FrontTables, chan, is_write, is_probe,
                 sub, row, col, arrive, want):
    """Insert one request per point into its target channel's queue:
    ``chan`` and ``want`` have the frontend state's shape ``S`` (``()`` or
    ``(P,)``), ``queues`` leaves are ``S + (C, Q[, L-1])`` and the other
    fields broadcast against them (see ``controller.queue_insert``).
    Returns ``(queues', ok S)``, ``ok`` False where the target channel's
    queue was full."""
    queues, oks = C.queue_insert(
        queues, is_write, is_probe, sub, row, col, arrive,
        want[..., None] & (chan[..., None] == ft.chan_ids))
    return queues, oks.any(-1)


def frontend_insert(cspec: CompiledSpec, cfg: FrontendConfig,
                    fp: FrontParams, fs: FrontState, queues: C.Queue, clk,
                    ft: FrontTables, active=None,
                    replay: ReplayTables | None = None):
    """Decode + insert up to one probe and one streaming (or replayed)
    request per point into ``queues`` this cycle, without touching ``fs``
    — the accept flags come back in a :class:`FrontDraft` for
    :func:`frontend_commit`.  Probes insert first so a saturated stream
    cannot starve them.  ``clk`` is a host int or a tensor of ``fs``'s
    shape (each point's clock); ``queues`` leaves are ``S + (C, Q[,
    L-1])`` for ``fs``'s shape ``S``; a point whose ``active`` flag is off
    inserts nothing and keeps its rng and accumulator.  ``replay`` is the
    device stream ``pattern="trace"`` needs (:func:`replay_tables`)."""
    require_replay(cfg, replay)
    n = len(ft.layout)
    draws = _draws(ft, fs.rng) if ft.draw_c.numel() else None
    used = 0
    lane = lambda x: x.view(x.shape + (1, 1))        # S -> S + (C, Q)
    arrive = lane(clk) if isinstance(clk, torch.Tensor) else clk
    zero = torch.zeros_like(fs.seq)
    okp = ok = zero
    want = zero.bool()
    accum = fs.accum_fp

    if cfg.probes:
        want_p = ~fs.probe_busy & (fs.probe_next <= clk)
        if active is not None:
            want_p = want_p & active
        chan, sub, row, col = _rand_addr(cspec, ft, draws[..., :n])
        used = n
        queues, okp_b = route_insert(queues, ft, chan, False, True, sub, row,
                                     col, arrive, want_p)
        okp = okp_b.to(I32)

    if cfg.stream:
        accum = (accum + 256).clamp(max=cfg.max_backlog_fp)
        want = accum >= fp.interval_fp
        if cfg.pattern == "trace":
            want, chan, sub, row, col, is_write = _replay_next(
                replay, fs, want, clk)
            sub, row, col = _lane_sub(sub), lane(row), lane(col)
        else:
            if cfg.pattern == "sequential":
                chan, sub, row, col = _seq_addr(cspec, ft, fs.seq)
            else:
                chan, sub, row, col = _rand_addr(cspec, ft,
                                                 draws[..., used:used + n])
            is_write = ((draws[..., -1] >> 9) % 256) >= fp.read_ratio_fp
        if active is not None:
            want = want & active
            accum = torch.where(active, accum, fs.accum_fp)
        queues, ok_b = route_insert(queues, ft, chan, lane(is_write), False,
                                    sub, row, col, arrive, want)
        ok = ok_b.to(I32)

    rng = fs.rng
    if draws is not None:
        rng = draws[..., -1]
        if active is not None:
            rng = torch.where(active, rng, fs.rng)
    return queues, FrontDraft(rng=rng, accum=accum, want=want, okp=okp,
                              ok=ok)


def frontend_commit(cfg: FrontendConfig, fp: FrontParams, fs: FrontState,
                    draft: FrontDraft, okp_total, ok_total,
                    paced: bool = False) -> FrontState:
    """Fold the accept counts into :class:`FrontState`; a replay paced by
    its arrival clocks (``paced``, :func:`paced_by_arrive`) keeps the
    accumulator as refilled."""
    probe_busy = fs.probe_busy
    if cfg.probes:
        probe_busy = probe_busy | (okp_total > 0)
    accum = draft.accum
    seq, sent = fs.seq, fs.sent
    dropped = fs.dropped_backpressure
    if cfg.stream:
        okb = ok_total > 0
        oki = okb.to(I32)
        if not paced:
            accum = accum - oki * fp.interval_fp
        seq = seq + oki
        sent = sent + oki
        dropped = dropped + (draft.want & ~okb).to(I32)
    return FrontState(accum_fp=accum, rng=draft.rng, seq=seq,
                      probe_busy=probe_busy, probe_next=fs.probe_next,
                      sent=sent, dropped_backpressure=dropped,
                      served=fs.served)


def frontend_step(cspec: CompiledSpec, cfg: FrontendConfig, fp: FrontParams,
                  fs: FrontState, queues: C.Queue, clk, ft: FrontTables):
    """Composition of :func:`frontend_insert` + :func:`frontend_commit`."""
    queues, draft = frontend_insert(cspec, cfg, fp, fs, queues, clk, ft)
    return queues, frontend_commit(cfg, fp, fs, draft, draft.okp, draft.ok)


# --------------------------------------------------------------------------
# System-level frontend: one mapper routing across spec groups
# --------------------------------------------------------------------------


class GroupFront(NamedTuple):
    """One spec group's decode tables in a multi-group system: the radices
    and place values of its layout without the channel field, the
    permutation to ``(sub-levels..., row, col)``, and the system channel
    ids its queue rows hold."""
    counts: torch.Tensor          # (n_g,) int64
    strides: torch.Tensor         # (n_g,) int64
    perm: torch.Tensor            # (n_g,) int64
    chan_ids: torch.Tensor        # (C_g,) int32 system channel ids


class SystemTables(NamedTuple):
    """Per-run device constants of the system frontend: ``single`` holds
    the 1-group system's :class:`FrontTables` (and the rest is unused);
    otherwise the groups' decode tables and the cycle's LCG draws."""
    single: FrontTables | None
    groups: tuple                 # per group GroupFront
    n_channels: int
    n_slots: int                  # the widest group's field count
    draw_a_lo: torch.Tensor | None
    draw_a_hi: torch.Tensor | None
    draw_c: torch.Tensor | None

    @property
    def k_draws(self) -> int:
        """The run's LCG draws per cycle."""
        ft = self.single if self.single is not None else self
        return int(ft.draw_c.numel())


def system_front_tables(msys, cfg: FrontendConfig, device) -> SystemTables:
    """The frontend's device tables of a memory system, read from the
    groups' geometry at the time of the call (a run builds them when it
    starts, so an edit such as ``cspec.rows = 2`` after construction is
    honoured, as in the reference)."""
    sys_layout = make_system_layout(msys, cfg.mapper)
    if sys_layout[0] == "single":
        g = msys.groups[0]
        return SystemTables(front_tables(g.cspec, cfg, g.channels, device),
                            (), g.channels, 0, None, None, None)
    _, n_channels, bases, sublayouts = sys_layout
    groups = tuple(
        GroupFront(*_decode_tables(
            lay, list(grp.cspec.levels[1:]) + ["row", "col"], device),
            chan_ids=torch.arange(base, base + grp.channels, dtype=I32,
                                  device=device))
        for grp, base, lay in zip(msys.groups, bases, sublayouts))
    return SystemTables(None, groups, n_channels,
                        max(len(lay) for lay in sublayouts),
                        *_draw_tables(rng_draws_per_cycle(cfg, sys_layout),
                                      device))


def _group_pack(gf: GroupFront, values):
    """Layout-ordered field values ``S + (n_g,)`` of one group -> (sub,
    row, col) shaped to broadcast against its queue's ``S + (C_g, Q)``."""
    v = values.to(I32).index_select(-1, gf.perm)
    q = v.view(v.shape[:-1] + (1, 1, v.shape[-1]))
    return q[..., :-2], q[..., -2], q[..., -1]


def _system_route(st: SystemTables, queues: tuple, chan, is_write, is_probe,
                  per_group, arrive, want):
    """Insert one request per point into the owning group's owning
    channel: exactly one (group, channel) can accept, and a full target
    queue refuses.  Returns ``(queues', ok S)``."""
    new_q, ok = [], None
    for gf, q_g, (sub, row, col) in zip(st.groups, queues, per_group):
        q_g, oks = C.queue_insert(
            q_g, is_write, is_probe, sub, row, col, arrive,
            want[..., None] & (chan[..., None] == gf.chan_ids))
        new_q.append(q_g)
        ok = oks.any(-1) if ok is None else ok | oks.any(-1)
    return tuple(new_q), ok


def system_frontend_insert(msys, cfg: FrontendConfig, fp: FrontParams,
                           fs: FrontState, queues: tuple, clk,
                           st: SystemTables, active=None,
                           replay: ReplayTables | None = None):
    """The multi-group twin of :func:`frontend_insert`: ``queues`` is the
    per-group tuple of ``S + (C_g, Q)`` queues.  A 1-group system runs
    :func:`frontend_insert` unchanged.  The cycle's draws are the
    reference's, in its order: for a probe, one draw picks the system
    channel and one draw per field slot (the widest group's field count)
    feeds every group's fields; a random stream request draws the same
    way; the last draw decides read or write.  A replayed request carries
    its system channel and a ``sub`` padded to the widest group: each
    group takes its first ``L_g - 1`` columns."""
    if st.single is not None:
        q0, draft = frontend_insert(msys.groups[0].cspec, cfg, fp, fs,
                                    queues[0], clk, st.single, active,
                                    replay)
        return (q0,), draft
    require_replay(cfg, replay)
    draws = _draws(st, fs.rng) if st.draw_c.numel() else None
    n = 1 + st.n_slots
    used = 0
    lane = lambda x: x.view(x.shape + (1, 1))        # S -> S + (C, Q)
    arrive = lane(clk) if isinstance(clk, torch.Tensor) else clk
    zero = torch.zeros_like(fs.seq)
    okp = ok = zero
    want = zero.bool()
    accum = fs.accum_fp

    def rand_addr(d):
        chan = ((d[..., 0] >> 8) % st.n_channels).to(I32)
        fields = d[..., 1:] >> 8
        return chan, [_group_pack(gf, fields[..., :gf.counts.numel()]
                                  % gf.counts) for gf in st.groups]

    if cfg.probes:
        want_p = ~fs.probe_busy & (fs.probe_next <= clk)
        if active is not None:
            want_p = want_p & active
        chan, per_group = rand_addr(draws[..., :n])
        used = n
        queues, okp_b = _system_route(st, queues, chan, False, True,
                                      per_group, arrive, want_p)
        okp = okp_b.to(I32)

    if cfg.stream:
        accum = (accum + 256).clamp(max=cfg.max_backlog_fp)
        want = accum >= fp.interval_fp
        if cfg.pattern == "trace":
            want, chan, sub, row, col, is_write = _replay_next(
                replay, fs, want, clk)
            row, col = lane(row), lane(col)
            per_group = [(_lane_sub(sub[..., :gf.perm.numel() - 2]), row,
                          col) for gf in st.groups]
        else:
            if cfg.pattern == "sequential":
                seq = fs.seq.to(torch.int64)
                chan = (seq % st.n_channels).to(I32)
                q = (seq // st.n_channels)[..., None]
                per_group = [_group_pack(gf, (q // gf.strides) % gf.counts)
                             for gf in st.groups]
            else:
                chan, per_group = rand_addr(draws[..., used:used + n])
            is_write = ((draws[..., -1] >> 9) % 256) >= fp.read_ratio_fp
        if active is not None:
            want = want & active
            accum = torch.where(active, accum, fs.accum_fp)
        queues, ok_b = _system_route(st, queues, chan, lane(is_write), False,
                                     per_group, arrive, want)
        ok = ok_b.to(I32)

    rng = fs.rng
    if draws is not None:
        rng = draws[..., -1]
        if active is not None:
            rng = torch.where(active, rng, fs.rng)
    return queues, FrontDraft(rng=rng, accum=accum, want=want, okp=okp,
                              ok=ok)


# --------------------------------------------------------------------------
# Event-horizon helpers (the engine's fast-forward path)
# --------------------------------------------------------------------------

#: Horizon sentinel — far beyond any reachable cycle count.
HORIZON_MAX = 1 << 30


def rng_draws_per_cycle(cfg: FrontendConfig, sys_layout) -> int:
    """Static number of LCG draws :func:`frontend_insert` /
    :func:`system_frontend_insert` performs per cycle, for a system layout
    of :func:`repro_torch.core.addrmap.make_system_layout`.  The draws are
    unconditional, so an idle cycle advances the rng by exactly this
    count; with several groups it grows with the widest group's field
    count.  A replayed stream draws nothing."""
    if sys_layout[0] == "single":
        n_fields = len(sys_layout[1])
        probe_draws = n_fields
        stream_draws = {"sequential": 1, "random": n_fields + 1,
                        "trace": 0}
    else:
        n_slots = max(len(lay) for lay in sys_layout[3])
        probe_draws = 1 + n_slots
        stream_draws = {"sequential": 1, "random": 1 + n_slots + 1,
                        "trace": 0}
    draws = 0
    if cfg.probes:
        draws += probe_draws
    if cfg.stream:
        draws += stream_draws[cfg.pattern]
    return draws


def lcg_affine(k: int) -> tuple:
    """Host-side ``(a, c)`` of :func:`_lcg` composed ``k`` times
    (mod 2**32)."""
    a, c = 1, 0
    for _ in range(k):
        a, c = (LCG_A * a) % (1 << 32), (LCG_A * c + LCG_C) % (1 << 32)
    return a, c


def lcg_power(d: int, a_cycle: int, c_cycle: int) -> tuple:
    """Host-side ``(a, c)`` of the per-cycle affine map ``x -> a_cycle*x +
    c_cycle`` composed ``d >= 0`` times (mod 2**32): the binary
    exponentiation over the bits of ``d`` in exact Python integers."""
    d = int(d)
    if d < 0:
        raise ValueError(f"lcg_jump needs d >= 0, got {d}")
    ra, rc = 1, 0
    pa, pc = a_cycle % (1 << 32), c_cycle % (1 << 32)
    while d:
        if d & 1:
            ra, rc = (pa * ra) % (1 << 32), (pa * rc + pc) % (1 << 32)
        pa, pc = (pa * pa) % (1 << 32), (pa * pc + pc) % (1 << 32)
        d >>= 1
    return ra, rc


def lcg_apply(rng, ra, rc):
    """``(ra * rng + rc) mod 2**32`` on the device with :func:`_mul32`;
    ``ra`` and ``rc`` are ints or int64 tensors of ``rng``'s shape."""
    return (_mul32(ra & 0xFFFF, ra >> 16, rng) + rc) & MASK32


def lcg_jump(rng, d: int, a_cycle: int, c_cycle: int):
    """Advance ``rng`` by ``d >= 0`` cycles of the per-cycle affine map
    ``x -> a_cycle*x + c_cycle``.  The engine's host loop knows ``d`` as
    a Python int, so :func:`lcg_power` folds its bits on the host and the
    device applies one affine map (:func:`lcg_apply`)."""
    return lcg_apply(rng, *lcg_power(d, a_cycle, c_cycle))


def idle_advance(cfg: FrontendConfig, fs: FrontState, d: int, a_cycle: int,
                 c_cycle: int, k_draws: int) -> FrontState:
    """Apply ``d`` idle cycles' worth of frontend state change in one
    step: the clamped accumulator refill and the rng's ``k_draws`` draws
    per cycle are the only frontend state that moves on an idle cycle
    (:func:`idle_jump` with the host's refill and LCG map of ``d``)."""
    return idle_jump(cfg, fs, min(256 * d, cfg.max_backlog_fp),
                     *lcg_power(d, a_cycle, c_cycle), k_draws)


def idle_jump(cfg: FrontendConfig, fs: FrontState, refill, ra, rc,
              k_draws: int) -> FrontState:
    """Advance each point by its own number of idle cycles ``d``, with what
    the host computed from the ``d``: the accumulator refill ``min(256 *
    d, max_backlog_fp)`` (the same clamp as refilling ``d`` times, since
    the accumulator is never negative) and the rng's affine map ``(ra,
    rc)`` (:func:`lcg_power`), ints or tensors of ``fs``'s shape (int32 and
    int64).  A point with ``d = 0`` (refill 0, map ``(1, 0)``) is left as
    it is."""
    if cfg.stream:
        fs = fs._replace(accum_fp=(fs.accum_fp + refill).clamp(
            max=cfg.max_backlog_fp))
    if k_draws:
        fs = fs._replace(rng=lcg_apply(fs.rng, ra, rc))
    return fs


def arrival_horizon(cfg: FrontendConfig, fp: FrontParams, fs: FrontState,
                    cur, replay: ReplayTables | None = None):
    """Earliest cycle ``>= cur`` at which the frontend could next attempt
    an insert, assuming no intervening completions (conservative, as in
    the reference), per point (``cur`` an int or a tensor of ``fs``'s
    shape):

    * probe: attempts at ``max(probe_next, cur)`` once not busy;
    * stream: ``want`` first fires at the ``j``-th cycle from ``cur`` with
      ``min(accum + 256*(j+1), cap) >= interval`` — never, where the cap
      can't reach the interval (a per-point mask, as the reference's
      ``jnp.where``);
    * a ``replay`` paced by its arrival clocks: the position's due clock,
      the exact gate of :func:`_replay_next` (dependency holds ignored)."""
    h = torch.full_like(fs.seq, HORIZON_MAX)
    if cfg.probes:
        h = fs.probe_next.clamp(min=cur).masked_fill(fs.probe_busy,
                                                     HORIZON_MAX)
    if paced_by_arrive(cfg, replay):
        due = _due(replay, fs, fs.seq % replay.n)
        due = (due.clamp(min=cur) if not isinstance(cur, torch.Tensor)
               else torch.maximum(due, cur))
        h = torch.minimum(h, due)
    elif cfg.stream:
        need = fp.interval_fp - fs.accum_fp
        j = ((need + 255) // 256 - 1).clamp(min=0)
        never = fp.interval_fp > cfg.max_backlog_fp
        hs = cur + j
        if isinstance(never, torch.Tensor):
            h = torch.minimum(h, hs.masked_fill(never, HORIZON_MAX))
        elif not never:
            h = torch.minimum(h, hs)
    return h


def absorb_locals(events: C.StepEvents) -> torch.Tensor:
    """Reduce the completion events over each point's channels (the last
    axis) to ``[probes_done, requests_served, probe_completion]`` int32,
    ``(3,) + S`` (at most one probe is in flight per point, so the
    completion sum is its max)."""
    probe = events.served_probe
    return torch.stack([
        probe.sum(-1, dtype=I32),
        (events.served_read & ~probe).sum(-1, dtype=I32)
        + events.served_write.sum(-1, dtype=I32),
        events.probe_completion.sum(-1, dtype=I32)])


def frontend_finish(fs: FrontState, fp: FrontParams, done_total,
                    served_total, completion_total) -> FrontState:
    """Fold the absorb vector into :class:`FrontState`: closes the probe
    loop and advances the served-request counter."""
    done = done_total > 0
    return fs._replace(
        probe_busy=fs.probe_busy & ~done,
        probe_next=torch.where(done, completion_total + fp.probe_gap,
                               fs.probe_next),
        served=fs.served + served_total)

