"""Random simulator states for holding the port's kernels against their
plain versions (``chip_smoke.py`` and ``tests/test_torch_cuda.py``).

Everything is drawn with numpy from a seed, so the kernel and its plain
version see the same inputs on any device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import controller as C
from repro_torch.core import device as D
from repro_torch.core.compile import CompiledSpec


def _i32(a, device):
    return torch.as_tensor(np.asarray(a, np.int32), device=device)


def random_device_state(cspec: CompiledSpec, dp: D.DynParams, device,
                        seed: int, clk0: int, channels: int = 1,
                        steps: int = 80) -> tuple:
    """A device state after ``steps`` random commands at random addresses
    and increasing clocks from ``clk0`` (each channel enabled with
    probability 0.9), applied with the port's ``issue``.  Returns
    ``(state, next clock)``."""
    rng = np.random.default_rng(seed)
    st = D.init_state(cspec, channels, device)
    counts = [int(c) for c in cspec.level_counts[1:]]
    clk = clk0
    for _ in range(steps):
        st = D.issue(cspec, dp, st,
                     _i32(rng.integers(0, cspec.n_cmds, channels), device),
                     _i32(np.stack([rng.integers(0, c, channels)
                                    for c in counts], 1), device),
                     _i32(rng.integers(0, 64, channels), device), clk,
                     torch.as_tensor(rng.random(channels) < 0.9,
                                     device=device))
        clk += int(rng.integers(1, 8))
    return st, clk


def random_ctrl_state(cspec: CompiledSpec, dp: D.DynParams, device,
                      seed: int, clk0: int = 0, depth: int = 32,
                      channels: int = 3, margin: int = 4) -> tuple:
    """A controller state of ``channels`` independent channels and the
    clock to step it from:

    * a random device history from ``clk0``;
    * queues filled to 100%, about 50% and 0% in turn over the channels,
      with random addresses, rows that hit an open row 40% of the time,
      and arrivals within 5 cycles of the clock (so with many ties);
    * refresh units from 3 cycles before their due time to 3 cycles past
      the urgent ``margin``;
    * with split activation, a quarter of the banks activating, their
      ACT-2 deadline 0-3 cycles after the clock (the exclusive window is
      2 cycles).
    """
    rng = np.random.default_rng(seed + 7919)
    dev, clk = random_device_state(cspec, dp, device, seed, clk0, channels)
    clk += int(rng.integers(1, 4))
    B, U = cspec.n_banks, cspec.n_refresh_units
    last_ref = clk - dp.nREFI - rng.integers(-3, margin + 4, (channels, U))
    rs = dev.row_state.cpu().numpy()
    a1r = dev.act1_row.cpu().numpy()
    a1c = dev.act1_clk.cpu().numpy()
    if cspec.split_activation:
        act = rng.random((channels, B)) < 0.25
        rs = np.where(act, D.ROW_ACTIVATING, rs)
        a1r = np.where(act, rng.integers(0, 64, (channels, B)), a1r)
        a1c = np.where(act, clk - dp.nAAD + rng.integers(0, 4, (channels, B)),
                       a1c)
    dev = dev._replace(row_state=_i32(rs, device), act1_row=_i32(a1r, device),
                       act1_clk=_i32(a1c, device),
                       last_ref=_i32(last_ref, device))
    counts = [int(c) for c in cspec.level_counts[1:]]
    sub = np.stack([rng.integers(0, c, (channels, depth)) for c in counts], 2)
    strides = np.asarray(cspec.addr_strides(), np.int64)
    bank = (sub * strides).sum(2)
    open_row = np.take_along_axis(rs, bank, 1)
    row = np.where((rng.random((channels, depth)) < 0.4) & (open_row >= 0),
                   open_row, rng.integers(0, 64, (channels, depth)))
    fill = np.asarray([(1.0, 0.5, 0.0)[c % 3] for c in range(channels)])
    valid = rng.random((channels, depth)) < fill[:, None]
    arrive = clk - rng.integers(0, 6, (channels, depth))
    arrive[:, 1] = arrive[:, 0]
    queue = C.Queue(
        valid=torch.as_tensor(valid, device=device),
        is_write=torch.as_tensor(rng.random((channels, depth)) < 0.3,
                                 device=device),
        is_probe=torch.as_tensor(rng.random((channels, depth)) < 0.15,
                                 device=device),
        sub=_i32(sub, device), row=_i32(row, device),
        col=_i32(rng.integers(0, 8, (channels, depth)), device),
        arrive=_i32(arrive, device))
    cs = C.init_ctrl_state(cspec, depth, channels, device)._replace(
        dev=dev, queue=queue,
        hit_streak=_i32(rng.integers(0, 4, (channels, B)), device),
        prac_count=_i32(rng.integers(0, 3, (channels, B)), device))
    return cs, clk


def predicate_ctrl_state(cspec: CompiledSpec, dp: D.DynParams, device,
                         seed: int, bh: int = 0, prac: int = 0,
                         link: int = 0, clk0: int = 0, depth: int = 32,
                         channels: int = 3) -> tuple:
    """:func:`random_ctrl_state` with BlockHammer and PRAC state around
    their thresholds and arrivals around a link's boundary:

    * ``bh``: sketch counts in ``[0, 2 bh)``, so some rows are
      blacklisted and some not;
    * ``prac``: every bank's counter in ``[prac - 3, prac)``, and in about
      half of the refresh units one bank at ``prac`` (an alert);
    * ``link``: arrivals from ``link + 4`` cycles before the clock to 4
      cycles after ``clk - link``.

    Returns ``(cs, clk)``; step it at :func:`predicate_clocks` to reach
    the sketch's decay cycles."""
    cs, clk = random_ctrl_state(cspec, dp, device, seed, clk0, depth,
                                channels)
    rng = np.random.default_rng(seed + 15485863)
    B, U = cspec.n_banks, cspec.n_refresh_units
    if bh:
        cs = cs._replace(bh_sketch=_i32(
            rng.integers(0, 2 * bh, (channels, 2, C.SKETCH)), device))
    if prac:
        count = rng.integers(max(prac - 3, 0), prac, (channels, B))
        for c in range(channels):
            for u in range(U):
                if rng.random() < 0.5:
                    count[c, u * (B // U) + rng.integers(B // U)] = prac
        cs = cs._replace(prac_count=_i32(count, device))
    if link:
        arrive = clk - link + rng.integers(-4, 5, (channels, depth))
        cs = cs._replace(queue=cs.queue._replace(arrive=_i32(arrive,
                                                             device)))
    return cs, clk


def predicate_clocks(clk: int, nrefi: int, n: int = 12) -> list:
    """Increasing clocks to step a controller state at: ``n`` consecutive
    cycles from ``clk``, then the three cycles around the next ``nREFI``
    multiple (the BlockHammer sketch decays on it) and around the one
    after."""
    m = (clk + n) // nrefi * nrefi + nrefi
    return (list(range(clk, clk + n)) + [m - 1, m, m + 1]
            + [m + nrefi - 1, m + nrefi, m + nrefi + 1])


def reads_every_field(cspec: CompiledSpec, ctx: C.PredCtx) -> torch.Tensor:
    """A user predicate over every :class:`~repro_torch.core.controller.PredCtx`
    field but ``dp`` (the clock, the candidates, row hits, banks, refresh
    units, urgency and the PRAC counters), true for some slots and false
    for others: it holds the kernel's user mask, computed on the device
    over all lanes, against the plain step's predicates."""
    urgent = D.take(ctx.ref_urgent, ctx.ru)
    hot = D.take(ctx.cs.prac_count, ctx.bank) > 0
    return (((ctx.cand_row + ctx.clk + ctx.bank) % 3 != 0) | ctx.open_hit
            | urgent | hot | (ctx.cand_cmd == cspec.id_PRE))


def lane_case(cspec: CompiledSpec, dp: D.DynParams, device, seed: int,
              points: int, channels: int, reset: bool,
              stagger: bool = True, depth: int = 32) -> tuple:
    """A batch of ``points`` design points of ``channels`` channels each
    for the fused step at per-point clocks: ``(cs, clk (P,) int32, active
    (P,) bool)``, the state's leaves ``(P, C, ...)``.

    * ``reset``: the reset state (refresh ``stagger`` on or off) with a few
      requests queued, every point at clock 0 (the staggered channels'
      ``last_ref`` is negative there);
    * otherwise :func:`random_ctrl_state` over all lanes, the points at
      clocks ``clk + 0..3``.

    Every third point (from the second) is inactive: a finished point
    whose clock is already past the run's end."""
    rng = np.random.default_rng(seed + 104729)
    shape = (points, channels)
    if reset:
        cs = C.init_ctrl_state(cspec, depth, channels, device, stagger,
                               points)
        counts = [int(c) for c in cspec.level_counts[1:]]
        sub = np.stack([rng.integers(0, c, shape + (depth,))
                        for c in counts], -1)
        cs = cs._replace(queue=cs.queue._replace(
            valid=torch.as_tensor(rng.random(shape + (depth,)) < 0.3,
                                  device=device),
            is_write=torch.as_tensor(rng.random(shape + (depth,)) < 0.3,
                                     device=device),
            sub=_i32(sub, device),
            row=_i32(rng.integers(0, 64, shape + (depth,)), device)))
        clks = [0] * points
    else:
        cs, clk = random_ctrl_state(cspec, dp, device, seed, clk0=seed * 97,
                                    depth=depth, channels=points * channels)
        cs = C._tree(lambda a: a.view(shape + a.shape[1:]), cs)
        clks = [clk + int(d) for d in rng.integers(0, 4, points)]
    active = [p % 3 != 1 for p in range(points)]
    return (cs, torch.tensor(clks, dtype=torch.int32, device=device),
            torch.tensor(active, device=device))


def one_point(cs: C.CtrlState, clk: int) -> tuple:
    """A ``(C, ...)`` state at host clock ``clk`` as the dispatched step's
    batch of one point: ``(cs (1, C, ...), clk (1,) int32, active (1,)
    bool)``; the state's leaves are views, so the kernel's in-place update
    shows in ``cs`` too."""
    dev = cs.queue.valid.device
    return (C._tree(lambda a: a[None], cs),
            torch.tensor([clk], dtype=torch.int32, device=dev),
            torch.ones(1, dtype=torch.bool, device=dev))


def step_one_point(cspec: CompiledSpec, dp: D.DynParams, cfg, cs, clk: int,
                   horizon: bool = True, link_latency: int = 0) -> tuple:
    """The dispatched step (``C.step_and_horizon``, or
    ``C.controller_step`` without ``horizon``) of a ``(C, ...)`` state at
    host clock ``clk`` behind a link of ``link_latency`` cycles, as a
    batch of one point: ``(cs', StepEvents, horizon (C,) or None)`` in the
    channels' shape."""
    fn = C.step_and_horizon if horizon else C.controller_step
    out = fn(cspec, dp, cfg, *one_point(cs, clk), link_latency)
    first = lambda a: a[0]
    return (C._tree(first, out[0]), C._tree(first, out[1]),
            out[2][0] if horizon else None)


def clone_ctrl(cs: C.CtrlState) -> C.CtrlState:
    """A deep copy of a controller state (the fused kernel updates its
    input in place)."""
    cl = lambda nt: type(nt)(*(t.clone() for t in nt))
    return C.CtrlState(dev=cl(cs.dev), queue=cl(cs.queue),
                       hit_streak=cs.hit_streak.clone(),
                       bh_sketch=cs.bh_sketch.clone(),
                       prac_count=cs.prac_count.clone())


def ctrl_diff(a: C.CtrlState, b: C.CtrlState) -> dict:
    """``{field: max |a - b|}`` over every tensor of two controller
    states, the nonzero ones only."""
    out = {}
    for name, x, y in (
            *((f"dev.{k}", getattr(a.dev, k), getattr(b.dev, k))
              for k in a.dev._fields),
            *((f"queue.{k}", getattr(a.queue, k), getattr(b.queue, k))
              for k in a.queue._fields),
            ("hit_streak", a.hit_streak, b.hit_streak),
            ("prac_count", a.prac_count, b.prac_count),
            ("bh_sketch", a.bh_sketch, b.bh_sketch)):
        d = int((x.long() - y.long()).abs().max()) if x.numel() else 0
        if d:
            out[name] = d
    return out


def events_diff(a: C.StepEvents, b: C.StepEvents) -> dict:
    """``{field: max |a - b|}`` over the fields of two ``StepEvents``,
    the nonzero ones only."""
    out = {}
    for k in a._fields:
        x, y = getattr(a, k), getattr(b, k)
        if x.shape != y.shape:
            out[k] = f"shape {tuple(x.shape)} != {tuple(y.shape)}"
            continue
        d = int((x.long() - y.long()).abs().max())
        if d:
            out[k] = d
    return out
