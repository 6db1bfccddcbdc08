"""Memory-controller base scheduling workflow + filtering predicates.

The counterpart of ``repro.core.controller``: one common command-selection
pipeline that every controller specializes by injecting filtering
predicates (boolean masks over the request queue), run twice per cycle
(column pass, then row pass) for dual-C/A standards.  Every tensor has a
leading channel axis; the reference's per-channel ``vmap`` is that axis.
A batch of design points adds a point axis before it (``(P, C, ...)``:
``P * C`` lanes, each point at its own clock), the reference's outer
``vmap`` over load points.

Ported: the FR-FCFS / FCFS schedulers, the refresh engine, the
refresh-urgency and ACT-2 predicates, the BlockHammer (count-min sketch)
and PRAC (per-bank activation counters, alerts served by the refresh
engine) predicates, user ``extra_predicates``, a CXL-style link latency
in front of a spec group's channels, the controller step and the channel
horizon.

The step has two versions that compute the same function bit for bit:
the fused CUDA kernel of ``repro_torch.kernels.controller_step`` (one
launch per cycle for every lane: readiness, selection, refresh, issue,
events and the next horizon) and its plain PyTorch version here
(:func:`controller_step_plain`, :func:`channel_horizon_plain`,
:func:`step_and_horizon_plain`, and :func:`step_lanes_plain` over points
at their own clocks).  :func:`controller_step` and
:func:`step_and_horizon` dispatch: the kernel on CUDA tensors, the plain
version on CPU tensors, an error otherwise.  User ``extra_predicates`` are
Python callables over :class:`PredCtx` tensors, which the kernel cannot
run: on the card they are evaluated on the device over every lane
(:func:`user_mask`) and their verdict rides the kernel's launch, one
launch per pass on a dual command bus.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import device as D
from repro_torch.core import spec as S
from repro_torch.core.compile import CompiledSpec
from repro_torch.kernels import controller_step as KS

I32 = torch.int32
I32_MAX = 2**31 - 1

# --------------------------------------------------------------------------
# Request schedulers: masked-priority selection over the request queue
# --------------------------------------------------------------------------
#
# A scheduler is ``(mask, row_hit, arrive) -> (slot, ok)`` over ``(C, Q)``
# tensors, picking at most one slot per channel among those ``mask``
# allows.  Ties go to the lowest slot index, as with jnp.argmin (torch's
# argmin/argmax return the first extremal index on CPU and CUDA).


def _oldest(mask, arrive):
    key = arrive.masked_fill(~mask, I32_MAX)
    return key.argmin(1), mask.any(1)


def frfcfs(mask, row_hit, arrive):
    """First-Ready FCFS: ready row hits first, then oldest ready."""
    hit_mask = mask & row_hit
    use_hits = hit_mask.any(1, keepdim=True)
    return _oldest(torch.where(use_hits, hit_mask, mask), arrive)


def fcfs(mask, row_hit, arrive):
    return _oldest(mask, arrive)


SCHEDULERS = {"FRFCFS": frfcfs, "FCFS": fcfs}

# --------------------------------------------------------------------------
# Queue / controller state
# --------------------------------------------------------------------------


class Queue(NamedTuple):
    valid: torch.Tensor      # (C, Q) bool
    is_write: torch.Tensor   # (C, Q) bool
    is_probe: torch.Tensor   # (C, Q) bool
    sub: torch.Tensor        # (C, Q, L-1) per-level indices below channel
    row: torch.Tensor        # (C, Q) int32
    col: torch.Tensor        # (C, Q) int32
    arrive: torch.Tensor     # (C, Q) int32


def empty_queue(cspec: CompiledSpec, depth: int, channels: int,
                device) -> Queue:
    nsub = len(cspec.levels) - 1
    z = lambda *sh: torch.zeros((channels,) + sh, dtype=I32, device=device)
    f = lambda: torch.zeros((channels, depth), dtype=torch.bool,
                            device=device)
    return Queue(valid=f(), is_write=f(), is_probe=f(),
                 sub=z(depth, nsub), row=z(depth), col=z(depth),
                 arrive=z(depth))


def queue_insert(q: Queue, is_write, is_probe, sub, row, col, arrive, want):
    """Insert one request into the first free slot of each channel whose
    ``want[..., c]`` is set.  The queue's leaves are ``S + (C, Q[, L-1])``
    and ``want`` is ``S + (C,)``, where ``S`` is ``()`` for one point or
    ``(P,)`` for a batch of points; each request field is a Python scalar
    or a tensor that broadcasts against its queue leaf (``S + (1, 1)``, or
    0-d for one point).  Returns ``(q', ok S + (C,))``.

    The first free slot is the free slot whose running free count is 1
    (the reference's ``argmax`` over the free mask)."""
    free = ~q.valid
    first = free & (free.cumsum(-1) == 1)            # one-hot or 0 per channel
    ok = want & free.any(-1)
    hit = first & ok[..., None]

    def put(a, v):
        # a tensor value goes through where: masked_fill would read a 0-d
        # tensor back to the host (a device sync per field on CUDA)
        if isinstance(v, torch.Tensor):
            return torch.where(hit, v, a)
        return a.masked_fill(hit, v)
    return Queue(valid=q.valid | hit,
                 is_write=put(q.is_write, is_write),
                 is_probe=put(q.is_probe, is_probe),
                 sub=torch.where(hit[..., None], sub, q.sub),
                 row=put(q.row, row), col=put(q.col, col),
                 arrive=put(q.arrive, arrive)), ok


class CtrlState(NamedTuple):
    dev: D.DeviceState
    queue: Queue
    hit_streak: torch.Tensor   # (C, n_banks) consecutive row-hit services
    bh_sketch: torch.Tensor    # (C, 2, SKETCH) BlockHammer count-min sketch
    prac_count: torch.Tensor   # (C, n_banks) ACT counter since recovery


SKETCH = 1024


def init_ctrl_state(cspec: CompiledSpec, depth: int, channels: int,
                    device, refresh_stagger: bool = False,
                    points: int | None = None) -> CtrlState:
    """The reset state of ``channels`` channels (leaves ``(C, ...)``), or
    of ``points`` runs of them (leaves ``(P, C, ...)``: ``P * C`` lanes).
    With ``refresh_stagger`` channel ``c`` of a multi-channel system
    starts its refresh epoch ``c * nREFI // channels`` cycles early
    (``last_ref`` negative), so the channels' refresh windows never align;
    channel 0 keeps its phase (the reference's
    ``engine.make_run._init_state``)."""
    lanes = channels * (points or 1)
    z = lambda *sh: torch.zeros((lanes,) + sh, dtype=I32, device=device)
    cs = CtrlState(dev=D.init_state(cspec, lanes, device),
                   queue=empty_queue(cspec, depth, lanes, device),
                   hit_streak=z(cspec.n_banks), bh_sketch=z(2, SKETCH),
                   prac_count=z(cspec.n_banks))
    if points is not None:
        cs = _tree(lambda a: a.view((points, channels) + a.shape[1:]), cs)
    if refresh_stagger and channels > 1:
        nrefi = int(cspec.timings["nREFI"])
        offs = torch.tensor([-(c * nrefi // channels)
                             for c in range(channels)], dtype=I32,
                            device=device)
        cs = cs._replace(dev=cs.dev._replace(
            last_ref=cs.dev.last_ref + offs[:, None]))
    return cs


def _tree(fn, *trees):
    """``fn`` over the leaves (tensors, or host arrays) of NamedTuples of
    the same structure."""
    first = trees[0]
    if not isinstance(first, tuple):
        return fn(*trees)
    return type(first)(*(_tree(fn, *leaves) for leaves in zip(*trees)))


class PredCtx(NamedTuple):
    """Everything a filtering predicate may look at.  Its tensors have a
    leading lane axis (the channels of one point in the plain step, every
    lane of the batch in :func:`user_mask`), so a predicate works per row;
    ``clk`` broadcasts against them: a host int in the plain step, a
    ``(lanes, 1)`` int32 tensor of the lanes' clocks in
    :func:`user_mask`."""
    dp: D.DynParams
    cs: CtrlState
    clk: object
    cand_cmd: torch.Tensor     # (C, Q) candidate command per slot
    cand_row: torch.Tensor     # (C, Q)
    open_hit: torch.Tensor     # (C, Q) request's row is open
    bank: torch.Tensor         # (C, Q) flat bank ids
    ru: torch.Tensor           # (C, Q) refresh-unit ids
    ref_urgent: torch.Tensor   # (C, n_refresh_units) refresh must go first


# --------------------------------------------------------------------------
# Built-in filtering predicates
# --------------------------------------------------------------------------


def pred_refresh_urgency(cspec, ctx):
    """Block requests to a refresh unit whose refresh is overdue-urgent."""
    return ~D.take(ctx.ref_urgent, ctx.ru)


def pred_act2_exclusive(cspec, ctx):
    """LPDDR5/6: when a pending ACT-2 approaches its tAAD deadline, only
    ACT-2 candidates may issue (nothing may interrupt it)."""
    if not cspec.split_activation:
        return torch.ones_like(ctx.cand_cmd, dtype=torch.bool)
    pending = D.take(ctx.cs.dev.row_state, ctx.bank) == D.ROW_ACTIVATING
    deadline = D.take(ctx.cs.dev.act1_clk, ctx.bank) + ctx.dp.nAAD
    urgent = pending & (ctx.clk + 2 >= deadline)       # slack of one slot
    is_act2 = ctx.cand_cmd == cspec.id_ACT2
    # any urgent ACT-2 in the channel: only those; else no restriction
    return (is_act2 & urgent) | ~urgent.any(1, keepdim=True)


def pred_act2_follows_act1(cspec, ctx):
    """LPDDR5/6: only a request whose bank is Activating may issue ACT-2."""
    if not cspec.split_activation:
        return torch.ones_like(ctx.cand_cmd, dtype=torch.bool)
    is_act2 = ctx.cand_cmd == cspec.id_ACT2
    activating = D.take(ctx.cs.dev.row_state, ctx.bank) == D.ROW_ACTIVATING
    return ~is_act2 | activating


MASK32 = 0xFFFFFFFF


def _bh_hashes(bank, row):
    """The BlockHammer sketch's two hashes of ``(bank, row)`` tensors: the
    reference's uint32 arithmetic in int64 masked to 32 bits (torch has
    no uint32 multiply on the CPU); ``SKETCH`` is a power of two, so the
    modulo is a mask.  The 32-bit multiplier is split in 16-bit halves so
    that no product leaves int64."""
    k = (bank.long() * 1_000_003 + row.long()) & MASK32
    a = 2654435761
    kh = ((a & 0xFFFF) * k + ((((a >> 16) * k) & 0xFFFF) << 16)) & MASK32
    h0 = (kh >> 5) & (SKETCH - 1)
    h1 = ((k * 40503 + 2057) & MASK32) & (SKETCH - 1)
    return h0, h1


def _opener(cspec: CompiledSpec) -> int:
    return cspec.id_ACT1 if cspec.split_activation else cspec.id_ACT


def make_pred_blockhammer(threshold: int):
    """BlockHammer: defer row opens to rows whose estimated activation
    count (the count-min sketch's) has reached the blacklist threshold."""
    def pred(cspec, ctx):
        is_open_cmd = ctx.cand_cmd == _opener(cspec)
        h0, h1 = _bh_hashes(ctx.bank, ctx.cand_row)
        sk = ctx.cs.bh_sketch
        est = torch.minimum(D.take(sk[:, 0], h0), D.take(sk[:, 1], h1))
        return ~(is_open_cmd & (est >= threshold))
    return pred


def _prac_alert(cspec, prac_count, threshold: int):
    """``(C, U)``: a bank of the refresh unit has reached the threshold."""
    C = prac_count.shape[0]
    return (prac_count >= threshold).reshape(
        C, cspec.n_refresh_units, -1).any(2)


def make_pred_prac(threshold: int):
    """PRAC: once a bank's activation counter crosses the alert threshold,
    requests to its refresh unit are blocked until the recovery (a
    priority REFab) resets the unit's counters."""
    def pred(cspec, ctx):
        return ~D.take(_prac_alert(cspec, ctx.cs.prac_count, threshold),
                       ctx.ru)
    return pred


# --------------------------------------------------------------------------
# Controller configuration
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    scheduler: str = "FRFCFS"
    queue_depth: int = 32
    refresh_enabled: bool = True
    # urgency margin: refresh becomes *blocking* this many cycles past due
    refresh_urgent_margin: int = 4
    # stagger the initial refresh phase across channels (multi-channel)
    refresh_stagger: bool = True
    blockhammer_threshold: int = 0     # 0 = disabled
    prac_threshold: int = 0            # 0 = disabled
    #: user predicates ``(cspec, ctx) -> bool (C, Q)`` over the
    #: :class:`PredCtx` tensors; on CUDA their verdict rides the kernel
    extra_predicates: tuple = ()

    def __post_init__(self):
        if self.scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {self.scheduler!r}; "
                             f"known: {sorted(SCHEDULERS)}")

    def predicates(self, cspec=None) -> tuple:
        """The pass's predicates in the reference's order: refresh urgency,
        the two ACT-2 predicates, BlockHammer, PRAC, then the user's.
        With ``cspec`` of a standard without split activation the ACT-2
        predicates (all-true there) are left out."""
        preds = [pred_refresh_urgency]
        if cspec is None or cspec.split_activation:
            preds += [pred_act2_follows_act1, pred_act2_exclusive]
        if self.blockhammer_threshold:
            preds.append(make_pred_blockhammer(self.blockhammer_threshold))
        if self.prac_threshold:
            preds.append(make_pred_prac(self.prac_threshold))
        return tuple(preds) + tuple(self.extra_predicates)


class StepEvents(NamedTuple):
    """What happened this cycle in each channel (-1 == nothing).

    Per bus slot ``[col, row]`` (``(C, 2)``): ``cmd``, ``bank`` (refresh
    commands carry their unit's representative bank), ``row``, ``arrive``
    (-1 for refresh commands) and ``hit_ready``; then ``(C,)`` outcomes.
    """
    cmd: torch.Tensor           # (C, 2) issued command per bus slot
    bank: torch.Tensor          # (C, 2)
    row: torch.Tensor           # (C, 2)
    arrive: torch.Tensor        # (C, 2) arrival clk of the served request
    hit_ready: torch.Tensor     # (C, 2) bool — a maskable row-hit existed
    served_read: torch.Tensor       # (C,) bool — a read's final RD issued
    served_write: torch.Tensor      # (C,) bool
    served_probe: torch.Tensor      # (C,) bool — the read served a probe
    probe_latency: torch.Tensor     # (C,) i32 completion - arrival
    probe_completion: torch.Tensor  # (C,) i32 absolute completion clock
    deferred: torch.Tensor          # (C,) i32 candidates masked by predicates


# --------------------------------------------------------------------------
# The base scheduling workflow
# --------------------------------------------------------------------------


def _candidates(cspec: CompiledSpec, dp: D.DynParams, cs, clk: int, bank):
    q = cs.queue
    cand_cmd, cand_row, open_hit = D.prereq(cspec, dp, cs.dev, q.is_write,
                                            q.sub, q.row, clk)
    # dense (C, n_cmds, n_banks) earliest table + one (C, Q) lookup
    table = D.earliest_ready_table_plain(cspec, dp, cs.dev)
    timing_ready = clk >= D.table_at(table, cand_cmd, bank)
    return cand_cmd, cand_row, open_hit, timing_ready, table


def _refresh_plan(cspec: CompiledSpec, dp: D.DynParams, cs, clk,
                  cfg: ControllerConfig):
    """Per-refresh-unit refresh state ``(C, U)``: due / urgent /
    candidate command."""
    dev = cs.dev
    since = clk - dev.last_ref
    due_time = since >= dp.nREFI
    urgent = since >= dp.nREFI + cfg.refresh_urgent_margin
    due = due_time
    if cfg.prac_threshold:
        # PRAC recovery rides the refresh engine, and is always urgent
        alert = _prac_alert(cspec, cs.prac_count, cfg.prac_threshold)
        due = due_time | alert
        urgent = urgent | (alert & ~due_time)
    urgent = urgent & due
    if not cfg.refresh_enabled:
        due = torch.zeros_like(due)
        urgent = torch.zeros_like(urgent)
    C, U = dev.last_ref.shape
    any_open = (dev.row_state.reshape(C, U, -1) != D.ROW_CLOSED).any(2)
    ref_cmd = torch.full_like(dev.last_ref, cspec.id_REFab).masked_fill(
        any_open, cspec.id_PREab)
    return due, urgent, ref_cmd


def _ru_addr(cspec, dp, ru):
    """Address-vector stand-in ``(C, L-1)`` for refresh-unit commands."""
    return ru[:, None] * dp.tables.sub_e0


def _try_issue_refresh(cspec: CompiledSpec, dp: D.DynParams, cs, clk: int,
                       due, urgent, ref_cmd, cmd_ok, table):
    """Plan the refresh-engine command of the most-overdue due unit.

    Refresh is *opportunistic* until urgent: a merely-due refresh yields
    to pending requests targeting the same unit; an urgent one preempts.
    Returns ``(cs', do, cmd, sub, ref_bank)`` with the PRAC counters of a
    refreshed unit reset.  The device issue itself is left to the
    caller: ``_select_and_issue`` issues at most one command per pass
    (its queue pick is gated off when refresh fires), so it folds this
    command into its single ``D.issue`` call.
    """
    tab = dp.tables
    score = (clk - cs.dev.last_ref).masked_fill(~due, -1)
    ru_l = score.argmax(1, keepdim=True)             # first on ties
    ru = ru_l[:, 0].to(I32)
    cmd = ref_cmd.gather(1, ru_l)[:, 0]
    banks_per_ru = cspec.n_banks // cspec.n_refresh_units
    ref_bank = ru * banks_per_ru
    ready = clk >= D.table_at(table, cmd[:, None], ref_bank[:, None])[:, 0]
    q = cs.queue
    pending_here = (q.valid & (q.sub[:, :, 0] == ru[:, None])).any(1)
    may_go = urgent.gather(1, ru_l)[:, 0] | ~pending_here
    do = due.any(1) & ready & may_go
    if cmd_ok is not None:
        do = do & D.lut(cmd_ok, cmd)
    # PRAC: recovery resets the unit's activation counters
    is_ref = do & (cmd == cspec.id_REFab)
    prac = cs.prac_count.masked_fill(
        is_ref[:, None] & (tab.bank_ru == ru[:, None]), 0)
    return (cs._replace(prac_count=prac), do, cmd, _ru_addr(cspec, dp, ru),
            ref_bank)


def _select_and_issue(cspec: CompiledSpec, dp: D.DynParams, cs, clk: int,
                      cfg: ControllerConfig, preds, cmd_ok, sched_fn,
                      link_latency: int = 0):
    """One pass of the base pipeline restricted to commands with
    ``cmd_ok[cmd]`` (``None``: every command; dual C/A runs this twice).
    ``link_latency`` models a CXL-style link in front of the channels: a
    request becomes a candidate at ``arrive + link_latency``, and read
    data takes another ``link_latency`` cycles back.  Returns ``(cs',
    events dict)``."""
    tab = dp.tables
    q = cs.queue
    bank = D.flat_bank(cspec, tab, q.sub)
    cand_cmd, cand_row, open_hit, timing_ready, table = _candidates(
        cspec, dp, cs, clk, bank)
    ru = q.sub[:, :, 0]

    due, urgent, ref_cmd = _refresh_plan(cspec, dp, cs, clk, cfg)
    ctx = PredCtx(dp=dp, cs=cs, clk=clk, cand_cmd=cand_cmd,
                  cand_row=cand_row, open_hit=open_hit, bank=bank, ru=ru,
                  ref_urgent=urgent)

    mask = q.valid & timing_ready
    if cmd_ok is not None:
        mask = mask & D.lut(cmd_ok, cand_cmd)
    if link_latency:
        mask = mask & (q.arrive + link_latency <= clk)
    pre_pred = mask
    for p in preds:
        mask = mask & p(cspec, ctx)
    deferred = (pre_pred & ~mask).sum(1, dtype=I32)

    # refresh engine first (its commands obey the same kind restriction)
    cs, ref_issued, ref_cmd_done, ref_sub, ref_bank = _try_issue_refresh(
        cspec, dp, cs, clk, due, urgent, ref_cmd, cmd_ok, table)

    hit_ready = (mask & open_hit).any(1) & ~ref_issued
    slot, ok = sched_fn(mask & ~ref_issued[:, None], open_hit, q.arrive)
    do = ok & ~ref_issued
    sl = slot[:, None]

    def at_slot(a):
        return a.gather(1, sl)[:, 0]

    cmd = at_slot(cand_cmd)
    rowv = at_slot(cand_row)
    b = at_slot(bank)
    arrive = at_slot(q.arrive)
    sub = q.sub.gather(1, sl[:, :, None].expand(-1, 1, q.sub.shape[2]))[:, 0]
    # at most one of the refresh command and the queue pick fires
    dev = D.issue(cspec, dp, cs.dev,
                  torch.where(ref_issued, ref_cmd_done, cmd),
                  torch.where(ref_issued[:, None], ref_sub, sub),
                  rowv.masked_fill(ref_issued, 0), clk, do | ref_issued)

    fx = D.lut(tab.cmd_fx, cmd)
    fin_rd = do & ((fx & S.FX_FINAL_RD) != 0)
    fin_wr = do & ((fx & S.FX_FINAL_WR) != 0)
    served = fin_rd | fin_wr
    valid = q.valid.scatter(1, sl, at_slot(q.valid)[:, None]
                            & ~served[:, None])

    # row-hit streak bookkeeping (FRFCFS-Cap support)
    b_hit = tab.bank_ids == b[:, None]
    streak = torch.where(served[:, None] & b_hit, cs.hit_streak + 1,
                         cs.hit_streak)
    is_open_cmd = do & (cmd == _opener(cspec))
    streak = streak.masked_fill(is_open_cmd[:, None] & b_hit, 0)

    # BlockHammer: the row open counts in the sketch, which halves on
    # nREFI multiples (once per pass, as in the reference)
    sk = cs.bh_sketch
    if cfg.blockhammer_threshold:
        h0, h1 = _bh_hashes(b, rowv)
        sk = sk.scatter_add(2, torch.stack([h0, h1], 1)[:, :, None],
                            is_open_cmd[:, None, None].expand(-1, 2, 1)
                            .to(I32))
        if clk % dp.nREFI == 0:
            sk = sk >> 1
    prac = cs.prac_count
    if cfg.prac_threshold:
        prac = prac + (is_open_cmd[:, None] & b_hit).to(I32)

    probe = fin_rd & at_slot(q.is_probe)
    completion = clk + dp.read_latency + link_latency
    ev = dict(
        cmd=torch.where(do, cmd, ref_cmd_done.masked_fill(~ref_issued, -1)),
        bank=torch.where(do, b, ref_bank.masked_fill(~ref_issued, -1)),
        row=rowv.masked_fill(~do, -1),
        arrive=arrive.masked_fill(~do, -1),
        hit_ready=hit_ready,
        served_read=fin_rd, served_write=fin_wr, served_probe=probe,
        probe_latency=(completion - arrive).masked_fill(~probe, 0),
        probe_completion=probe.to(I32) * completion,
        deferred=deferred,
    )
    cs = cs._replace(dev=dev, queue=q._replace(valid=valid),
                     hit_streak=streak, bh_sketch=sk, prac_count=prac)
    return cs, ev


# --------------------------------------------------------------------------
# Event horizon (the engine's fast-forward path)
# --------------------------------------------------------------------------

#: see ``repro_torch.core.frontend.HORIZON_MAX`` — shared sentinel value
HORIZON_MAX = 1 << 30


def channel_horizon_plain(cspec: CompiledSpec, dp: D.DynParams,
                          cfg: ControllerConfig, cs: CtrlState, clk: int,
                          link_latency: int = 0):
    """Earliest cycle ``>= clk`` at which each channel could issue any
    command — queue candidate or refresh engine — on the current state,
    ``(C,)``.  Conservative by construction (predicate, bus-kind and
    scheduler masks are ignored: they only shrink the issue set), exactly
    as ``repro.core.controller.channel_horizon``:

    * queue: per valid slot, the earliest-ready table at the slot's
      prerequisite command, and not before ``arrive + link_latency``;
    * refresh: per unit, ``max(due clock, earliest-ready of its
      PREab/REFab candidate)``; a PRAC alert makes the unit due now;
    * clock expiry (``data_clock_sync``): the first ``clock_until`` still
      in the future;
    * BlockHammer: the next ``nREFI`` multiple (the sketch decays there).
    """
    tab = dp.tables
    q = cs.queue
    bank = D.flat_bank(cspec, tab, q.sub)
    cand_cmd, _, _ = D.prereq(cspec, dp, cs.dev, q.is_write, q.sub, q.row,
                              clk)
    table = D.earliest_ready_table_plain(cspec, dp, cs.dev)
    t_slot = D.table_at(table, cand_cmd, bank)
    if link_latency:
        t_slot = torch.maximum(t_slot, q.arrive + link_latency)
    h = t_slot.masked_fill(~q.valid, HORIZON_MAX).amin(1)
    if cfg.refresh_enabled:
        dev = cs.dev
        C, U = dev.last_ref.shape
        due_t = dev.last_ref + dp.nREFI
        if cfg.prac_threshold:
            due_t = due_t.masked_fill(
                _prac_alert(cspec, cs.prac_count, cfg.prac_threshold), clk)
        any_open = (dev.row_state.reshape(C, U, -1) != D.ROW_CLOSED).any(2)
        ref_cmd = torch.full_like(due_t, cspec.id_REFab).masked_fill(
            any_open, cspec.id_PREab)
        rep = tab.ru_ids * (cspec.n_banks // cspec.n_refresh_units)
        ready = D.table_at(table, ref_cmd, rep.expand_as(ref_cmd))
        h = torch.minimum(h, torch.maximum(due_t, ready).amin(1))
    if cspec.data_clock_sync:
        cu = cs.dev.clock_until
        h = torch.minimum(h, cu.masked_fill(cu <= clk, HORIZON_MAX).amin(1))
    if cfg.blockhammer_threshold:
        h = h.clamp(max=(clk + dp.nREFI - 1) // dp.nREFI * dp.nREFI)
    return h.clamp(min=clk)


def _pack_events(ev_col: dict, ev_row: dict | None = None) -> StepEvents:
    """Pack one or two selection-pass event dicts into ``StepEvents``:
    per-bus-slot fields stack ``[col-bus, row-bus]`` (the row slot is idle
    for single-bus standards); per-cycle outcomes OR/sum across passes."""
    if ev_row is None:
        idle = lambda k, v: torch.full_like(ev_col[k], v)
        slot = {k: torch.stack([ev_col[k], idle(k, -1)], 1)
                for k in ("cmd", "bank", "row", "arrive")}
        slot["hit_ready"] = torch.stack(
            [ev_col["hit_ready"], torch.zeros_like(ev_col["hit_ready"])], 1)
        return StepEvents(**slot, **{k: ev_col[k] for k in (
            "served_read", "served_write", "served_probe", "probe_latency",
            "probe_completion", "deferred")})
    slot = {k: torch.stack([ev_col[k], ev_row[k]], 1)
            for k in ("cmd", "bank", "row", "arrive", "hit_ready")}
    return StepEvents(
        **slot,
        served_read=ev_col["served_read"] | ev_row["served_read"],
        served_write=ev_col["served_write"] | ev_row["served_write"],
        served_probe=ev_col["served_probe"] | ev_row["served_probe"],
        probe_latency=ev_col["probe_latency"] + ev_row["probe_latency"],
        probe_completion=(ev_col["probe_completion"]
                          + ev_row["probe_completion"]),
        deferred=ev_col["deferred"] + ev_row["deferred"],
    )


#: calls of :func:`controller_step_plain` (on any device): a run on the
#: card shows with it that its main path never fell back to the plain step
plain_calls = 0


def controller_step_plain(cspec: CompiledSpec, dp: D.DynParams,
                          cfg: ControllerConfig, cs: CtrlState,
                          clk: int, link_latency: int = 0) -> tuple:
    """One controller cycle of every channel in plain PyTorch at host
    clock ``clk``.  Dual-C/A standards run the selection pipeline twice —
    a column pass and a row pass; others run it once.  ``link_latency``
    is the spec group's CXL-style link (see :func:`_select_and_issue`)."""
    global plain_calls
    plain_calls += 1
    preds = cfg.predicates(cspec)
    sched_fn = SCHEDULERS[cfg.scheduler]
    if cspec.dual_command_bus:
        tab = dp.tables
        cs, ev_col = _select_and_issue(cspec, dp, cs, clk, cfg, preds,
                                       tab.col_cmds, sched_fn, link_latency)
        cs, ev_row = _select_and_issue(cspec, dp, cs, clk, cfg, preds,
                                       tab.row_cmds, sched_fn, link_latency)
        return cs, _pack_events(ev_col, ev_row)
    cs, ev = _select_and_issue(cspec, dp, cs, clk, cfg, preds, None,
                               sched_fn, link_latency)
    return cs, _pack_events(ev)


def step_and_horizon_plain(cspec: CompiledSpec, dp: D.DynParams,
                           cfg: ControllerConfig, cs: CtrlState,
                           clk: int, link_latency: int = 0) -> tuple:
    """The fused kernel's plain version: :func:`controller_step_plain` at
    ``clk``, then :func:`channel_horizon_plain` at ``clk + 1`` on the new
    state.  Returns ``(cs', events, horizon (C,))``."""
    cs, ev = controller_step_plain(cspec, dp, cfg, cs, clk, link_latency)
    return cs, ev, channel_horizon_plain(cspec, dp, cfg, cs, clk + 1,
                                         link_latency)


def idle_events(lanes: int, device) -> StepEvents:
    """The events of lanes that execute no cycle: nothing issued, served
    or deferred."""
    neg = torch.full((lanes, 2), -1, dtype=I32, device=device)
    no = torch.zeros(lanes, dtype=torch.bool, device=device)
    zero = torch.zeros(lanes, dtype=I32, device=device)
    return StepEvents(cmd=neg, bank=neg, row=neg, arrive=neg,
                      hit_ready=torch.zeros((lanes, 2), dtype=torch.bool,
                                            device=device),
                      served_read=no, served_write=no, served_probe=no,
                      probe_latency=zero, probe_completion=zero,
                      deferred=zero)


def step_lanes_plain(cspec: CompiledSpec, dp: D.DynParams,
                     cfg: ControllerConfig, cs: CtrlState, clk, active,
                     horizon: bool = True, link_latency: int = 0) -> tuple:
    """The fused kernel's plain version over ``P x C`` lanes (``cs``
    leaves ``(P, C, ...)``; ``clk`` and ``active`` ``(P,)`` tensors or
    host lists): each active point's channels take one step at the
    point's clock (:func:`step_and_horizon_plain`, or
    :func:`controller_step_plain` without ``horizon``); an inactive
    point's lanes keep their state and give idle events and the horizon
    ``HORIZON_MAX``.  Returns ``(cs', StepEvents, horizon (P, C))``.  It
    loops over the points in Python, unless there are several points and
    every one is active at one clock (an exploration chunk, or any batch
    whose points run in lockstep): then all ``P * C`` lanes take one step
    as channels.  It is the kernel's yardstick and the engine's step on
    the CPU."""
    host = lambda x: (x.tolist()  # lint: ignore[ts102] CPU path only
                      if isinstance(x, torch.Tensor) else list(x))
    clks, acts = host(clk), host(active)
    P, nch = cs.queue.valid.shape[:2]
    device = cs.queue.valid.device
    if P > 1 and all(acts) and len(set(clks)) == 1:
        # every point active at one clock: the lanes are independent
        # channels of one step (the plain step treats channels apart)
        flat = _tree(lambda a: a.reshape((P * nch,) + a.shape[2:]), cs)
        if horizon:
            flat, ev, h = step_and_horizon_plain(cspec, dp, cfg, flat,
                                                 clks[0], link_latency)
        else:
            flat, ev = controller_step_plain(cspec, dp, cfg, flat, clks[0],
                                             link_latency)
            h = torch.full((P * nch,), HORIZON_MAX, dtype=I32, device=device)
        back = lambda a: a.reshape((P, nch) + a.shape[1:])
        return _tree(back, flat), _tree(back, ev), back(h)
    parts = []
    for p, (t, on) in enumerate(zip(clks, acts)):
        cs_p = _tree(lambda a: a[p], cs)
        h = torch.full((nch,), HORIZON_MAX, dtype=I32, device=device)
        if not on:
            ev = idle_events(nch, device)
        elif horizon:
            cs_p, ev, h = step_and_horizon_plain(cspec, dp, cfg, cs_p, t,
                                                 link_latency)
        else:
            cs_p, ev = controller_step_plain(cspec, dp, cfg, cs_p, t,
                                             link_latency)
        parts.append((cs_p, ev, h))
    stack = lambda *xs: torch.stack(xs)
    return (_tree(stack, *(c for c, _, _ in parts)),
            _tree(stack, *(e for _, e, _ in parts)),
            torch.stack([h for _, _, h in parts]))


# --------------------------------------------------------------------------
# Dispatch: the fused kernel on CUDA tensors, the plain version on the CPU
# --------------------------------------------------------------------------

_PLANS: dict = {}


def _events_view(out: torch.Tensor) -> tuple:
    """``StepEvents`` and the horizon as views of the kernel's packed
    ``(..., 16)`` int32 events buffer, one row per lane (bool fields are
    bytes of it)."""
    e = KS.EVENT
    by = out.view(torch.uint8)
    pair = lambda k: out[..., e[k]:e[k] + 2]
    flag = lambda k, n=1: (by[..., e[k]:e[k] + n] if n > 1
                           else by[..., e[k]]).view(torch.bool)
    ev = StepEvents(
        cmd=pair("EvCmd"), bank=pair("EvBank"), row=pair("EvRow"),
        arrive=pair("EvArrive"), hit_ready=flag("EvHitReadyByte", 2),
        served_read=flag("EvServedReadByte"),
        served_write=flag("EvServedWriteByte"),
        served_probe=flag("EvServedProbeByte"),
        probe_latency=out[..., e["EvProbeLatency"]],
        probe_completion=out[..., e["EvProbeCompletion"]],
        deferred=out[..., e["EvDeferred"]])
    return ev, out[..., e["EvHorizon"]]


def step_plan(cspec: CompiledSpec, dp: D.DynParams, cfg: ControllerConfig,
              cs: CtrlState, link_latency: int = 0,
              plans: dict | None = None) -> KS.StepPlan:
    """The kernel's plan for this (spec, latencies, config, link latency,
    queue depth, lanes, device), built at first use and kept, for ``cs``
    leaves ``(P, C, ...)``; the events and the horizon are views of the
    plan's buffer in the lanes' shape.  Each spec group of a memory system
    has its own ``dp``, so its own plan and buffer.  ``plans`` is the
    caller's store (a cached run keeps every plan it built); without it a
    process-wide store keeps the last few."""
    *shape, Q = cs.queue.valid.shape
    dev = cs.queue.valid.device
    key = (id(dp), cfg, int(link_latency), Q, tuple(shape), dev)
    store = _PLANS if plans is None else plans
    hit = store.get(key)
    if hit is not None and hit[0] is dp:
        return hit[1]
    if len(shape) != 2:
        raise ValueError("controller step: the state's leaves must be "
                         f"(points, channels, ...), got {tuple(shape)}")
    plan = KS.build_plan(cspec, dp, cfg, Q, shape[1], dev, shape[0],
                         link_latency)
    plan.events, plan.horizon = _events_view(
        plan.out.view(plan.lane_shape + (KS.EVENT["EvWords"],)))
    if plans is None and len(_PLANS) >= 8:
        _PLANS.pop(next(iter(_PLANS)))
    store[key] = (dp, plan)
    return plan


def _device_kind(cs: CtrlState) -> str:
    kind = cs.queue.valid.device.type
    if kind not in ("cuda", "cpu"):
        raise NotImplementedError(f"controller step on {kind!r} tensors")
    return kind


def user_mask(cspec: CompiledSpec, dp: D.DynParams, cfg: ControllerConfig,
              cs: CtrlState, clk: torch.Tensor) -> torch.Tensor:
    """The user predicates' verdict ``(P, C, Q)`` bool on a state of
    ``(P, C, ...)`` leaves at the points' clocks ``clk`` ``(P,)``: the AND
    of ``cfg.extra_predicates`` over the :class:`PredCtx` that
    :func:`_select_and_issue` builds at the start of a pass, every lane at
    once (its point's clock as a ``(lanes, 1)`` column), on the state's
    device and without a host sync."""
    shape = cs.queue.valid.shape
    lanes = _tree(lambda a: a.reshape((-1,) + a.shape[2:]), cs)
    t = clk.repeat_interleave(shape[1])[:, None]
    q = lanes.queue
    bank = D.flat_bank(cspec, dp.tables, q.sub)
    cand_cmd, cand_row, open_hit = D.prereq(cspec, dp, lanes.dev,
                                            q.is_write, q.sub, q.row, t)
    _, urgent, _ = _refresh_plan(cspec, dp, lanes, t, cfg)
    ctx = PredCtx(dp=dp, cs=lanes, clk=t, cand_cmd=cand_cmd,
                  cand_row=cand_row, open_hit=open_hit, bank=bank,
                  ru=q.sub[:, :, 0], ref_urgent=urgent)
    mask = torch.ones_like(q.valid)
    for p in cfg.extra_predicates:
        mask = mask & p(cspec, ctx)
    return mask.reshape(shape).contiguous()


def _dispatch(cspec: CompiledSpec, dp: D.DynParams, cfg: ControllerConfig,
              cs, clk, active, horizon: bool, link_latency: int,
              plans: dict | None) -> tuple:
    if _device_kind(cs) == "cpu":
        return step_lanes_plain(cspec, dp, cfg, cs, clk, active, horizon,
                                link_latency)
    plan = step_plan(cspec, dp, cfg, cs, link_latency, plans)
    if not cfg.extra_predicates:
        KS.controller_step_cuda(plan, cs, clk, active, horizon)
        return cs, plan.events, plan.horizon
    # a dual bus takes one launch per pass: the row pass's predicates read
    # the state the column pass left
    for only in ((0, 1) if cspec.dual_command_bus else (-1,)):
        KS.controller_step_cuda(plan, cs, clk, active, horizon and only != 0,
                                user_mask(cspec, dp, cfg, cs, clk), only)
    return cs, plan.events, plan.horizon


def controller_step(cspec: CompiledSpec, dp: D.DynParams,
                    cfg: ControllerConfig, cs: CtrlState,
                    clk: torch.Tensor, active: torch.Tensor,
                    link_latency: int = 0, plans: dict | None = None
                    ) -> tuple:
    """One controller cycle of every lane: ``(cs', StepEvents)``.

    ``clk`` is a ``(P,)`` int32 tensor of per-point clocks with ``active``
    ``(P,)`` bool (``cs`` leaves ``(P, C, ...)``; inactive points are left
    as they are); a single run is one point.  ``link_latency`` is the
    lanes' spec group's link.  On CUDA tensors it launches the fused
    kernel (after :func:`user_mask` where there are user predicates; one
    launch per pass of a dual command bus then), which updates ``cs``'s
    tensors in place and returns views of a buffer the next launch
    overwrites (see ``repro_torch.kernels.controller_step``); on CPU
    tensors it runs the plain version.  ``plans`` keeps the kernel's
    plans (see :func:`step_plan`)."""
    return _dispatch(cspec, dp, cfg, cs, clk, active, False,
                     link_latency, plans)[:2]


def step_and_horizon(cspec: CompiledSpec, dp: D.DynParams,
                     cfg: ControllerConfig, cs: CtrlState,
                     clk: torch.Tensor, active: torch.Tensor,
                     link_latency: int = 0, plans: dict | None = None
                     ) -> tuple:
    """:func:`controller_step` at ``clk`` and the channel horizon at
    ``clk + 1`` on the new state, ``(cs', StepEvents, horizon (P, C))``:
    the kernel on CUDA tensors, :func:`step_lanes_plain` on CPU
    tensors."""
    return _dispatch(cspec, dp, cfg, cs, clk, active, True, link_latency,
                     plans)
