"""The fused controller step: CUDA kernel wrapper and its per-run plan.

``controller_step_cuda(plan, cs, clk, active, horizon)`` launches
``csrc/controller_step.cu`` (built for ``sm_90a`` at first use, see
``build.py``): one block per lane does what
``repro_torch.core.controller.step_and_horizon_plain`` does (readiness
table, candidates, predicates — BlockHammer and PRAC included, and the
user predicates' verdict when the caller passes it as ``user_mask`` —
refresh engine, scheduler, issue, events and, with ``horizon``, the
event horizon at ``clk + 1``, under the plan's link latency), bit for
bit.  A
lane is one channel of one design point.  One launch steps ``P`` points
of ``C`` channels, each at its point's clock (``clk`` a ``(P,)`` int32
tensor on the card, with the ``(P,)`` bool ``active``; the state's leaves
are ``(P, C, ...)``; an inactive point's lanes keep their state and write
idle events); a single run is a batch of one point.  It replaces the TPU
kernel
``repro/kernels/timing_check.py::maxplus_matmul`` on the simulator's main
path; the source note says what bounds it.

Aliasing.  The kernel updates the controller state IN PLACE: every tensor
of ``cs.dev``, ``cs.queue.valid``, ``cs.hit_streak``, ``cs.prac_count``
and, with BlockHammer on, ``cs.bh_sketch`` is overwritten with the next
state (an inactive lane's is left as it
was), so the caller must not keep them as the old state (the engine drops
the old state each cycle; a test clones its inputs first).  The events and
the horizon are views of one int32 buffer that the plan owns and the next
launch overwrites; the engine reads them within the cycle, and its trace
path copies them (``torch.stack``).

The plan (:func:`build_plan`) packs the spec's constant tables into one
int32 tensor in the layout ``HEADER`` gives (mirrored from the ``Header``
enum of the source; a CPU test compares the two).  It is built once per
run in plain Python and numpy, so the CPU tests can check it field by
field.  Everything the kernel does not take raises ``ValueError`` here,
before any launch: there is no path back to the eager step on CUDA.

``launch_count`` counts kernel launches, so a run can show that its main
path went through the kernel.

The source compiles one kernel instance per set of features
(:data:`FEATURE`: link latency, BlockHammer, PRAC, user mask); the
launch picks the plan's (:attr:`StepPlan.features`, plus the user flag
when a mask is passed), so a run without a feature does not pay for its
gates.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

#: kernel launches since import (or the last reset by the caller)
launch_count = 0

#: the kernel's block size and shared-memory capacities (``kThreads`` and
#: the ``kMax*`` constants of the source)
LIMITS = dict(Threads=256, MaxQueue=256, MaxNodes=128, MaxCmds=16,
              MaxBanks=128, MaxUnits=8, MaxRingRows=8, MaxRingDepth=8,
              MaxSubLevels=5, MaxConsts=1024, Sketch=1024)

#: header words of the packed plan, in the order of the source's ``Header``
#: (the last name is the count of the others)
HEADER = (
    "Q", "L1", "F", "B", "U", "N", "R", "W", "K", "NRing", "Bpr",
    "Split", "Dcs", "Dual", "Refresh", "Fcfs",
    "IdPre", "IdOpener", "IdAct2", "IdRd", "IdWr", "IdSyncRd", "IdSyncWr",
    "IdRefab", "IdPreab",
    "NREFI", "NAAD", "ClockIdle", "ReadLatency", "UrgentMargin",
    "LinkLatency", "BhThreshold", "PracThreshold",
    "OffKeys", "OffA", "OffScope", "OffFx", "OffPass", "OffBankStride",
    "OffNodeMul", "OffNodeOff", "OffRingCmd", "OffRingLevel", "OffRingNode",
    "NConsts", "HeaderWords")
H = {name: i for i, name in enumerate(HEADER)}

#: one channel's row of the events buffer (the source's ``Event``): int32
#: words, then the bool fields as bytes of the same row
EVENT = dict(EvCmd=0, EvBank=2, EvRow=4, EvArrive=6, EvProbeLatency=8,
             EvProbeCompletion=9, EvDeferred=10, EvHorizon=11,
             EvHitReadyByte=48, EvServedReadByte=50, EvServedWriteByte=51,
             EvServedProbeByte=52, EvWords=16)

#: the source's ``Feature`` flags: each compiles a feature's gates into a
#: kernel instance (the last name is the count of instances)
FEATURE = dict(FeatLink=1, FeatBh=2, FeatPrac=4, FeatUser=8, Features=16)

#: device pointers the launch takes, in the order of the source's
#: ``StepPtrs``: the plan, ten state arrays, six queue arrays, the events
#: buffer, the clocks, the active flags and the user predicates' mask
PTRS = ("consts", "last_issue", "win_ring", "row_state", "act1_row",
        "act1_clk", "clock_until", "last_ref", "hit_streak", "prac_count",
        "bh_sketch", "valid", "is_write", "is_probe", "sub", "row", "arrive",
        "out", "clk", "active", "user_mask")
NUM_PTRS = len(PTRS)
PTR = {name: i for i, name in enumerate(PTRS)}

#: the tables after the header, in the order they are packed (each at the
#: offset its ``Off<name>`` header word gives)
TABLES = ("Keys", "A", "Scope", "Fx", "Pass", "BankStride", "NodeMul",
          "NodeOff", "RingCmd", "RingLevel", "RingNode")


class StepPlan:
    """Everything one run's launches share: the packed constants on the
    device (``consts``) and on the host (``host``), the dimensions, the
    events buffer ``out`` ``(lanes, 16)`` int32, the ctypes pointer array
    and the last state it was checked against.  ``events`` and ``horizon``
    are filled by the caller with views of ``out``.  It takes states of
    ``(P, C, ...)`` leaves."""

    def __init__(self, host: np.ndarray, depth: int, channels: int, device,
                 points: int):
        self.host = host
        self.head = host.ctypes.data        # the header words, by value
        self.depth, self.channels, self.points = depth, channels, points
        #: the state's leading dims
        self.lane_shape = (points, channels)
        self.lanes = channels * points
        self.device = torch.device(device)
        self.consts = torch.as_tensor(host, device=self.device)
        self.out = torch.zeros((self.lanes, EVENT["EvWords"]),
                               dtype=torch.int32, device=self.device)
        self.ptrs = (ctypes.c_void_p * NUM_PTRS)()
        self.ptrs[PTR["consts"]] = self.consts.data_ptr()
        self.ptrs[PTR["out"]] = self.out.data_ptr()
        self.checked = None          # data_ptrs of the last checked state
        self.events = self.horizon = None
        f = FEATURE
        #: the kernel instance's flags the header's words switch on
        self.features = ((f["FeatLink"] if self.dim("LinkLatency") else 0)
                         | (f["FeatBh"] if self.dim("BhThreshold") else 0)
                         | (f["FeatPrac"] if self.dim("PracThreshold")
                            else 0))

    def dim(self, name: str) -> int:
        return int(self.host[H[name]])

    def table(self, name: str) -> np.ndarray:
        """One packed table (see :data:`TABLES`), shaped as the kernel
        reads it."""
        K, F, L1, R = (self.dim(k) for k in ("K", "F", "L1", "NRing"))
        shape = dict(Keys=(4, K), A=(K, F), Scope=(F,), Fx=(F,), Pass=(F,),
                     BankStride=(L1,), NodeMul=(L1, L1 + 1),
                     NodeOff=(L1 + 1,), RingCmd=(R,), RingLevel=(R,),
                     RingNode=(R,))[name]
        off = self.dim("Off" + name)
        return self.host[off:off + int(np.prod(shape))].reshape(shape)


def build_plan(cspec, dp, cfg, depth: int, channels: int, device,
               points: int, link_latency: int = 0) -> StepPlan:
    """Pack the constant tables of ``cspec`` (latencies and scalar timings
    of ``dp``) and the options of ``cfg`` (BlockHammer and PRAC thresholds
    included) for a queue of ``depth`` slots in each of ``channels``
    channels of ``points`` design points behind a link of
    ``link_latency`` cycles; raises ``ValueError`` for what the kernel
    does not take."""
    tab = dp.tables
    L1 = len(cspec.levels) - 1
    F, B, U = int(cspec.n_cmds), int(cspec.n_banks), int(cspec.n_refresh_units)
    keys = tab.ready.keys.cpu().numpy()
    A = tab.ready.A.cpu().numpy()
    K = A.shape[0]
    ring_rows = max(int(cspec.n_ring), 1)
    lim = LIMITS
    for what, have, cap in (
            ("queue depth", depth, lim["MaxQueue"]),
            ("hierarchy levels below the channel", L1, lim["MaxSubLevels"]),
            ("commands", F, lim["MaxCmds"]), ("banks", B, lim["MaxBanks"]),
            ("refresh units", U, lim["MaxUnits"]),
            ("hierarchy nodes", int(cspec.num_nodes), lim["MaxNodes"]),
            ("ring rows", ring_rows, lim["MaxRingRows"]),
            ("ring depth", int(cspec.ring_depth), lim["MaxRingDepth"])):
        if have > cap:
            raise ValueError(f"controller-step kernel: {what} {have} above "
                             f"its limit {cap} ({cspec.name})")
    if link_latency < 0:
        raise ValueError(f"controller-step kernel: link latency "
                         f"{link_latency} below 0")
    if depth < 1 or channels < 1 or points < 1:
        raise ValueError("controller-step kernel: needs a queue, a channel "
                         f"and a point, got depth {depth}, channels "
                         f"{channels}, points {points}")
    if B % U:
        raise ValueError(f"controller-step kernel: {B} banks do not split "
                         f"into {U} refresh units")
    split = bool(cspec.split_activation)
    dual = bool(cspec.dual_command_bus)
    if dual:        # bit 0: the column pass's commands, bit 1: the row's
        col = tab.col_cmds.cpu().numpy().astype(np.int64)
        pass_bits = col | (tab.row_cmds.cpu().numpy().astype(np.int64) << 1)
    else:
        pass_bits = np.ones(F, np.int64)
    sync_rd = cspec.id_CAS_RD if cspec.id_CAS_RD >= 0 else cspec.id_RCKSTRT
    sync_wr = cspec.id_CAS_WR if cspec.id_CAS_WR >= 0 else cspec.id_RCKSTRT
    tables = dict(
        Keys=keys, A=A, Scope=np.asarray(cspec.cmd_scope),
        Fx=np.asarray(cspec.cmd_fx), Pass=pass_bits,
        BankStride=tab.bank_stride.cpu().numpy(),
        NodeMul=tab.node_mul.cpu().numpy(),
        NodeOff=tab.node_off.cpu().numpy(),
        RingCmd=np.asarray(cspec.ring_cmd), RingLevel=np.asarray(
            cspec.ring_level), RingNode=np.asarray(cspec.ring_node))
    head = dict(
        Q=depth, L1=L1, F=F, B=B, U=U, N=int(cspec.num_nodes), R=ring_rows,
        W=int(cspec.ring_depth), K=K, NRing=int(cspec.n_ring), Bpr=B // U,
        Split=int(split), Dcs=int(bool(cspec.data_clock_sync)),
        Dual=int(dual), Refresh=int(bool(cfg.refresh_enabled)),
        Fcfs=int(cfg.scheduler == "FCFS"), IdPre=cspec.id_PRE,
        IdOpener=cspec.id_ACT1 if split else cspec.id_ACT,
        IdAct2=cspec.id_ACT2, IdRd=cspec.id_RD, IdWr=cspec.id_WR,
        IdSyncRd=sync_rd, IdSyncWr=sync_wr, IdRefab=cspec.id_REFab,
        IdPreab=cspec.id_PREab, NREFI=dp.nREFI, NAAD=dp.nAAD,
        ClockIdle=dp.clock_idle, ReadLatency=dp.read_latency,
        UrgentMargin=cfg.refresh_urgent_margin, LinkLatency=link_latency,
        BhThreshold=cfg.blockhammer_threshold,
        PracThreshold=cfg.prac_threshold)
    words = [np.zeros(H["HeaderWords"], np.int64)]
    off = H["HeaderWords"]
    for name in TABLES:
        a = np.asarray(tables[name], np.int64).reshape(-1)
        head["Off" + name] = off
        words.append(a)
        off += a.size
    head["NConsts"] = off
    if off > lim["MaxConsts"]:
        raise ValueError(f"controller-step kernel: {off} constant words "
                         f"above its limit {lim['MaxConsts']}")
    host = np.concatenate(words)
    for name, value in head.items():
        host[H[name]] = int(value)
    if host.min() < -2**31 or host.max() >= 2**31:
        raise ValueError("controller-step kernel: a constant is out of int32")
    return StepPlan(host.astype(np.int32), depth, channels, device, points)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import build
        lib = build.load("controller_step")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.controller_step_launch.argtypes = [vp, vp, ci, ci, ci, ci, ci,
                                               vp]
        lib.controller_step_launch.restype = ci
        lib.controller_step_num_ptrs.restype = ci
        lib.controller_step_error_string.argtypes = [ci]
        lib.controller_step_error_string.restype = ctypes.c_char_p
        if lib.controller_step_num_ptrs() != NUM_PTRS:
            raise RuntimeError("controller-step kernel: pointer table "
                               "mismatch between the source and its wrapper")
        _LIB = lib
    return _LIB


def _state_tensors(cs):
    d = cs.dev
    return (d.last_issue, d.win_ring, d.row_state, d.act1_row, d.act1_clk,
            d.clock_until, d.last_ref, cs.hit_streak, cs.prac_count,
            cs.bh_sketch)


def _check(plan: StepPlan, named: list):
    """Raise unless every ``(name, tensor, dtype, shape)`` is a
    contiguous tensor of that dtype and shape on the plan's device."""
    dev = plan.device
    for name, t, dtype, shape in named:
        if not isinstance(t, torch.Tensor):
            got = type(t).__name__
        elif t.device != dev or t.dtype != dtype or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            got = f"{t.dtype} {tuple(t.shape)} on {t.device}"
        else:
            continue
        raise ValueError(
            f"controller-step kernel: {name} must be a contiguous "
            f"{dtype} tensor of shape {shape} on {dev}, got {got}")


def _check_state(plan: StepPlan, cs):
    """The checks made before every launch: the in-place state tensors
    when their storage differs from the last checked state (once per run
    in the engine, which keeps updating the same tensors), the queue on
    every call (the frontend makes it anew each cycle), then the device."""
    C, Q = plan.lane_shape, plan.depth
    d = plan.dim
    i32 = torch.int32
    st = _state_tensors(cs)
    ptrs = tuple(t.data_ptr() for t in st)
    if ptrs != plan.checked:
        N, F, B, U = d("N"), d("F"), d("B"), d("U")
        _check(plan, [
            ("last_issue", st[0], i32, C + (N, F)),
            ("win_ring", st[1], i32, C + (d("R"), d("W"))),
            ("row_state", st[2], i32, C + (B,)),
            ("act1_row", st[3], i32, C + (B,)),
            ("act1_clk", st[4], i32, C + (B,)),
            ("clock_until", st[5], i32, C + (U,)),
            ("last_ref", st[6], i32, C + (U,)),
            ("hit_streak", st[7], i32, C + (B,)),
            ("prac_count", st[8], i32, C + (B,)),
            ("bh_sketch", st[9], i32, C + (2, LIMITS["Sketch"]))])
        for i, p in enumerate(ptrs):
            plan.ptrs[PTR["last_issue"] + i] = p
        plan.checked = ptrs
    q = cs.queue
    b = torch.bool
    _check(plan, [("queue.valid", q.valid, b, C + (Q,)),
                  ("queue.is_write", q.is_write, b, C + (Q,)),
                  ("queue.is_probe", q.is_probe, b, C + (Q,)),
                  ("queue.sub", q.sub, i32, C + (Q, d("L1"))),
                  ("queue.row", q.row, i32, C + (Q,)),
                  ("queue.arrive", q.arrive, i32, C + (Q,))])
    if plan.device.type != "cuda":
        raise ValueError("controller-step kernel: the plan lives on "
                         f"{plan.device}; the kernel runs on CUDA tensors")


def controller_step_cuda(plan: StepPlan, cs, clk: torch.Tensor,
                         active: torch.Tensor, horizon: bool,
                         user_mask: torch.Tensor | None = None,
                         only_pass: int = -1):
    """Launch the fused step on the current stream (no synchronise): the
    state of ``cs`` is updated in place, the events (and, with
    ``horizon``, the horizon at ``clk + 1``) land in ``plan.out``.
    ``clk`` and ``active`` are the ``(P,)`` int32 clocks and bool flags of
    the plan's points on its device; the caller keeps the clocks in ``[0,
    2**30)`` (the engine checks them on the host, where it sets them).

    ``user_mask``, a ``(P, C, Q)`` bool tensor, is the user predicates'
    verdict on the state the pass starts from; the kernel ANDs it into its
    own predicates.  ``only_pass`` 0 or 1 runs that pass of a dual command
    bus alone (-1: every pass): the column pass writes its events, and the
    row pass, launched next, adds its own to them."""
    global launch_count
    P = plan.points
    _check(plan, [("clk", clk, torch.int32, (P,)),
                  ("active", active, torch.bool, (P,))])
    features = plan.features
    if user_mask is not None:
        _check(plan, [("user_mask", user_mask, torch.bool,
                       plan.lane_shape + (plan.depth,))])
        features |= FEATURE["FeatUser"]
    if only_pass not in (-1, 0, 1) or (only_pass == 1
                                       and not plan.dim("Dual")):
        raise ValueError(f"controller-step kernel: only_pass {only_pass} "
                         "is not a pass of this standard's command bus")
    _check_state(plan, cs)
    q = cs.queue
    p = plan.ptrs
    for name in ("valid", "is_write", "is_probe", "sub", "row", "arrive"):
        p[PTR[name]] = getattr(q, name).data_ptr()
    p[PTR["clk"]] = clk.data_ptr()
    p[PTR["active"]] = active.data_ptr()
    p[PTR["user_mask"]] = None if user_mask is None else user_mask.data_ptr()
    lib = _lib()
    rc = lib.controller_step_launch(
        p, plan.head, plan.lanes, plan.channels, int(horizon), only_pass,
        features, torch.cuda.current_stream(plan.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("controller-step kernel launch failed: "
                           + lib.controller_step_error_string(rc).decode())
    launch_count += 1
    return plan.out
