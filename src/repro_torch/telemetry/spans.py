"""Spans inside the port's steps, on the profiler's clock.

A span marks where one layer of a train step or a prefill starts and
ends: the loss head, a layer group's forward, recompute and backward,
AdamW, a layer's forward and the cache's k/v recompute, the last logits
and the sample.  It records only while a ``torch.profiler`` session is
recording (``torch.autograd._profiler_enabled()``); otherwise a span site
costs that one check, opens no range, records no event and adds no
autograd node.  While recording, a span

- opens a ``torch.profiler.record_function(name)`` range, so its host
  interval is in the profiler's trace on the clock of its device trace;
- keeps a record: ``id``, ``name``, ``parent`` (the id of the span open
  on the same thread when it opened), the ids of its step or request
  (:func:`tag`: ``step`` and ``microbatch``, or ``request``), where in the
  model it ran (``chunk``, ``group``, ``layer``), ``device_s`` and, on
  CUDA, the caching allocator's ``num_device_alloc``,
  ``num_device_free`` and ``num_alloc_retries`` deltas over the span.

``device_s`` is the device time between two timing CUDA events recorded
on the current stream at open and at close, resolved when the records
are read (after the caller has synchronised); in a process that has not
initialised CUDA it is the host duration.

A backward span opens at the gradient of one tensor and closes at the
gradient of another: :func:`bwd_open` and :func:`bwd_close` put identity
markers on them (``view_as`` forward, the gradient as it is backward), so
the span opens and closes on the autograd engine's thread.

    with torch.profiler.profile():
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    for r in spans.records():
        print(r["name"], r["step"], r["device_s"])

:func:`records` returns the records of the latest profiler session: a
session's records start at the first span recorded after a span site, or
:func:`records`, found the profiler off.  :func:`clear` drops them.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

_on = torch.autograd._profiler_enabled

#: what a span site returns with the profiler off
OFF = contextlib.nullcontext()

_ALLOC = ("num_device_alloc", "num_device_free", "num_alloc_retries")
_WHERE = ("chunk", "group", "layer")
_IDS = ("step", "microbatch", "request")


def _alloc_counts() -> tuple:
    s = torch.cuda.memory_stats_as_nested_dict()
    return tuple(s.get(k, 0) for k in _ALLOC)


class _Span:
    """One recorded span: its record, its range and its start marks."""
    __slots__ = ("rec", "rf", "ev", "t0", "t1", "mem", "session")

    def __init__(self, name: str, parent, where: dict, session: int,
                 ids: dict):
        self.rec = {"id": next(_STATE.ids), "name": name, "parent": parent,
                    **{k: ids.get(k) for k in _IDS},
                    **{k: where.get(k) for k in _WHERE}}
        self.session = session
        self.rf = torch.profiler.record_function(name)
        self.rf.__enter__()
        self.t1 = None
        if torch.cuda.is_initialized():
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record()
            self.mem = _alloc_counts()
        else:
            self.ev = self.mem = None
        self.t0 = time.perf_counter()

    def close(self) -> None:
        self.t1 = time.perf_counter()
        if self.ev is not None:
            self.ev[1].record()
            self.mem = tuple(b - a for a, b in zip(self.mem,
                                                   _alloc_counts()))
        self.rf.__exit__(None, None, None)

    def record(self) -> dict:
        if self.ev is not None:
            self.ev[1].synchronize()
            dev = self.ev[0].elapsed_time(self.ev[1]) / 1e3
            mem = dict(zip(_ALLOC, self.mem))
        else:
            dev = self.t1 - self.t0
            mem = dict.fromkeys(_ALLOC, 0)
        return {**self.rec, "device_s": dev, **mem}


class _State:
    """The spans of the latest session, each thread's stack of open
    spans, and the ids of the step or request being run."""

    def __init__(self):
        self.ids = itertools.count()
        self.session = 0
        self.live = False
        self.spans: list = []
        self.tags: dict = {}
        self.local = threading.local()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None or (st and st[-1].session != self.session):
            st = self.local.stack = []
        return st

    def open(self, name: str, where: dict) -> _Span:
        if not self.live:
            self.session += 1
            self.spans = []
            self.live = True
        st = self.stack()
        sp = _Span(name, st[-1].rec["id"] if st else None, where,
                   self.session, self.tags)
        st.append(sp)
        self.spans.append(sp)
        return sp

    def close(self, name: str) -> None:
        """Close the innermost open span called ``name`` on this thread
        (none open: nothing)."""
        st = self.stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i].rec["name"] == name:
                st.pop(i).close()
                return


_STATE = _State()


class _Scope:
    __slots__ = ("name", "where")

    def __init__(self, name: str, where: dict):
        self.name, self.where = name, where

    def __enter__(self):
        _STATE.open(self.name, self.where)

    def __exit__(self, *exc):
        _STATE.close(self.name)


def span(name: str, **where):
    """A context manager that records span ``name`` while the profiler
    records; ``where``: ``chunk``, ``group`` or ``layer``."""
    if not _on():
        _STATE.live = False
        return OFF
    return _Scope(name, where)


def tag(**ids) -> None:
    """Set the ids that the spans opened from now on share, on every
    thread: ``step`` and ``microbatch``, or ``request``."""
    _STATE.tags = ids


def in_backward() -> bool:
    """Whether the autograd engine is executing a backward pass on this
    thread (a checkpointed region runs again there, as its recompute)."""
    return torch._C._current_graph_task_id() != -1


class _Mark(torch.autograd.Function):
    """Identity; its backward calls ``hook`` before handing the gradient
    on as it is."""

    @staticmethod
    def forward(ctx, x, hook):
        ctx.hook = hook
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if _on():
            ctx.hook()
        return g, None


def bwd_open(x: torch.Tensor, name: str, **where) -> torch.Tensor:
    """``x`` itself; while recording, a view of it whose gradient opens
    span ``name`` in the backward pass."""
    if not _on():
        _STATE.live = False
        return x
    return _Mark.apply(x, lambda: _STATE.open(name, where))


def bwd_close(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` itself; while recording, a view of it whose gradient closes
    the innermost open span ``name`` in the backward pass."""
    if not _on():
        _STATE.live = False
        return x
    return _Mark.apply(x, lambda: _STATE.close(name))


def records() -> list:
    """The records of the latest profiler session, by id: a list of dicts
    (the module's docstring lists the keys).  Spans still open are left
    out.  Synchronises with each span's closing event."""
    if not _on():
        _STATE.live = False
    return [sp.record() for sp in list(_STATE.spans) if sp.t1 is not None]


def clear() -> None:
    """Drop the records of the latest session."""
    _STATE.spans = []
