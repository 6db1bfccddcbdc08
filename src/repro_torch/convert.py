"""Carry simulator state between the reference package and the port.

The reference's state pytrees, brought to the host as numpy arrays (for
example ``jax.tree.map(np.asarray, state)._asdict()``), become the port's
tensors on a given device; :func:`to_numpy` and :func:`stats_to_numpy`
are the way back.  A reference state of one channel (no channel axis)
gains the port's leading channel axis of size 1; one that already has the
axis keeps it.  This module reads plain dicts and arrays only: it imports
nothing of the reference package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import controller as C
from repro_torch.core import device as D
from repro_torch.core import frontend as F
from repro_torch.core.engine import ChannelStats, Stats


def _fields(x) -> dict:
    return x if isinstance(x, dict) else x._asdict()


def _tensor(a, dtype, per_channel_ndim: int, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.ndim == per_channel_ndim:
        arr = arr[None]
    if arr.ndim != per_channel_ndim + 1:
        raise ValueError(f"expected a {per_channel_ndim}-d array per "
                         f"channel, got shape {arr.shape}")
    np_dtype = np.bool_ if dtype == torch.bool else np.int32
    return torch.tensor(np.array(arr, np_dtype), device=device)


_DEV_NDIM = dict(last_issue=2, win_ring=2, row_state=1, act1_row=1,
                 act1_clk=1, clock_until=1, last_ref=1)
_QUEUE_NDIM = dict(valid=1, is_write=1, is_probe=1, sub=2, row=1, col=1,
                   arrive=1)
_BOOL = {"valid", "is_write", "is_probe"}


def device_state(d, device) -> D.DeviceState:
    d = _fields(d)
    return D.DeviceState(**{k: _tensor(d[k], torch.int32, n, device)
                            for k, n in _DEV_NDIM.items()})


def queue(d, device) -> C.Queue:
    d = _fields(d)
    return C.Queue(**{k: _tensor(d[k], torch.bool if k in _BOOL
                                 else torch.int32, n, device)
                      for k, n in _QUEUE_NDIM.items()})


def ctrl_state(d, device) -> C.CtrlState:
    d = _fields(d)
    return C.CtrlState(
        dev=device_state(d["dev"], device), queue=queue(d["queue"], device),
        hit_streak=_tensor(d["hit_streak"], torch.int32, 1, device),
        bh_sketch=_tensor(d["bh_sketch"], torch.int32, 2, device),
        prac_count=_tensor(d["prac_count"], torch.int32, 1, device))


def front_state(d, device) -> F.FrontState:
    """The frontend state is system-level: 0-d tensors, the uint32 rng
    carried as int64."""
    d = _fields(d)
    i32 = lambda k: torch.tensor(int(np.asarray(d[k])), dtype=torch.int32,
                                 device=device)
    return F.FrontState(
        accum_fp=i32("accum_fp"),
        rng=torch.tensor(int(np.asarray(d["rng"])) & F.MASK32,
                         dtype=torch.int64, device=device),
        seq=i32("seq"),
        probe_busy=torch.tensor(bool(np.asarray(d["probe_busy"])),
                                device=device),
        probe_next=i32("probe_next"), sent=i32("sent"),
        dropped_backpressure=i32("dropped_backpressure"),
        served=i32("served"))


def dyn_params(d, cspec, device, channels: int = 1) -> D.DynParams:
    """The port's DynParams (device tables included) for the reference's
    latencies ``d``."""
    d = _fields(d)
    dp = D.dyn_params(cspec, device, channels, ct_lat=np.asarray(d["ct_lat"]))
    return dp._replace(**{k: int(np.asarray(d[k])) for k in (
        "nREFI", "nRFC", "nAAD", "clock_idle", "read_latency")})


def to_numpy(x):
    """Tensors -> numpy arrays throughout a (nested) NamedTuple, tuple,
    list or dict; every other leaf is returned as it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    return x


def stats_to_numpy(stats: Stats) -> Stats:
    """The port's :class:`Stats` with numpy leaves (the reference's
    ``Simulator.run`` returns its Stats so)."""
    out = to_numpy(stats)
    return out._replace(per_channel=ChannelStats(*out.per_channel),
                        per_group=tuple(out.per_group))
