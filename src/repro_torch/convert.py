"""Carry simulator state and LM parameters between the reference package
and the port.

The reference's state pytrees, brought to the host as numpy arrays (for
example ``jax.tree.map(np.asarray, state)._asdict()``), become the port's
tensors on a given device; :func:`to_numpy` and :func:`stats_to_numpy`
are the way back.  A reference state of one channel (no channel axis)
gains the port's leading channel axis of size 1; one that already has the
axis keeps it.  :func:`lm_params` turns the reference's LM parameter
tree into the port's per-layer :class:`ParamTree`, :func:`lm_params_to_numpy`
is the way back.  This module reads plain dicts and arrays only: it
imports nothing of the reference package (nor ``ml_dtypes``).
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


# ---------------------------------------------------------------------------
# LM parameters
# ---------------------------------------------------------------------------

def bf16_tensor(a, device) -> torch.Tensor:
    """A bf16 array of the reference as a bf16 tensor: ``a`` is the
    reference's array brought to numpy (an ``ml_dtypes`` bfloat16 dtype,
    read here as its bits) or its ``uint16`` bits."""
    arr = np.asarray(a)
    if arr.dtype.name != "bfloat16" and arr.dtype != np.uint16:
        raise TypeError(f"bf16 parameter given as {arr.dtype} (takes "
                        "bfloat16 or its uint16 bits)")
    bits = np.ascontiguousarray(arr).view(np.int16).copy()
    return torch.from_numpy(bits).view(torch.bfloat16).to(device)


def bf16_bits(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor's values as ``uint16`` bits."""
    return t.detach().cpu().contiguous().view(torch.int16).numpy().view(
        np.uint16)


def nest(flat: dict, sep: str = ".") -> dict:
    """``{"groups.b0.wq": a}`` -> ``{"groups": {"b0": {"wq": a}}}``."""
    out: dict = {}
    for path, val in flat.items():
        node = out
        *head, last = path.split(sep)
        for p in head:
            node = node.setdefault(p, {})
        node[last] = val
    return out


def _layer_trees(tree: dict, cfg):
    """``(layer index, block tree, index into the stacked axis or None)``
    of the reference's ``groups.b{j}`` (stacked, layer ``g * P + j``) and
    ``rem.r{j}`` (layer ``G * P + j``)."""
    P, G = len(cfg.block_pattern), cfg.n_groups()
    for j in range(P):
        for g in range(G):
            yield g * P + j, tree["groups"][f"b{j}"], g
    for j in range(cfg.n_remainder()):
        yield G * P + j, tree["rem"][f"r{j}"], None


def lm_params(tree: dict, cfg, device):
    """The reference's LM parameter tree (numpy leaves, nested dicts as
    ``repro.models.init_params`` returns them) as the port's per-layer
    :class:`~repro_torch.models.layers.ParamTree` on ``device``: the
    stacked ``groups.b{j}`` leaves are unstacked along their leading
    (layer) axis."""
    from repro_torch.models.model import param_defs
    from repro_torch.models.layers import ParamTree
    params = ParamTree(param_defs(cfg), device)
    n_set = 0

    def put(dst, src: dict, index):
        nonlocal n_set
        for name, val in src.items():
            if isinstance(val, dict):
                put(dst[name], val, index)
                continue
            t = bf16_tensor(val, device)
            if index is not None:
                t = t[index]
            if tuple(t.shape) != tuple(dst[name].shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)}, the port "
                                 f"wants {tuple(dst[name].shape)}")
            with torch.no_grad():
                dst[name].copy_(t)
            n_set += 1

    put(params, {k: v for k, v in tree.items()
                 if k not in ("groups", "rem")}, None)
    for i, block, index in _layer_trees(tree, cfg):
        put(params["layers"][i], block, index)
    n_want = sum(1 for _ in params.parameters())
    if n_set != n_want:
        raise ValueError(f"set {n_set} of the port's {n_want} parameters")
    return params


def lm_params_to_numpy(params, cfg) -> dict:
    """The port's parameters as the reference's nested tree (layers
    stacked into ``groups.b{j}`` / ``rem.r{j}``), leaves as ``uint16``
    bf16 bits."""
    def tree_of(m) -> dict:
        out = {k: bf16_bits(v) for k, v in m._parameters.items()}
        out.update({k: tree_of(c) for k, c in m._modules.items()
                    if k != "layers"})
        return out

    out = tree_of(params)
    P, G = len(cfg.block_pattern), cfg.n_groups()
    layers = [tree_of(m) for m in params["layers"]]

    def stack(trees):
        return {k: stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
                else np.stack([t[k] for t in trees]) for k in trees[0]}

    if G:
        out["groups"] = {f"b{j}": stack([layers[g * P + j] for g in range(G)])
                         for j in range(P)}
    if cfg.n_remainder():
        out["rem"] = {f"r{j}": layers[G * P + j]
                      for j in range(cfg.n_remainder())}
    return out
