"""The readiness check as one (max,+) product, the counterpart of
``repro/kernels/ops.py``'s timing wrappers.

``readiness_matrix`` gives the earliest-issue cycle of *every* command at
*every* queue slot in one product ``T (slots x timing keys) (max,+)
A (timing keys x commands)``:

* :func:`build_keys` — the distinct (level, preceding command, window)
  triples of the spec's constraints, each a timing key;
* :func:`build_A` — ``A[k, c]``, the largest latency of a constraint with
  key ``k`` targeting command ``c``, else -3e38 (float32);
* :func:`gather_T` — ``T[q, k]``, key ``k``'s last issue at slot ``q``'s
  node of the key's level (the dense table for window-1 keys, the windowed
  ring for deeper ones), -3e38 where never issued (float32);
* :func:`readiness_matrix` and :func:`earliest_for` — the product through
  ``timing_check.maxplus_matmul``, and its value at one command per slot.

The signatures are the reference's, except that ``use_pallas`` and
``interpret`` give way to routing by the tensors' device: on CUDA the
product launches the kernel of ``csrc/readiness.cu``, on the CPU it runs
the plain version.  The port's :class:`~repro_torch.core.device.
DeviceState` has a leading channel axis: ``state.last_issue[c]`` is
channel ``c``.  ``subs`` may be ``(Q, L-1)`` (the same slots in every
channel) or ``(C, Q, L-1)``, and every result gains the leading ``C``
axis: ``gather_T`` gives ``(C, Q, K)``, ``readiness_matrix`` ``(C, Q,
n_cmds)``, ``earliest_for`` ``(C, Q)``; a one-channel state gives a
leading axis of 1.  The product runs once over all ``C * Q`` rows.  The
result is float32 as the reference's: exact while timestamps plus latency
stay below 2**24; the int32 table of ``device.earliest_ready_table`` is
exact everywhere.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.timing_check import maxplus_matmul

NEG = -(1 << 28)                 # "never issued" in the device state
F32_NEG = -3e38                  # the (max,+) identity the wrappers use


class TimingKeys(NamedTuple):
    """Static (spec-compile-time) key table."""
    key_level: np.ndarray    # (K,)
    key_cmd: np.ndarray      # (K,)
    key_win: np.ndarray      # (K,)
    key_ring: np.ndarray     # (K,) windowed-ring entry base, -1 = dense
    ct_key: np.ndarray       # (C,) constraint -> key index


def build_keys(cspec) -> TimingKeys:
    """Compress the (level, prev_cmd, window) triples referenced by
    constraints into a dense key set, in order of first reference."""
    triples: dict = {}
    ct_key = np.zeros(len(cspec.ct_prev), np.int32)
    for i in range(len(cspec.ct_prev)):
        t = (int(cspec.ct_level[i]), int(cspec.ct_prev[i]),
             int(cspec.ct_win[i]))
        ct_key[i] = triples.setdefault(t, len(triples))
    keys = sorted(triples, key=triples.get)
    pair_off = {(p, lvl): off for p, lvl, off, _ in cspec.ring_pairs}
    return TimingKeys(
        key_level=np.array([k[0] for k in keys], np.int32),
        key_cmd=np.array([k[1] for k in keys], np.int32),
        key_win=np.array([k[2] for k in keys], np.int32),
        key_ring=np.array([pair_off.get((k[1], k[0]), -1) if k[2] > 1
                           else -1 for k in keys], np.int32),
        ct_key=ct_key)


def build_A(cspec, keys: TimingKeys, ct_lat, device=None) -> torch.Tensor:
    """``A[k, c]`` = the largest latency (as float32) of the constraints
    with key ``k`` targeting command ``c``, else -3e38; on ``ct_lat``'s
    device (or ``device`` for a numpy ``ct_lat``)."""
    lat = ct_lat if isinstance(ct_lat, torch.Tensor) else \
        torch.as_tensor(np.array(ct_lat), device=device)
    K, n = len(keys.key_level), int(cspec.n_cmds)
    flat = torch.as_tensor(keys.ct_key.astype(np.int64) * n
                           + np.asarray(cspec.ct_next, np.int64),
                           device=lat.device)
    A = torch.full((K * n,), F32_NEG, dtype=torch.float32, device=lat.device)
    A.scatter_reduce_(0, flat, lat.to(torch.float32), reduce="amax")
    return A.reshape(K, n)


def _nodes(cspec, subs: torch.Tensor) -> torch.Tensor:
    """Node index at every level for slots ``(..., L-1)`` -> ``(..., L)``
    (the reference's ``device.node_per_level``)."""
    counts = [int(c) for c in cspec.level_counts]
    offs = [int(o) for o in cspec.level_offsets]
    flat = torch.zeros(subs.shape[:-1], dtype=torch.int64,
                       device=subs.device)
    nodes = [flat]
    for i in range(1, len(counts)):
        flat = flat * counts[i] + subs[..., i - 1].long()
        nodes.append(flat + offs[i])
    return torch.stack(nodes, -1)


def gather_T(cspec, keys: TimingKeys, state, subs) -> torch.Tensor:
    """``T[c, q, k]``: key ``k``'s issue timestamp in channel ``c`` at slot
    ``q``'s level-``level_k`` node, float32, -3e38 where never issued."""
    li, wr = state.last_issue, state.win_ring
    C, _, n_cmds = li.shape
    dev = li.device
    subs = torch.as_tensor(subs, device=dev)
    if subs.dim() == 2:
        subs = subs.expand(C, *subs.shape)
    Q = subs.shape[1]
    kl = torch.as_tensor(keys.key_level.astype(np.int64), device=dev)
    kc = torch.as_tensor(keys.key_cmd.astype(np.int64), device=dev)
    node = _nodes(cspec, subs)[..., kl]                          # (C, Q, K)
    T = li.reshape(C, -1).gather(1, (node * n_cmds + kc).reshape(C, -1))
    if np.any(keys.key_ring >= 0):
        depth = wr.shape[2]
        kr = torch.as_tensor(keys.key_ring.astype(np.int64), device=dev)
        kw = torch.as_tensor(np.minimum(keys.key_win - 1, depth - 1)
                             .astype(np.int64), device=dev)
        lvl_off = torch.as_tensor(np.asarray(cspec.level_offsets, np.int64)
                                  [keys.key_level], device=dev)
        ridx = (kr + node - lvl_off).clamp(0, cspec.n_ring - 1)
        ring = wr.reshape(C, -1).gather(1, (ridx * depth + kw).reshape(C, -1))
        T = torch.where((kr >= 0).repeat(Q), ring, T)
    # a window>1 key its command never stamps (key_ring == -1) reads a
    # dense slot that is never written at that level, so it stays NEG
    T = T.reshape(C, Q, -1)
    return torch.where(T <= NEG, torch.full(T.shape, F32_NEG, device=dev),
                       T.to(torch.float32))


def readiness_matrix(cspec, keys: TimingKeys, ct_lat, state,
                     subs) -> torch.Tensor:
    """``(C, Q, n_cmds)`` earliest-issue cycles for every slot x command
    (float32; -3e38 or below where nothing constrains the command)."""
    T = gather_T(cspec, keys, state, subs)
    A = build_A(cspec, keys, ct_lat, device=T.device)
    C, Q, K = T.shape
    return maxplus_matmul(T.reshape(C * Q, K), A).reshape(C, Q, -1)


def earliest_for(cspec, keys: TimingKeys, ct_lat, state, subs,
                 cand_cmds) -> torch.Tensor:
    """``(C, Q)``: :func:`readiness_matrix` at command ``cand_cmds[q]``
    (``(Q,)``, or ``(C, Q)`` per channel) of each slot."""
    em = readiness_matrix(cspec, keys, ct_lat, state, subs)
    cand = torch.as_tensor(cand_cmds, device=em.device).long()
    if cand.dim() == 1:
        cand = cand.expand(em.shape[0], -1)
    return em.gather(2, cand[..., None])[..., 0]
