"""The timing-readiness table and the (max,+) product: CUDA kernel
wrappers and their plain versions.

``csrc/readiness.cu`` (built for ``sm_90a`` at first use, see ``build.py``)
holds two (max,+) kernels, both bound here:

* :func:`readiness_table` — the dense ``(channels, n_cmds, n_banks)``
  int32 table of the earliest cycle at which each command may issue at
  each bank, ``repro.core.device.earliest_ready_table`` bit for bit with a
  leading channel axis.  On CUDA tensors it launches the kernel, or
  raises; on CPU tensors it runs :func:`readiness_table_plain` (a gather
  plus an ``amax``), the only place the plain version stands in for it.
* :func:`maxplus_cuda` — ``out[q, c] = max(init, max_k T[q, k] + A[k, c])``
  on CUDA tensors, int32 or fp32, the TPU kernel ``repro/kernels/
  timing_check.py::maxplus_matmul`` on arbitrary operands.  Its public
  entry point, with the reference's fp32 semantics, is ``repro_torch.
  kernels.timing_check.maxplus_matmul``; :func:`maxplus_plain` is its
  plain version.

Both replace the TPU kernel; the source note says what bounds them.

``launch_count`` counts launches of either kernel (never plain-version
calls), so a run can show that its path went through them.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import sm_count

NEG = -(1 << 28)                 # "never issued"
ABSENT = -(1 << 31)              # no constraint of key k targets command f
INT32_MIN = -(1 << 31)

#: kernel launches since import (or the last reset by the caller)
launch_count = 0


class ReadinessTables(NamedTuple):
    """Per-run device tables of one spec, made once per run.

    The timing keys are the distinct (level, preceding command, window)
    triples of the reachable constraints (``level <= cmd_scope[prev]``;
    the others never see a stamped timestamp).  ``keys`` rows are
    ``[is_ring, base, col, div]``: key ``k``'s timestamp for bank ``b``
    sits at node ``base + b // div`` of the ring (column ``window - 1``)
    or of the dense last-issue table (column ``prev``).  ``A[k, f]`` is
    the largest latency of a constraint with key ``k`` targeting command
    ``f``, ``ABSENT`` where there is none — the constraint matrix of the
    TPU kernel, in int32.
    """
    keys: torch.Tensor          # (4, K) int32
    A: torch.Tensor             # (K, n_cmds) int32
    # plain version: flat index of key k / bank b into
    # cat(last_issue.flatten(1), win_ring.flatten(1)), and A split into a
    # presence mask and a zero-filled latency
    gather_idx: torch.Tensor    # (K, n_banks) int64
    present: torch.Tensor       # (K, n_cmds) bool
    lat: torch.Tensor           # (K, n_cmds) int32
    n_cmds: int
    n_banks: int


def build_tables(cspec, ct_lat, device) -> ReadinessTables:
    """Key tables of ``cspec`` and the constraint matrix of the run's
    resolved latencies ``ct_lat`` (one per constraint row)."""
    ct_lat = np.asarray(ct_lat.cpu() if isinstance(ct_lat, torch.Tensor)
                        else ct_lat, np.int64)
    n_banks, n_cmds = int(cspec.n_banks), int(cspec.n_cmds)
    node_counts = np.cumprod(np.asarray(cspec.level_counts, np.int64))
    offs = np.asarray(cspec.level_offsets, np.int64)
    key_of: dict = {}
    rows = []                   # [is_ring, base, col, div]
    A = []
    for i in range(len(cspec.ct_prev)):
        p, f = int(cspec.ct_prev[i]), int(cspec.ct_next[i])
        level, win = int(cspec.ct_level[i]), int(cspec.ct_win[i])
        if level > int(cspec.cmd_scope[p]):
            continue            # preceding command never stamps this level
        k = key_of.get((level, p, win))
        if k is None:
            k = key_of[(level, p, win)] = len(rows)
            div = n_banks // int(node_counts[level])
            if win > 1:
                ro = int(cspec.ct_ring[i])
                if ro < 0:
                    raise ValueError("reachable window>1 constraint "
                                     "without a ring")
                rows.append([1, ro, win - 1, div])
            else:
                rows.append([0, int(offs[level]), p, div])
            A.append([ABSENT] * n_cmds)
        A[k][f] = max(A[k][f], int(ct_lat[i]))
    keys = np.asarray(rows, np.int64).reshape(-1, 4)
    A = np.asarray(A, np.int64).reshape(-1, n_cmds)

    ring_rows, depth = max(cspec.n_ring, 1), int(cspec.ring_depth)
    dense_size = int(cspec.num_nodes) * n_cmds
    node = keys[:, 1:2] + np.arange(n_banks)[None, :] // keys[:, 3:4]
    gather_idx = np.where(keys[:, 0:1] == 1,
                          dense_size + node * depth + keys[:, 2:3],
                          node * n_cmds + keys[:, 2:3])
    assert gather_idx.size == 0 or (
        gather_idx.max() < dense_size + ring_rows * depth)
    present = A != ABSENT
    i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                    device=device)
    return ReadinessTables(
        keys=i32(keys.T), A=i32(A),
        gather_idx=torch.as_tensor(gather_idx, dtype=torch.int64,
                                   device=device),
        present=torch.as_tensor(present, device=device),
        lat=i32(np.where(present, A, 0)), n_cmds=n_cmds, n_banks=n_banks)


def readiness_table_plain(tables: ReadinessTables, last_issue: torch.Tensor,
                          win_ring: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: gather every key's timestamp
    per bank, add each command's latency where a constraint exists, mask
    never-issued timestamps to NEG, and take the max over keys."""
    C = last_issue.shape[0]
    src = torch.cat([last_issue.reshape(C, -1), win_ring.reshape(C, -1)], 1)
    t = src.index_select(1, tables.gather_idx.reshape(-1)).reshape(
        C, -1, 1, tables.n_banks)                           # (C, K, 1, B)
    ok = (t > NEG) & tables.present[None, :, :, None]       # (C, K, F, B)
    allowed = (t + tables.lat[None, :, :, None]).masked_fill(~ok, NEG)
    if allowed.shape[1] == 0:
        return torch.full((C, tables.n_cmds, tables.n_banks), NEG,
                          dtype=torch.int32, device=last_issue.device)
    return allowed.amax(dim=1)


def maxplus_plain(T: torch.Tensor, A: torch.Tensor, init) -> torch.Tensor:
    """Plain version of the (max,+) kernel: ``max(init, max_k T[:, k, None]
    + A[k])`` in ``T``'s dtype (int32 adds wrap; fp32 maxima propagate
    NaN), chunked over K so at most 2**26 sums are live."""
    Q, K = T.shape
    C = A.shape[1]
    out = torch.full((Q, C), init, dtype=T.dtype, device=T.device)
    step = max(1, (1 << 26) // max(1, Q * C))
    for k0 in range(0, K, step):
        part = (T[:, k0:k0 + step, None] + A[None, k0:k0 + step]).amax(1)
        out = torch.maximum(out, part)
    return out


#: the general product's tile configurations (``csrc/readiness.cu``)
MAXPLUS_ONE_BLOCK, MAXPLUS_TILE32, MAXPLUS_TILE128 = 0, 1, 2
#: one block's static shared memory, and the most steps given to it
SMEM_BYTES = 48 * 1024
ONE_BLOCK_STEPS = 1 << 20


def maxplus_plan(Q: int, K: int, C: int, n_sm: int) -> int:
    """The tile configuration for a ``(Q, K) x (K, C)`` product on a card
    of ``n_sm`` SMs: one block when both operands fit its shared memory
    and the work is small; 128 x 128 tiles (8 x 8 per thread) when they
    give at least ``n_sm / 2`` blocks; else 32 x 32 tiles (2 x 2)."""
    if 4 * (Q * K + K * C) <= SMEM_BYTES and Q * K * C <= ONE_BLOCK_STEPS:
        return MAXPLUS_ONE_BLOCK
    if 2 * (-(-Q // 128)) * (-(-C // 128)) >= n_sm:
        return MAXPLUS_TILE128
    return MAXPLUS_TILE32


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import build
        lib = build.load("readiness")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.readiness_table_launch.argtypes = [vp, vp, vp, vp, vp] \
            + [ci] * 7 + [vp]
        lib.readiness_table_launch.restype = ci
        lib.maxplus_launch.argtypes = [ci, ci, vp, vp, vp, ci, ci, ci,
                                       ctypes.c_float, ci, vp]
        lib.maxplus_launch.restype = ci
        lib.readiness_error_string.argtypes = [ci]
        lib.readiness_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def readiness_table_cuda(tables: ReadinessTables, last_issue: torch.Tensor,
                         win_ring: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronise)."""
    global launch_count
    dev = last_issue.device
    for name, t in (("last_issue", last_issue), ("win_ring", win_ring),
                    ("keys", tables.keys), ("A", tables.A)):
        if t.device != dev or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"readiness kernel: {name} must be a "
                             f"contiguous int32 tensor on {dev}, got "
                             f"{t.dtype} on {t.device}")
    C, N, F = last_issue.shape
    if win_ring.dim() != 3 or win_ring.shape[0] != C or F != tables.n_cmds:
        raise ValueError(f"readiness kernel: shapes {tuple(last_issue.shape)}"
                         f" / {tuple(win_ring.shape)} do not match the "
                         "tables")
    K = tables.A.shape[0]
    out = torch.empty((C, F, tables.n_banks), dtype=torch.int32, device=dev)
    if C == 0:
        return out
    lib = _lib()
    rc = lib.readiness_table_launch(
        last_issue.data_ptr(), win_ring.data_ptr(), tables.keys.data_ptr(),
        tables.A.data_ptr(), out.data_ptr(), C, N, F, win_ring.shape[1],
        win_ring.shape[2], K, tables.n_banks,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("readiness kernel launch failed: "
                           + lib.readiness_error_string(rc).decode())
    launch_count += 1
    return out


_MAXPLUS_DTYPES = {torch.float32: 0, torch.int32: 1}


def maxplus_cuda(T: torch.Tensor, A: torch.Tensor, init) -> torch.Tensor:
    """Launch the (max,+) kernel on the current stream (no synchronise):
    ``out[q, c] = max(init, max_k T[q, k] + A[k, c])`` for contiguous
    ``T (Q, K)`` and ``A (K, C)`` of one dtype, int32 or float32, on one
    card; the tile configuration from :func:`maxplus_plan`."""
    global launch_count
    dev = T.device
    if T.dim() != 2 or A.dim() != 2 or T.shape[1] != A.shape[0]:
        raise ValueError(f"maxplus kernel: shapes {tuple(T.shape)} x "
                         f"{tuple(A.shape)} do not chain")
    for name, x in (("T", T), ("A", A)):
        if x.device != dev or x.dtype != T.dtype \
                or x.dtype not in _MAXPLUS_DTYPES or not x.is_contiguous():
            raise ValueError(f"maxplus kernel: {name} must be a contiguous "
                             f"int32 or float32 tensor on {dev} of T's "
                             f"dtype, got {x.dtype} on {x.device}")
    Q, K = T.shape
    C = A.shape[1]
    out = torch.empty((Q, C), dtype=T.dtype, device=dev)
    if Q == 0 or C == 0:
        return out
    lib = _lib()
    is_int = T.dtype == torch.int32
    rc = lib.maxplus_launch(
        _MAXPLUS_DTYPES[T.dtype], maxplus_plan(Q, K, C, sm_count(dev)),
        T.data_ptr(), A.data_ptr(), out.data_ptr(), Q, K, C,
        0.0 if is_int else float(init), int(init) if is_int else 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("maxplus kernel launch failed: "
                           + lib.readiness_error_string(rc).decode())
    launch_count += 1
    return out


def readiness_table(tables: ReadinessTables, last_issue: torch.Tensor,
                    win_ring: torch.Tensor) -> torch.Tensor:
    """``(C, n_cmds, n_banks)`` earliest-issue table: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors, an error otherwise."""
    kind = last_issue.device.type
    if kind == "cuda":
        return readiness_table_cuda(tables, last_issue, win_ring)
    if kind == "cpu":
        return readiness_table_plain(tables, last_issue, win_ring)
    raise NotImplementedError(f"readiness table on {kind!r} tensors")
